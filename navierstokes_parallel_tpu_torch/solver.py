"""Time integration: step, solve and the observable.

PyTorch counterpart of ``navierstokes_parallel_tpu/solver.py`` for the
cavity problems (1 and 2).  One time step (reference main.c:86-146):

    adaptive CFL dt  ->  velocity BCs  ->  tentative F/G  ->  Poisson RHS
    ->  pressure solve (SOR, multigrid or CG)  ->  velocity projection

On an f32 CUDA state F, G and the RHS come from the hand-written momentum
kernel, the SOR sweeps from the SOR kernel and the multigrid smoothing from
the warm-start kernel; elsewhere the plain PyTorch formulations run.
``solve`` is a host loop ``while t < T`` (``run_steps`` over a ``Stepper``):
PyTorch runs eagerly, so the JAX package's on-device ``lax.while_loop``
becomes one scalar read of ``t`` per step.  The CLI runs the same loop with
its frames, checkpoints and history rows between the steps, so it takes
``solve``'s steps, kernels and bits.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .config import Params
from .grid import State, allocate_state
from .ops import boundary, momentum, sor
from .ops.cuda import momentum_kernel
from .utils.timing import device_fence


class StepDiagnostics(NamedTuple):
    dt: torch.Tensor      # time step taken (0-d, on the state's device)
    sor_iterations: int   # SOR sweeps (mg: V-cycles, cg: CG steps)
    sor_res_norm: float   # final SOR residual norm
    sor_converged: bool   # SOR met tolerance (the reference ignores it)


class SolveStats(NamedTuple):
    steps: int
    total_sor_iterations: int
    sor_failures: int     # steps where SOR hit max_it
    last_res_norm: float


def step(state: State, params: Params, *,
         pressure_method: str = "rb_sor") -> Tuple[State, StepDiagnostics]:
    """One time step (reference main.c:86-146).  Does not modify `state`:
    u and v are cloned once, then updated in place (BCs, projection)."""
    if params.problem not in (1, 2):
        raise NotImplementedError(
            f"problem {params.problem} is not ported yet: ROADMAP A6-A8 "
            f"(the port runs the cavity problems 1 and 2)")
    u, v, p, t, n = state
    u, v = u.clone(), v.clone()

    dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
    lid = boundary.lid_velocity(params.problem, params.f, t)
    boundary.apply_cavity_bcs(u, v, lid)
    if momentum_kernel.usable(params, u.device):
        F, G, rhs = momentum_kernel.momentum_rhs(u, v, dt, gamma, params)
    else:
        F, G = momentum.compute_fg(u, v, dt, gamma, params)
        rhs = momentum.compute_rhs(F, G, dt, params)
    result = sor.solve_pressure(p, rhs, params, method=pressure_method)
    momentum.project_velocities(u, v, F, G, result.p, dt, params)

    new_state = State(u=u, v=v, p=result.p, t=t + dt, n=n + 1)
    diag = StepDiagnostics(
        dt=dt,
        sor_iterations=result.iterations,
        sor_res_norm=result.res_norm,
        sor_converged=result.converged,
    )
    return new_state, diag


def solve(params: Params, state: Optional[State] = None, *,
          device=None, pressure_method: str = "rb_sor", max_steps: int = 0
          ) -> Tuple[State, SolveStats]:
    """Integrate from `state` (or zeros on `device`) to t >= T, or stop
    after `max_steps` steps when it is > 0."""
    if state is None:
        if device is None:
            raise ValueError("solve needs a state or a device")
        state = allocate_state(params, device)
    stepper = Stepper(params, state, pressure_method)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.state(), stats


def run_steps(stepper, params: Params, *, max_steps: int = 0,
              before: Optional[Callable[[], None]] = None,
              after: Optional[Callable[[StepDiagnostics, int], None]] = None
              ) -> SolveStats:
    """Advance `stepper` (a ``Stepper`` or a ``sharded.ShardedStepper``) to
    t >= T, or `max_steps` steps when it is > 0, reading t once per step.
    ``before()`` runs before each step and ``after(diag, steps)`` after it
    (the CLI's frames, history rows and checkpoints).  Returns the stats of
    the steps taken."""
    # Compare against T in the state's dtype, as the JAX while_loop does: in
    # f32, float(f32(T)) can differ from the Python T by one ulp, which would
    # change the step count.
    T = float(torch.tensor(params.T, dtype=params.torch_dtype))
    steps = iters = failures = 0
    last = 0.0
    while not 0 < max_steps <= steps and stepper.t < T:
        if before is not None:
            before()
        diag = stepper.step()
        steps += 1
        iters += diag.sor_iterations
        failures += 0 if diag.sor_converged else 1
        last = diag.sor_res_norm
        if after is not None:
            after(diag, steps)
    return SolveStats(steps=steps, total_sor_iterations=iters,
                      sor_failures=failures, last_res_norm=last)


class Stepper:
    """Host-loop adapter for one device (the JAX CLI's
    ``_SingleChipStepper``; the sharded one is
    ``parallel/sharded.py::ShardedStepper``): each ``step()`` is one
    ``solver.step`` of the held state."""

    def __init__(self, params: Params, state: State,
                 pressure_method: str = "rb_sor"):
        self.params = params
        self.pressure_method = pressure_method
        self._state = state

    def warm(self) -> None:
        """Build the kernels and take PyTorch's first-use costs before a
        timed loop (``warm_up``)."""
        warm_up(self.params, self._state.u.device, self.pressure_method)

    @property
    def t(self) -> float:
        return float(self._state.t)

    @property
    def n(self) -> int:
        return self._state.n

    def step(self) -> StepDiagnostics:
        self._state, diag = step(self._state, self.params,
                                 pressure_method=self.pressure_method)
        return diag

    def state(self) -> State:
        return self._state

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank: one device has one rank."""
        return flag


def warm_up(params: Params, device, pressure_method: str = "rb_sor") -> None:
    """Run one throw-away step (a single sweep) from a zero state, so a
    timed solve excludes the kernel build and PyTorch's first-use loading of
    its own CUDA kernels (the JAX CLI compiles before it starts its timer).
    An unported route raises here, before any timing."""
    state, _ = step(allocate_state(params, device), params.replace(max_it=1),
                    pressure_method=pressure_method)
    device_fence(state)


def center_values(state: State, params: Params) -> Tuple[float, float]:
    """The reference's reduced observable: cavity-center velocities
    (main.c:148-149 prints u[i_max/2][j_max/2], v[i_max/2][j_max/2])."""
    i_c, j_c = params.i_max // 2, params.j_max // 2
    return float(state.u[i_c, j_c]), float(state.v[i_c, j_c])
