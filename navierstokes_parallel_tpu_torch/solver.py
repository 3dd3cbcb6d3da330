"""Time integration: step, solve and the observable.

PyTorch counterpart of ``navierstokes_parallel_tpu/solver.py`` for the
cavity problems (1 and 2).  One time step (reference main.c:86-146):

    adaptive CFL dt  ->  velocity BCs  ->  tentative F/G  ->  Poisson RHS
    ->  red-black SOR pressure solve  ->  velocity projection

On an f32 CUDA state F, G and the RHS come from the hand-written momentum
kernel and the sweeps from the SOR kernel; elsewhere the plain PyTorch
formulations run.  ``solve`` is a host loop ``while t < T``: PyTorch runs
eagerly, so the JAX package's on-device ``lax.while_loop`` becomes one
scalar read of ``t`` per step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .config import Params
from .grid import State, allocate_state
from .ops import boundary, momentum, sor
from .ops.cuda import momentum_kernel
from .utils.timing import device_fence


class StepDiagnostics(NamedTuple):
    dt: torch.Tensor      # time step taken (0-d, on the state's device)
    sor_iterations: int   # SOR sweeps in this step
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
          device=None, pressure_method: str = "rb_sor"
          ) -> Tuple[State, SolveStats]:
    """Integrate from `state` (or zeros on `device`) to t >= T."""
    if state is None:
        if device is None:
            raise ValueError("solve needs a state or a device")
        state = allocate_state(params, device)
    # Compare against T in the state's dtype, as the JAX while_loop does: in
    # f32, float(f32(T)) can differ from the Python T by one ulp, which would
    # change the step count.
    T = torch.full((), params.T, dtype=state.t.dtype, device=state.t.device)
    steps = iters = failures = 0
    last = 0.0
    while bool(state.t < T):
        state, diag = step(state, params, pressure_method=pressure_method)
        steps += 1
        iters += diag.sor_iterations
        failures += 0 if diag.sor_converged else 1
        last = diag.sor_res_norm
    return state, SolveStats(steps=steps, total_sor_iterations=iters,
                             sor_failures=failures, last_res_norm=last)


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
