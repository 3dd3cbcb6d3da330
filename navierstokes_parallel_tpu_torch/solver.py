"""Time integration: step, solve and the observable.

PyTorch counterpart of ``navierstokes_parallel_tpu/solver.py`` for the
cavity (problems 1 and 2), the plane channel (3) and the free-slip
Taylor-Green box (4), each with or without flag-field obstacles
(ops/obstacles.py); natural convection (problem 5) steps with
models/convection.py, which reuses this module's rhs and tail, and free
surfaces (problem 6) with models/freesurface.py.  One time step (reference main.c:86-146):

    adaptive CFL dt  ->  velocity BCs  ->  tentative F/G  ->  Poisson RHS
    ->  pressure solve (SOR, multigrid, CG or DCT)  ->  velocity projection

On an f32 CUDA state F, G and the RHS come from the hand-written momentum
kernel, the SOR sweeps from the SOR kernel and the multigrid smoothing from
the warm-start kernel; elsewhere the plain PyTorch formulations run.  An
obstacle step takes none of the kernels on any device, as in the JAX
package: the plain F/G pinned on the obstacle faces, the masked pressure
solve (ops/masked.py), and the obstacle BCs again after the projection.
``step_ab2`` is the second-order (Adams-Bashforth 2) step: it needs the
explicit tendency, which the fused momentum kernel does not give, so it
takes the plain F/G and RHS on every device, as the JAX package does.
``solve`` and ``solve_ab2`` are a host loop ``while t < T`` (``run_steps``
over a ``Stepper``): PyTorch runs eagerly, so the JAX package's on-device
``lax.while_loop`` becomes one scalar read of ``t`` per step.  The CLI runs
the same loop with its frames, checkpoints and history rows between the
steps, so it takes ``solve``'s steps, kernels and bits.  ``solve_ensemble``
integrates a batch of independent states (``stack_states``: a leading
member axis, the JAX package's ``vmap``) by the same loop over an
``EnsembleStepper``, with one read of the members' times a step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .config import Params
from .grid import State, allocate_state
from .ops import boundary, momentum, obstacles, sor
from .ops.cuda import momentum_kernel
from .utils import timing
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


def _apply_bcs(u, v, t, params: Params) -> None:
    """The velocity BCs of the problem, then those of its obstacles, in
    place on u and v."""
    if params.problem == 3:
        boundary.apply_channel_bcs(u, v, params)
    elif params.problem == 4:
        boundary.apply_freeslip_box(u, v)
    else:
        boundary.apply_cavity_bcs(
            u, v, boundary.lid_velocity(params.problem, params.f, t))
    if params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)


def _rhs(F, G, u, v, dt, params: Params):
    """(F, G, rhs) from the plain F/G: with obstacles F = u and G = v on the
    obstacle faces BEFORE the divergence, and no equation on solid cells
    (aperture-weighted under the cut-cell closure: ops/obstacles.py)."""
    if not params.obstacles:
        return F, G, momentum.compute_rhs(F, G, dt, params)
    F, G = obstacles.pin_fg(F, G, u, v, params)
    return F, G, obstacles.poisson_rhs(F, G, dt, params)


def _check_problem(params: Params) -> None:
    if params.problem not in (1, 2, 3, 4):
        # As the JAX package's step, whose boundary.lid_velocity refuses
        # them: natural convection steps with models/convection.py, free
        # surfaces with models/freesurface.py.
        raise ValueError(f"unknown problem type {params.problem}")


def step(state: State, params: Params, *,
         pressure_method: str = "rb_sor") -> Tuple[State, StepDiagnostics]:
    """One time step (reference main.c:86-146).  Does not modify `state`:
    u and v are cloned once, then updated in place (BCs, projection)."""
    _check_problem(params)
    u, v, p, t, n = state
    u, v = u.clone(), v.clone()

    with timing.span("step.dt_bcs"):
        dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
        _apply_bcs(u, v, t, params)
    if momentum_kernel.usable(params, u.device):
        F, G, rhs = momentum_kernel.momentum_rhs(u, v, dt, gamma, params)
    else:
        F, G, rhs = _rhs(*momentum.compute_fg(u, v, dt, gamma, params), u, v,
                         dt, params)
    return _advance(u, v, p, t, n, F, G, rhs, dt, params, pressure_method)


def _advance(u, v, p, t, n, F, G, rhs, dt, params: Params,
             pressure_method: str) -> Tuple[State, StepDiagnostics]:
    """The pressure solve and the projection (in place on u and v), the
    tail of `step` and `step_ab2`."""
    result = sor.solve_pressure(p, rhs, params, method=pressure_method)
    with timing.span("step.project"):
        momentum.project_velocities(u, v, F, G, result.p, dt, params)
        if params.obstacles:
            # The projection sweeps the obstacle faces too (not the outer
            # walls): restore their no-slip values.
            obstacles.apply_obstacle_bcs(u, v, params)

    new_state = State(u=u, v=v, p=result.p, t=t + dt, n=n + 1)
    diag = StepDiagnostics(
        dt=dt,
        sor_iterations=result.iterations,
        sor_res_norm=result.res_norm,
        sor_converged=result.converged,
    )
    return new_state, diag


class AB2State(NamedTuple):
    """The Adams-Bashforth 2 carry: the state, the previous step's explicit
    tendency (dU/dt on F's layout, dV/dt on G's) and the previous dt
    (0-d; 0 marks the bootstrap: the first step is explicit Euler)."""

    s: State
    ru: torch.Tensor
    rv: torch.Tensor
    dt_prev: torch.Tensor


def ab2_init(state: State) -> AB2State:
    """The bootstrap carry of `state`: zero tendencies, dt_prev = 0."""
    return AB2State(s=state, ru=torch.zeros_like(state.u),
                    rv=torch.zeros_like(state.v),
                    dt_prev=torch.zeros_like(state.t))


def ab2_extrapolate(F, G, u, v, dt, carry):
    """(F, G, ru, rv): the Euler tentative velocities F, G extrapolated
    through the previous step's tendency, in the JAX package's order of
    operations, and this step's tendencies ru = (F - u)/dt, rv = (G - v)/dt
    (their ghost rows hold values no later read touches).  `carry` has
    ``ru``, ``rv`` and ``dt_prev`` of the previous step (an ``AB2State``,
    or the sharded backend's blocks)."""
    ru = (F - u) / dt
    rv = (G - v) / dt
    w = torch.where(carry.dt_prev > 0, dt / (2.0 * carry.dt_prev),
                    torch.zeros_like(dt))
    return (F + (dt * w) * (ru - carry.ru), G + (dt * w) * (rv - carry.rv),
            ru, rv)


def step_ab2(ab2: AB2State, params: Params, *,
             pressure_method: str = "rb_sor"
             ) -> Tuple[AB2State, StepDiagnostics]:
    """One variable-step Adams-Bashforth 2 time step (the JAX package's
    ``step_ab2``): the explicit tendency R = (F - u)/dt is extrapolated
    through the previous step,

        F = u + dt [(1 + w) R_n - w R_{n-1}],   w = dt / (2 dt_{n-1}),

    w = 0 on the bootstrap step (plain Euler); the projection is Euler's.
    AB2 is stable on the viscous dt limit only for tau <= 0.5.  F, G and
    the RHS are the plain formulations on every device (the fused kernel
    has no tendency output).  Does not modify `ab2`."""
    _check_problem(params)
    u, v, p, t, n = ab2.s
    u, v = u.clone(), v.clone()

    with timing.span("step.dt_bcs"):
        dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
        _apply_bcs(u, v, t, params)
    F, G, ru, rv = ab2_extrapolate(
        *momentum.compute_fg(u, v, dt, gamma, params), u, v, dt, ab2)
    F, G, rhs = _rhs(F, G, u, v, dt, params)
    state, diag = _advance(u, v, p, t, n, F, G, rhs, dt, params,
                           pressure_method)
    return AB2State(s=state, ru=ru, rv=rv, dt_prev=dt), diag


def solve(params: Params, state: Optional[State] = None, *,
          device=None, pressure_method: str = "rb_sor", max_steps: int = 0,
          time_order: int = 1) -> Tuple[State, SolveStats]:
    """Integrate from `state` (or zeros on `device`) to t >= T, or stop
    after `max_steps` steps when it is > 0; `time_order` 2 steps with
    ``step_ab2`` from the Euler bootstrap."""
    if state is None:
        if device is None:
            raise ValueError("solve needs a state or a device")
        state = allocate_state(params, device)
    stepper = Stepper(params, state, pressure_method, time_order)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.state(), stats


def solve_ab2(params: Params, state: Optional[State] = None, *,
              device=None, pressure_method: str = "rb_sor",
              max_steps: int = 0) -> Tuple[State, SolveStats]:
    """``solve`` with second-order time stepping (the JAX package's
    ``solve_ab2``, which has no `max_steps`)."""
    return solve(params, state, device=device,
                 pressure_method=pressure_method, max_steps=max_steps,
                 time_order=2)


def run_steps(stepper, params: Params, *, max_steps: int = 0,
              before: Optional[Callable[[], None]] = None,
              after: Optional[Callable[[StepDiagnostics, int], None]] = None
              ) -> SolveStats:
    """Advance `stepper` (a ``Stepper``, an ``EnsembleStepper`` or a
    ``sharded.ShardedStepper``) to t >= T, or `max_steps` steps when it is
    > 0, reading t once per step.  ``before()`` runs before each step and
    ``after(diag, steps)`` after it (the CLI's frames, history rows and
    checkpoints).  Returns the stats of the steps taken."""
    # Compare against T in the state's dtype, as the JAX while_loop does: in
    # f32, float(f32(T)) can differ from the Python T by one ulp, which would
    # change the step count.
    T = float(torch.tensor(params.T, dtype=params.torch_dtype))
    steps = iters = failures = 0
    last = 0.0
    while not 0 < max_steps <= steps and _read_t(stepper) < T:
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


def _read_t(stepper) -> float:
    """The stepper's time on the host: the loop's one sync a step."""
    timing.count("sync.loop_t")
    with timing.span("loop.read_t"):
        return stepper.t


class Stepper:
    """Host-loop adapter for one device (the JAX CLI's
    ``_SingleChipStepper``, and with `time_order` 2 its ``_AB2Stepper``;
    the sharded one is ``parallel/sharded.py::ShardedStepper``): each
    ``step()`` is one ``solver.step`` or ``step_ab2`` of the held state.
    An AB2 stepper starts from the Euler bootstrap, also from a resumed
    state: a checkpoint holds the state, not the tendency."""

    def __init__(self, params: Params, state: State,
                 pressure_method: str = "rb_sor", time_order: int = 1):
        if time_order not in (1, 2):
            raise ValueError(f"time_order must be 1 or 2, got {time_order}")
        self.params = params
        self.pressure_method = pressure_method
        self.time_order = time_order
        self._state = state if time_order == 1 else ab2_init(state)

    def warm(self) -> None:
        """Build the kernels and take PyTorch's first-use costs before a
        timed loop (``warm_up``)."""
        warm_up(self.params, self.state().u.device, self.pressure_method,
                self.time_order)

    @property
    def t(self) -> float:
        return float(self.state().t)

    @property
    def n(self) -> int:
        return self.state().n

    def step(self) -> StepDiagnostics:
        fn = step if self.time_order == 1 else step_ab2
        self._state, diag = fn(self._state, self.params,
                               pressure_method=self.pressure_method)
        return diag

    def state(self) -> State:
        return self._state if self.time_order == 1 else self._state.s

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank: one device has one rank."""
        return flag


def warm_up(params: Params, device, pressure_method: str = "rb_sor",
            time_order: int = 1) -> None:
    """Run one throw-away step (a single sweep) from a zero state, the
    route of `time_order`, so a timed solve excludes the kernel build and
    PyTorch's first-use loading of its own CUDA kernels (the JAX CLI
    compiles before it starts its timer).  An unported route raises here,
    before any timing."""
    stepper = Stepper(params.replace(max_it=1),
                      allocate_state(params, device), pressure_method,
                      time_order)
    stepper.step()
    device_fence(stepper.state())


def stack_states(states) -> State:
    """Per-member States as one batched State (a leading member axis):
    u, v, p (B, i_max + 2, j_max + 2), t (B,) and n (B,) int64."""
    states = list(states)
    return State(*(torch.stack([getattr(s, f) for s in states])
                   for f in ("u", "v", "p", "t")),
                 n=torch.tensor([int(s.n) for s in states],
                                device=states[0].u.device))


def _step_each_member(u, v, p, t, active, params: Params, method: str):
    """``_ensemble_step`` member by member through ``step`` (obstacle
    domains)."""
    outs, diags = [], []
    for k, flag in enumerate(active):
        member = State(u[k], v[k], p[k], t[k], 0)
        if flag:
            member, diag = step(member, params, pressure_method=method)
        else:
            diag = StepDiagnostics(torch.zeros_like(member.t), 0, 0.0, True)
        outs.append(member)
        diags.append(diag)

    def stacked(name):
        return torch.stack([getattr(s, name) for s in outs])

    result = sor.BatchResult(
        p=stacked("p"),
        iterations=torch.tensor([d.sor_iterations for d in diags],
                                device=u.device),
        res_norm=torch.tensor([d.sor_res_norm for d in diags],
                              dtype=p.dtype, device=u.device),
        converged=torch.tensor([d.sor_converged for d in diags],
                               device=u.device))
    return (stacked("u"), stacked("v"), stacked("t"),
            torch.stack([d.dt for d in diags]), result)


def _ensemble_step(u, v, p, t, active, params: Params, method: str):
    """One step of the members `active` (host bools) names: the new u, v,
    t, each member's dt and the batch's ``sor.BatchResult`` (whose p is
    the new pressure).  Problems 1-4 take `step` on the whole batch (the
    BCs, F/G and rhs by the fused momentum kernel on an f32 CUDA state,
    every member in one launch, else by the plain formulation;
    ``sor.solve_pressure_batch``); obstacle domains step member by member.
    Counts the batch step, the members it steps and those it holds."""
    stepped = sum(1 for flag in active if flag)
    timing.count("ensemble.steps")
    timing.count("ensemble.member_steps", stepped)
    timing.count("ensemble.held", len(active) - stepped)
    if params.obstacles:
        return _step_each_member(u, v, p, t, active, params, method)
    u, v = u.clone(), v.clone()
    with timing.span("step.dt_bcs"):
        dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
        dt3, gamma3 = dt.view(-1, 1, 1), gamma.view(-1, 1, 1)
        if params.problem == 3:
            boundary.apply_channel_bcs(u, v, params)
        elif params.problem == 4:
            boundary.apply_freeslip_box(u, v)
        else:
            lid = boundary.lid_velocity(params.problem, params.f, t)
            boundary.apply_cavity_bcs(u, v,
                                      lid.view(-1, 1) if lid.dim() else lid)
    if momentum_kernel.usable(params, u.device):
        F, G, rhs = momentum_kernel.momentum_rhs(u, v, dt, gamma, params)
    else:
        F, G = momentum.compute_fg(u, v, dt3, gamma3, params)
        rhs = momentum.compute_rhs(F, G, dt3, params)
    result = sor.solve_pressure_batch(p, rhs, params, method=method,
                                      active=active)
    with timing.span("step.project"):
        momentum.project_velocities(u, v, F, G, result.p, dt3, params)
    return u, v, t + dt, dt, result


def _check_ensemble_method(pressure_method: str) -> None:
    if pressure_method == "pallas_sor":
        raise ValueError(
            "solve_ensemble cannot batch the Pallas kernels; use rb_sor "
            "(same algorithm, jnp formulation) or mg/cg/fft")


class EnsembleStepper:
    """Host-loop adapter of a batch of independent states
    (``stack_states``), the batched counterpart of ``Stepper``, driven by
    ``run_steps``: each ``step()`` is one ``_ensemble_step`` of the
    members still short of T, after which a member that has reached T
    holds its state (``torch.where``), as the JAX package's batched
    ``while_loop`` holds a finished member's carry.  Each member's n,
    steps, pressure iterations, failures and last norm stay on the device
    (``stats()``).

    ``t`` is the earliest member time: its read of every member's t is the
    loop's one sync a step, and the next ``step()`` takes the members to
    step (t < T, compared in the state's dtype, as JAX compares) from that
    same read.  The StepDiagnostics a step returns hold its dt (one per
    member) and no host number of the solve (0 sweeps, norm 0, converged),
    so that ``run_steps`` reads nothing more: its SolveStats count the
    batch's steps alone.  ``run_steps`` compares t with T in params'
    dtype, so the states take params' dtype."""

    def __init__(self, params: Params, states: State,
                 pressure_method: str = "rb_sor"):
        _check_ensemble_method(pressure_method)
        if pressure_method not in sor.METHODS:
            raise ValueError(f"unknown pressure solver method "
                             f"{pressure_method!r}")
        _check_problem(params)
        self.params = params
        self.pressure_method = pressure_method
        u, v, p, t = (x.clone() for x in states[:4])
        n = torch.as_tensor(states.n, device=t.device).clone()
        self._state = State(u=u, v=v, p=p, t=t, n=n)
        T = torch.tensor(params.T, dtype=t.dtype, device=t.device)
        self._T, self._T_host = T, float(T)
        self._active = t < T
        self._flags = None
        zero = torch.zeros(t.shape[0], dtype=torch.int64, device=t.device)
        self._steps, self._iters = zero.clone(), zero.clone()
        self._failures = zero.clone()
        self._last = torch.zeros_like(t)

    def warm(self) -> None:
        """One throw-away batched step at max_it 1 from a batch at rest of
        the held batch's size, so a timed loop excludes the kernel build
        and PyTorch's first use of its kernels."""
        rest = allocate_state(self.params, self._state.u.device)
        stepper = EnsembleStepper(
            self.params.replace(max_it=1),
            stack_states([rest] * self._state.u.shape[0]),
            self.pressure_method)
        stepper.step()
        device_fence(stepper.state())

    def _read_times(self):
        """Every member's t on the host, the one read a step, and the
        members the next step takes."""
        times = self._state.t.tolist()
        self._flags = [time < self._T_host for time in times]
        return times

    @property
    def t(self) -> float:
        return min(self._read_times())

    def step(self) -> StepDiagnostics:
        if self._flags is None:
            self._read_times()
        flags, self._flags = self._flags, None
        u, v, p, t, n = self._state
        u_new, v_new, t_new, dt, res = _ensemble_step(
            u, v, p, t, flags, self.params, self.pressure_method)
        with timing.span("ensemble.hold"):
            active = self._active
            a3 = active.view(-1, 1, 1)
            self._state = State(u=torch.where(a3, u_new, u),
                                v=torch.where(a3, v_new, v),
                                p=torch.where(a3, res.p, p),
                                t=torch.where(active, t_new, t),
                                n=n + active)
            self._steps += active
            self._iters += torch.where(active, res.iterations, 0)
            self._failures += active & ~res.converged
            self._last = torch.where(active, res.res_norm, self._last)
            self._active = self._state.t < self._T
        return StepDiagnostics(dt=dt, sor_iterations=0, sor_res_norm=0.0,
                               sor_converged=True)

    def state(self) -> State:
        return self._state

    def stats(self) -> SolveStats:
        """Each member's steps, pressure iterations, failures and last
        residual norm, as (B,) tensors on the device."""
        return SolveStats(steps=self._steps,
                          total_sor_iterations=self._iters,
                          sor_failures=self._failures,
                          last_res_norm=self._last)


def solve_ensemble(params: Params, states: State, *,
                   pressure_method: str = "rb_sor",
                   mesh=None) -> Tuple[State, SolveStats]:
    """Integrate a batch of independent initial states (``stack_states``)
    to t >= T: the JAX package's ``solve_ensemble``, whose ``vmap`` becomes
    a leading batch axis.  Each member keeps its own adaptive dt, step
    count and pressure iterations; a member that has reached T holds its
    state fixed (``torch.where``) while the others step, as JAX's batched
    ``while_loop`` does.  The loop is ``run_steps`` over an
    ``EnsembleStepper``, which reads the members' times once a step for
    the whole batch.  Returns the batched State and SolveStats whose
    fields are per-member tensors.

    The batched step is ``step`` on the member axis: on an f32 CUDA state
    the fused momentum kernel and rb_sor's SOR sweep kernel take every
    member in the same launches (the kernels carry a member axis; the JAX
    package's vmap runs its jnp route instead, ``disable_pallas``), on the
    CPU their plain twins.  rb_sor and jacobi (the refinement outer, or the
    direct solve on an f64 state) and fft solve the whole batch at once;
    mg, cg and the compensated outer solve member by member inside the
    batched step, and obstacle domains step member by member.
    ``pressure_method="pallas_sor"`` is JAX's ValueError.

    `mesh` (``parallel.topology.make_batch_mesh()``, a 1-D mesh over the
    process group) is the data-parallel ensemble: the batch, given on every
    rank, is cut into contiguous slices of equal size, each rank solves its
    own on its device by the batched route above with no communication,
    and the fields and the per-member stats are all-gathered in member
    order, on every rank.  JAX's refusals: a mesh of more than one axis,
    and a batch that is not a multiple of the mesh."""
    _check_ensemble_method(pressure_method)
    if mesh is not None:
        return _solve_ensemble_on_mesh(params, states, pressure_method, mesh)
    stepper = EnsembleStepper(params, states, pressure_method)
    run_steps(stepper, params)
    return stepper.state(), stepper.stats()


def _solve_ensemble_on_mesh(params: Params, states: State,
                            pressure_method: str, mesh):
    """``solve_ensemble``'s data-parallel arm: this rank's slice of the
    members solved unmeshed, then every slice all-gathered."""
    import torch.distributed as dist

    if len(mesh.axes) != 1:
        raise ValueError(
            f"ensemble mesh must be 1D (batch axis); got {mesh.axes}")
    n_members, size = states.u.shape[0], mesh.shape[0]
    if n_members % size != 0:
        raise ValueError(
            f"batch size {n_members} must be a multiple of the "
            f"{size}-device ensemble mesh")
    lo = mesh.coords[0] * (n_members // size)
    hi = lo + n_members // size
    n = torch.as_tensor(states.n)
    mine = State(*(x[lo:hi].to(mesh.device) for x in states[:4]),
                 n=n[lo:hi].to(mesh.device))
    out, stats = solve_ensemble(params, mine, pressure_method=pressure_method)

    def gathered(x):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    return State(*(gathered(x) for x in out)), SolveStats(
        *(gathered(x) for x in stats))


def center_values(state: State, params: Params) -> Tuple[float, float]:
    """The reference's reduced observable: cavity-center velocities
    (main.c:148-149 prints u[i_max/2][j_max/2], v[i_max/2][j_max/2])."""
    i_c, j_c = params.i_max // 2, params.j_max // 2
    return float(state.u[i_c, j_c]), float(state.v[i_c, j_c])
