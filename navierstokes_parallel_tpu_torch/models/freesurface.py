"""Free-surface flows (marker-and-cell): dam break, drops, sloshing.

PyTorch counterpart of ``navierstokes_parallel_tpu/models/freesurface.py``
(problem 6): a liquid with a moving free boundary in a closed box, tracked
by marker particles (particles.py), with the flag-field surface operators
of ops/surface.py.  One time step (Griebel et al. 1998 alg. 8.1):

  1. the adaptive dt over the fluid-adjacent faces only, capped by the
     one-cell free-fall time (computed on the host in float64, applied in
     the state's dtype);
  2. the container-wall BCs (no-slip or free-slip) and the obstacle BCs;
  3. the flag field from the particles, and the surface velocity pass;
  4. the plain F/G with gravity, pinned to u/v on every face that is not
     fluid-fluid, and the rhs;
  5. the pressure solve with the Dirichlet surface condition
     (``p_surface``: "interpolated", the SUMMAC condition, by default;
     "atmospheric" p = 0; "hydrostatic", the explicit column value);
  6. the projection on fluid-fluid faces only, the wall BCs again and the
     surface pass again with gravity on the free faces (``dt=dt``);
  7. the particles advect through the end-of-step field (Heun).

The whole step is plain PyTorch on every device, as it is jnp in the JAX
package: no kernel stands behind it.  ``solve_free`` and ``trace_free``
are host loops over ``FreeStepper`` (one t read per step, one residual
norm per pressure outer pass).  The sharded backend steps problem 6 with
parallel/sharded_free.py, and so does the gspmd backend
(``solve_free(mesh=...)``): the fields and the particles replicated on
every rank, the pressure sweeps partitioned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import particles as P
from ..config import Params
from ..grid import State, allocate_state, resolve_device
from ..ops import boundary, momentum, obstacles
from ..ops import stencils as st
from ..ops import surface as surf
from ..ops.boundary import Side
from ..solver import SolveStats, StepDiagnostics, run_steps


class FreeSurfaceState(NamedTuple):
    state: State
    pset: P.ParticleSet


class FreeView(NamedTuple):
    """A flat view of a ``FreeSurfaceState`` for the CLI's host loop: the
    grid fields under ``State``'s names (frames, monitors, centre values)
    and the particle set, which utils/checkpoint.py saves."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    n: int
    pset: P.ParticleSet


def free_view(fs: FreeSurfaceState) -> FreeView:
    s = fs.state
    return FreeView(u=s.u, v=s.v, p=s.p, t=s.t, n=s.n, pset=fs.pset)


def free_state_from_numpy(u, v, p, t, n, x, y, active, *, device,
                          dtype=torch.float32) -> FreeSurfaceState:
    """A ``FreeSurfaceState`` from host arrays (e.g. a JAX state through
    numpy): the fields in `dtype`, the particles in their own dtype."""
    from ..grid import state_from_numpy

    return FreeSurfaceState(
        state=state_from_numpy(u, v, p, t, n, device=device, dtype=dtype),
        pset=P.particle_set_from_numpy(x, y, active, device=device))


def to_device(fs: FreeSurfaceState, device) -> FreeSurfaceState:
    """`fs` with every tensor on `device` (dtypes kept)."""
    s = fs.state
    return FreeSurfaceState(
        state=State(u=s.u.to(device), v=s.v.to(device), p=s.p.to(device),
                    t=s.t.to(device), n=s.n),
        pset=P.ParticleSet(*(a.to(device) for a in fs.pset)))


def initial_free_state(params: Params, device) -> FreeSurfaceState:
    """The problem-6 initial condition of the parameter file: liquid at
    rest filling [fluid_x0, fluid_x1] x [fluid_y0, fluid_y1] (the optional
    lines 16-19), float64 particles as the JAX CLI's."""
    if params.problem != 6:
        raise ValueError(f"initial_free_state is the problem-6 entry "
                         f"point, got problem {params.problem}")
    pset = fill_region(params, params.fluid_x0, params.fluid_x1,
                       params.fluid_y0, params.fluid_y1, device=device)
    return FreeSurfaceState(state=allocate_state(params, device), pset=pset)


def _box_bcs(u, v, wall: str = "noslip", params: Params = None):
    """The container walls, in place: no-slip (the reference's) or
    free-slip (the usual dam-break setting), LEFT, RIGHT, BOTTOM, TOP; then
    the obstacles' no-slip BCs."""
    if wall not in ("noslip", "freeslip"):
        raise ValueError(f"unknown wall condition {wall!r}")
    set_wall = (boundary.set_noslip if wall == "noslip"
                else boundary.set_freeslip)
    for side in (Side.LEFT, Side.RIGHT, Side.BOTTOM, Side.TOP):
        set_wall(u, v, side)
    if params is not None and params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)
    return u, v


def _check_step(params: Params, p_surface: str) -> None:
    if obstacles.aperture_active(params):
        raise ValueError(
            "free-surface runs use the traced staircase pressure operator "
            "— set obstacle_pressure='staircase' (cut-cell apertures are "
            "static and cannot follow the moving fluid region)")
    if p_surface not in ("interpolated", "atmospheric", "hydrostatic"):
        raise ValueError(f"unknown p_surface {p_surface!r}")


def _free_dt_gamma(u, v, flags: surf.Flags, params: Params):
    """The CFL dt over the fluid-adjacent faces (the empty region's
    continuation values carry no physics), then capped by the one-cell
    free-fall time tau sqrt(2 min(dx, dy) / |g|), a host float64; gamma
    scales with dt."""
    fl = flags.fluid
    u_act = fl.clone()
    u_act[:-1, :] |= fl[1:, :]
    v_act = fl.clone()
    v_act[:, :-1] |= fl[:, 1:]
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    dt, gamma = momentum.adaptive_dt_gamma(torch.where(u_act, u, zero),
                                           torch.where(v_act, v, zero),
                                           params)
    g_mag = max(abs(params.g_x), abs(params.g_y))
    if g_mag > 0.0:
        cap = params.tau * float(
            np.sqrt(2.0 * min(params.dx, params.dy) / g_mag))
        # A tensor over a tensor: PyTorch turns a number over a tensor
        # into a reciprocal times the number.
        scale = torch.clamp(st.scalar(cap, dt.dtype, dt.device) / dt,
                            max=1.0)
        dt = dt * scale
        gamma = gamma * scale
    return dt, gamma


def free_step(fs: FreeSurfaceState, params: Params, *,
              wall: str = "noslip", ppc: Optional[int] = None,
              p_surface: str = "interpolated", pressure_inner_fn=None
              ) -> Tuple[FreeSurfaceState, StepDiagnostics]:
    """One free-surface time step (module docstring).  Does not modify
    `fs`.  `ppc` defaults to params.particles_per_cell (the fill
    fractions' normalisation); `pressure_inner_fn` replaces the pressure
    solve's sweeps (``surface.solve_pressure_free``'s hook)."""
    _check_step(params, p_surface)
    if ppc is None:
        ppc = params.particles_per_cell
    u, v, p, t, n = fs.state
    flags = surf.cell_flags(fs.pset.x, fs.pset.y, fs.pset.active, params,
                            ppc=ppc)
    dt, gamma = _free_dt_gamma(u, v, flags, params)
    u, v = _box_bcs(u.clone(), v.clone(), wall, params)
    u, v = surf.apply_surface_bcs(u, v, flags, params)

    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = surf.pin_fg(F, G, u, v, flags)
    rhs = momentum.compute_rhs(F, G, dt, params)
    p_surf = (surf.surface_pressure(flags, params)
              if p_surface == "hydrostatic" else None)
    result = surf.solve_pressure_free(
        p, rhs, flags, params, p_surf,
        interpolated=p_surface == "interpolated", inner_fn=pressure_inner_fn)
    # The projection on fluid-fluid faces only: free faces keep their BC
    # values (a nonzero p_surf would kick them by dt grad p_s).
    u_p, v_p = momentum.project_velocities(u.clone(), v.clone(), F, G,
                                           result.p, dt, params)
    u_ff, v_ff = surf.fluid_face_masks(flags)
    i_max, j_max = params.i_max, params.j_max
    u[1:i_max, 1:-1] = torch.where(u_ff, u_p[1:i_max, 1:-1],
                                   u[1:i_max, 1:-1])
    v[1:-1, 1:j_max] = torch.where(v_ff, v_p[1:-1, 1:j_max],
                                   v[1:-1, 1:j_max])
    # The second surface pass: the divergence re-zeroed and gravity on the
    # free faces, which the pinned momentum skips (a drop would hang).
    u, v = _box_bcs(u, v, wall, params)
    u, v = surf.apply_surface_bcs(u, v, flags, params, dt=dt)

    pset = P.advect(fs.pset, u, v, dt, params, method="heun")
    new = FreeSurfaceState(state=State(u=u, v=v, p=result.p, t=t + dt,
                                       n=n + 1), pset=pset)
    return new, StepDiagnostics(dt=dt, sor_iterations=result.iterations,
                                sor_res_norm=result.res_norm,
                                sor_converged=result.converged)


class FreeStepper:
    """Host-loop adapter for problem 6 (the JAX CLI's ``_FreeStepper``):
    each ``step()`` is one ``free_step`` of the held state, and ``state()``
    is its ``FreeView``.  `inner_fn` is the pressure sweeps' hook
    (parallel/sharded_free.py); `mesh`, when given, makes ``any_rank`` a
    collective over its ranks (the state is replicated on each)."""

    def __init__(self, params: Params, fs: FreeSurfaceState, *,
                 wall: str = "noslip", ppc: Optional[int] = None,
                 p_surface: str = "interpolated", inner_fn=None, mesh=None):
        _check_step(params, p_surface)
        self.params = params
        self.wall = wall
        self.ppc = ppc
        self.p_surface = p_surface
        self.inner_fn = inner_fn
        self.mesh = mesh
        self._fs = fs

    def warm(self) -> None:
        """One throw-away step with a single sweep, so a timed loop
        excludes PyTorch's first-use costs."""
        free_step(self._fs, self.params.replace(max_it=1), wall=self.wall,
                  ppc=self.ppc, p_surface=self.p_surface,
                  pressure_inner_fn=self.inner_fn)

    @property
    def t(self) -> float:
        return float(self._fs.state.t)

    @property
    def n(self) -> int:
        return self._fs.state.n

    def step(self) -> StepDiagnostics:
        self._fs, diag = free_step(self._fs, self.params, wall=self.wall,
                                   ppc=self.ppc, p_surface=self.p_surface,
                                   pressure_inner_fn=self.inner_fn)
        return diag

    def free_state(self) -> FreeSurfaceState:
        return self._fs

    def state(self) -> FreeView:
        return free_view(self._fs)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (collective with a mesh)."""
        if self.mesh is None:
            return flag
        import torch.distributed as dist

        x = torch.tensor(int(flag), device=self.mesh.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(x)


def solve_free(params: Params, fs: FreeSurfaceState, *,
               wall: str = "noslip", ppc: Optional[int] = None,
               p_surface: str = "interpolated", mesh=None,
               max_steps: int = 0) -> Tuple[FreeSurfaceState, SolveStats]:
    """Integrate to t >= T (or `max_steps` steps when > 0), reading t once
    per step.  With `mesh` (a 2-D ``parallel.topology.Mesh`` over the
    process group; the gspmd backend's refusal of a mesh with a trivial
    axis holds) every rank holds the whole state, fields and particles,
    and steps it as one device does with the pressure sweeps partitioned
    over the mesh (``sharded_free.make_free_stepper``).  The JAX package
    shards the fields here and its partitioner gathers them for the
    particle and flag operations; blocks between steps would save nothing,
    since the step needs the whole fields on every rank."""
    if mesh is not None:
        from ..parallel import gspmd, sharded_free

        gspmd._check_mesh(mesh)
        stepper = sharded_free.make_free_stepper(
            params, to_device(fs, mesh.device), mesh, wall=wall, ppc=ppc,
            p_surface=p_surface)
    else:
        stepper = FreeStepper(params, fs, wall=wall, ppc=ppc,
                              p_surface=p_surface)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.free_state(), stats


def trace_free(params: Params, fs: FreeSurfaceState, *,
               wall: str = "noslip", ppc: Optional[int] = None,
               p_surface: str = "interpolated", record_every: int = 1):
    """``solve_free`` recording the particle history (frame 0 the initial
    set, then one every `record_every` steps) for the JAX package's
    ``plot_particle_paths``; returns (state, stats, frames)."""
    stepper = FreeStepper(params, fs, wall=wall, ppc=ppc,
                          p_surface=p_surface)
    frames = [P._snapshot(fs.pset)]

    def after(diag, steps):
        if steps % record_every == 0:
            frames.append(P._snapshot(stepper.free_state().pset))

    stats = run_steps(stepper, params, after=after)
    return stepper.free_state(), stats, np.stack(frames)


# ---------------------------------------------------------------------------
# Setups.
# ---------------------------------------------------------------------------


def fill_region(params: Params, x0: float, x1: float, y0: float, y1,
                ppc: Optional[int] = None, dtype=torch.float64, *,
                device=None) -> P.ParticleSet:
    """Marker particles on a ppc x ppc lattice per cell inside
    [x0, x1] x [y0, y1] (clipped to the domain; obstacle cells left out);
    `y1` may be a callable y1(x), a sub-cell initial surface.  `ppc`
    defaults to params.particles_per_cell.  float64 positions by default,
    as the JAX package's under x64 (its CLI and tests)."""
    if ppc is None:
        ppc = params.particles_per_cell
    dx, dy = params.dx, params.dy
    sx = dx / ppc
    sy = dy / ppc
    xs = np.arange(sx / 2, params.a, sx)
    ys = np.arange(sy / 2, params.b, sy)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    y_top = y1(xs)[:, None] if callable(y1) else y1
    keep = (gx >= x0) & (gx <= x1) & (gy >= y0) & (gy <= y_top)
    if params.obstacles:
        fl = obstacles.fluid_mask(params)
        ci = np.clip((gx / dx).astype(int) + 1, 1, params.i_max)
        cj = np.clip((gy / dy).astype(int) + 1, 1, params.j_max)
        keep &= fl[ci, cj]
    pts = np.stack([gx[keep], gy[keep]], -1)
    return P.init_particles(pts, dtype=dtype, device=device)


def _setup(params_kw: dict, region, device, dtype: str):
    if device is None:
        raise ValueError("a free-surface setup needs a device")
    device = resolve_device(device)
    params = Params(problem=1, a=params_kw.pop("a", 1.0),
                    b=params_kw.pop("b", 1.0), g_x=0.0, omega=1.7,
                    dtype=dtype, **params_kw)
    pset = fill_region(params, *region(params), device=device)
    return params, FreeSurfaceState(state=allocate_state(params, device),
                                    pset=pset)


def dam_break(n: int = 64, *, width: float = 1.0, height: float = 2.0,
              a: float = 5.0, b: float = 3.0, T: float = 2.0,
              Re: float = 1000.0, g: float = 1.0, ppc: int = 3,
              tau: float = 0.4, epsilon: float = 1e-3, max_it: int = 2000,
              dtype: str = "float64", device=None
              ) -> Tuple[Params, FreeSurfaceState]:
    """Collapse of a liquid column against the left wall (Martin & Moyce
    1952; Griebel sect. 8.4.1); `n` cells per unit length, gravity g in
    -y.  `dtype` float64 is the JAX package's under x64."""
    return _setup(dict(i_max=int(round(n * a)), j_max=int(round(n * b)),
                       a=a, b=b, T=T, Re=Re, g_y=-g, tau=tau,
                       epsilon=epsilon, max_it=max_it,
                       particles_per_cell=ppc),
                  lambda prm: (0.0, width, 0.0, height), device, dtype)


def filled_box(n: int = 48, *, depth: float = 0.5, Re: float = 100.0,
               g: float = 1.0, T: float = 0.2, ppc: int = 3,
               epsilon: float = 1e-6, max_it: int = 5000, tau: float = 0.4,
               dtype: str = "float64", device=None
               ) -> Tuple[Params, FreeSurfaceState]:
    """Liquid at rest filling y < depth of the unit box: the hydrostatic
    equilibrium case."""
    return _setup(dict(i_max=n, j_max=n, T=T, Re=Re, g_y=-g, tau=tau,
                       epsilon=epsilon, max_it=max_it,
                       particles_per_cell=ppc),
                  lambda prm: (0.0, 1.0, 0.0, depth), device, dtype)


def drop(n: int = 48, *, cx: float = 0.5, cy: float = 0.7,
         half: float = 0.15, Re: float = 10000.0, g: float = 1.0,
         T: float = 0.25, ppc: int = 3, epsilon: float = 1e-4,
         max_it: int = 2000, tau: float = 0.4, dtype: str = "float64",
         device=None) -> Tuple[Params, FreeSurfaceState]:
    """A square blob in free fall: its centre of mass must follow
    y(t) = cy - g t^2 / 2."""
    return _setup(dict(i_max=n, j_max=n, T=T, Re=Re, g_y=-g, tau=tau,
                       epsilon=epsilon, max_it=max_it,
                       particles_per_cell=ppc),
                  lambda prm: (cx - half, cx + half, cy - half, cy + half),
                  device, dtype)


def sloshing(n: int = 64, *, depth: float = 0.5, amp: float = 0.04,
             mode: int = 1, Re: float = 5000.0, g: float = 1.0,
             T: float = 8.0, ppc: int = 6, epsilon: float = 1e-5,
             max_it: int = 3000, tau: float = 0.4, dtype: str = "float64",
             device=None) -> Tuple[Params, FreeSurfaceState]:
    """A standing gravity wave in the unit box: mean depth `depth`, surface
    eta(x) = amp cos(mode pi x) seeded column by column; its period obeys
    omega^2 = g k tanh(k h).  Run with wall="freeslip" and the SUMMAC
    condition; ppc 6 resolves the sub-cell fill differences."""
    return _setup(dict(i_max=n, j_max=n, T=T, Re=Re, g_y=-g, tau=tau,
                       epsilon=epsilon, max_it=max_it,
                       particles_per_cell=ppc),
                  lambda prm: (0.0, prm.a, 0.0, lambda x: depth + amp
                               * np.cos(mode * np.pi * x / prm.a)),
                  device, dtype)


# ---------------------------------------------------------------------------
# Observables.
# ---------------------------------------------------------------------------


def fluid_volume(fs: FreeSurfaceState, params: Params) -> float:
    """Fluid area: (number of fluid cells) dx dy."""
    flags = surf.cell_flags(fs.pset.x, fs.pset.y, fs.pset.active, params)
    return float(torch.sum(flags.fluid)) * params.dx * params.dy


def front_position(fs: FreeSurfaceState) -> float:
    """The rightmost active particle's x: the surge front."""
    return float(torch.max(torch.where(fs.pset.active, fs.pset.x,
                                       -float("inf"))))


def column_height(fs: FreeSurfaceState) -> float:
    """The highest active particle's y (the residual column at the left
    wall in the dam break)."""
    return float(torch.max(torch.where(fs.pset.active, fs.pset.y,
                                       -float("inf"))))


def surface_elevation(fs: FreeSurfaceState, params: Params,
                      ppc: Optional[int] = None) -> np.ndarray:
    """Per-column fluid height from the particle mass, count_i dy / ppc^2
    (sub-cell resolution dy / ppc^2)."""
    if ppc is None:
        ppc = params.particles_per_cell
    ci = torch.clamp(torch.floor(st.div(fs.pset.x, params.dx)).to(
        torch.int64), 0, params.i_max - 1)
    counts = torch.zeros(params.i_max, dtype=torch.int32,
                         device=fs.pset.x.device)
    counts.index_add_(0, ci, fs.pset.active.to(torch.int32))
    return counts.cpu().numpy() * params.dy / ppc ** 2


def center_of_mass(fs: FreeSurfaceState) -> Tuple[float, float]:
    act = fs.pset.active
    n = torch.clamp(torch.sum(act), min=1)
    zero = torch.zeros((), dtype=fs.pset.x.dtype, device=act.device)
    cx = torch.sum(torch.where(act, fs.pset.x, zero)) / n
    cy = torch.sum(torch.where(act, fs.pset.y, zero)) / n
    return float(cx), float(cy)
