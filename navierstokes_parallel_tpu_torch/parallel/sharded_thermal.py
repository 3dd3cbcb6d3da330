"""Natural convection (problem 5) on the sharded backend.

Counterpart of ``navierstokes_parallel_tpu/parallel/sharded_thermal.py``:
the sharded isothermal step (parallel/sharded.py) plus the three thermal
pieces of ``models/convection.py::thermal_step``, each on the rank's padded
blocks:

  * the temperature BCs as global-index-masked roll updates
    (``_apply_t_bcs_sharded``): the Dirichlet reflection on the heated pair
    of walls and the adiabatic copy on the other, wherever the true ghost
    line falls under pad-to-divisible sharding; T is exchanged beside u and
    v before the energy step and again after it;
  * the energy step, ``ops/energy.py::advance_temperature`` unchanged on
    the block (its stencils are local once the halos are fresh), written
    only on the true global interior;
  * the Boussinesq buoyancy on F's and G's live entries (global-index
    masks), after which F's west and G's south halo strips are refilled, so
    the divergence across a seam reads the neighbour's buoyant values.

dt is the sharded step's (the all-reduced maxima seeded with 0, or with
the global corner on the mesh gradient's and the gspmd backend's steps)
with the energy equation's explicit-diffusion bound.  The pressure solve is the
isothermal one (``sharded._sharded_pressure_solve``): the deep-halo inner
under rb_sor / pallas_sor (kernel B6 on the card), the sharded V-cycle
under mg (B6 as its smoother, the coarse cycle for the replicated tail),
the pencil DCT, cg, and the exchange-per-half-sweep routes.  F and G are
the plain ones, as in the JAX package.  The step is differentiable as the
isothermal one (parallel/autograd.py): cfg's numeric fields may be 0-d
tensors that carry a gradient (diff.solve_thermal_n_steps(mesh=...)).

The JAX package runs ``while t < T`` inside ``shard_map``; here it is the
host loop of ``solver.run_steps`` over ``ThermalShardedStepper``.  The JAX
package's AOT compile (``compile_sharded_thermal_solve``) is the stepper's
warm-up here.  Obstacle domains are refused, as in the JAX package, and
Adams-Bashforth 2 runs on one device only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import Params
from ..models.convection import ThermalState, allocate_thermal
from ..ops import energy
from ..ops import stencils as st
from ..solver import SolveStats, StepDiagnostics, run_steps
from . import halo
from .sharded import (_all_reduce, _apply_bcs_sharded, _check_method,
                      _keep_corners, _local_fg, _local_rhs, _pressure_solve,
                      _project, _sharded_dt_gamma, _valid_mask_or_none,
                      gather_field, scatter_field)
from .topology import Mesh, make_grid_mesh


def _check_thermal(params: Params, cfg, mesh: Mesh, pressure_method: str):
    """The thermal contract on top of ``sharded._check_method``; returns
    (px, py, li, lj)."""
    check_thermal_config(params, cfg)
    return _check_method(params, mesh, pressure_method)


def check_thermal_config(params: Params, cfg, obstacles: bool = False):
    """The configurations the blocks' thermal step runs (the sharded and
    the gspmd backend's): a known heating pattern and sidewall condition,
    and no obstacle domain unless `obstacles` (the gspmd backend steps
    those as one device does)."""
    if params.obstacles and not obstacles:
        raise ValueError(
            "sharded thermal runs do not compose with obstacle domains "
            "yet — run them on a single device")
    if cfg.heating not in ("side", "below"):
        raise ValueError(f"unknown heating mode {cfg.heating!r}")
    if cfg.sidewalls == "freeslip":
        if not (isinstance(cfg.lid_u, (int, float)) and cfg.lid_u == 0.0):
            raise ValueError("lid_u requires sidewalls='noslip'")
    elif cfg.sidewalls != "noslip":
        raise ValueError(f"unknown sidewall mode {cfg.sidewalls!r}")


def _apply_thermal_vel_bcs_sharded(u, v, params: Params, cfg, mesh: Mesh):
    """The velocity BCs of ``convection._apply_vel_bcs`` on padded blocks:
    no-slip plates, sidewalls per cfg.sidewalls (free-slip ones are the
    Rayleigh-Benard roll symmetry planes), in the sharded cavity's masked
    roll form and side order.  Returns new blocks."""
    if cfg.sidewalls != "freeslip":
        lid = torch.as_tensor(cfg.lid_u, dtype=u.dtype, device=u.device)
        return _apply_bcs_sharded(u, v, lid, params, mesh)
    I, J = params.i_max, params.j_max
    u = halo.exchange_halo(u, mesh)
    v = halo.exchange_halo(v, mesh)
    gi, gj = halo.padded_global_indices(u.shape, mesh)
    in_j = (gj >= 1) & (gj <= J)
    in_i = (gi >= 1) & (gi <= I)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    # LEFT / RIGHT free-slip: zero normal edge, zero-gradient tangential.
    u = torch.where((gi == 0) & in_j, zero, u)
    v = torch.where((gi == 0) & in_j, torch.roll(v, -1, 0), v)
    u = torch.where((gi == I) & in_j, zero, u)
    v = torch.where((gi == I + 1) & in_j, torch.roll(v, 1, 0), v)
    # BOTTOM / TOP rigid no-slip plates (no lid).
    v = torch.where(in_i & (gj == 0), zero, v)
    u = torch.where(in_i & (gj == 0), -torch.roll(u, -1, 1), u)
    v = torch.where(in_i & (gj == J), zero, v)
    u = torch.where(in_i & (gj == J + 1), -torch.roll(u, 1, 1), u)
    return u, v


def _apply_t_bcs_sharded(T, params: Params, cfg, mesh: Mesh):
    """The T BCs of ``convection._apply_t_bcs`` on a padded block: the
    halos exchanged, then the Dirichlet ghost reflection on the heated
    wall pair and the adiabatic copy on the other as masked roll updates,
    valid at halo positions too.  The four global ghost corners keep
    their value (no single-device BC writes them, and an exchange zeroes
    them on a corner shard's ring).  Returns a new block."""
    I, J = params.i_max, params.j_max
    T_pre = T
    T = halo.exchange_halo(T, mesh)
    gi, gj = halo.padded_global_indices(T.shape, mesh)
    in_j = (gj >= 1) & (gj <= J)
    in_i = (gi >= 1) & (gi <= I)
    hot = torch.as_tensor(cfg.t_left, dtype=T.dtype, device=T.device)
    cold = torch.as_tensor(cfg.t_right, dtype=T.dtype, device=T.device)
    corner = ((gi == 0) | (gi == I + 1)) & ((gj == 0) | (gj == J + 1))
    if cfg.heating == "below":
        # Conducting bottom / top plates, adiabatic sidewalls.
        T = torch.where(in_i & (gj == 0), 2.0 * hot - torch.roll(T, -1, 1), T)
        T = torch.where(in_i & (gj == J + 1),
                        2.0 * cold - torch.roll(T, 1, 1), T)
        T = torch.where((gi == 0) & in_j, torch.roll(T, -1, 0), T)
        T = torch.where((gi == I + 1) & in_j, torch.roll(T, 1, 0), T)
    else:
        # Hot left / cold right walls, adiabatic top and bottom.
        T = torch.where((gi == 0) & in_j, 2.0 * hot - torch.roll(T, -1, 0), T)
        T = torch.where((gi == I + 1) & in_j,
                        2.0 * cold - torch.roll(T, 1, 0), T)
        T = torch.where(in_i & (gj == 0), torch.roll(T, -1, 1), T)
        T = torch.where(in_i & (gj == J + 1), torch.roll(T, 1, 1), T)
    return torch.where(corner, T_pre, T)


def _buoyant_fg_sharded(F, G, T, u, v, dt, params: Params, cfg, gi, gj,
                        mesh: Mesh):
    """The Boussinesq buoyancy of ``energy.buoyant_fg`` on local blocks, on
    F's live entries (global i <= i_max - 1) and G's (j <= j_max - 1);
    then F's west and G's south halo strips are refilled as
    ``sharded._local_fg`` fills them (its fill ran before the buoyancy).
    A statically zero coefficient adds nothing.  In place; returns
    (F, G)."""
    if energy._static_zero(cfg.beta_gx) and energy._static_zero(cfg.beta_gy):
        return F, G
    I, J = params.i_max, params.j_max
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    # The T halos are fresh (the caller applies the sharded T BCs), so the
    # east / north face averages are exact on the block.
    if not energy._static_zero(cfg.beta_gx):
        face_x = st.div(T[1:-1, 1:-1] + T[2:, 1:-1], 2.0)
        F[1:-1, 1:-1] += torch.where((gi <= I - 1) & (gj <= J),
                                     -dt * cfg.beta_gx * face_x, zero)
    if not energy._static_zero(cfg.beta_gy):
        face_y = st.div(T[1:-1, 1:-1] + T[1:-1, 2:], 2.0)
        G[1:-1, 1:-1] += torch.where((gj <= J - 1) & (gi <= I),
                                     -dt * cfg.beta_gy * face_y, zero)
    F[0, :] = halo._shift_up(F[-2, :], mesh, "x")
    G[:, 0] = halo._shift_up(G[:, -2], mesh, "y")
    edges = halo.edge_masks(mesh)
    if edges["left"]:
        F[0, :] = u[0, :]
    if edges["bottom"]:
        G[:, 0] = v[:, 0]
    return F, G


def _sharded_thermal_step(u, v, p, T, params: Params, cfg,
                          pressure_method: str, mesh: Mesh,
                          corner: bool = False, solve=None):
    """One Boussinesq step on local padded blocks (``thermal_step``'s
    order: T advances with the old velocities, the momentum takes the new
    T); returns (u, v, p, T, dt, SORResult) with new blocks.  `corner` and
    `solve` as in ``sharded._sharded_step`` (one device's CFL rule with
    the ghost corners carried; another pressure solve)."""
    li, lj = u.shape[0] - 2, u.shape[1] - 2
    valid, gi, gj = _valid_mask_or_none(params, li, lj, mesh)
    dt, gamma = _sharded_dt_gamma(
        u, v, params, valid, mesh,
        limit=energy.thermal_dt_limit(params, cfg.alpha), corner=corner)
    start = (u, v, p)

    u, v = _apply_thermal_vel_bcs_sharded(u, v, params, cfg, mesh)
    T = _apply_t_bcs_sharded(T, params, cfg, mesh)
    T_new = energy.advance_temperature(T, u, v, dt, gamma, params, cfg.alpha)
    if valid is not None:
        # A pad shard's locally interior cells (the far ghost corner, pad
        # cells) are no interior cells of the global grid.
        T_new[1:-1, 1:-1] = torch.where(valid, T_new[1:-1, 1:-1],
                                        T[1:-1, 1:-1])
    T_new = _apply_t_bcs_sharded(T_new, params, cfg, mesh)

    F, G = _local_fg(u, v, dt, gamma, params, gi, gj, mesh)
    F, G = _buoyant_fg_sharded(F, G, T_new, u, v, dt, params, cfg, gi, gj,
                               mesh)
    rhs = _local_rhs(F, G, dt, params, valid)
    result = (solve or _pressure_solve)(p, rhs, params, pressure_method, li,
                                        lj, valid, mesh)
    # The projection writes in place; F and G's stencils saved u and v.
    u, v = u.clone(), v.clone()
    _project(u, v, F, G, result.p, dt, params, gi, gj)
    p = result.p
    if corner:
        u, v, p = (_keep_corners(x, x0, params, mesh)
                   for x, x0 in zip((u, v, p), start))
    return u, v, p, T_new, dt, result


def scatter_thermal(params: Params, ts, mesh: Mesh) -> ThermalState:
    """This rank's padded blocks of a reference-layout ``ThermalState`` (the
    port's or the JAX package's) on the mesh's device."""
    dtype = params.torch_dtype
    return ThermalState(
        u=scatter_field(params, ts.u, mesh),
        v=scatter_field(params, ts.v, mesh),
        p=scatter_field(params, ts.p, mesh),
        T=scatter_field(params, ts.T, mesh),
        t=torch.tensor(float(ts.t), dtype=dtype, device=mesh.device),
        n=int(ts.n))


def gather_thermal(params: Params, local: ThermalState,
                   mesh: Mesh) -> ThermalState:
    """The reference-layout ``ThermalState`` of every rank's blocks, on
    every rank (collective)."""
    return ThermalState(u=gather_field(params, local.u, mesh),
                        v=gather_field(params, local.v, mesh),
                        p=gather_field(params, local.p, mesh),
                        T=gather_field(params, local.T, mesh),
                        t=local.t, n=local.n)


class ThermalShardedStepper:
    """Host-loop adapter for problem 5 on the sharded backend (the JAX
    package's ``ThermalShardedStepper``): holds this rank's padded blocks of
    a reference-layout ``ThermalState`` and advances them one step per
    ``step()``.  ``state()`` gathers the state on every rank; it is
    collective, so every rank calls it at the same steps."""

    def __init__(self, params: Params, cfg, state: ThermalState,
                 mesh: Optional[Mesh] = None,
                 pressure_method: str = "rb_sor"):
        if mesh is None:
            mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max)
        _check_thermal(params, cfg, mesh, pressure_method)
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.pressure_method = pressure_method
        self._local = scatter_thermal(params, state, mesh)

    def warm(self) -> None:
        """Build the kernels and take first-use costs (``warm_up``)."""
        warm_up(self.params, self.cfg, self.mesh, self.pressure_method)

    @property
    def t(self) -> float:
        return float(self._local.t)

    @property
    def n(self) -> int:
        return self._local.n

    def step(self) -> StepDiagnostics:
        loc = self._local
        u, v, p, T, dt, result = _sharded_thermal_step(
            loc.u, loc.v, loc.p, loc.T, self.params, self.cfg,
            self.pressure_method, self.mesh)
        self._local = ThermalState(u=u, v=v, p=p, T=T, t=loc.t + dt,
                                   n=loc.n + 1)
        return StepDiagnostics(dt=dt, sor_iterations=result.iterations,
                               sor_res_norm=result.res_norm,
                               sor_converged=result.converged)

    def state(self) -> ThermalState:
        return gather_thermal(self.params, self._local, self.mesh)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (collective)."""
        x = torch.tensor(int(flag), device=self.mesh.device)
        return bool(_all_reduce(x, dist.ReduceOp.MAX, self.mesh))


def warm_up(params: Params, cfg, mesh: Mesh,
            pressure_method: str = "rb_sor") -> None:
    """One throw-away step with a single sweep from the conduction state,
    so a timed solve excludes the kernel build and first-use costs; an
    unported route raises here."""
    ThermalShardedStepper(params.replace(max_it=1), cfg,
                          allocate_thermal(params, cfg, mesh.device), mesh,
                          pressure_method).step()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def solve_sharded_thermal(params: Params, cfg, state=None,
                          mesh: Optional[Mesh] = None, *,
                          pressure_method: str = "rb_sor",
                          max_steps: int = 0
                          ) -> Tuple[ThermalState, SolveStats]:
    """Sharded counterpart of ``convection.thermal_solve`` over the
    initialised process group: scatter -> step to t >= T (or `max_steps`)
    -> gather, returning a reference-layout ``ThermalState`` on every rank.
    `state` None is the conduction state."""
    if mesh is None:
        mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max)
    if state is None:
        state = allocate_thermal(params, cfg, mesh.device)
    stepper = ThermalShardedStepper(params, cfg, state, mesh,
                                    pressure_method)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.state(), stats
