"""Multi-device sharded solver: one rank per shard, halos and reductions
through ``torch.distributed``.

Counterpart of ``navierstokes_parallel_tpu/parallel/sharded.py`` for the
cavity (problems 1-2), the plane channel (3) and the free-slip box (4),
with the Euler and the Adams-Bashforth 2 step and every pressure method of
the JAX sharded backend.  The staggered grid's interior is block-sharded over a (px, py)
process mesh (parallel/topology.py); every rank advances its (li+2, lj+2)
padded block with the single-device stencils, exchanges one-cell halo
strips with its neighbours (parallel/halo.py) and combines reductions with
``dist.all_reduce`` on 0-d device tensors (the JAX package's ``pmax`` /
``psum``).  The pressure solve is ops/sor.py's with the sharded hooks
(the exchange-and-Neumann ghost fill, the all-reduced L2 norm, the block's
parity and pad mask), as JAX's ``_sharded_pressure_solve`` dispatches it:

  * rb_sor / pallas_sor on an f32 state with the refinement on: the f64
    refinement around the deep-halo inner (parallel/deep_halo.py), whose
    sweeps are kernel B6 on the card;
  * mg: the same outer around the sharded V-cycle (ops/mg.py), whose
    smoother is kernel B6 too (divisible grids);
  * fft: around the pencil-decomposed DCT solve (ops/fft.py; divisible
    grids whose pencils tile);
  * cg: around the sharded conjugate gradient (ops/mg.py);
  * rb_sor_sync, jacobi, an f64 state, the refinement off or blocks
    thinner than 2 cells: ``sor.solve_pressure`` with the hooks, i.e. the
    plain inner or the direct solve with an exchange before every
    half-sweep.

The JAX package runs the whole ``while t < T`` on the device inside
``shard_map``; PyTorch runs eagerly, so the loop is on the host: one
``t < T`` read per step, as ``solver.solve`` does, and one residual read
per outer pass of the pressure solve.  Every rank takes the same steps:
dt comes from the all-reduced maxima.

Pad-to-divisible sharding: any interior size runs.  Each axis is padded to
the next multiple of the mesh extent; every boundary condition, update
mask and reduction is keyed on *global* indices against the true
i_max/j_max, so pad cells stay inert.

``solve_sharded`` takes and returns reference-layout (i_max+2, j_max+2)
states: a JAX ``State`` goes in unchanged (its arrays through numpy), the
blocks are cut with the JAX package's ``_scatter_blocks`` layout and put
back in ``_gather_blocks``' layout after an all-gather, on every rank and
on its device (``gather_field``).

``ShardedStepper`` holds each rank's blocks for the CLI's host loop and
advances them one step per ``step()``; its ``state()`` is ``gather_state``,
a collective that every rank calls at the same steps.

Flag-field obstacle domains (``Params.obstacles``) run as in the JAX
package: the obstacle BCs after the domain BCs and after the projection
(halo seams re-pulled before and after), F and G pinned on the obstacle
faces, the aperture-weighted divergence under the cut-cell closure,
and the refinement around the masked deep-halo inner
(parallel/deep_halo.py) with the masked f64 defect as its ``residual_fn``;
rb_sor and pallas_sor only, on an f32 state with the refinement on.  No
kernel runs there, as no Pallas kernel does in the JAX package.  A
rank's masks, weights and geometry constants are the single-device ones
(ops/obstacles.py, ops/masked.py) cut at the rank's origin, which is a
host integer here (JAX, whose axis index is traced, forms them from
global-index predicates instead); each is built once per configuration
and block.

Natural convection (problem 5) steps with parallel/sharded_thermal.py and
free surfaces (problem 6) with parallel/sharded_free.py, which build on
this module's helpers; ``ShardedStepper`` refuses both, naming its twin.

The step is differentiable: on blocks that require grad its collectives
go through parallel/autograd.py and the pressure solve through the
implicit-function adjoint (``_pressure_adjoint``), so ``diff.py``
integrates on a mesh with the arithmetic of ``ShardedStepper``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Params
from ..diff import _embed
from ..grid import State, host_array
from ..ops import boundary, fft, masked, mg, momentum, obstacles, sor
from ..ops import stencils as st
from ..solver import SolveStats, StepDiagnostics, ab2_extrapolate, run_steps
from . import autograd, deep_halo, halo
from .topology import Mesh, local_block_dims, make_grid_mesh

# The pressure methods of the sharded backend.
METHODS = ("rb_sor", "pallas_sor", "rb_sor_sync", "jacobi", "mg", "cg", "fft")


class AB2Carry(NamedTuple):
    """A rank's Adams-Bashforth 2 carry: the previous step's tendency
    blocks and dt (0 marks the bootstrap)."""

    ru: torch.Tensor
    rv: torch.Tensor
    dt_prev: torch.Tensor


def _all_reduce(x: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """`x` reduced over the mesh's ranks (in place; returned).  A sum that
    requires grad is a new tensor with the all-reduce's transpose
    (parallel/autograd.py); the maxima of the CFL rule have their own
    (``_global_maxima``)."""
    if autograd.tracked(x):
        if op != dist.ReduceOp.SUM:
            raise ValueError("only the all-reduce SUM is differentiable here")
        return autograd.all_reduce_sum(x, mesh)
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _global_indices(shape, li: int, lj: int, mesh: Mesh):
    """(gi, gj): global 1-based interior indices of the local interior
    cells, broadcastable (li, 1) and (1, lj) int tensors."""
    ox, oy = mesh.origin(li, lj)
    gi = torch.arange(shape[0], device=mesh.device).view(-1, 1) + ox + 1
    gj = torch.arange(shape[1], device=mesh.device).view(1, -1) + oy + 1
    return gi, gj


def _valid_mask_or_none(params: Params, li: int, lj: int, mesh: Mesh):
    """(mask of the true, non-pad interior cells or None if there is no
    pad, gi, gj)."""
    gi, gj = _global_indices((li, lj), li, lj, mesh)
    px, py = mesh.shape
    if li * px == params.i_max and lj * py == params.j_max:
        return None, gi, gj
    return (gi <= params.i_max) & (gj <= params.j_max), gi, gj


def _apply_bcs_sharded(u, v, lid_u, params: Params, mesh: Mesh):
    """Serial-semantics cavity velocity BCs (boundaries.c:7-39) on padded
    local blocks, as global-index-masked roll updates, so they land wherever
    the true wall or ghost line falls (block edge, or block interior under
    padding).  Side order LEFT, RIGHT, BOTTOM, TOP (main.c:95-104) matters:
    BOTTOM/TOP read u values that RIGHT writes.  The masked writes land on
    halo positions too, which keeps every halo copy of a BC-written cell
    equal to its owner's without a second exchange.  Returns new blocks."""
    I, J = params.i_max, params.j_max
    u = halo.exchange_halo(u, mesh)
    v = halo.exchange_halo(v, mesh)
    gi, gj = halo.padded_global_indices(u.shape, mesh)
    in_j = (gj >= 1) & (gj <= J)
    in_i = (gi >= 1) & (gi <= I)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    # LEFT: u wall edge on gi == 0; v tangential ghost reflection.
    u = torch.where((gi == 0) & in_j, zero, u)
    v = torch.where((gi == 0) & in_j, -torch.roll(v, -1, 0), v)
    # RIGHT: u wall edge on gi == i_max; v ghost at gi == i_max + 1.
    u = torch.where((gi == I) & in_j, zero, u)
    v = torch.where((gi == I + 1) & in_j, -torch.roll(v, 1, 0), v)
    # BOTTOM: v wall edge on gj == 0; u tangential reflection.
    v = torch.where(in_i & (gj == 0), zero, v)
    u = torch.where(in_i & (gj == 0), -torch.roll(u, -1, 1), u)
    # TOP: v wall edge on gj == j_max; u reflected against the moving lid.
    v = torch.where(in_i & (gj == J), zero, v)
    u = torch.where(in_i & (gj == J + 1), 2.0 * lid_u - torch.roll(u, 1, 1),
                    u)
    return u, v


def _apply_freeslip_bcs_sharded(u, v, params: Params, mesh: Mesh):
    """Free-slip box BCs (problem 4, ops/boundary.py::apply_freeslip_box)
    on padded local blocks: the cavity's construction with the tangential
    ghost copied instead of negated, and no lid.  Returns new blocks."""
    I, J = params.i_max, params.j_max
    u = halo.exchange_halo(u, mesh)
    v = halo.exchange_halo(v, mesh)
    gi, gj = halo.padded_global_indices(u.shape, mesh)
    in_j = (gj >= 1) & (gj <= J)
    in_i = (gi >= 1) & (gi <= I)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    # LEFT / RIGHT: zero normal edge, zero-gradient tangential ghost.
    u = torch.where((gi == 0) & in_j, zero, u)
    v = torch.where((gi == 0) & in_j, torch.roll(v, -1, 0), v)
    u = torch.where((gi == I) & in_j, zero, u)
    v = torch.where((gi == I + 1) & in_j, torch.roll(v, 1, 0), v)
    # BOTTOM / TOP.
    v = torch.where(in_i & (gj == 0), zero, v)
    u = torch.where(in_i & (gj == 0), torch.roll(u, -1, 1), u)
    v = torch.where(in_i & (gj == J), zero, v)
    u = torch.where(in_i & (gj == J + 1), torch.roll(u, 1, 1), u)
    return u, v


def _apply_channel_bcs_sharded(u, v, params: Params, mesh: Mesh):
    """Plane-channel BCs (problem 3, ops/boundary.py::apply_channel_bcs) on
    padded local blocks: parabolic inflow on the left, zero-gradient
    outflow on the right with the global flux balance, no-slip walls, in
    the cavity's global-index-masked construction.  q_in and q_out are
    all-reduced sums over OWNED positions only: a halo copy carries its
    owner's global index, so a plain index mask would count every cell
    that lies in a neighbour's halo twice.  With obstacles the inflow is
    the per-span profile table (ops/obstacles.py::inflow_profile) gathered
    by global row, and the balance runs over the fluid rows of the outflow
    column only.  Returns new blocks."""
    I, J = params.i_max, params.j_max
    u = halo.exchange_halo(u, mesh)
    v = halo.exchange_halo(v, mesh)
    gi, gj = halo.padded_global_indices(u.shape, mesh)
    in_j = (gj >= 1) & (gj <= J)
    in_i = (gi >= 1) & (gi <= I)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)

    # LEFT inflow at y_j = (gj - 1/2) dy, formed in the state's dtype as
    # the JAX sharded backend forms it; v's ghost reflected to 0.
    if params.obstacles:
        profile = _inflow_table(params, u.dtype, u.device)[gj.clamp(0, J + 1)]
    else:
        y = (gj.to(u.dtype) - 0.5) * st.scalar(params.dy, u.dtype, u.device)
        profile = st.div(4.0 * y * (params.b - y), params.b * params.b)
    u = torch.where((gi == 0) & in_j, profile, u)
    v = torch.where((gi == 0) & in_j, -torch.roll(v, -1, 0), v)
    # RIGHT outflow: the u edge copies its upstream neighbour, the v ghost
    # is zero-gradient (the previous local row always holds gi - 1).
    u = torch.where((gi == I) & in_j, torch.roll(u, 1, 0), u)
    v = torch.where((gi == I + 1) & in_j, torch.roll(v, 1, 0), v)
    # Global flux balance over owned positions.  gi == 0 lies only on
    # x-shard 0's ring (never replicated); gi == I may lie in the next
    # x-shard's halo under padding.
    ni, nj = u.shape
    pos_i = torch.arange(ni, device=u.device).view(-1, 1)
    pos_j = torch.arange(nj, device=u.device).view(1, -1)
    own_j = (pos_j >= 1) & (pos_j <= nj - 2)
    own_i = (pos_i >= 1) & (pos_i <= ni - 2)
    out_edge = (gi == I) & in_j
    n_out = J
    if params.obstacles:
        # Solid faces of the outflow column stay no-slip: no correction.
        out_edge = out_edge & _obstacle_block(params, mesh, ni - 2,
                                              nj - 2).fluid
        n_out = max(1, int(obstacles.masks(params).fluid[-2, 1:-1].sum()))
    q_in = _all_reduce(torch.sum(torch.where((gi == 0) & in_j & own_j, u,
                                             zero)), dist.ReduceOp.SUM, mesh)
    q_out = _all_reduce(torch.sum(torch.where(out_edge & own_i & own_j, u,
                                              zero)), dist.ReduceOp.SUM, mesh)
    u = torch.where(out_edge, u + st.div(q_in - q_out, n_out), u)
    # BOTTOM / TOP no-slip walls.
    v = torch.where(in_i & (gj == 0), zero, v)
    u = torch.where(in_i & (gj == 0), -torch.roll(u, -1, 1), u)
    v = torch.where(in_i & (gj == J), zero, v)
    u = torch.where(in_i & (gj == J + 1), -torch.roll(u, 1, 1), u)
    return u, v


@functools.lru_cache(maxsize=8)
def _inflow_table(params: Params, dtype: torch.dtype, device: torch.device):
    """The obstacle-aware inflow profile by global padded row (0 on the
    ghost rows), in `dtype` on `device`."""
    tab = np.zeros(params.j_max + 2)
    tab[1:-1] = obstacles.inflow_profile(params)
    return torch.from_numpy(tab).to(dtype=dtype, device=device)


class _ObstacleBlock(NamedTuple):
    """A rank's obstacle geometry: ops/obstacles.py::masks cut to its padded
    block, and the ring cells that have an owner."""

    u_solid: torch.Tensor
    u_refl_n: torch.Tensor
    u_refl_s: torch.Tensor
    v_solid: torch.Tensor
    v_refl_e: torch.Tensor
    v_refl_w: torch.Tensor
    fluid: torch.Tensor       # (li + 2, lj + 2)
    has_owner: torch.Tensor   # (li + 2, lj + 2)


@functools.lru_cache(maxsize=32)
def _block_geometry(params: Params, mesh_shape, coords, li: int, lj: int,
                    device: torch.device) -> _ObstacleBlock:
    px, py = mesh_shape
    ox, oy = coords[0] * li, coords[1] * lj
    m = obstacles.masks(params)

    def cut(arr_np):
        return torch.from_numpy(np.ascontiguousarray(_global_block_slice(
            arr_np, mesh_shape, coords, li, lj))).to(device)

    gi = torch.arange(li + 2, device=device).view(-1, 1) + ox
    gj = torch.arange(lj + 2, device=device).view(1, -1) + oy
    has_owner = ((gi >= 1) & (gi <= px * li) & (gj >= 1) & (gj <= py * lj))
    return _ObstacleBlock(
        u_solid=cut(m.u_solid), u_refl_n=cut(m.u_refl_n),
        u_refl_s=cut(m.u_refl_s), v_solid=cut(m.v_solid),
        v_refl_e=cut(m.v_refl_e), v_refl_w=cut(m.v_refl_w),
        fluid=cut(m.fluid), has_owner=has_owner)


def _obstacle_block(params: Params, mesh: Mesh, li: int,
                    lj: int) -> _ObstacleBlock:
    """This rank's ``_ObstacleBlock``, built once per configuration."""
    return _block_geometry(params, mesh.shape, mesh.coords, li, lj,
                           mesh.device)


def _global_block_slice(arr_np: np.ndarray, mesh_shape, coords, li: int,
                        lj: int) -> np.ndarray:
    """This rank's padded (li+2, lj+2) block of a global padded-layout
    (i_max+2, j_max+2) numpy constant, zero on the high side beyond it (the
    divisibility pad): global index g lands at block position g - origin,
    so the slice starts at the rank's origin."""
    px, py = mesh_shape
    full = np.zeros((px * li + 2, py * lj + 2), arr_np.dtype)
    full[:arr_np.shape[0], :arr_np.shape[1]] = arr_np
    ox, oy = coords[0] * li, coords[1] * lj
    return full[ox:ox + li + 2, oy:oy + lj + 2]


@functools.lru_cache(maxsize=32)
def _constant_blocks(params: Params, which: str, mesh_shape, coords,
                     li: int, lj: int, dtype: torch.dtype,
                     device: torch.device):
    """The rank's blocks of the geometry's static values, rounded to
    `dtype` once: the immersed-boundary weights ("ib",
    ops/obstacles.py::ib_weights, in IBWeights' order) or the cut-cell
    face fractions ("apertures": au, av)."""
    arrays = (obstacles.ib_weights(params) if which == "ib"
              else obstacles.apertures(params)[:2])
    return tuple(torch.from_numpy(np.ascontiguousarray(_global_block_slice(
        a, mesh_shape, coords, li, lj))).to(dtype=dtype, device=device)
        for a in arrays)


def _blocks_of(params: Params, which: str, mesh: Mesh, shape, dtype):
    return _constant_blocks(params, which, mesh.shape, mesh.coords,
                            shape[0] - 2, shape[1] - 2, dtype, mesh.device)


def _exchange_seams_only(arr: torch.Tensor, mesh: Mesh,
                         has_owner: torch.Tensor) -> torch.Tensor:
    """Re-pull the halo ring from its owners where an owner exists; ring
    cells on the physical boundary keep the BC values just written (a plain
    exchange would zero them: a mesh-edge shard receives zeros)."""
    return torch.where(has_owner, halo.exchange_halo(arr, mesh), arr)


def _apply_obstacle_bcs_sharded(u, v, params: Params, mesh: Mesh):
    """The obstacle BCs of ops/obstacles.py::apply_obstacle_bcs on padded
    local blocks (ops/obstacles.py::masks cut to each): the mirror values,
    or with ``params.obstacle_surfaces`` the ghost-fluid sum of products
    over the rank's blocks of the weights.  A reflection whose edge lies on
    the last interior row or column of a block reads its fluid neighbour
    from the halo ring, which the projection leaves stale: the seams are
    re-pulled from their owners first, and again afterwards so that every
    ring copy of a written edge equals its owner's.  Returns new blocks."""
    li, lj = u.shape[0] - 2, u.shape[1] - 2
    geo = _obstacle_block(params, mesh, li, lj)
    u = _exchange_seams_only(u, mesh, geo.has_owner)
    v = _exchange_seams_only(v, mesh, geo.has_owner)
    if params.obstacle_surfaces:
        # The weights are zero off their (disjoint) edge categories, so
        # only the u_solid / v_solid gate is needed.
        w = obstacles.IBWeights(*_blocks_of(params, "ib", mesh, u.shape,
                                            u.dtype))
        u_bc = (w.u_wn * torch.roll(u, -1, 1) + w.u_ws * torch.roll(u, 1, 1)
                + w.u_we * torch.roll(u, -1, 0)
                + w.u_ww * torch.roll(u, 1, 0))
        v_bc = (w.v_we * torch.roll(v, -1, 0) + w.v_ww * torch.roll(v, 1, 0)
                + w.v_wn * torch.roll(v, -1, 1)
                + w.v_ws * torch.roll(v, 1, 1))
    else:
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        u_bc = torch.where(geo.u_refl_n, -torch.roll(u, -1, 1),
                           torch.where(geo.u_refl_s, -torch.roll(u, 1, 1),
                                       zero))
        v_bc = torch.where(geo.v_refl_e, -torch.roll(v, -1, 0),
                           torch.where(geo.v_refl_w, -torch.roll(v, 1, 0),
                                       zero))
    u = torch.where(geo.u_solid, u_bc, u)
    v = torch.where(geo.v_solid, v_bc, v)
    return (_exchange_seams_only(u, mesh, geo.has_owner),
            _exchange_seams_only(v, mesh, geo.has_owner))


def _local_fg(u, v, dt, gamma, params: Params, gi, gj, mesh: Mesh,
              g_x=None, g_y=None):
    """Tentative velocities on a local block (integration.c:73-96), masked
    by the global F/G domains, with F = u / G = v on the walls.  `g_x` /
    `g_y` override the configuration's body force (diff.Controls)."""
    dx, dy, Re = params.dx, params.dy, params.Re
    g_x = params.g_x if g_x is None else g_x
    g_y = params.g_y if g_y is None else g_y
    u_int = st.shifted(u, 0, 0)
    v_int = st.shifted(v, 0, 0)

    diff_u = st.div(st.d2_dx2(u, dx) + st.d2_dy2(u, dy), Re)
    conv_u = st.du2_dx(u, v, dx, gamma) + st.duv_dy(u, v, dy, gamma)
    f_all = u_int + dt * (diff_u - conv_u + g_x)

    diff_v = st.div(st.d2_dx2(v, dx) + st.d2_dy2(v, dy), Re)
    conv_v = st.duv_dx(u, v, dx, gamma) + st.dv2_dy(u, v, dy, gamma)
    g_all = v_int + dt * (diff_v - conv_v + g_y)

    F = torch.zeros_like(u)
    G = torch.zeros_like(v)
    F[1:-1, 1:-1] = torch.where(gi <= params.i_max - 1, f_all, u_int)
    G[1:-1, 1:-1] = torch.where(gj <= params.j_max - 1, g_all, v_int)

    # The divergence reads F's west and G's south halo: the neighbour's F/G
    # inside the mesh, u/v on the left and bottom walls (padding is on the
    # high side only, so the physical west/south boundary always sits on a
    # mesh-edge shard's halo ring).
    F[0, :] = halo._shift_up(F[-2, :], mesh, "x")
    G[:, 0] = halo._shift_up(G[:, -2], mesh, "y")
    edges = halo.edge_masks(mesh)
    if edges["left"]:
        F[0, :] = u[0, :]
    if edges["bottom"]:
        G[:, 0] = v[:, 0]
    return F, G


def _global_maxima(u, v, valid, mesh: Mesh, corner: bool = False):
    """(u_max, v_max): the signed maxima of the global fields over the true
    interior cells (pad cells left out), both in one all-reduce; under
    autograd with the tie rule of ``torch.max`` (parallel/autograd.py).
    The seed is 0, as the JAX package's sharded steppers seed their pmax
    (``jnp.maximum(0.0, lax.pmax(...))``), or with `corner` the global
    corner x[0, 0] (rank (0, 0)'s), the one-device rule of
    ``st.max_interior`` that the mesh gradient and the gspmd backend
    follow: their steps carry the corners (``_keep_corners``)."""
    if autograd.tracked(u, v):
        m_u, c_u, m_v, c_v = autograd.global_maxima((u, v), valid, mesh)
    else:
        m_u, c_u, m_v, c_v = autograd.maxima((u, v), valid, mesh).unbind()
    if not corner:
        c_u = c_v = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.maximum(c_u, m_u), torch.maximum(c_v, m_v)


def _keep_corners(new, old, params: Params, mesh: Mesh):
    """`new` with the four global ghost corners of `old` (at every block
    position that holds one, halo copies included): one device never
    writes them, where a sharded exchange zeroes them on a corner shard's
    ring."""
    gi, gj = halo.padded_global_indices(new.shape, mesh)
    corner = (((gi == 0) | (gi == params.i_max + 1))
              & ((gj == 0) | (gj == params.j_max + 1)))
    return torch.where(corner, old, new)


def _sharded_dt_gamma(u, v, params: Params, valid, mesh: Mesh, limit=None,
                      corner: bool = False):
    """The adaptive dt and the donor-cell weight from the global maxima of
    the local blocks (``_global_maxima``, seeded with 0 or with the
    `corner`) by the AD-safe CFL rule of the differentiable step
    (``momentum.cfl_dt_gamma``).  `limit` joins the viscous bound in the
    min: the energy equation's explicit-diffusion bound of problem 5 (a
    host float, or a 0-d tensor when alpha carries a gradient)."""
    u_max, v_max = _global_maxima(u, v, valid, mesh, corner)
    dx, dy = params.dx, params.dy
    visc = params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    # Device tensors, not Python scalars: CUDA divides by a host scalar as
    # a multiply by its reciprocal, which rounds differently.
    if isinstance(limit, torch.Tensor):
        bound = torch.minimum(st.scalar(visc, u.dtype, u.device), limit)
    else:
        bound = st.scalar(visc if limit is None else min(visc, limit),
                          u.dtype, u.device)
    return momentum.cfl_dt_gamma(u_max, v_max, params, bound)


def _local_rhs(F, G, dt, params: Params, valid, fluid=None):
    """The padded block's Poisson rhs div(F, G)/dt, zero on pad cells (and
    off `fluid` when given)."""
    dx_t = st.scalar(params.dx, F.dtype, F.device)
    dy_t = st.scalar(params.dy, F.dtype, F.device)
    rhs_int = ((F[1:-1, 1:-1] - F[:-2, 1:-1]) / dx_t
               + (G[1:-1, 1:-1] - G[1:-1, :-2]) / dy_t) / dt
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    for mask in (valid, fluid):
        if mask is not None:
            rhs_int = torch.where(mask, rhs_int, zero)
    rhs = torch.zeros_like(F)
    rhs[1:-1, 1:-1] = rhs_int
    return rhs


def _project(u, v, F, G, p, dt, params: Params, gi, gj) -> None:
    """The projection (main.c:131-136), in place on the blocks u and v,
    masked by the global update domains."""
    dx_t = st.scalar(params.dx, u.dtype, u.device)
    dy_t = st.scalar(params.dy, u.dtype, u.device)
    u_new = F[1:-1, 1:-1] - dt * (p[2:, 1:-1] - p[1:-1, 1:-1]) / dx_t
    v_new = G[1:-1, 1:-1] - dt * (p[1:-1, 2:] - p[1:-1, 1:-1]) / dy_t
    u[1:-1, 1:-1] = torch.where((gi <= params.i_max - 1) & (gj <= params.j_max),
                                u_new, u[1:-1, 1:-1])
    v[1:-1, 1:-1] = torch.where((gj <= params.j_max - 1) & (gi <= params.i_max),
                                v_new, v[1:-1, 1:-1])


def _sharded_step(u, v, p, t, params: Params, pressure_method: str,
                  mesh: Mesh, ab2=None, controls=None, corner: bool = False,
                  solve=None):
    """One time step on local padded blocks (reference main.c:86-146);
    returns (u, v, p, dt, SORResult, carry) with new blocks.  `ab2` is the
    ``AB2Carry`` of these blocks, or None for the Euler step; `carry` is
    the next one (None for Euler).  `controls` (diff.Controls, replicated
    0-d tensors) scales the lid and overrides the body force.  With
    `corner` the step follows one device's rule: the CFL maxima seeded
    with the global corner, and the ghost corners of u, v and p carried
    through (the mesh gradient, the gspmd backend).  `solve` takes the
    place of ``_pressure_solve`` (same arguments; the gspmd backend's
    one-device schedule)."""
    li, lj = u.shape[0] - 2, u.shape[1] - 2
    valid, gi, gj = _valid_mask_or_none(params, li, lj, mesh)
    dt, gamma = _sharded_dt_gamma(u, v, params, valid, mesh, corner=corner)
    start = (u, v, p)

    if params.problem == 3:
        u, v = _apply_channel_bcs_sharded(u, v, params, mesh)
    elif params.problem == 4:
        u, v = _apply_freeslip_bcs_sharded(u, v, params, mesh)
    else:
        lid = boundary.lid_velocity(params.problem, params.f, t)
        if controls is not None:
            lid = lid * controls.lid_scale
        u, v = _apply_bcs_sharded(u, v, lid, params, mesh)
    geo = None
    if params.obstacles:
        geo = _obstacle_block(params, mesh, li, lj)
        u, v = _apply_obstacle_bcs_sharded(u, v, params, mesh)
    F, G = _local_fg(u, v, dt, gamma, params, gi, gj, mesh,
                     *(() if controls is None else controls[1:]))
    carry = None
    if ab2 is not None:
        # solver.step_ab2's extrapolation on the whole padded block.  Its
        # halos need no exchange: the west/south F/G halo edges are the
        # owners' values and the u/v halos are fresh from the BC pass, so a
        # carried ru/rv halo copy always equals its owner's.
        F, G, ru, rv = ab2_extrapolate(F, G, u, v, dt, ab2)
        carry = AB2Carry(ru, rv, dt)
    Fa, Ga = F, G
    if geo is not None:
        # F = u, G = v on the obstacle faces after the extrapolation
        # (ops/obstacles.py::pin_fg); halo positions carry their owner's
        # global index, so the pin keeps the halos consistent.
        F = torch.where(geo.u_solid, u, F)
        G = torch.where(geo.v_solid, v, G)
        Fa, Ga = F, G
        if obstacles.aperture_active(params):
            # The cut-cell divergence: the face fractions scale the rhs
            # only; the projection needs the tentative velocities.
            au, av = _blocks_of(params, "apertures", mesh, F.shape, F.dtype)
            Fa, Ga = F * au, G * av
    rhs = _local_rhs(Fa, Ga, dt, params, valid,
                     None if geo is None else geo.fluid[1:-1, 1:-1])
    result = (solve or _pressure_solve)(p, rhs, params, pressure_method, li,
                                        lj, valid, mesh)
    p = result.p
    # The projection writes in place; F and G's stencils saved u and v.
    u, v = u.clone(), v.clone()
    _project(u, v, F, G, p, dt, params, gi, gj)
    if geo is not None:
        # The projection sweeps the obstacle faces too: restore them.
        u, v = _apply_obstacle_bcs_sharded(u, v, params, mesh)
    if corner:
        u, v, p = (_keep_corners(x, x0, params, mesh)
                   for x, x0 in zip((u, v, p), start))
    return u, v, p, dt, result, carry


@functools.lru_cache(maxsize=32)
def _residual_weights(params: Params, mesh_shape, coords, li: int, lj: int,
                      device: torch.device) -> masked._DeviceWeights:
    """ops/masked.py's f64 weights of the masked operator (with the cut-cell
    face fractions under the aperture closure) cut to the rank's interior,
    zero on the pad."""
    w = masked._weights(params)

    def cut(arr_np):
        full = np.zeros(params.shape, arr_np.dtype)
        full[1:-1, 1:-1] = arr_np
        return np.ascontiguousarray(_global_block_slice(
            full, mesh_shape, coords, li, lj)[1:-1, 1:-1])

    block = masked._Weights(*(cut(a) for a in w[:6]),
                            n_fluid=int(cut(w.fluid).sum()))
    parity = (coords[0] * li + coords[1] * lj) % 2
    return masked._on_device(block, torch.float64, device, parity)


def _masked_residual_fn(params: Params, li: int, lj: int, mesh: Mesh):
    """``residual_fn(p64, rhs_int64)`` of the refinement: the f64 defect of
    the masked operator (ops/masked.py::masked_residual) on the rank's
    exchanged block, 0 on solid cells."""
    w = _residual_weights(params, mesh.shape, mesh.coords, li, lj,
                          mesh.device)

    def residual_fn(p64: torch.Tensor, rhs_int64: torch.Tensor):
        return masked.masked_residual(halo.exchange_halo(p64, mesh),
                                      rhs_int64, w)

    return residual_fn


def _deep_route(params: Params, li: int, lj: int,
                pressure_method: str = "rb_sor") -> bool:
    """Whether rb_sor / pallas_sor take the deep-halo inner: blocks of at
    least 2 x 2 cells, and for rb_sor an f32 state with the refinement on.
    pallas_sor refines on every state, as on one device (f32 sweeps under
    the f64 master): the steppers refuse it on an f64 state as the JAX
    package's sharded backend does (``_check_method``), the mesh gradient
    runs it (``check_gradient``)."""
    if min(li, lj) < 2:
        return False
    return pressure_method == "pallas_sor" or (
        params.dtype == "float32" and params.sor_refine_every > 0)


def _ghost_fn(params: Params, valid, mesh: Mesh):
    """The sharded ghost fill of the pressure: the exchange and the Neumann
    closure, masked by global index on a padded grid."""
    if valid is None:
        def ghost_fn(q):
            return halo.neumann_or_exchange(q, mesh)
        return ghost_fn
    return halo.make_masked_ghost_fn(params.i_max, params.j_max, mesh)


def solve_hooks(params: Params, li: int, lj: int, valid,
                mesh: Mesh) -> dict:
    """The hooks that adapt ops/sor.py's solves to a rank's block: the
    exchange-and-Neumann ghost fill (masked on padded grids), the
    all-reduced L2 norm and interior mean (over the fluid cells of an
    obstacle domain), and the block's parity."""
    ox, oy = mesh.origin(li, lj)
    # Obstacle domains: the L2 norm over the fluid cells (ops/masked.py).
    n_cells = obstacles.n_fluid_cells(params)

    def l2_fn(arr):
        return torch.sqrt(st.div(_all_reduce(torch.sum(arr * arr),
                                             dist.ReduceOp.SUM, mesh),
                                 n_cells))

    def mean_fn(arr):
        # The global interior mean of problem 3's deflation: `arr` is an
        # interior-shaped local array whose pad cells are 0.
        return st.div(_all_reduce(torch.sum(arr), dist.ReduceOp.SUM, mesh),
                      n_cells)

    return dict(ghost_fn=_ghost_fn(params, valid, mesh), l2_fn=l2_fn,
                parity=(ox + oy) % 2, mean_fn=mean_fn)


def _sharded_pressure_solve(p, rhs, params: Params, pressure_method: str,
                            li: int, lj: int, valid, mesh: Mesh):
    """The pressure solve on local padded blocks with the sharded hooks
    (``solve_hooks``) and the block's pad mask; the inner stage by method,
    as JAX's ``_sharded_pressure_solve`` picks it."""
    hooks = solve_hooks(params, li, lj, valid, mesh)
    refined = params.replace(sor_refine_every=max(1, params.sor_refine_every))
    if params.obstacles:
        # The masked f64 defect through the residual_fn hook around the
        # masked deep-halo inner (rb_sor, pallas_sor), or around
        # mg_cycles_per_outer masked V-cycles on blocks (mg: the mesh
        # gradient and the gspmd backend; the steppers refuse it).
        fluid = _obstacle_block(params, mesh, li, lj).fluid[1:-1, 1:-1]
        if pressure_method == "mg":
            inner = masked.make_sharded_mg_inner(params, li, lj, mesh)
            refined = params.replace(
                sor_refine_every=max(1, params.mg_cycles_per_outer))
        else:
            inner = deep_halo.make_deep_inner(params, li, lj, mesh)
        return sor._solve_pressure_refined(
            p, rhs, refined, inner_fn=inner,
            valid_mask=fluid if valid is None else valid & fluid,
            residual_fn=_masked_residual_fn(params, li, lj, mesh), **hooks)
    if pressure_method == "mg":
        # One V-cycle per outer pass (as JAX's sharded mg); divisible grids.
        return sor._solve_pressure_refined(
            p, rhs, params.replace(sor_refine_every=1),
            inner_fn=mg.make_sharded_inner(params, li, lj, mesh), **hooks)
    if pressure_method == "fft":
        # One pencil-decomposed direct solve per outer pass.
        return sor._solve_pressure_refined(
            p, rhs, params.replace(sor_refine_every=1),
            inner_fn=fft.make_sharded_inner(params, li, lj, mesh), **hooks)
    if pressure_method == "cg":
        return sor._solve_pressure_refined(
            p, rhs, refined,
            inner_fn=mg.make_sharded_cg_inner(params, li, lj, mesh),
            valid_mask=valid, **hooks)
    if pressure_method in ("rb_sor", "pallas_sor") and _deep_route(
            params, li, lj, pressure_method):
        # One 2K-deep exchange per K sweeps.
        return sor._solve_pressure_refined(
            p, rhs, refined,
            inner_fn=deep_halo.make_deep_inner(params, li, lj, mesh),
            valid_mask=valid, **hooks)
    # The exchange before every half-sweep: rb_sor_sync forces it; it is
    # also the f64, refinement-off and thin-block route, and jacobi's.
    method = "rb_sor" if pressure_method == "rb_sor_sync" else pressure_method
    return sor.solve_pressure(p, rhs, params, method=method,
                              valid_mask=valid, **hooks)


def _pressure_solve(p, rhs, params: Params, pressure_method: str, li: int,
                    lj: int, valid, mesh: Mesh):
    """``_sharded_pressure_solve``; under autograd with its implicit-function
    adjoint (parallel/autograd.py, ``_pressure_adjoint``)."""
    if autograd.tracked(p, rhs):
        return autograd.pressure_solve(p, rhs, params, pressure_method, li, lj,
                                       valid, mesh)
    return _sharded_pressure_solve(p, rhs, params, pressure_method, li, lj,
                                   valid, mesh)


def _pressure_adjoint(p_bar, params: Params, pressure_method: str, li: int,
                      lj: int, valid, mesh: Mesh):
    """(p0_bar, rhs_bar) of ``_sharded_pressure_solve`` for the output
    cotangent `p_bar` on this rank's block: diff.py's ``_ift_bwd`` and
    ``_ift_bwd_masked`` on blocks.  The solve's output is the ghost fill
    of its interior, so the cotangent first goes through the fill's
    transpose (seam halos back to their owners, physical ghosts onto their
    interior neighbours; autograd's vector-Jacobian product of the fill).
    The result is deflated by the all-reduced mean over the true interior
    (the fluid cells of an obstacle domain), solved from zero by the same
    sharded solve (A is symmetric), and deflated again.  Unmasked, the
    converged solution does not depend on p0: p0_bar = 0.  The masked solve
    keeps p0 on the solid cells, whose cotangents pass to p0_bar."""
    with torch.enable_grad(), autograd.ordered(mesh):
        x = torch.zeros_like(p_bar, requires_grad=True)
        z = torch.autograd.grad(_ghost_fn(params, valid, mesh)(x), x,
                                p_bar)[0][1:-1, 1:-1]
    keep = valid
    if params.obstacles:
        fluid = _obstacle_block(params, mesh, li, lj).fluid[1:-1, 1:-1]
        keep = fluid if valid is None else valid & fluid
    n_cells = obstacles.n_fluid_cells(params)
    zero = torch.zeros((), dtype=p_bar.dtype, device=p_bar.device)

    def deflated(x):
        if keep is not None:
            x = torch.where(keep, x, zero)
        x = x - st.div(_all_reduce(torch.sum(x), dist.ReduceOp.SUM, mesh),
                       n_cells)
        return x if keep is None else torch.where(keep, x, zero)

    lam = _sharded_pressure_solve(torch.zeros_like(p_bar), _embed(deflated(z)),
                                  params, pressure_method, li, lj, valid,
                                  mesh).p
    p0_bar = torch.zeros_like(p_bar)
    if params.obstacles:
        p0_bar[1:-1, 1:-1] = torch.where(fluid, zero, z)
    return p0_bar, _embed(deflated(lam[1:-1, 1:-1]))


def _check_method(params: Params, mesh: Mesh, pressure_method: str,
                  time_order: int = 1):
    """Refuse what the port's sharded backend does not run, and what the
    JAX package's refuses; returns (px, py, li, lj)."""
    if pressure_method not in METHODS:
        raise ValueError(f"unknown pressure solver method {pressure_method!r}")
    if time_order not in (1, 2):
        raise ValueError(f"time_order must be 1 or 2, got {time_order}")
    if params.obstacles:
        if pressure_method not in ("rb_sor", "pallas_sor"):
            raise ValueError(
                f"sharded obstacle domains run the masked deep-halo rb_sor "
                f"inner only (got {pressure_method!r}) — masked mg runs on "
                f"one device (drop --backend sharded) or on the gspmd "
                f"backend (--backend gspmd)")
        if params.dtype != "float32" or params.sor_refine_every < 1:
            raise ValueError(
                "sharded obstacle domains require the f32 state with the "
                "mixed-precision refinement (sor_refine_every >= 1)")
    px, py = mesh.shape
    li, lj = local_block_dims((px, py), params.i_max, params.j_max)
    padded = (px * li != params.i_max) or (py * lj != params.j_max)
    if pressure_method in ("mg", "fft") and padded:
        raise ValueError(
            f"sharded {pressure_method} requires an evenly-divisible grid; "
            f"{params.i_max}x{params.j_max} over a {px}x{py} mesh pads to "
            f"{px * li}x{py * lj} — use pressure_method='rb_sor'")
    if pressure_method == "fft" and (li % py != 0 or lj % px != 0):
        raise ValueError(
            f"sharded fft pencils must tile: blocks {li}x{lj} on a "
            f"{px}x{py} mesh need li % py == 0 and lj % px == 0")
    if pressure_method == "fft":
        fft.check_precision(params)
    if pressure_method == "pallas_sor" and not _deep_route(params, li, lj):
        raise ValueError(
            "sharded pallas_sor needs the mixed-precision refinement "
            "(float32 state and sor_refine_every > 0) and blocks of at "
            "least 2 x 2 cells")
    return px, py, li, lj


def _check_isothermal(params: Params, time_order: int) -> None:
    """Refuse the problems whose sharded step lives in another module: the
    JAX backend's isothermal step would run them as an oscillating lid."""
    if params.problem == 5 and time_order == 2:
        raise ValueError(
            "problem 5 with time_order 2 runs on one device (the sharded "
            "thermal stepper integrates first-order, as the JAX package's "
            "multi-chip thermal steppers do)")
    if params.problem == 5:
        raise ValueError(
            "problem 5 steps on the sharded backend with "
            "parallel/sharded_thermal.py (ThermalShardedStepper, "
            "solve_sharded_thermal)")
    if params.problem == 6:
        raise ValueError(
            "problem 6 steps on the sharded backend with "
            "parallel/sharded_free.py (solve_free_sharded)")


def check_gradient(params: Params, mesh: Mesh,
                   pressure_method: str) -> Params:
    """Refuse what the mesh gradient (diff.py) does not run; returns the
    configuration as ``_check_method`` checks its route.  The routes are the
    steppers', and two more that one device runs: an f64 state on an
    obstacle domain (the masked deep-halo inner in f32 under the f64
    master) and by pallas_sor (the deep-halo inner, kernel B6 on the card);
    an obstacle domain also by mg (the masked V-cycle on blocks,
    ops/masked.py).  A mesh of more than one device with a trivial axis is
    refused, as the JAX package's mesh gradient refuses it."""
    if len(mesh.shape) != 2:
        raise ValueError(f"the mesh gradient needs a 2-D grid mesh; got "
                         f"the axes {mesh.axes}")
    px, py = mesh.shape
    if px * py > 1 and min(px, py) == 1:
        raise ValueError(
            f"the mesh gradient rejects the {px}x{py} mesh, as the JAX "
            f"package's does (its GSPMD partitioner gives wrong values when "
            f"one mesh axis is trivial): use a 2D factorization or one "
            f"device")
    if params.obstacles or pressure_method == "pallas_sor":
        params = params.replace(
            dtype="float32", sor_refine_every=max(1, params.sor_refine_every))
    # Masked mg passes the masked route's checks (any grid: its V-cycle
    # gathers from the first level that does not split into even blocks).
    _check_method(params, mesh, "rb_sor" if params.obstacles
                  and pressure_method == "mg" else pressure_method)
    return params


# ---------------------------------------------------------------------------
# Block layout (the JAX package's): each shard's (li+2, lj+2) padded block is
# one tile of a (px*(li+2), py*(lj+2)) concatenation, halo copies included,
# so the gathered ghost ring holds the exact values the single-device path
# leaves there.
# ---------------------------------------------------------------------------

def _scatter_blocks(arr, px: int, py: int, li: int, lj: int) -> np.ndarray:
    """Reference-layout (i_max+2, j_max+2) array -> block-concatenated
    (px*(li+2), py*(lj+2)) layout (overlapping halo copies included)."""
    arr = np.asarray(arr)
    g = np.zeros((px * li + 2, py * lj + 2), arr.dtype)
    g[: arr.shape[0], : arr.shape[1]] = arr
    rows = []
    for ax in range(px):
        cols = [g[ax * li: ax * li + li + 2, ay * lj: ay * lj + lj + 2]
                for ay in range(py)]
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


def _gather_blocks(blocks, px: int, py: int, li: int, lj: int,
                   shape) -> np.ndarray:
    """Inverse of `_scatter_blocks`: the reference-layout padded array,
    interiors from in-block cells, the global ghost ring from the edge
    shards' halo rings, pad rows/columns dropped."""
    b = np.asarray(blocks).reshape(px, li + 2, py, lj + 2)
    out = np.zeros((px * li + 2, py * lj + 2), b.dtype)
    for ax in range(px):
        for ay in range(py):
            out[ax * li + 1: (ax + 1) * li + 1,
                ay * lj + 1: (ay + 1) * lj + 1] = b[ax, 1:-1, ay, 1:-1]
    for ay in range(py):
        out[0, ay * lj + 1: (ay + 1) * lj + 1] = b[0, 0, ay, 1:-1]
        out[-1, ay * lj + 1: (ay + 1) * lj + 1] = b[px - 1, -1, ay, 1:-1]
    for ax in range(px):
        out[ax * li + 1: (ax + 1) * li + 1, 0] = b[ax, 1:-1, 0, 0]
        out[ax * li + 1: (ax + 1) * li + 1, -1] = b[ax, 1:-1, py - 1, -1]
    out[0, 0] = b[0, 0, 0, 0]
    out[0, -1] = b[0, 0, py - 1, -1]
    out[-1, 0] = b[px - 1, -1, 0, 0]
    out[-1, -1] = b[px - 1, -1, py - 1, -1]
    return out[: shape[0], : shape[1]]


def scatter_field(params: Params, arr, mesh: Mesh) -> torch.Tensor:
    """This rank's padded block of a reference-layout field (a tensor on
    any device or an array; None for zeros) on the mesh's device, in the
    configuration's dtype."""
    px, py = mesh.shape
    li, lj = local_block_dims((px, py), params.i_max, params.j_max)
    dtype = params.torch_dtype
    if arr is None:
        return torch.zeros((li + 2, lj + 2), dtype=dtype, device=mesh.device)
    ax, ay = mesh.coords
    blocks = _scatter_blocks(host_array(arr), px, py, li, lj)
    mine = blocks[ax * (li + 2):(ax + 1) * (li + 2),
                  ay * (lj + 2):(ay + 1) * (lj + 2)]
    return torch.tensor(mine, dtype=dtype, device=mesh.device)


def gather_field(params: Params, x: torch.Tensor, mesh: Mesh,
                 padded: bool = False) -> torch.Tensor:
    """The reference-layout field of every rank's block `x`, on every rank:
    an all-gather, then `_gather_blocks`' layout assembled on the mesh's
    device (no host copy); with `padded` the (px li + 2, py lj + 2) layout
    of the padded grid."""
    px, py = mesh.shape
    li, lj = local_block_dims((px, py), params.i_max, params.j_max)
    parts = [torch.empty_like(x) for _ in range(px * py)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    b = torch.stack(parts).view(px, py, li + 2, lj + 2)
    out = x.new_zeros((px * li + 2, py * lj + 2))
    out[1:-1, 1:-1] = b[:, :, 1:-1, 1:-1].permute(0, 2, 1, 3).reshape(
        px * li, py * lj)
    out[0, 1:-1] = b[0, :, 0, 1:-1].reshape(-1)
    out[-1, 1:-1] = b[-1, :, -1, 1:-1].reshape(-1)
    out[1:-1, 0] = b[:, 0, 1:-1, 0].reshape(-1)
    out[1:-1, -1] = b[:, -1, 1:-1, -1].reshape(-1)
    out[0, 0], out[0, -1] = b[0, 0, 0, 0], b[0, -1, 0, -1]
    out[-1, 0], out[-1, -1] = b[-1, 0, -1, 0], b[-1, -1, -1, -1]
    shape = (px * li + 2, py * lj + 2) if padded else params.shape
    return out[:shape[0], :shape[1]].contiguous()


def scatter_state(params: Params, state, mesh: Mesh) -> State:
    """This rank's padded blocks of a reference-layout state (a port or a
    JAX ``State``; None for the zero state) as a ``State`` of local blocks
    on the mesh's device, in the configuration's dtype."""
    dtype = params.torch_dtype

    def block(arr):
        return scatter_field(params, arr, mesh)

    if state is None:
        return State(u=block(None), v=block(None), p=block(None),
                     t=torch.zeros((), dtype=dtype, device=mesh.device), n=0)
    return State(u=block(state.u), v=block(state.v), p=block(state.p),
                 t=torch.tensor(float(host_array(state.t)), dtype=dtype,
                                device=mesh.device),
                 n=int(host_array(state.n)))


def gather_state(params: Params, local: State, mesh: Mesh) -> State:
    """The reference-layout state of every rank's blocks, on every rank
    (``gather_field``), on the mesh's device."""
    return State(u=gather_field(params, local.u, mesh),
                 v=gather_field(params, local.v, mesh),
                 p=gather_field(params, local.p, mesh), t=local.t, n=local.n)


def _step_local(local: State, params: Params, pressure_method: str,
                mesh: Mesh, ab2=None):
    """One time step of this rank's blocks: (state, diagnostics, the next
    AB2 carry or None)."""
    u, v, p, dt, result, carry = _sharded_step(
        local.u, local.v, local.p, local.t, params, pressure_method, mesh,
        ab2)
    return (State(u=u, v=v, p=p, t=local.t + dt, n=local.n + 1),
            StepDiagnostics(dt=dt, sor_iterations=result.iterations,
                            sor_res_norm=result.res_norm,
                            sor_converged=result.converged), carry)


class ShardedStepper:
    """Host-loop adapter for the sharded backend (JAX
    ``parallel/sharded.py::ShardedStepper``): holds this rank's padded
    blocks of a reference-layout `state` (None: the zero state) and
    advances them one step per ``step()``, with `time_order` 2 by the
    Adams-Bashforth 2 step from the Euler bootstrap (also from a resumed
    state: a checkpoint holds the state, not the tendency).  ``state()``
    gathers the reference-layout state on every rank; it is collective, so
    every rank calls it at the same steps."""

    def __init__(self, params: Params, state=None,
                 mesh: Optional[Mesh] = None,
                 pressure_method: str = "rb_sor", time_order: int = 1):
        _check_isothermal(params, time_order)
        if mesh is None:
            mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max)
        _check_method(params, mesh, pressure_method, time_order)
        self.params = params
        self.mesh = mesh
        self.pressure_method = pressure_method
        self.time_order = time_order
        self._local = scatter_state(params, state, mesh)
        self._ab2 = None
        if time_order == 2:
            self._ab2 = AB2Carry(torch.zeros_like(self._local.u),
                                 torch.zeros_like(self._local.v),
                                 torch.zeros_like(self._local.t))

    def warm(self) -> None:
        """Build the kernels and take first-use costs (``warm_up``)."""
        warm_up(self.params, self.mesh, self.pressure_method,
                self.time_order)

    @property
    def t(self) -> float:
        return float(self._local.t)

    @property
    def n(self) -> int:
        return self._local.n

    def step(self) -> StepDiagnostics:
        self._local, diag, self._ab2 = _step_local(
            self._local, self.params, self.pressure_method, self.mesh,
            self._ab2)
        return diag

    def state(self) -> State:
        return gather_state(self.params, self._local, self.mesh)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (collective: an all-reduce
        that every rank calls at the same point)."""
        x = torch.tensor(int(flag), device=self.mesh.device)
        return bool(_all_reduce(x, dist.ReduceOp.MAX, self.mesh))


def warm_up(params: Params, mesh: Mesh, pressure_method: str = "rb_sor",
            time_order: int = 1) -> None:
    """One throw-away step of `time_order`'s route with a single sweep from
    the zero state, so a timed solve excludes the kernel build and
    first-use costs (the JAX CLI compiles before its timer starts); an
    unported route raises here."""
    ShardedStepper(params.replace(max_it=1), None, mesh,
                   pressure_method, time_order).step()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def solve_sharded(params: Params, state=None, mesh: Optional[Mesh] = None, *,
                  pressure_method: str = "rb_sor", max_steps: int = 0,
                  time_order: int = 1) -> Tuple[State, SolveStats]:
    """Sharded counterpart of ``solver.solve`` over the initialised process
    group: scatter -> solve on the local blocks -> gather, returning a
    reference-layout state (ghost ring included) on every rank.  `mesh`
    defaults to the pad-optimal mesh over the group; `time_order` 2 steps
    with Adams-Bashforth 2 from the Euler bootstrap."""
    stepper = ShardedStepper(params, state, mesh, pressure_method,
                             time_order)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.state(), stats
