"""Geometric multigrid pressure solver (method="mg").

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/mg.py``: a
cell-centered V(2,2)-cycle on the
homogeneous-Neumann 5-point Laplacian, used as the inner stage of the same
f64 refinement outer as SOR (ops/sor.py), where one V-cycle on the f32
correction replaces K red-black sweeps and ``iterations`` counts V-cycles.
Plain SOR needs O(n) sweeps per digit; a V-cycle contracts the error by a
grid-independent factor, so the reference stopping rule is met in a handful
of cycles.

  * smoother: red-black Gauss-Seidel (omega = 1) in the roll +
    self-coefficient formulation, the hand-written warm-start kernel for a
    CUDA tensor and its plain twin for a CPU one
    (ops/cuda/sor_kernel.py::warm_sweeps);
  * restriction: 2x2 full-weighting average of the residual;
  * prolongation: piecewise-constant injection, written as repeats (each
    output is one input value, so it is exact), added to p;
  * coarse solve: 32 red-black sweeps on the coarsest level.

Every level keeps its ghost ring at 0, which the self-coefficient Laplacian
expects.  The cycle runs eagerly from Python down to the first level whose
whole sub-hierarchy fits one thread block's shared memory
(sor_kernel.coarse_cycle_depth: 130^2 for a 2048^2 grid).  For a CUDA
tensor one kernel launch runs the rest of the cycle from there
(sor_kernel.coarse_cycle), and each level above it is four launches: two
smoother calls, the residual with its restriction (sor_kernel.mg_restrict)
and the prolongation with its add (sor_kernel.mg_prolong), the last two
counted per level in ``mg.fused_levels``.  All give the same bits as the
plain functions below, which a CPU tensor runs down to the coarsest
level.

The sharded multigrid (the end of this module) runs the same cycle on each
rank's block of a process mesh: restriction and prolongation stay local,
the smoother is the deep-halo one (one 2n-deep exchange, then n sweeps of
the extended block through ``sor_kernel.ext_sweeps``: kernel B6 on the
card, as for the sharded SOR inner), the level residual exchanges one-cell
halos, and the coarsest sharded level is all-gathered and finished by
``v_cycle`` on every rank.  ``make_sharded_cg_inner`` is the sharded
conjugate gradient on the same level operator.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Params
from ..utils import timing
from .cuda import sor_kernel


class _Level(NamedTuple):
    shape: Tuple[int, int]   # padded (n_i + 2, n_j + 2)
    dx2_inv: float
    dy2_inv: float


def build_levels(params: Params, min_cells: int = 8) -> List[_Level]:
    """Coarsen by 2 in both directions while both stay even and >= min."""
    return _coarsen(params.i_max, params.j_max, 1.0 / (params.dx * params.dx),
                    1.0 / (params.dy * params.dy), min_cells)


def _coarsen(ni: int, nj: int, dx2_inv: float, dy2_inv: float,
             min_cells: int) -> List[_Level]:
    """The levels of an ni x nj interior: halve both while both stay even
    and at least min_cells after halving."""
    levels = [_Level((ni + 2, nj + 2), dx2_inv, dy2_inv)]
    while (ni % 2 == 0 and nj % 2 == 0 and ni // 2 >= min_cells
           and nj // 2 >= min_cells):
        ni //= 2
        nj //= 2
        dx2_inv /= 4.0
        dy2_inv /= 4.0
        levels.append(_Level((ni + 2, nj + 2), dx2_inv, dy2_inv))
    return levels


@functools.lru_cache(maxsize=None)
def _masks(shape: Tuple[int, int], dx2_inv: float, dy2_inv: float):
    """(red, black, self_coef) interior/parity masks of a padded level, as
    numpy arrays (self_coef in f32), built once per level."""
    ni, nj = shape
    ii, jj = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
    interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    par = (ii + jj) % 2
    self_coef = (
        ((ii == 1).astype(np.float32) + (ii == ni - 2).astype(np.float32))
        * np.float32(dx2_inv)
        + ((jj == 1).astype(np.float32) + (jj == nj - 2).astype(np.float32))
        * np.float32(dy2_inv)
    )
    return interior & (par == 0), interior & (par == 1), self_coef


@functools.lru_cache(maxsize=None)
def _self_coef(lvl: _Level, device: torch.device) -> torch.Tensor:
    """The level's self coefficient as a tensor on `device`, built once."""
    return torch.from_numpy(_masks(*lvl)[2]).to(device)


def _neighbor_sum(p: torch.Tensor, lvl: _Level,
                  self_coef: torch.Tensor) -> torch.Tensor:
    return ((torch.roll(p, 1, 0) + torch.roll(p, -1, 0)) * lvl.dx2_inv
            + (torch.roll(p, 1, 1) + torch.roll(p, -1, 1)) * lvl.dy2_inv
            + p * self_coef)


def _smooth(p: torch.Tensor, rhs: torch.Tensor, lvl: _Level, n_sweeps: int,
            omega: float = 1.0) -> torch.Tensor:
    """n red-black sweeps from p at this level: the warm-start kernel for a
    CUDA tensor, its plain twin for a CPU one."""
    return sor_kernel.warm_sweeps(p, rhs, n_sweeps, omega, lvl.dx2_inv,
                                  lvl.dy2_inv)


def ghost_zero(p: torch.Tensor) -> torch.Tensor:
    """A copy of p with its ghost ring zeroed (the self-coefficient
    Laplacian expects it)."""
    out = torch.zeros_like(p)
    out[1:-1, 1:-1] = p[1:-1, 1:-1]
    return out


def _lap(p: torch.Tensor, lvl: _Level) -> torch.Tensor:
    s2 = 2.0 * (lvl.dx2_inv + lvl.dy2_inv)
    return _neighbor_sum(p, lvl, _self_coef(lvl, p.device)) - s2 * p


def _restrict(r_fine: torch.Tensor, coarse_shape) -> torch.Tensor:
    """2x2 full-weighting average of the fine interior into a padded coarse
    array (zeros elsewhere).  The four terms are summed pairwise, row by
    row, the order XLA's CPU reduce_window takes on the cavity's
    power-of-two grids."""
    x = r_fine[1:-1, 1:-1]
    avg = 0.25 * ((x[0::2, 0::2] + x[0::2, 1::2])
                  + (x[1::2, 0::2] + x[1::2, 1::2]))
    out = torch.zeros(coarse_shape, dtype=r_fine.dtype, device=r_fine.device)
    out[1:-1, 1:-1] = avg
    return out


def _prolong(e_coarse: torch.Tensor, fine_shape) -> torch.Tensor:
    """Piecewise-constant injection of the coarse interior onto the fine
    interior (padded): each coarse value fills a 2x2 block."""
    up = e_coarse[1:-1, 1:-1].repeat_interleave(2, 0).repeat_interleave(2, 1)
    out = torch.zeros(fine_shape, dtype=e_coarse.dtype,
                      device=e_coarse.device)
    out[1:-1, 1:-1] = up
    return out


def _down_plain(p: torch.Tensor, rhs: torch.Tensor, lvl: _Level,
                coarse: _Level):
    """(r_c, e_c): the level's residual rhs - A p restricted to the coarse
    level, and a zero correction there."""
    r_c = _restrict(rhs - _lap(p, lvl), coarse.shape)  # reads the interior
    e_c = torch.zeros(coarse.shape, dtype=p.dtype, device=p.device)
    return r_c, e_c


def _up_plain(p: torch.Tensor, e_c: torch.Tensor,
              lvl: _Level) -> torch.Tensor:
    """p plus the coarse correction injected onto the level (+ 0 on the
    ghost ring)."""
    return p + _prolong(e_c, lvl.shape)


def _down_kernel(p: torch.Tensor, rhs: torch.Tensor, lvl: _Level,
                 coarse: _Level):
    """_down_plain in one launch (the cycle has checked its levels)."""
    timing.count("mg.fused_levels")
    return sor_kernel.mg_restrict_unchecked(
        p, rhs, sor_kernel.transfer_constants(lvl.dx2_inv, lvl.dy2_inv))


def _up_kernel(p: torch.Tensor, e_c: torch.Tensor,
               lvl: _Level) -> torch.Tensor:
    """_up_plain in one launch (the cycle has checked its levels)."""
    return sor_kernel.mg_prolong_unchecked(p, e_c)


def _cycle(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
           depth: int, nu1: int, nu2: int, coarse_sweeps: int, smooth,
           down, up, tail_depth: int) -> torch.Tensor:
    """One V(nu1, nu2) cycle at `depth` with `smooth(p, rhs, level, n)` as
    the smoother and `down(p, rhs, level, coarse)` -> (r_c, e_c) and
    `up(p, e_c, level)` as the grid transfers (_down_plain and _up_plain
    or their kernels); at tail_depth the rest of the cycle is one call of
    sor_kernel.coarse_cycle.  Each level's work runs in the span
    ``mg.level<depth>``, which holds the next level's: a level's own time
    is its span less its child."""
    lvl = levels[depth]
    if depth == tail_depth:
        with timing.span("mg.coarse_cycle"):
            return sor_kernel.coarse_cycle(p, rhs, levels[depth:], nu1, nu2,
                                           coarse_sweeps)
    with timing.span(f"mg.level{depth}"):
        if depth == len(levels) - 1:
            return smooth(p, rhs, lvl, coarse_sweeps)

        p = smooth(p, rhs, lvl, nu1)
        r_c, e_c = down(p, rhs, lvl, levels[depth + 1])
        e_c = _cycle(e_c, r_c, levels, depth + 1, nu1, nu2, coarse_sweeps,
                     smooth, down, up, tail_depth)
        p = up(p, e_c, lvl)
        return smooth(p, rhs, lvl, nu2)


def _route(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
           depth: int):
    """(down, up, tail_depth) of a cycle from `depth` on p's device: for a
    CUDA tensor the transfer kernels above the coarse cycle, which takes
    over at t = sor_kernel.coarse_cycle_depth(levels) (at `depth` itself
    when that lies deeper), the whole hierarchy checked here once; for any
    other tensor the plain transfers down to the coarsest level."""
    if p.device.type != "cuda":
        return _down_plain, _up_plain, len(levels)
    tail_depth = max(depth, sor_kernel.coarse_cycle_depth(levels))
    sor_kernel.check_transfer_levels(p, rhs, levels[depth:tail_depth + 1])
    return _down_kernel, _up_kernel, tail_depth


def v_cycle(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
            depth: int = 0, nu1: int = 2, nu2: int = 2,
            coarse_sweeps: int = 32) -> torch.Tensor:
    """One V(nu1, nu2) cycle on A p = rhs at `depth`; returns improved p.
    For a CPU tensor it calls _smooth 2 (len(levels) - depth) - 1 times,
    with the plain transfers between.  For a CUDA tensor it calls _smooth
    twice and each transfer kernel once on each level above
    t = sor_kernel.coarse_cycle_depth(levels) and sor_kernel.coarse_cycle
    once, at depth t (at `depth` itself when that lies deeper)."""
    return _cycle(p, rhs, levels, depth, nu1, nu2, coarse_sweeps, _smooth,
                  *_route(p, rhs, levels, depth))


def v_cycle_plain(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
                  nu1: int = 2, nu2: int = 2,
                  coarse_sweeps: int = 32) -> torch.Tensor:
    """v_cycle from levels[0] down on the plain smoother and transfers,
    whatever the tensor's device: the plain twin of sor_kernel.coarse_cycle
    and of the cycle on the card."""
    def smooth(q, rhs_l, lvl, n_sweeps):
        return sor_kernel.warm_sweeps_plain(q, rhs_l, n_sweeps, 1.0,
                                            lvl.dx2_inv, lvl.dy2_inv)

    levels = [_Level(*lvl) for lvl in levels]
    return _cycle(p, rhs, levels, 0, nu1, nu2, coarse_sweeps, smooth,
                  _down_plain, _up_plain, len(levels))


def inner_v_cycle(rhs_neg: torch.Tensor, n_cycles: int,
                  params: Params) -> torch.Tensor:
    """Refinement inner: delta = (approx A^-1) rhs_neg by `n_cycles`
    V(2, 2) cycles from delta = 0, routed and checked once for all."""
    levels = build_levels(params)
    rhs = rhs_neg.to(torch.float32)
    d = torch.zeros(params.shape, dtype=torch.float32, device=rhs.device)
    route = _route(d, rhs, levels, 0)
    for _ in range(int(n_cycles)):
        timing.count("mg.cycles")
        d = _cycle(d, rhs, levels, 0, 2, 2, 32, _smooth, *route)
    return d


# ---------------------------------------------------------------------------
# Sharded multigrid (parallel/sharded.py).  Coarsening by 2 keeps the block
# decomposition aligned: restriction and prolongation act on each rank's
# local interior with no communication; the smoother and the level residual
# exchange halos, and the refinement outer all-reduces the defect norm.
# Masks and self coefficients come from global indices (the block's origin
# on the mesh), so the physical-boundary Neumann folding and the
# checkerboard stay globally consistent.
# ---------------------------------------------------------------------------

class _ShardedLevel(NamedTuple):
    shape: Tuple[int, int]    # local padded (li + 2, lj + 2)
    g_dims: Tuple[int, int]   # global interior (i_max, j_max) of the level
    dx2_inv: float
    dy2_inv: float


def build_levels_sharded(params: Params, li: int, lj: int,
                         min_local: int = 4) -> List[_ShardedLevel]:
    """Per-rank level list; coarsen while the LOCAL block stays even and at
    least min_local cells wide after halving (the global dims halve with
    it, rounding down)."""
    return [_ShardedLevel(lvl.shape, (params.i_max >> k, params.j_max >> k),
                          lvl.dx2_inv, lvl.dy2_inv)
            for k, lvl in enumerate(_coarsen(
                li, lj, 1.0 / (params.dx * params.dx),
                1.0 / (params.dy * params.dy), min_local))]


def _level_masks(level: _ShardedLevel, mesh):
    """(red, black, self_coef) of a level's local padded block, from its
    global indices, built once per level and place on the mesh (the cache
    keeps no process group)."""
    return _level_masks_at(level, dataclasses.replace(mesh, group=None,
                                                      axis_groups={}))


@functools.lru_cache(maxsize=None)
def _level_masks_at(level: _ShardedLevel, mesh):
    from ..parallel import halo

    (ni_l, nj_l), (i_max_l, j_max_l) = level.shape, level.g_dims
    gi, gj = halo.padded_global_indices(level.shape, mesh)
    ii = torch.arange(ni_l, device=mesh.device).view(-1, 1)
    jj = torch.arange(nj_l, device=mesh.device).view(1, -1)
    interior = ((gi >= 1) & (gi <= i_max_l) & (gj >= 1) & (gj <= j_max_l)
                & (ii >= 1) & (ii <= ni_l - 2) & (jj >= 1) & (jj <= nj_l - 2))
    par = (gi + gj) % 2
    f32 = torch.float32
    self_coef = (((gi == 1).to(f32) + (gi == i_max_l).to(f32)) * level.dx2_inv
                 + ((gj == 1).to(f32) + (gj == j_max_l).to(f32))
                 * level.dy2_inv)
    return interior & (par == 0), interior & (par == 1), self_coef


@functools.lru_cache(maxsize=None)
def _ext_interior(ext_shape, H: int, origin, g_dims, device: torch.device):
    """The global-interior mask of a level's extended block, built once per
    level (the smoother runs twice per level and V-cycle)."""
    return sor_kernel.ext_masks(ext_shape, H, origin, g_dims[0], g_dims[1],
                                1.0, 1.0, device=device)[0]


def _smooth_sharded_deep(p, rhs, level, n_sweeps: int, omega: float, mesh):
    """The communication-avoiding smoother (parallel/deep_halo.py applied to
    a warm start): ONE 2n-deep halo exchange of p and rhs, then n red-black
    sweeps on the extended block, ``sor_kernel.ext_sweeps`` with the
    level's constants (kernel B6 on the card).  Ring cells of the extended
    block replicate the neighbours' cells and update in lockstep with them,
    so the central (li, lj) core gets exactly what exchanging before every
    half-sweep gives."""
    from ..parallel import deep_halo

    shape, g_dims, dx2_inv, dy2_inv = level
    li, lj = shape[0] - 2, shape[1] - 2
    H = 2 * n_sweeps
    origin = mesh.origin(li, lj)
    consts = (*g_dims, omega, dx2_inv, dy2_inv)
    interior = _ext_interior((li + 2 * H, lj + 2 * H), H, origin, g_dims,
                             p.device)

    def clean_extend(local_int):
        return torch.where(interior, deep_halo.extend_block(
            local_int.to(torch.float32), H, mesh), 0.0)

    out = sor_kernel.ext_sweeps(clean_extend(p[1:-1, 1:-1]),
                                clean_extend(rhs[1:-1, 1:-1]), n_sweeps,
                                origin, H, consts)
    p = p.clone()
    p[1:-1, 1:-1] = out[H:H + li, H:H + lj]
    return p


def _smooth_sharded(p, rhs, level, n_sweeps: int, mesh, omega: float = 1.0):
    """Red-black sweeps on a local block: the deep-halo smoother when the
    2n-deep halo fits the neighbour block (one exchange for all n sweeps),
    else a one-cell exchange before each half-sweep (physical-edge halos
    need no refresh: the self coefficient folds the Neumann BC, and what
    the rolls bring in there is masked out)."""
    from ..parallel import halo

    if 2 * n_sweeps <= min(level.shape[0] - 2, level.shape[1] - 2):
        return _smooth_sharded_deep(p, rhs, level, n_sweeps, omega, mesh)
    red, black, self_coef = _level_masks(level, mesh)
    coef = omega / (2.0 * (level.dx2_inv + level.dy2_inv))

    def half(p, mask):
        p = halo.exchange_halo(p, mesh)
        nb = _neighbor_sum(p, level, self_coef)
        return torch.where(mask, (1.0 - omega) * p + coef * (nb - rhs), p)

    for _ in range(int(n_sweeps)):
        p = half(half(p, red), black)
    return p


def _lap_sharded(p, level, mesh):
    from ..parallel import halo

    self_coef = _level_masks(level, mesh)[2]
    p = halo.exchange_halo(p, mesh)
    return (_neighbor_sum(p, level, self_coef)
            - 2.0 * (level.dx2_inv + level.dy2_inv) * p)


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """JAX's tiled ``all_gather(x, axis, axis=dim)``: every rank's x along
    the mesh axis, concatenated along dim in the axis' order."""
    group, size = mesh.axis_group(axis)
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_interior(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The global (ni, nj) = `dims` array of every rank's interior-shaped
    block `x`, on every rank: all-gathered over "x", then "y", with the
    pad-to-divisible cells on the high side dropped."""
    x = _all_gather(_all_gather(x, mesh, "x", 0), mesh, "y", 1)
    return x[:dims[0], :dims[1]]


def cut_interior(g: torch.Tensor, mesh, li: int, lj: int) -> torch.Tensor:
    """This rank's (li, lj) block of a global interior-shaped array, zero
    on the pad (the inverse of ``gather_interior``)."""
    px, py = mesh.shape
    full = g.new_zeros((px * li, py * lj))
    full[:g.shape[0], :g.shape[1]] = g
    ox, oy = mesh.origin(li, lj)
    return full[ox:ox + li, oy:oy + lj]


def _coarse_solve_replicated(p, rhs, level, nu1: int, nu2: int,
                             coarse_sweeps: int, mesh):
    """The coarsest sharded level's solve: all-gather the (small) level over
    "x", then "y", onto every rank (``gather_interior``; a padded level
    drops its pad), finish the V-cycle on the replicated global array with
    ``v_cycle`` (down to the <= 8^2 level), and cut the local block back
    out.  On the card ``v_cycle`` takes its kernels, the smoother and the
    coarse cycle, whose bits equal their plain twins' (the JAX package
    runs its jnp smoother here)."""
    shape, g_dims, dx2_inv, dy2_inv = level
    li, lj = shape[0] - 2, shape[1] - 2

    def gather_global(arr):
        out = arr.new_zeros((g_dims[0] + 2, g_dims[1] + 2))
        out[1:-1, 1:-1] = gather_interior(arr[1:-1, 1:-1], mesh, g_dims)
        return out

    glevels = _coarsen(*g_dims, dx2_inv, dy2_inv, 8)
    e_g = v_cycle(gather_global(p), gather_global(rhs), glevels, nu1=nu1,
                  nu2=nu2, coarse_sweeps=coarse_sweeps)
    out = torch.zeros_like(p)
    out[1:-1, 1:-1] = cut_interior(e_g[1:-1, 1:-1], mesh, li, lj)
    return out


def v_cycle_sharded(p, rhs, levels, mesh, depth: int = 0, nu1: int = 2,
                    nu2: int = 2, coarse_sweeps: int = 32):
    """One V(nu1, nu2) cycle on this rank's blocks of the sharded levels."""
    lvl = levels[depth]
    if depth == len(levels) - 1:
        return _coarse_solve_replicated(p, rhs, lvl, nu1, nu2, coarse_sweeps,
                                        mesh)
    p = _smooth_sharded(p, rhs, lvl, nu1, mesh)
    r = rhs - _lap_sharded(p, lvl, mesh)
    coarse_shape = levels[depth + 1].shape
    r_c = _restrict(r, coarse_shape)
    e_c = torch.zeros(coarse_shape, dtype=p.dtype, device=p.device)
    e_c = v_cycle_sharded(e_c, r_c, levels, mesh, depth + 1, nu1, nu2,
                          coarse_sweeps)
    p = p + _prolong(e_c, lvl.shape)
    return _smooth_sharded(p, rhs, lvl, nu2, mesh)


def split_depth(dims, mesh_shape, cap: int = None) -> int:
    """The first level of a hierarchy (global interior `dims` per level)
    that the gspmd V-cycle gathers: a level stays sharded while it is not
    the coarsest, its interior splits into equal blocks over the mesh and
    the blocks are even (so the restriction to the next level stays
    local), and while it lies above `cap`."""
    px, py = mesh_shape
    for k, (ni, nj) in enumerate(dims):
        if (k == len(dims) - 1 or (cap is not None and k >= cap)
                or ni % px or nj % py or (ni // px) % 2 or (nj // py) % 2):
            return k
    return len(dims) - 1


def build_levels_gspmd(params: Params, mesh_shape,
                       cuda: bool = False) -> List[_ShardedLevel]:
    """The gspmd backend's levels: exactly one device's ``build_levels``,
    each as a rank's block, down to the gathered level ``split_depth``
    (the last entry; on the card at most ``sor_kernel.coarse_cycle_depth``,
    where one device enters the coarse cycle).  A grid that does not
    divide the mesh (17^2 on 2x2) gathers at level 0: every rank runs the
    whole V-cycle."""
    from ..parallel.topology import local_block_dims

    levels = build_levels(params)
    dims = [(lvl.shape[0] - 2, lvl.shape[1] - 2) for lvl in levels]
    cap = sor_kernel.coarse_cycle_depth(levels) if cuda else None
    d = split_depth(dims, mesh_shape, cap)
    li, lj = local_block_dims(mesh_shape, params.i_max, params.j_max)
    return [_ShardedLevel(((li >> k) + 2, (lj >> k) + 2), dims[k],
                          lvl.dx2_inv, lvl.dy2_inv)
            for k, lvl in enumerate(levels[:d + 1])]


def make_sharded_inner(params: Params, li: int, lj: int, mesh,
                       levels=None):
    """inner_fn(rhs_neg_local_padded, n_cycles) -> delta for the refinement
    loop: n V-cycles of the sharded hierarchy from delta = 0.  `levels`
    (default ``build_levels_sharded``: coarsened while the local block
    stays at least 4 cells) ends in the level that is gathered."""
    if levels is None:
        levels = build_levels_sharded(params, li, lj)

    def inner(rhs_neg: torch.Tensor, n_cycles: int) -> torch.Tensor:
        rhs = rhs_neg.to(torch.float32)
        d = torch.zeros(levels[0].shape, dtype=torch.float32,
                        device=rhs.device)
        for _ in range(int(n_cycles)):
            d = v_cycle_sharded(d, rhs, levels, mesh)
        return d

    return inner


def make_sharded_cg_inner(params: Params, li: int, lj: int, mesh):
    """inner_fn for the refinement loop: n conjugate-gradient steps on
    B x = -b (B = -A, positive semi-definite for the Neumann Laplacian)
    over local padded blocks: the halo-exchanged level Laplacian
    (``_lap_sharded``), all-reduced dot products.  Every CG vector is
    masked to the true local interior, so pad cells and the halo ring
    contribute neither to the operator nor to the inner products; padded
    grids run.  Every scalar stays a 0-d device tensor."""
    level = build_levels_sharded(params, li, lj)[0]
    red, black, _ = _level_masks(level, mesh)
    valid = red | black

    def mask(x):
        return torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    def B(x):
        return mask(-_lap_sharded(x, level, mesh))

    def dot(a, c):
        s = torch.sum(a * c)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=mesh.group)
        return s

    def inner(rhs_neg: torch.Tensor, n_iters: int) -> torch.Tensor:
        b = mask(rhs_neg.to(torch.float32))
        x = torch.zeros(level.shape, dtype=torch.float32, device=b.device)
        r = -b
        d = r
        rs = dot(r, r)
        zero = torch.zeros_like(rs)
        for _ in range(int(n_iters)):
            Bd = B(d)
            denom = dot(d, Bd)
            alpha = torch.where(denom > 0, rs / denom, zero)
            x = x + alpha * d
            r = r - alpha * Bd
            rs_new = dot(r, r)
            beta = torch.where(rs > 0, rs_new / rs, zero)
            d = r + beta * d
            rs = rs_new
        return x

    return inner
