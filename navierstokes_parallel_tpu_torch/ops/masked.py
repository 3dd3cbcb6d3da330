"""Masked pressure-Poisson solvers for flag-field obstacle domains.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/masked.py``.  The
obstacle-free solvers (ops/sor.py) impose the Neumann wall by ghost-strip
copies, which cannot express an interior geometry.  Here the same operator
is written in neighbour-weight and self-coefficient form,

    (A p)_ij = sum_d w_d (p_d - p_ij),   w_d = 1/dx^2 (or 1/dy^2) if the
                                         d-neighbour is fluid, else 0,

which drops solid (and ghost) neighbours per cell.  The convergence
contract is the reference's, L2(res) <= eps * (||p0|| + 1.5), with the L2
norm and ||p0|| normalised by the FLUID cell count (a half-blocked cavity
then thresholds as the half-height cavity does).

The weights and level geometry are the JAX module's numpy code, copied (so
equal bit for bit), cached per ``Params`` and moved to a device once per
(params, dtype, device).  The solve is the JAX module's mixed-precision
refinement, run by ops/sor.py's one f64 outer with this operator's hooks:
an f64 master and f64 defect against the masked operator, and f32
correction iterations between the checks -- K = ``sor_refine_every``
masked red-black sweeps ("rb_sor") or ``mg_cycles_per_outer`` masked V(2,2)
cycles ("mg").  Every other method is refused with JAX's ``ValueError``.  On
problem 3 each defect loses its constant mode over the fluid cells.

The JAX package has no Pallas kernel for these solvers.  On the card the
masked V-cycle (``_v_cycle_masked``) runs hand-written CUDA kernels
(ops/cuda/masked_kernel.py, ``csrc/masked_cycle.cu``) wherever its levels,
p and rhs are float32 and need no gradient, with the plain functions' bits:
a launch a half-sweep, a restriction and a prolongation on the levels too
large for one block, and one launch for the rest of the cycle.  Everything
else is plain PyTorch on every device: the CPU, float64 levels, autograd,
the masked rb_sor sweeps (``relaxed_sweeps``) and the sharded blocks'
levels.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import Params
from ..utils import timing
from . import obstacles, sor
from .cuda import masked_kernel
from .sor import SORResult, _checkerboard
from .stencils import div


class _Weights(NamedTuple):
    """Interior-shaped (i_max, j_max) float64 numpy constants."""

    w_e: np.ndarray
    w_w: np.ndarray
    w_n: np.ndarray
    w_s: np.ndarray
    diag: np.ndarray       # sum of the four weights, >= 1 dummy on solid
    fluid: np.ndarray      # bool
    n_fluid: int


def _build_weights(fluid_padded: np.ndarray, dx2_inv: float,
                   dy2_inv: float, au: np.ndarray = None,
                   av: np.ndarray = None) -> _Weights:
    """Neighbor weights from the flag field; with face-fraction arrays
    `au`/`av` (padded, ops/obstacles.py::Apertures) each fluid-fluid weight
    is additionally scaled by its open fraction — the cut-cell closure.
    The staircase booleans still gate every coupling, so solid neighbors
    and ghost cells never enter regardless of their face fraction."""
    fl = fluid_padded
    interior = fl[1:-1, 1:-1]
    w_e = np.where(interior & fl[2:, 1:-1], dx2_inv, 0.0)
    w_w = np.where(interior & fl[:-2, 1:-1], dx2_inv, 0.0)
    w_n = np.where(interior & fl[1:-1, 2:], dy2_inv, 0.0)
    w_s = np.where(interior & fl[1:-1, :-2], dy2_inv, 0.0)
    if au is not None:
        w_e = w_e * au[1:-1, 1:-1]
        w_w = w_w * au[:-2, 1:-1]
        w_n = w_n * av[1:-1, 1:-1]
        w_s = w_s * av[1:-1, :-2]
    diag = w_e + w_w + w_n + w_s
    diag = np.where(diag > 0.0, diag, 1.0)  # inert on solid cells
    return _Weights(w_e=w_e, w_w=w_w, w_n=w_n, w_s=w_s, diag=diag,
                    fluid=interior.copy(), n_fluid=int(interior.sum()))


@functools.lru_cache(maxsize=32)
def _weights(params: Params) -> _Weights:
    fl = obstacles.masks(params).fluid
    if obstacles.aperture_active(params):
        ap = obstacles.apertures(params)
        return _build_weights(fl, 1.0 / (params.dx * params.dx),
                              1.0 / (params.dy * params.dy), ap.au, ap.av)
    return _build_weights(fl, 1.0 / (params.dx * params.dx),
                          1.0 / (params.dy * params.dy))


class _DeviceWeights(NamedTuple):
    """A ``_Weights`` on a device in one dtype; ``red``/``black`` are the
    fluid cells of each colour (interior-shaped bool); ``packed`` the
    level's arrays for the masked V-cycle's kernels
    (``masked_kernel.pack_level``), on the float32 CUDA levels of
    ``device_levels`` only."""

    w_e: torch.Tensor
    w_w: torch.Tensor
    w_n: torch.Tensor
    w_s: torch.Tensor
    diag: torch.Tensor
    fluid: torch.Tensor
    n_fluid: int
    red: torch.Tensor
    black: torch.Tensor
    packed: object = None


def _on_device(w: _Weights, dtype, device,
               parity: int = 0) -> _DeviceWeights:
    """`w` in `dtype` on `device`, with its colour masks (the checkerboard
    of the 0-based interior indices, i.e. of the 1-based global ones; a
    shard's block passes its origin's `parity`)."""
    def arr(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    fluid = torch.from_numpy(w.fluid).to(device)
    return _DeviceWeights(
        w_e=arr(w.w_e), w_w=arr(w.w_w), w_n=arr(w.w_n), w_s=arr(w.w_s),
        diag=arr(w.diag), fluid=fluid, n_fluid=w.n_fluid,
        red=_checkerboard(w.fluid.shape, 0, parity, device=device) & fluid,
        black=_checkerboard(w.fluid.shape, 1, parity, device=device) & fluid)


@functools.lru_cache(maxsize=32)
def device_weights(params: Params, dtype: torch.dtype,
                   device: torch.device) -> _DeviceWeights:
    """The finest level's weights (``_weights``) in `dtype` on `device`."""
    return _on_device(_weights(params), dtype, device)


def _nb_sum(p, w: _DeviceWeights):
    """sum_d w_d * p_d on the interior of a padded array, in the JAX
    package's order (e, w, n, s)."""
    return (p[2:, 1:-1] * w.w_e + p[:-2, 1:-1] * w.w_w
            + p[1:-1, 2:] * w.w_n + p[1:-1, :-2] * w.w_s)


def masked_residual(p, rhs_int, w: _DeviceWeights):
    """(A p - rhs) on fluid cells, 0 on solid.  `p` padded, `rhs_int`
    interior-shaped."""
    r = _nb_sum(p, w) - w.diag * p[1:-1, 1:-1] - rhs_int
    return torch.where(w.fluid, r, torch.zeros((), dtype=r.dtype,
                                                device=r.device))


def _masked_half_sweep(p, rhs_int, color_fluid, one_minus_omega,
                       omega_over_diag, w: _DeviceWeights):
    """One colour's relaxed update, IN PLACE on p; returns p.  The
    relaxation constants are JAX's (1 - omega) and omega / diag, formed
    once per solve in the sweeps' dtype."""
    p_int = p[1:-1, 1:-1]
    p_new = (one_minus_omega * p_int
             + omega_over_diag * (_nb_sum(p, w) - rhs_int))
    p[1:-1, 1:-1] = torch.where(color_fluid, p_new, p_int)
    return p


def _smooth_masked(p, rhs_int, w: _DeviceWeights, n_sweeps: int, omega):
    """n_sweeps masked red-black SOR iterations, in place on p; returns p.
    No ghost fill is needed: the weights zero every ghost and solid
    neighbour term.  `omega` is a 0-d tensor of p's dtype (1 for the
    multigrid smoother); the relaxation constants are JAX's (1 - omega) and
    omega / diag, formed once here.  The colours are w's fluid cells of
    each parity (JAX's ``_color_masks``)."""
    return relaxed_sweeps(p, rhs_int, w, n_sweeps, 1.0 - omega,
                          omega / w.diag)


def relaxed_sweeps(p, rhs_int, w: _DeviceWeights, n_sweeps: int,
                   one_minus_omega, omega_over_diag):
    """``_smooth_masked`` with the relaxation constants given, for a caller
    that forms them once per solve (the sharded deep-halo inner); in place
    on p, returns p."""
    for _ in range(n_sweeps):
        for colour in (w.red, w.black):
            p = _masked_half_sweep(p, rhs_int, colour, one_minus_omega,
                                   omega_over_diag, w)
    return p


def masked_rb_iteration(p, rhs_int, omega, w: _DeviceWeights):
    """One masked red-black SOR iteration, in place on p."""
    return _smooth_masked(p, rhs_int, w, 1, omega)


def _l2_fluid(r_int, w) -> torch.Tensor:
    """sqrt(sum(r^2) / n_fluid): the L2 norm over the fluid cells."""
    return torch.sqrt(div(torch.sum(r_int * r_int), w.n_fluid))


# ---------------------------------------------------------------------------
# Masked multigrid: V(2,2) on the neighbour-weight operator per level.
# ---------------------------------------------------------------------------


class _MaskedLevel(NamedTuple):
    weights: _Weights
    red: np.ndarray        # interior bool: red fluid cells
    black: np.ndarray
    shape: Tuple[int, int]  # padded


@functools.lru_cache(maxsize=32)
def _masked_levels(params: Params, min_cells: int = 8):
    """Coarsen geometry by 2: coarse cell fluid iff ANY child is fluid
    (keeps narrow channels open so the coarse correction can travel), with
    weights rebuilt from the coarse mask at the coarse spacing.  In
    aperture mode the face fractions coarsen geometrically alongside —
    a coarse face's open fraction is the mean of its two children's — so
    every level smooths the cut-cell operator, not the staircase one."""
    fl = obstacles.masks(params).fluid
    ni, nj = params.i_max, params.j_max
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    if obstacles.aperture_active(params):
        ap = obstacles.apertures(params)
        au, av = ap.au, ap.av
    else:
        au = av = None
    levels: List[_MaskedLevel] = []
    while True:
        w = _build_weights(fl, dx2_inv, dy2_inv, au, av)
        ii, jj = np.meshgrid(np.arange(1, ni + 1), np.arange(1, nj + 1),
                             indexing="ij")
        checker = (ii + jj) % 2 == 0
        levels.append(_MaskedLevel(
            weights=w, red=checker & w.fluid, black=(~checker) & w.fluid,
            shape=(ni + 2, nj + 2)))
        if ni % 2 or nj % 2 or ni // 2 < min_cells or nj // 2 < min_cells:
            break
        blocks = fl[1:-1, 1:-1].reshape(ni // 2, 2, nj // 2, 2)
        coarse = blocks.any(axis=(1, 3))
        ni_c, nj_c = ni // 2, nj // 2
        if au is not None:
            # Coarse east face of coarse cell (I, J) = fine east faces of
            # fine cell 2I at rows 2J-1 and 2J (1-based padded indices).
            au_c = np.zeros((ni_c + 2, nj_c + 2))
            au_c[1 : ni_c + 1, 1 : nj_c + 1] = 0.5 * (
                au[2 : ni + 1 : 2, 1 : nj : 2]
                + au[2 : ni + 1 : 2, 2 : nj + 1 : 2])
            av_c = np.zeros((ni_c + 2, nj_c + 2))
            av_c[1 : ni_c + 1, 1 : nj_c + 1] = 0.5 * (
                av[1 : ni : 2, 2 : nj + 1 : 2]
                + av[2 : ni + 1 : 2, 2 : nj + 1 : 2])
            au, av = au_c, av_c
        ni, nj = ni_c, nj_c
        dx2_inv /= 4.0
        dy2_inv /= 4.0
        fl = np.zeros((ni + 2, nj + 2), bool)
        fl[1:-1, 1:-1] = coarse
    return tuple(levels)


@functools.lru_cache(maxsize=32)
def device_levels(params: Params, dtype: torch.dtype,
                  device: torch.device) -> Tuple[_DeviceWeights, ...]:
    """Every level of ``_masked_levels`` in `dtype` on `device`; float32
    levels on a CUDA device carry their kernel arrays (``packed``)."""
    levels = tuple(_on_device(lvl.weights, dtype, device)
                   for lvl in _masked_levels(params))
    if dtype == torch.float32 and torch.device(device).type == "cuda":
        levels = tuple(w._replace(packed=masked_kernel.pack_level(w))
                       for w in levels)
    return levels


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """0.25 x the 2x2 block sums of an interior-shaped array, summed
    pairwise row by row (ops/mg.py::_restrict's order, XLA's reduce_window
    on the CPU)."""
    return 0.25 * ((r[0::2, 0::2] + r[0::2, 1::2])
                   + (r[1::2, 0::2] + r[1::2, 1::2]))


def _v_cycle_masked(p, rhs_int, levels, depth=0, nu1=2, nu2=2,
                    coarse_sweeps=32, one=None):
    """One masked V(nu1, nu2) cycle on `levels` (``device_levels``) from
    p, in place on p: the coarsest level takes `coarse_sweeps` smoothing
    iterations; residuals restrict by full weighting and are zeroed on
    coarse-solid cells, corrections prolong by injection and are zeroed on
    fine-solid cells.  Each level's work runs in the span
    ``masked.level<depth>``, which holds the next level's: a level's own
    time is its span less its child.

    Where ``masked_kernel.usable`` holds (float32 CUDA levels, p and rhs
    float32 needing no gradient) the cycle is ``_v_cycle_kernel``'s, bit
    for bit this one, and counts in ``masked.fused_cycles``."""
    w = levels[depth]
    if masked_kernel.usable(p, rhs_int, w):
        timing.count("masked.fused_cycles")
        shapes = tuple(tuple(lv.fluid.shape) for lv in levels)
        return _v_cycle_kernel(p, rhs_int.contiguous(), levels, depth, nu1,
                               nu2, coarse_sweeps,
                               masked_kernel.one_block_depth(shapes))
    if one is None:
        one = torch.ones((), dtype=p.dtype, device=p.device)
    with timing.span(f"masked.level{depth}"):
        if depth == len(levels) - 1:
            return _smooth_masked(p, rhs_int, w, coarse_sweeps, one)
        p = _smooth_masked(p, rhs_int, w, nu1, one)
        r = -masked_residual(p, rhs_int, w)
        coarse = levels[depth + 1]
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        r_c = torch.where(coarse.fluid, _restrict(r), zero)
        ni_c, nj_c = coarse.fluid.shape
        e_c = torch.zeros((ni_c + 2, nj_c + 2), dtype=p.dtype,
                          device=p.device)
        e_c = _v_cycle_masked(e_c, r_c, levels, depth + 1, nu1, nu2,
                              coarse_sweeps, one)
        up = e_c[1:-1, 1:-1].repeat_interleave(2, 0).repeat_interleave(2, 1)
        p[1:-1, 1:-1] += torch.where(w.fluid, up, zero)
        return _smooth_masked(p, rhs_int, w, nu2, one)


def _v_cycle_kernel(p, rhs_int, levels, depth, nu1, nu2, coarse_sweeps,
                    block_depth):
    """``_v_cycle_masked``'s cycle on the card, in place on p: from
    `block_depth` (``masked_kernel.one_block_depth``) one launch of
    ``masked_kernel.cycle`` runs the rest of the cycle in one block; above
    it a level's sweeps take a launch a half-sweep, its residual's
    restriction one and the prolongation one (11 launches a cycle at
    440 x 82).  Spans as ``_v_cycle_masked``'s."""
    w = levels[depth].packed
    with timing.span(f"masked.level{depth}"):
        if depth >= block_depth:
            return masked_kernel.cycle(
                p, rhs_int, [lv.packed for lv in levels[depth:]], nu1, nu2,
                coarse_sweeps)
        if depth == len(levels) - 1:
            return masked_kernel.half_sweeps(p, rhs_int, w, coarse_sweeps)
        masked_kernel.half_sweeps(p, rhs_int, w, nu1)
        e_c, r_c = masked_kernel.restrict(p, rhs_int, w,
                                          levels[depth + 1].packed)
        _v_cycle_kernel(e_c, r_c, levels, depth + 1, nu1, nu2, coarse_sweeps,
                        block_depth)
        masked_kernel.prolong(p, e_c, w)
        return masked_kernel.half_sweeps(p, rhs_int, w, nu2)


# ---------------------------------------------------------------------------
# The masked V-cycle on the blocks of a process mesh (the gspmd backend's
# obstacle runs by mg, and the mesh gradient's).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _block_levels(params: Params, mesh_shape, coords, depth: int,
                  device: torch.device) -> Tuple[_DeviceWeights, ...]:
    """Levels 0..depth of ``_masked_levels`` cut to the rank's interior
    block (each level splits into equal blocks over the mesh), in f32 on
    `device`, with the block's colour parity."""
    px, py = mesh_shape
    out = []
    for lvl in _masked_levels(params)[:depth + 1]:
        w = lvl.weights
        li, lj = w.fluid.shape[0] // px, w.fluid.shape[1] // py
        ox, oy = coords[0] * li, coords[1] * lj

        def cut(a):
            return np.ascontiguousarray(a[ox:ox + li, oy:oy + lj])

        block = _Weights(*(cut(a) for a in w[:6]),
                         n_fluid=int(cut(w.fluid).sum()))
        out.append(_on_device(block, torch.float32, device, (ox + oy) % 2))
    return tuple(out)


def make_sharded_mg_inner(params: Params, li: int, lj: int, mesh):
    """The refinement's inner_fn(rhs_neg_full, n) -> delta on this rank's
    (li + 2, lj + 2) block: n masked V(2,2) cycles of ``_v_cycle_masked``
    over the levels of ``_masked_levels``, from delta = 0.  A level runs
    on blocks while it splits into equal, even blocks over the mesh
    (``mg.split_depth``): its weights cut per rank as the fine level's
    are, each half-sweep of the smoother after a halo exchange, the
    residual on the exchanged block, restriction and prolongation local.
    From the first level that does not split (level 0 on a grid that does
    not divide the mesh) the level is all-gathered and every rank finishes
    the cycle with ``_v_cycle_masked`` from that depth.  Every operation
    is the one-device cycle's on the same cells, so the cores are its
    bits."""
    from ..parallel import halo
    from .mg import cut_interior, gather_interior, split_depth

    f32 = torch.float32
    device = mesh.device
    dims = [lvl.weights.fluid.shape for lvl in _masked_levels(params)]
    depth = split_depth(dims, mesh.shape)
    blocks = _block_levels(params, mesh.shape, mesh.coords, depth, device)
    whole = device_levels(params, f32, device)
    one = torch.ones((), dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)

    def smooth(p, rhs, w, n):
        # _smooth_masked's sweeps, each half-sweep after an exchange.
        one_minus_omega, omega_over_diag = 1.0 - one, one / w.diag
        for _ in range(n):
            for colour in (w.red, w.black):
                p = _masked_half_sweep(halo.exchange_halo(p, mesh), rhs,
                                       colour, one_minus_omega,
                                       omega_over_diag, w)
        return p

    def cycle(p, rhs, k, nu1=2, nu2=2):
        bi, bj = p.shape[0] - 2, p.shape[1] - 2
        if k == depth:
            pg = p.new_zeros((dims[k][0] + 2, dims[k][1] + 2))
            pg[1:-1, 1:-1] = gather_interior(p[1:-1, 1:-1], mesh, dims[k])
            pg = _v_cycle_masked(pg, gather_interior(rhs, mesh, dims[k]),
                                 whole, k, one=one)
            out = torch.zeros_like(p)
            out[1:-1, 1:-1] = cut_interior(pg[1:-1, 1:-1], mesh, bi, bj)
            return out
        w = blocks[k]
        p = smooth(p, rhs, w, nu1)
        r = -masked_residual(halo.exchange_halo(p, mesh), rhs, w)
        r_c = torch.where(blocks[k + 1].fluid, _restrict(r), zero)
        e_c = cycle(p.new_zeros((bi // 2 + 2, bj // 2 + 2)), r_c, k + 1)
        up = e_c[1:-1, 1:-1].repeat_interleave(2, 0).repeat_interleave(2, 1)
        p[1:-1, 1:-1] += torch.where(w.fluid, up, zero)
        return smooth(p, rhs, w, nu2)

    def inner(rhs_full: torch.Tensor, n: int) -> torch.Tensor:
        rhs = rhs_full[1:-1, 1:-1].to(f32)
        d = torch.zeros((li + 2, lj + 2), dtype=f32, device=device)
        for _ in range(int(n)):
            d = cycle(d, rhs, 0)
        return d

    return inner


# ---------------------------------------------------------------------------
# The one device's solve: ops/sor.py's f64 outer over the masked operator.
# ---------------------------------------------------------------------------


def solve_pressure_masked(p: torch.Tensor, rhs: torch.Tensor, params: Params,
                          method: str = "rb_sor") -> SORResult:
    """The masked solve: ``sor._solve_pressure_refined`` (an f64 master
    and exact f64 defect, f32 corrections between the checks) with the
    masked operator's hooks, as the sharded backend's obstacle branch
    passes them on a block (parallel/sharded.py::_sharded_pressure_solve):
    the masked defect (``masked_residual``), the fluid cells as the valid
    mask, the fluid norm (``_l2_fluid``) and, on problem 3, the fluid mean.
    The inner stage is K masked red-black sweeps (rb_sor) or
    ``mg_cycles_per_outer`` masked V-cycles (mg) from delta = 0, counted in
    ``masked.sweeps`` or ``masked.cycles``; the spans and the other
    counters are the outer's (``pressure.*``).  The returned p keeps the
    ghost ring of the input (the masked operator never reads it)."""
    device = p.device
    f32 = torch.float32
    if method == "rb_sor":
        K = params.sor_refine_every
        w32 = device_weights(params, f32, device)
        omega32 = torch.tensor(params.omega, dtype=f32, device=device)

        def inner(rhs_full, n_inner):
            timing.count("masked.sweeps", n_inner)
            d = torch.zeros(params.shape, dtype=f32, device=device)
            return _smooth_masked(d, rhs_full[1:-1, 1:-1], w32, n_inner,
                                  omega32)
    elif method == "mg":
        K = params.mg_cycles_per_outer
        levels = device_levels(params, f32, device)

        def inner(rhs_full, n_inner):
            timing.count("masked.cycles", n_inner)
            # Outside the cycles, which the kernels take contiguous.
            rhs_int = rhs_full[1:-1, 1:-1].contiguous()
            d = torch.zeros(params.shape, dtype=f32, device=device)
            for _ in range(n_inner):
                d = _v_cycle_masked(d, rhs_int, levels)
            return d
    else:
        raise ValueError(
            f"method {method!r} does not support obstacle domains — use "
            "rb_sor or mg (fft transforms are separable, cg/pallas kernels "
            "are unmasked)")
    w64 = device_weights(params, torch.float64, device)
    return sor._solve_pressure_refined(
        p, rhs, params.replace(sor_refine_every=max(1, K),
                               outer_precision="float64"),
        inner_fn=inner, ghost_fn=lambda q: q, valid_mask=w64.fluid,
        l2_fn=lambda r: _l2_fluid(r, w64),
        mean_fn=lambda r: div(torch.sum(r), w64.n_fluid),
        residual_fn=lambda q, r: masked_residual(q, r, w64))
