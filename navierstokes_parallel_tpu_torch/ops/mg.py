"""Geometric multigrid pressure solver (method="mg"), single device.

PyTorch counterpart of the single-chip half of
``navierstokes_parallel_tpu/ops/mg.py``: a cell-centered V(2,2)-cycle on the
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
  * restriction: 2x2 full-weighting average;
  * prolongation: piecewise-constant injection, written as repeats (each
    output is one input value, so it is exact);
  * coarse solve: 32 red-black sweeps on the coarsest level.

Every level keeps its ghost ring at 0, which the self-coefficient Laplacian
expects.  The cycle runs eagerly from Python, where each level costs a few
dozen small launches, down to the first level whose whole sub-hierarchy
fits one thread block's shared memory (sor_kernel.coarse_cycle_depth: 130^2
for a 2048^2 grid).  For a CUDA tensor one kernel launch runs the rest of
the cycle from there (sor_kernel.coarse_cycle), with the same bits as the
functions below; for a CPU tensor the recursion goes on to the coarsest
level.  The levels above it are still bound by the host's launch rate.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import Params
from .cuda import sor_kernel


class _Level(NamedTuple):
    shape: Tuple[int, int]   # padded (n_i + 2, n_j + 2)
    dx2_inv: float
    dy2_inv: float


def build_levels(params: Params, min_cells: int = 8) -> List[_Level]:
    """Coarsen by 2 in both directions while both stay even and >= min."""
    ni, nj = params.i_max, params.j_max
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
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


def _cycle(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
           depth: int, nu1: int, nu2: int, coarse_sweeps: int, smooth,
           tail_depth: int) -> torch.Tensor:
    """One V(nu1, nu2) cycle at `depth` with `smooth(p, rhs, level, n)` as
    the smoother; at tail_depth the rest of the cycle is one call of
    sor_kernel.coarse_cycle."""
    lvl = levels[depth]
    if depth == tail_depth:
        return sor_kernel.coarse_cycle(p, rhs, levels[depth:], nu1, nu2,
                                       coarse_sweeps)
    if depth == len(levels) - 1:
        return smooth(p, rhs, lvl, coarse_sweeps)

    p = smooth(p, rhs, lvl, nu1)
    r = rhs - _lap(p, lvl)
    coarse = levels[depth + 1]
    r_c = _restrict(r, coarse.shape)  # reads the interior only
    e_c = torch.zeros(coarse.shape, dtype=p.dtype, device=p.device)
    e_c = _cycle(e_c, r_c, levels, depth + 1, nu1, nu2, coarse_sweeps, smooth,
                 tail_depth)
    p = p + _prolong(e_c, lvl.shape)
    return smooth(p, rhs, lvl, nu2)


def v_cycle(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
            depth: int = 0, nu1: int = 2, nu2: int = 2,
            coarse_sweeps: int = 32) -> torch.Tensor:
    """One V(nu1, nu2) cycle on A p = rhs at `depth`; returns improved p.
    For a CPU tensor it calls _smooth 2 (len(levels) - depth) - 1 times.
    For a CUDA tensor it calls _smooth twice on each level above
    t = sor_kernel.coarse_cycle_depth(levels) and sor_kernel.coarse_cycle
    once, at depth t (at `depth` itself when that lies deeper)."""
    tail_depth = len(levels)
    if p.device.type == "cuda":
        tail_depth = max(depth, sor_kernel.coarse_cycle_depth(levels))
    return _cycle(p, rhs, levels, depth, nu1, nu2, coarse_sweeps, _smooth,
                  tail_depth)


def v_cycle_plain(p: torch.Tensor, rhs: torch.Tensor, levels: List[_Level],
                  nu1: int = 2, nu2: int = 2,
                  coarse_sweeps: int = 32) -> torch.Tensor:
    """v_cycle from levels[0] down on the plain smoother, whatever the
    tensor's device: the plain twin of sor_kernel.coarse_cycle."""
    def smooth(q, rhs_l, lvl, n_sweeps):
        return sor_kernel.warm_sweeps_plain(q, rhs_l, n_sweeps, 1.0,
                                            lvl.dx2_inv, lvl.dy2_inv)

    levels = [_Level(*lvl) for lvl in levels]
    return _cycle(p, rhs, levels, 0, nu1, nu2, coarse_sweeps, smooth,
                  len(levels))


def inner_v_cycle(rhs_neg: torch.Tensor, n_cycles: int,
                  params: Params) -> torch.Tensor:
    """Refinement inner: delta = (approx A^-1) rhs_neg by `n_cycles`
    V-cycles from delta = 0."""
    levels = build_levels(params)
    rhs = rhs_neg.to(torch.float32)
    d = torch.zeros(params.shape, dtype=torch.float32, device=rhs.device)
    for _ in range(int(n_cycles)):
        d = v_cycle(d, rhs, levels)
    return d
