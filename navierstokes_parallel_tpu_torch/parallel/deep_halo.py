"""Communication-avoiding sharded SOR inner stage: deep halos, K local sweeps.

Counterpart of ``navierstokes_parallel_tpu/parallel/deep_halo.py``.  Each
chunk of K sweeps exchanges a 2K-deep halo ONCE, then runs K red-black
sweeps on the shard's extended (li+2H, lj+2H) block, H = 2K, with no
communication.  Stale values at the ring's edge travel one cell per
half-sweep, so after 2K half-sweeps the central (li, lj) core carries
exactly what a sweep of the whole grid gives: the per-cell arithmetic is
the same, so the core equals the single-device sweeps bit for bit.  Cells
outside the true global interior (physical ghosts, pad cells, the zeros a
mesh-edge shard receives) are zeroed and never updated; the Neumann
boundary is folded into a self coefficient keyed on the global index.

The sweeps on the extended block are ``sor_kernel.ext_sweeps``: kernel B6
(``csrc/sor_ext.cu``) on a CUDA tensor, its plain twin on the CPU, for
``rb_sor`` and ``pallas_sor`` alike (the port's two SOR methods take one
route).  The JAX package's VMEM gate on the block size has no counterpart:
the kernel tiles any block.  Obstacle domains (``_ext_sweeps_masked``) are
not ported (ROADMAP A10).
"""

from __future__ import annotations

import torch

from ..config import Params
from ..ops.cuda import sor_kernel
from .halo import _shift_pair
from .topology import Mesh


def comm_depth(params: Params, li: int, lj: int) -> int:
    """Sweeps per cross-shard exchange, K: ``sor_comm_every`` clamped so the
    halo depth H = 2K fits in the neighbour block (single-hop exchange:
    H <= min(li, lj))."""
    return max(1, min(params.sor_comm_every, li // 2, lj // 2))


def extend_block(local: torch.Tensor, H: int, mesh: Mesh) -> torch.Tensor:
    """(li, lj) interior block -> (li+2H, lj+2H) extended block whose H-deep
    ring holds the mesh neighbours' edge strips, corners from the diagonal
    neighbour through the two-stage exchange.  Ring cells with no neighbour
    receive zeros."""
    lo_y, hi_y = _shift_pair(local[:, -H:], local[:, :H], mesh, "y")
    mid = torch.cat([lo_y, local, hi_y], dim=1)
    lo_x, hi_x = _shift_pair(mid[-H:, :], mid[:H, :], mesh, "x")
    return torch.cat([lo_x, mid, hi_x], dim=0)


def cut_ext_block(grid: torch.Tensor, origin, li: int, lj: int,
                  H: int) -> torch.Tensor:
    """The (li+2H, lj+2H) extended block of the shard at `origin` cut out of
    a whole padded grid held by one process: extended cell (a, b) is grid
    cell (ox - H + 1 + a, oy - H + 1 + b), 0 beyond the grid.  On every cell
    of the global interior it equals what `extend_block` assembles across
    ranks; the kernel checks cut a grid into blocks with it."""
    ox, oy = (int(o) for o in origin)
    ni, nj = grid.shape
    ext = grid.new_zeros((li + 2 * H, lj + 2 * H))
    a0, b0 = ox - H + 1, oy - H + 1
    lo_i, lo_j = max(a0, 0), max(b0, 0)
    hi_i, hi_j = min(a0 + ext.shape[0], ni), min(b0 + ext.shape[1], nj)
    ext[lo_i - a0:hi_i - a0, lo_j - b0:hi_j - b0] = grid[lo_i:hi_i, lo_j:hi_j]
    return ext


def make_deep_inner(params: Params, li: int, lj: int, mesh: Mesh):
    """``inner_fn(rhs_full, n_sweeps) -> delta_full`` for
    ``ops/sor._solve_pressure_refined`` on this rank's block: n_sweeps
    red-black sweeps from delta = 0 in chunks of K, one deep exchange and
    one ``ext_sweeps`` call per chunk.  rhs_full and delta_full are padded
    (li+2, lj+2) local blocks; only their interiors mean anything."""
    if params.obstacles:
        raise NotImplementedError(
            "obstacle domains on the sharded deep-halo inner "
            "(_ext_sweeps_masked) are not ported: ROADMAP A10 item 8")
    K = comm_depth(params, li, lj)
    H = 2 * K
    origin = mesh.origin(li, lj)
    f32 = torch.float32
    interior = sor_kernel.ext_masks(
        (li + 2 * H, lj + 2 * H), H, origin, params.i_max, params.j_max,
        1.0 / (params.dx * params.dx), 1.0 / (params.dy * params.dy),
        device=mesh.device)[0]
    zero = torch.zeros((), dtype=f32, device=mesh.device)

    def clean_extend(local_int: torch.Tensor) -> torch.Tensor:
        # Zero everything outside the true global interior: the
        # single-device kernels' zero ghost ring, generalized.
        return torch.where(interior, extend_block(local_int.to(f32), H, mesh),
                           zero)

    def inner_fn(rhs_full: torch.Tensor, n_sweeps: int) -> torch.Tensor:
        rhs_ext = clean_extend(rhs_full[1:-1, 1:-1])
        delta_int = torch.zeros((li, lj), dtype=f32, device=mesh.device)
        done = 0
        while done < int(n_sweeps):
            ns = min(K, int(n_sweeps) - done)
            delta_ext = sor_kernel.ext_sweeps(clean_extend(delta_int),
                                              rhs_ext, ns, origin, H, params)
            delta_int = delta_ext[H:H + li, H:H + lj]
            done += ns
        out = torch.zeros((li + 2, lj + 2), dtype=f32, device=mesh.device)
        out[1:-1, 1:-1] = delta_int
        return out

    return inner_fn
