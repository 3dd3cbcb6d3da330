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
the kernel tiles any block.

Obstacle domains (``Params.obstacles``) take the masked sweeps instead
(``_ext_sweeps_masked``, plain PyTorch on every device, as the JAX
package's are jnp): B6 carries no fluid weights.  The per-cell neighbour
weights of the masked operator (ops/masked.py) are formed on the extended
block from the global fluid mask cut at the block's extent, and the
sweeps are ops/masked.py's, in its neighbour order (e, w, n, s) and with
its (1 - omega) and omega / diag tensors, formed once per solve.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as nnf

from ..config import Params
from ..ops import masked, obstacles
from ..ops.cuda import sor_kernel
from ..ops.sor import _checkerboard
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


@functools.lru_cache(maxsize=32)
def _ext_masked_weights(params: Params, ext_shape, H: int, origin,
                        mesh_shape, li: int, lj: int,
                        device: torch.device) -> masked._DeviceWeights:
    """The masked operator's weights on an extended block, in the JAX
    package's ``_ext_masked_weights`` arithmetic: f32 weights where a cell
    and its neighbour are fluid (ops/obstacles.py::masks), each times its
    face fraction under the cut-cell closure, the diagonal their f32 sum (1
    on cells without a fluid neighbour).  The global constants are cut at
    the block's extent (``cover``: global index g at position g + H of an
    array spanning the padded extent and H + 1 more on each side; extended
    cell (a, b) is global (ox - H + 1 + a, oy - H + 1 + b)).  ``red`` /
    ``black``: the fluid cells of each global parity.  Built once per
    configuration and block."""
    f32 = torch.float32
    rows, cols = ext_shape
    ox, oy = origin
    px, py = mesh_shape

    def cover(arr_np, di=0, dj=0):
        # The global constant at (gi + di, gj + dj) of every extended cell.
        full = np.zeros((px * li + 2 * H + 2, py * lj + 2 * H + 2),
                        arr_np.dtype)
        full[H:H + arr_np.shape[0], H:H + arr_np.shape[1]] = arr_np
        a0, b0 = ox + 1 + di, oy + 1 + dj
        return torch.from_numpy(np.ascontiguousarray(
            full[a0:a0 + rows, b0:b0 + cols])).to(device)

    fl = obstacles.masks(params).fluid
    fluid = cover(fl)
    zero = torch.zeros((), dtype=f32, device=device)
    dx2_inv = torch.tensor(1.0 / (params.dx * params.dx), dtype=f32,
                           device=device)
    dy2_inv = torch.tensor(1.0 / (params.dy * params.dy), dtype=f32,
                           device=device)
    w_e = torch.where(fluid & cover(fl, 1, 0), dx2_inv, zero)
    w_w = torch.where(fluid & cover(fl, -1, 0), dx2_inv, zero)
    w_n = torch.where(fluid & cover(fl, 0, 1), dy2_inv, zero)
    w_s = torch.where(fluid & cover(fl, 0, -1), dy2_inv, zero)
    if obstacles.aperture_active(params):
        ap = obstacles.apertures(params)
        w_e = w_e * cover(ap.au).to(f32)
        w_w = w_w * cover(ap.au, -1, 0).to(f32)
        w_n = w_n * cover(ap.av).to(f32)
        w_s = w_s * cover(ap.av, 0, -1).to(f32)
    diag = w_e + w_w + w_n + w_s
    diag = torch.where(diag > 0.0, diag, torch.ones((), dtype=f32,
                                                    device=device))
    return masked._DeviceWeights(
        w_e=w_e, w_w=w_w, w_n=w_n, w_s=w_s, diag=diag, fluid=fluid,
        n_fluid=int(fluid.sum()),
        red=fluid & _checkerboard(ext_shape, 0, ox + oy, device=device),
        black=fluid & _checkerboard(ext_shape, 1, ox + oy, device=device))


def _ext_sweeps_masked(delta_ext: torch.Tensor, rhs_ext: torch.Tensor,
                       ns: int, w: masked._DeviceWeights, one_minus_omega,
                       omega_over_diag) -> torch.Tensor:
    """ns masked red-black sweeps on the extended block: ops/masked.py's
    sweeps on the block bordered by one ring of zeros (where the JAX
    package's rolls wrap around; either way only cells within 2 ns of the
    block's edge differ, and the core is exact); returns a new block."""
    return masked.relaxed_sweeps(nnf.pad(delta_ext, (1, 1, 1, 1)), rhs_ext,
                                 w, int(ns), one_minus_omega,
                                 omega_over_diag)[1:-1, 1:-1]


def make_deep_inner(params: Params, li: int, lj: int, mesh: Mesh):
    """``inner_fn(rhs_full, n_sweeps) -> delta_full`` for
    ``ops/sor._solve_pressure_refined`` on this rank's block: n_sweeps
    red-black sweeps from delta = 0 in chunks of K, one deep exchange and
    one ``ext_sweeps`` call per chunk (the masked sweeps on an obstacle
    domain).  rhs_full and delta_full are padded (li+2, lj+2) local blocks;
    only their interiors mean anything."""
    K = comm_depth(params, li, lj)
    H = 2 * K
    origin = mesh.origin(li, lj)
    f32 = torch.float32
    ext_shape = (li + 2 * H, lj + 2 * H)
    interior = sor_kernel.ext_masks(
        ext_shape, H, origin, params.i_max, params.j_max,
        1.0 / (params.dx * params.dx), 1.0 / (params.dy * params.dy),
        device=mesh.device)[0]
    zero = torch.zeros((), dtype=f32, device=mesh.device)
    if params.obstacles:
        w = _ext_masked_weights(params, ext_shape, H, origin, mesh.shape, li,
                                lj, mesh.device)
        omega = torch.tensor(params.omega, dtype=f32, device=mesh.device)
        one_minus_omega, omega_over_diag = 1.0 - omega, omega / w.diag

        def sweeps(delta_ext, rhs_ext, ns):
            return _ext_sweeps_masked(delta_ext, rhs_ext, ns, w,
                                      one_minus_omega, omega_over_diag)
    else:
        def sweeps(delta_ext, rhs_ext, ns):
            return sor_kernel.ext_sweeps(delta_ext, rhs_ext, ns, origin, H,
                                         params)

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
            delta_ext = sweeps(clean_extend(delta_int), rhs_ext, ns)
            delta_int = delta_ext[H:H + li, H:H + lj]
            done += ns
        out = torch.zeros((li + 2, lj + 2), dtype=f32, device=mesh.device)
        out[1:-1, 1:-1] = delta_int
        return out

    return inner_fn
