"""Red-black SOR sweeps: the hand-written CUDA kernels and their plain twins.

Counterpart of ``navierstokes_parallel_tpu/ops/pallas/sor_kernel.py``:

  * ``whole_grid_sweeps`` (``_make_kernel`` through ``_sweeps_call``
    there): n red-black SOR sweeps on A delta = rhs_neg from delta = 0 over
    the padded grid, in chunks of K sweeps, each one launch of the
    temporal-blocked tile (``csrc/nsp_sor_tile.cuh``) whose shape
    ``whole_grid_tile`` picks from the grid's size (the C entry point of
    ``inner_sweeps_tiled``, ``csrc/sor_tiled.cu``, under its own counter);
  * ``inner_sweeps_tiled`` (``_make_tiled_kernel`` / ``_make_tiled_kernel_db``
    through ``inner_sweeps_tiled``): the same sweeps in chunks of K, each
    chunk one launch over tiles that carry a 2K-deep halo and sweep K times
    in shared memory (``csrc/sor_tiled.cu``), the tile's rows the caller's;
  * ``inner_sweeps_compressed`` (``_make_compressed_kernel`` through
    ``inner_sweeps_compressed``): the same sweeps on the red and the black
    cells compacted into two half-width arrays, the compaction and the
    expansion one PyTorch gather each, the sweeps
    (``compressed_colour_sweeps``) one launch of B1's tile per chunk over
    the compacted arrays (``csrc/sor_compressed.cu``);
  * ``inner_sweeps`` routes between those three as the JAX package's
    ``inner_sweeps`` does: the tiled kernel where the grid exceeds the JAX
    whole-grid budget, else the compressed one when ``USE_COMPRESSED`` is
    set and the padded width is even, else the whole-grid one;
  * ``warm_sweeps`` (``_make_kernel`` with ``warm_start=True``): n
    red-black sweeps from a given p0, with omega and the level's dx^2 /
    dy^2 per call, the multigrid smoother (ops/mg.py): one launch of the
    tile per 8 sweeps, with a halo of twice the launch's sweeps
    (``csrc/sor.cu``);
  * ``coarse_cycle`` (the same TPU body, as ops/mg.py::v_cycle runs it on
    its coarse levels): one whole V-cycle on the levels whose p and rhs fit
    one block's shared memory together, in one launch
    (``csrc/mg_cycle.cu``); ``coarse_cycle_depth`` says from which level;
  * ``ext_sweeps`` (``parallel/deep_halo.py::_make_ext_kernel`` through
    ``_ext_sweeps_call``): ns <= H / 2 sweeps from a given delta on one
    shard's extended block, masks and parity from the shard's global
    origin, the sharded deep-halo inner (parallel/deep_halo.py;
    ``csrc/sor_ext.cu``).

All fold the Neumann boundary into a per-cell self coefficient, and all
give the same bits: every updated cell goes through the same expression on
the same neighbour values.  The kernels' source notes say what bounds them
on the card.  Each wrapper dispatches on the tensor's device: a CPU tensor
goes to its ``*_plain`` twin; a CUDA tensor launches the kernel or raises.

``whole_grid_sweeps_simple`` and ``warm_sweeps_simple`` are the first
kernels of ``whole_grid_sweeps`` and ``warm_sweeps`` (one launch per
half-sweep on the grid in device memory, ``csrc/sor.cu``), and
``inner_sweeps_compressed_simple`` the first of ``inner_sweeps_compressed``
(one launch per half-sweep on the compacted arrays).  No path calls them:
they share nothing with the tile but the cell update, so the smoke test and
the GPU tests hold every other sweep kernel against them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import Params
from . import _build

# Kernel launches, one per call of a wrapper that launches (each call runs
# all its launches in C): whole_grid_sweeps counts in LAUNCHES,
# inner_sweeps_tiled in TILED_LAUNCHES, compressed_colour_sweeps (the
# kernel of inner_sweeps_compressed) in COMPRESSED_LAUNCHES, warm_sweeps in
# WARM_LAUNCHES, coarse_cycle in CYCLE_LAUNCHES and ext_sweeps in
# EXT_LAUNCHES.
LAUNCHES = 0
TILED_LAUNCHES = 0
COMPRESSED_LAUNCHES = 0
WARM_LAUNCHES = 0
CYCLE_LAUNCHES = 0
EXT_LAUNCHES = 0

# The tiled route (JAX TILE_ROWS, SWEEPS_PER_CHUNK).  A tile writes
# TILE_ROWS x TILE_COLS cells per chunk of SWEEPS_PER_CHUNK = K sweeps and
# carries a halo of 2K cells on each side; the CLI's tile-size positional
# sets TILE_ROWS (set_default_tile).  The plain twin cuts full-width strips
# of TILE_ROWS rows, as the TPU kernel does; the CUDA kernel cuts 2-D tiles.
TILE_ROWS = 64
TILE_COLS = 64
SWEEPS_PER_CHUNK = 8
# Shared memory one block may use on an H100 (232,448 bytes): the tile of
# the tiled and extended-block kernels holds delta of its haloed tile there
# (rhs stays in registers or device memory); the coarse cycle holds p and
# rhs of its levels there.
MAX_SHARED_BYTES = 232448
# The whole-grid kernel's tiles, (rows, columns, sweeps per chunk), largest
# first, each with a kernel compiled for its shape
# (csrc/nsp_sor_tile.cuh::kHotShapes), and the fewest blocks a launch should
# have, one per SM of an H100: whole_grid_tile takes the first tile that
# cuts the grid into that many.
WHOLE_GRID_TILES = ((64, 64, 8), (32, 32, 8))
WHOLE_GRID_MIN_BLOCKS = 132
# The smoother's tile route: the tile, and the most sweeps of one launch
# (its halo is twice its sweeps).  Two sweeps of a 32 x 64 tile (a V-cycle's
# pre- or post-smoothing) have a kernel compiled for their shape.
WARM_TILE = (32, 64)
WARM_SWEEPS_PER_LAUNCH = 8
# The most levels one coarse cycle takes (csrc/mg_cycle.cu::kMaxLevels).
COARSE_CYCLE_MAX_LEVELS = 8
# None: the tiled route where the grid exceeds WHOLE_GRID_BUDGET_BYTES;
# True / False force it on or off (JAX PREFER_TILED_DMA).
PREFER_TILED = None
# The JAX package's whole-grid VMEM budget (fits_in_vmem), kept as the
# route boundary.
WHOLE_GRID_BUDGET_BYTES = 48 * 1024 * 1024
# The colour-compressed kernel instead of the whole-grid one (JAX
# USE_COMPRESSED; off there, as here).
USE_COMPRESSED = False
# The extended-block kernel's tile: EXT_TILE_ROWS x TILE_COLS cells written
# per block, with a halo of 2 ns cells for ns sweeps per call.
EXT_TILE_ROWS = 64


def warm_constants(omega: float, dx2_inv: float, dy2_inv: float):
    """(1 - omega, coef, dx2_inv, dy2_inv) as Python doubles; each is
    rounded to f32 once where it meets the f32 field, as the Pallas kernel
    bakes its Python-float constants."""
    omega, dx2_inv, dy2_inv = float(omega), float(dx2_inv), float(dy2_inv)
    coef = omega / (2.0 * (dx2_inv + dy2_inv))
    return 1.0 - omega, coef, dx2_inv, dy2_inv


def sweep_constants(params: Params):
    """warm_constants of the configuration's omega and grid spacing."""
    return warm_constants(params.omega, 1.0 / (params.dx * params.dx),
                          1.0 / (params.dy * params.dy))


def _masks(ii, jj, i_max: int, j_max: int, dx2_inv: float, dy2_inv: float):
    """(red, black, self_coef) of the cells at padded indices (ii, jj),
    broadcast against each other: parity (ii + jj) & 1 on the padded (=
    1-based interior) indices, red = 0; the Neumann boundary folded in (the
    ghost neighbour contributes 0, as the ring is never written, and
    self_coef * d adds the mirrored one)."""
    f32 = torch.float32
    interior = (ii >= 1) & (ii <= i_max) & (jj >= 1) & (jj <= j_max)
    par = (ii + jj) & 1
    self_coef = (((ii == 1).to(f32) + (ii == i_max).to(f32)) * dx2_inv
                 + ((jj == 1).to(f32) + (jj == j_max).to(f32)) * dy2_inv)
    return interior & (par == 0), interior & (par == 1), self_coef


def _half_sweep(d, rhs, mask, self_coef, constants):
    """One half-sweep of the cells in `mask`, neighbours by circular rolls
    of d (the wrap lands only where no updated cell reads it)."""
    one_minus_omega, coef, dx2_inv, dy2_inv = constants
    nb = ((torch.roll(d, 1, 0) + torch.roll(d, -1, 0)) * dx2_inv
          + (torch.roll(d, 1, 1) + torch.roll(d, -1, 1)) * dy2_inv
          + d * self_coef)
    d_new = one_minus_omega * d + coef * (nb - rhs)
    return torch.where(mask, d_new, d)


def _sweeps_plain(d: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                  constants) -> torch.Tensor:
    """The kernels' formulation in plain PyTorch, n red-black sweeps from
    the f32 field d: rolls of the whole padded field (interior cells next
    to the ghost ring read the ring as given), masks, self coefficient, one
    Python loop iteration per sweep.  With omega = 1 the (1 - omega) * d
    term is still computed, as the Pallas body does."""
    ni, nj = d.shape
    ii = torch.arange(ni, device=d.device).view(ni, 1)
    jj = torch.arange(nj, device=d.device).view(1, nj)
    red, black, self_coef = _masks(ii, jj, ni - 2, nj - 2, *constants[2:])
    for _ in range(int(n_sweeps)):
        d = _half_sweep(d, rhs, red, self_coef, constants)
        d = _half_sweep(d, rhs, black, self_coef, constants)
    return d


def inner_sweeps_plain(rhs_neg: torch.Tensor, n_sweeps: int,
                       params: Params) -> torch.Tensor:
    """whole_grid_sweeps in plain PyTorch: sweeps from delta = 0."""
    d = torch.zeros(rhs_neg.shape, dtype=torch.float32, device=rhs_neg.device)
    return _sweeps_plain(d, rhs_neg.to(torch.float32), n_sweeps,
                         sweep_constants(params))


def warm_sweeps_plain(p: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                      omega: float, dx2_inv: float,
                      dy2_inv: float) -> torch.Tensor:
    """warm_sweeps in plain PyTorch: sweeps from p (which is not modified)."""
    return _sweeps_plain(p.to(torch.float32, copy=True),
                         rhs.to(torch.float32), n_sweeps,
                         warm_constants(omega, dx2_inv, dy2_inv))


def check_inputs(rhs_neg: torch.Tensor, n_sweeps: int, params: Params) -> None:
    """Raise on anything the CUDA kernels of inner_sweeps do not take."""
    if rhs_neg.dtype != torch.float32:
        raise TypeError(f"SOR kernel takes float32, got {rhs_neg.dtype}")
    if tuple(rhs_neg.shape) != params.shape:
        raise ValueError(f"SOR kernel takes the padded shape {params.shape}, "
                         f"got {tuple(rhs_neg.shape)}")
    if not rhs_neg.is_contiguous():
        raise ValueError("SOR kernel takes a contiguous rhs")
    if int(n_sweeps) < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")


def _cuda_tensor(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain twin's), True for a CUDA one;
    raises for any other device: no silent fallback."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no SOR kernel for device {x.device}")
    return True


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA tensor only, got {x.device}")


def tile_blocks(shape, tile_rows: int, tile_cols: int) -> int:
    """Blocks of one launch of the tile over a grid of `shape`."""
    return -(-shape[0] // tile_rows) * -(-shape[1] // tile_cols)


def whole_grid_tile(shape):
    """(tile rows, tile columns, sweeps per chunk) of whole_grid_sweeps on a
    padded grid of `shape`: the first of WHOLE_GRID_TILES that cuts it into
    at least WHOLE_GRID_MIN_BLOCKS blocks, else the last.  A 258^2 grid is
    25 tiles of 64 x 64, too few for the card, and 81 of 32 x 32; from
    770^2 up the 64 x 64 tile fills it with fewer redundant halo updates."""
    for tile in WHOLE_GRID_TILES:
        if tile_blocks(shape, *tile[:2]) >= WHOLE_GRID_MIN_BLOCKS:
            return tile
    return WHOLE_GRID_TILES[-1]


def _tile_sweeps_from_zero(rhs_neg: torch.Tensor, n_sweeps: int,
                           params: Params, rows: int, cols: int,
                           K: int) -> torch.Tensor:
    """n_sweeps sweeps from delta = 0 on the card in chunks of K, one launch
    of the rows x cols tile per chunk (one for n_sweeps = 0)."""
    ni, nj = params.shape
    # Each chunk reads one buffer and writes every cell of the other, the
    # ghost ring's zeros included; the first reads none (delta = 0), so
    # neither buffer needs zeroing.
    d = torch.empty((ni, nj), dtype=torch.float32, device=rhs_neg.device)
    scratch = torch.empty_like(d)
    status = _build.load().nsp_sor_tiled_sweeps(
        d.data_ptr(), scratch.data_ptr(), rhs_neg.data_ptr(), ni, nj,
        int(n_sweeps), rows, cols, K, *sweep_constants(params),
        *_build.device_and_stream(rhs_neg))
    _build.check_status(status, "nsp_sor_tiled_sweeps")
    n_chunks = max(1, -(-int(n_sweeps) // K))
    return scratch if n_chunks % 2 else d


def whole_grid_sweeps(rhs_neg: torch.Tensor, n_sweeps: int,
                      params: Params) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A delta = rhs_neg from delta = 0,
    over the whole padded grid: the plain version for a CPU tensor, the
    CUDA kernel (one launch of whole_grid_tile's tile per chunk of sweeps,
    one for n_sweeps = 0) for a CUDA one."""
    global LAUNCHES
    if not _cuda_tensor(rhs_neg):
        return inner_sweeps_plain(rhs_neg, n_sweeps, params)
    check_inputs(rhs_neg, n_sweeps, params)
    out = _tile_sweeps_from_zero(rhs_neg, n_sweeps, params,
                                 *whole_grid_tile(params.shape))
    LAUNCHES += 1
    return out


def whole_grid_sweeps_simple(rhs_neg: torch.Tensor, n_sweeps: int,
                             params: Params) -> torch.Tensor:
    """whole_grid_sweeps by its first kernel, one launch per half-sweep on
    the grid in device memory: the yardstick the other sweep kernels are
    held against on the card, on no path.  CUDA tensors only."""
    _require_cuda(rhs_neg, "whole_grid_sweeps_simple")
    check_inputs(rhs_neg, n_sweeps, params)
    lib = _build.load()
    ni, nj = params.shape
    # The kernel never writes the ghost ring, which must stay 0.
    d = torch.zeros((ni, nj), dtype=torch.float32, device=rhs_neg.device)
    status = lib.nsp_sor_sweeps_simple(
        d.data_ptr(), rhs_neg.data_ptr(), ni, nj, int(n_sweeps),
        *sweep_constants(params), *_build.device_and_stream(rhs_neg))
    _build.check_status(status, "nsp_sor_sweeps_simple")
    return d


# --- the route ---------------------------------------------------------------

def whole_grid_fits(shape) -> bool:
    """The JAX package's whole-grid budget (fits_in_vmem, with its
    vmem_bytes_required), verbatim: delta + rhs + one temporary, each padded
    to (8, 128) tiles of f32, within 48 MiB.  It only draws the route
    boundary here; nothing of the CUDA kernels needs it."""
    ni, nj = shape

    def pad(a, m):
        return -(-a // m) * m

    return 3 * pad(ni, 8) * pad(nj, 128) * 4 <= WHOLE_GRID_BUDGET_BYTES


def route(params: Params) -> str:
    """'tiled', 'compressed' or 'whole': the kernel inner_sweeps takes, in
    the JAX package's order."""
    tiled = (not whole_grid_fits(params.shape) if PREFER_TILED is None
             else PREFER_TILED)
    if tiled:
        return "tiled"
    if USE_COMPRESSED and params.shape[1] % 2 == 0:
        return "compressed"
    return "whole"


def inner_sweeps(rhs_neg: torch.Tensor, n_sweeps: int,
                 params: Params) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A delta = rhs_neg from delta = 0,
    the refinement solver's inner stage, by the kernel `route` picks (its
    plain twin for a CPU tensor)."""
    which = route(params)
    if which == "tiled":
        return inner_sweeps_tiled(rhs_neg, n_sweeps, params)
    if which == "compressed":
        return inner_sweeps_compressed(rhs_neg, n_sweeps, params)
    return whole_grid_sweeps(rhs_neg, n_sweeps, params)


# --- the tiled kernel ----------------------------------------------------------

def tiled_shared_bytes(tile_rows: int, sweeps_per_chunk: int,
                       tile_cols: int = TILE_COLS) -> int:
    """Shared memory of one block of the tiled kernel: delta, f32, over the
    tile and its 2K-deep halo on each side (csrc/nsp_sor_tile.cuh)."""
    halo = 2 * sweeps_per_chunk
    return 4 * (tile_rows + 2 * halo) * (tile_cols + 2 * halo)


def tile_updates_per_cell(tile_rows: int, tile_cols: int, ns: int) -> float:
    """Cell updates per written cell and sweep of one tile away from the
    boundary: half-sweep h updates the cells of its colour in the centre
    widened by 2 ns - 1 - h (csrc/nsp_sor_tile.cuh), half of the box."""
    ns = int(ns)
    if ns == 0:
        return 0.0
    boxes = sum((tile_rows + 2 * w) * (tile_cols + 2 * w)
                for w in range(2 * ns))
    return boxes / 2 / ns / (tile_rows * tile_cols)


def tile_report(tile_rows: int, tile_cols: int, halo: int,
                compact: bool = False) -> dict:
    """The tile's layout on the current card (CUDA only): shared rows and
    columns, rows per thread (0: rhs read from device memory at each
    update), threads per block, shared bytes, resident blocks per SM and
    registers per thread, as the kernel library reports them; compact: of
    the kernel that reads and writes colour-compacted arrays (B5)."""
    out = (ctypes.c_int * 7)()
    name = ("nsp_sor_compressed_tile_report" if compact
            else "nsp_sor_tile_report")
    status = getattr(_build.load(), name)(
        int(tile_rows), int(tile_cols), int(halo), ctypes.addressof(out),
        torch.cuda.current_device())
    _build.check_status(status, name)
    keys = ("rows", "cols", "rows_per_thread", "threads", "shared_bytes",
            "blocks_per_sm", "registers")
    return dict(zip(keys, out))


def check_tile(tile_rows: int, sweeps_per_chunk: int) -> None:
    """Raise ValueError on a tile the tiled kernel cannot take: a size
    outside [1, 4096] (the JAX rule), K < 1, or delta of the haloed tile
    beyond the shared memory of one block (never clamped)."""
    if not 1 <= int(tile_rows) <= 4096:
        raise ValueError(f"tile size must be in [1, 4096], got {tile_rows}")
    if int(sweeps_per_chunk) < 1:
        raise ValueError(f"sweeps_per_chunk must be >= 1, got "
                         f"{sweeps_per_chunk}")
    need = tiled_shared_bytes(int(tile_rows), int(sweeps_per_chunk))
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"tile size {tile_rows} (x {TILE_COLS} columns, halo "
            f"{2 * sweeps_per_chunk}) needs {need} bytes of shared memory "
            f"per block; a block may use at most {MAX_SHARED_BYTES}")


def set_default_tile(tile_size: int) -> None:
    """CLI hook (the reference's CUDA block-size argument, main.cu:987-1000):
    the rows of a tile of the tiled route.  Validated by check_tile at the
    current SWEEPS_PER_CHUNK; the JAX package's rounding up to 8 rows is a
    TPU DMA rule and has no counterpart here."""
    global TILE_ROWS
    check_tile(tile_size, SWEEPS_PER_CHUNK)
    TILE_ROWS = int(tile_size)


def inner_sweeps_tiled_plain(rhs_neg: torch.Tensor, n_sweeps: int,
                             params: Params, tile_rows: int = None,
                             sweeps_per_chunk: int = SWEEPS_PER_CHUNK
                             ) -> torch.Tensor:
    """inner_sweeps_tiled in plain PyTorch, as the TPU kernel computes it:
    chunks of K sweeps (a short last one); within a chunk every strip of
    tile_rows rows reads the pre-chunk snapshot with H = 2K rows of halo on
    each side (rows outside the grid are 0), sweeps in place with rolls
    within the strip, and its own rows come back.  Masks and self_coef come
    from the global indices.  Stale halo values travel one row per
    half-sweep, so the returned rows equal the whole-grid sweeps."""
    ni, nj = params.shape
    B, K = int(tile_rows or TILE_ROWS), int(sweeps_per_chunk)
    check_tile(B, K)
    H = 2 * K
    S = -(-ni // B)
    constants = sweep_constants(params)
    dev, f32 = rhs_neg.device, torch.float32
    # Extended layout: grid row r at row r + H; rows beyond the grid are 0.
    rhs_ext = torch.zeros((S * B + 2 * H, nj), dtype=f32, device=dev)
    rhs_ext[H:H + ni] = rhs_neg
    d_ext = torch.zeros_like(rhs_ext)
    jj = torch.arange(nj, device=dev).view(1, nj)
    tt = torch.arange(B + 2 * H, device=dev).view(B + 2 * H, 1)
    strips = [(s * B, _masks(tt + (s * B - H), jj, params.i_max, params.j_max,
                             *constants[2:]))
              for s in range(S)]
    done = 0
    while done < int(n_sweeps):
        ns = min(K, int(n_sweeps) - done)
        out = torch.zeros_like(d_ext)
        for row0, (red, black, self_coef) in strips:
            rows = slice(row0, row0 + B + 2 * H)
            d, rhs = d_ext[rows].clone(), rhs_ext[rows]
            for _ in range(ns):
                d = _half_sweep(d, rhs, red, self_coef, constants)
                d = _half_sweep(d, rhs, black, self_coef, constants)
            out[row0 + H:row0 + H + B] = d[H:H + B]
        d_ext = out
        done += ns
    return d_ext[H:H + ni].clone()


def inner_sweeps_tiled(rhs_neg: torch.Tensor, n_sweeps: int, params: Params,
                       tile_rows: int = None,
                       sweeps_per_chunk: int = SWEEPS_PER_CHUNK
                       ) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A delta = rhs_neg from delta = 0 in
    chunks of sweeps_per_chunk, tiles of tile_rows (default TILE_ROWS) x
    TILE_COLS cells: the plain version for a CPU tensor, the CUDA kernel
    (one launch per chunk, one for n_sweeps = 0) for a CUDA one."""
    global TILED_LAUNCHES
    B, K = int(tile_rows or TILE_ROWS), int(sweeps_per_chunk)
    if not _cuda_tensor(rhs_neg):
        return inner_sweeps_tiled_plain(rhs_neg, n_sweeps, params, B, K)
    check_inputs(rhs_neg, n_sweeps, params)
    check_tile(B, K)
    out = _tile_sweeps_from_zero(rhs_neg, n_sweeps, params, B, TILE_COLS, K)
    TILED_LAUNCHES += 1
    return out


# --- the colour-compressed kernel -----------------------------------------------
#
# Index algebra (JAX sor_kernel.py:751-757; b = i & 1 is the row parity, nj
# even):
#   red[i, k]   = d[i, 2k + b]       black[i, k] = d[i, 2k + 1 - b]
#   red W/E neighbours  = black[i -/+ 1, k]
#   red N = black[i, k + b],   red S = black[i, k + b - 1]
#   black N = red[i, k + 1 - b], black S = red[i, k - b]

@functools.lru_cache(maxsize=16)
def _colour_index(ni: int, nj: int, device: torch.device):
    """(fwd, inv) of a padded (ni, nj even) grid on `device`, cached (read
    only): fwd (2, ni, nj // 2) holds the flat grid index of red[i, k] and
    of black[i, k], 2k + (c ^ b) in row i for colour c; inv (ni, nj) the
    flat index of each grid cell in the (2, ni, nj // 2) pair of arrays."""
    njc = nj // 2
    ii = torch.arange(ni, device=device).view(1, ni, 1)
    kk = torch.arange(njc, device=device).view(1, 1, njc)
    cc = torch.arange(2, device=device).view(2, 1, 1)
    fwd = ii * nj + 2 * kk + (cc ^ (ii & 1))
    jj = torch.arange(nj, device=device).view(1, nj)
    ii = ii.view(ni, 1)
    inv = ((ii + jj) & 1) * (ni * njc) + ii * njc + jj // 2
    return fwd, inv


def _compress_planar(full: torch.Tensor) -> torch.Tensor:
    """full (ni, nj even) -> (2, ni, nj // 2): its red and its black cells,
    one gather."""
    return torch.take(full, _colour_index(*full.shape, full.device)[0])


def _expand_planar(colours: torch.Tensor) -> torch.Tensor:
    """(2, ni, nj // 2) red and black cells -> the (ni, nj) grid, one
    gather."""
    _, ni, njc = colours.shape
    return torch.take(colours, _colour_index(ni, 2 * njc, colours.device)[1])


def _compress_colors(full: torch.Tensor):
    """full (ni, nj even) -> (red, black), each (ni, nj // 2)."""
    return tuple(_compress_planar(full).unbind(0))


def _decompress_colors(red: torch.Tensor, black: torch.Tensor) -> torch.Tensor:
    return _expand_planar(torch.stack([red, black]))


def inner_sweeps_compressed_plain(rhs_neg: torch.Tensor, n_sweeps: int,
                                  params: Params) -> torch.Tensor:
    """inner_sweeps_compressed in plain PyTorch, as the TPU kernel computes
    it: each half-sweep updates every interior cell of one compacted colour
    array from rolls of the other."""
    ni, nj = params.shape
    njc = nj // 2
    one_minus_omega, coef, dx2_inv, dy2_inv = sweep_constants(params)
    dev, f32 = rhs_neg.device, torch.float32
    rhs_r, rhs_b = _compress_colors(rhs_neg.to(f32))
    ii = torch.arange(ni, device=dev).view(ni, 1)
    kk = torch.arange(njc, device=dev).view(1, njc)
    b = ii & 1
    row_odd = b == 1

    def cell_meta(jj):
        interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
        self_coef = (((ii == 1).to(f32) + (ii == ni - 2).to(f32)) * dx2_inv
                     + ((jj == 1).to(f32) + (jj == nj - 2).to(f32)) * dy2_inv)
        return interior, self_coef

    int_r, sc_r = cell_meta(2 * kk + b)
    int_b, sc_b = cell_meta(2 * kk + 1 - b)

    def update(tgt, other, rhs, interior, self_coef, sel):
        we = (torch.roll(other, 1, 0) + torch.roll(other, -1, 0)) * dx2_inv
        o_m = torch.roll(other, 1, 1)   # k - 1
        o_p = torch.roll(other, -1, 1)  # k + 1
        nth = torch.where(sel, o_p, other)
        sth = torch.where(sel, other, o_m)
        nb = we + (nth + sth) * dy2_inv + tgt * self_coef
        new = one_minus_omega * tgt + coef * (nb - rhs)
        return torch.where(interior, new, tgt)

    red = torch.zeros((ni, njc), dtype=f32, device=dev)
    black = torch.zeros_like(red)
    for _ in range(int(n_sweeps)):
        red = update(red, black, rhs_r, int_r, sc_r, row_odd)
        black = update(black, red, rhs_b, int_b, sc_b, ~row_odd)
    return _decompress_colors(red, black)


def inner_sweeps_compressed(rhs_neg: torch.Tensor, n_sweeps: int,
                            params: Params) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A delta = rhs_neg from delta = 0 on
    the colour-compacted arrays: the plain version for a CPU tensor, the
    CUDA kernel (compressed_colour_sweeps between the compaction and the
    expansion) for a CUDA one.  The padded width must be even."""
    if params.shape[1] % 2:
        raise ValueError(f"the compressed SOR kernel takes an even padded "
                         f"width, got {params.shape[1]}")
    if not _cuda_tensor(rhs_neg):
        return inner_sweeps_compressed_plain(rhs_neg, n_sweeps, params)
    check_inputs(rhs_neg, n_sweeps, params)
    # Compaction and expansion stay outside the kernel, as in the JAX
    # package: one gather each.
    return _expand_planar(compressed_colour_sweeps(_compress_planar(rhs_neg),
                                                   n_sweeps, params))


def compressed_colour_sweeps(rhs_colours: torch.Tensor, n_sweeps: int,
                             params: Params) -> torch.Tensor:
    """The kernel of inner_sweeps_compressed, CUDA only: n_sweeps sweeps from
    delta = 0 on the colour-compacted arrays, the (2, ni, nj / 2) f32 red
    and black cells of rhs (_compress_planar) in, those of the result out.
    One launch of whole_grid_tile's tile per chunk of sweeps (one for
    n_sweeps = 0), two pairs of arrays taking turns; every cell of the
    result comes from the kernel."""
    global COMPRESSED_LAUNCHES
    _require_cuda(rhs_colours, "compressed_colour_sweeps")
    ni, nj = params.shape
    shape = (2, ni, nj // 2)
    if (rhs_colours.dtype != torch.float32 or not rhs_colours.is_contiguous()
            or tuple(rhs_colours.shape) != shape):
        raise ValueError(f"compressed_colour_sweeps takes a contiguous f32 "
                         f"{shape} array, got {rhs_colours.dtype} "
                         f"{tuple(rhs_colours.shape)}")
    rows, cols, K = whole_grid_tile(params.shape)
    bufs = torch.empty((2, *shape), dtype=torch.float32,
                       device=rhs_colours.device)
    first, other = bufs.unbind(0)
    status = _build.load().nsp_sor_compressed_sweeps(
        first[0].data_ptr(), first[1].data_ptr(), other[0].data_ptr(),
        other[1].data_ptr(), rhs_colours[0].data_ptr(),
        rhs_colours[1].data_ptr(), ni, nj, int(n_sweeps), rows, cols, K,
        *sweep_constants(params), *_build.device_and_stream(rhs_colours))
    _build.check_status(status, "nsp_sor_compressed_sweeps")
    COMPRESSED_LAUNCHES += 1
    n_chunks = max(1, -(-int(n_sweeps) // K))
    return other if n_chunks % 2 else first


def inner_sweeps_compressed_simple(rhs_neg: torch.Tensor, n_sweeps: int,
                                   params: Params) -> torch.Tensor:
    """inner_sweeps_compressed by its first kernel, one launch per
    half-sweep on the compacted arrays: the yardstick the compressed
    kernel is held against on the card, on no path.  CUDA tensors only."""
    _require_cuda(rhs_neg, "inner_sweeps_compressed_simple")
    if params.shape[1] % 2:
        raise ValueError(f"the compressed SOR kernel takes an even padded "
                         f"width, got {params.shape[1]}")
    check_inputs(rhs_neg, n_sweeps, params)
    ni, nj = params.shape
    rhs = _compress_planar(rhs_neg)
    # The kernel never writes the ghost cells, which must stay 0.
    d = torch.zeros((2, ni, nj // 2), dtype=torch.float32,
                    device=rhs_neg.device)
    status = _build.load().nsp_sor_compressed_sweeps_simple(
        d[0].data_ptr(), d[1].data_ptr(), rhs[0].data_ptr(),
        rhs[1].data_ptr(), ni, nj, int(n_sweeps), *sweep_constants(params),
        *_build.device_and_stream(rhs_neg))
    _build.check_status(status, "nsp_sor_compressed_sweeps_simple")
    return _expand_planar(d)


# --- the multigrid smoother ------------------------------------------------------

def check_warm_inputs(p: torch.Tensor, rhs: torch.Tensor,
                      n_sweeps: int) -> None:
    """Raise on anything the warm-start kernel does not take."""
    for name, x in (("p", p), ("rhs", rhs)):
        if x.dtype != torch.float32:
            raise TypeError(f"SOR kernel takes float32 {name}, got {x.dtype}")
        if x.dim() != 2 or min(x.shape) < 1:
            raise ValueError(f"SOR kernel takes a non-empty 2-D {name}, got "
                             f"shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"SOR kernel takes a contiguous {name}")
    if p.shape != rhs.shape:
        raise ValueError(f"p {tuple(p.shape)} and rhs {tuple(rhs.shape)} "
                         f"differ in shape")
    if p.device != rhs.device:
        raise ValueError(f"p on {p.device} and rhs on {rhs.device}")
    if int(n_sweeps) < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")


def warm_sweeps(p: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                omega: float, dx2_inv: float, dy2_inv: float) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A p = rhs from p, into a new tensor
    whose ghost ring is p's: the plain version for a CPU tensor, the CUDA
    kernel (one launch of the tile per WARM_SWEEPS_PER_LAUNCH sweeps, one
    for n_sweeps = 0) for a CUDA one."""
    global WARM_LAUNCHES
    if not _cuda_tensor(p):
        return warm_sweeps_plain(p, rhs, n_sweeps, omega, dx2_inv, dy2_inv)
    check_warm_inputs(p, rhs, n_sweeps)
    lib = _build.load()
    ni, nj = p.shape
    out = torch.empty_like(p)
    # A second buffer only where the sweeps take more than one launch.
    scratch = (torch.empty_like(p)
               if int(n_sweeps) > WARM_SWEEPS_PER_LAUNCH else out)
    status = lib.nsp_sor_warm_sweeps(
        out.data_ptr(), scratch.data_ptr(), p.data_ptr(), rhs.data_ptr(),
        ni, nj, int(n_sweeps), *WARM_TILE, WARM_SWEEPS_PER_LAUNCH,
        *warm_constants(omega, dx2_inv, dy2_inv),
        *_build.device_and_stream(p))
    _build.check_status(status, "nsp_sor_warm_sweeps")
    WARM_LAUNCHES += 1
    return out


def warm_sweeps_simple(p: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                       omega: float, dx2_inv: float,
                       dy2_inv: float) -> torch.Tensor:
    """warm_sweeps by its first kernel, one launch per half-sweep on the
    level in device memory: the yardstick the smoother's routes and the
    coarse cycle are held against on the card, on no path.  CUDA tensors
    only."""
    _require_cuda(p, "warm_sweeps_simple")
    check_warm_inputs(p, rhs, n_sweeps)
    lib = _build.load()
    ni, nj = p.shape
    out = torch.empty_like(p)
    status = lib.nsp_sor_warm_sweeps_simple(
        out.data_ptr(), p.data_ptr(), rhs.data_ptr(), ni, nj, int(n_sweeps),
        *warm_constants(omega, dx2_inv, dy2_inv),
        *_build.device_and_stream(p))
    _build.check_status(status, "nsp_sor_warm_sweeps_simple")
    return out


# --- the coarse tail of the multigrid V-cycle --------------------------------------
#
# A level is (padded shape, dx2_inv, dy2_inv), as ops/mg.py::build_levels
# makes them, finest first; the smoother is Gauss-Seidel (omega = 1).

def cycle_shared_bytes(levels) -> int:
    """Shared memory of the one block that holds p and rhs, f32, of every
    level."""
    return sum(2 * 4 * int(lvl[0][0]) * int(lvl[0][1]) for lvl in levels)


def coarse_cycle_depth(levels) -> int:
    """The depth from which ops/mg.py::v_cycle hands the cycle to
    coarse_cycle on the card: the first level whose whole sub-hierarchy
    fits one block's shared memory (MAX_SHARED_BYTES) and
    COARSE_CYCLE_MAX_LEVELS levels; len(levels) where none does.  The nine
    levels of a 2048^2 grid split 4 + 5: 2050^2 to 258^2 level by level,
    130^2, 66^2, 34^2, 18^2 and 10^2 (182,688 B) in the one launch."""
    for depth in range(len(levels)):
        tail = levels[depth:]
        if (len(tail) <= COARSE_CYCLE_MAX_LEVELS
                and cycle_shared_bytes(tail) <= MAX_SHARED_BYTES):
            return depth
    return len(levels)


def check_cycle_inputs(p: torch.Tensor, rhs: torch.Tensor, levels, nu1: int,
                       nu2: int, coarse_sweeps: int) -> None:
    """Raise on anything the coarse-cycle kernel does not take: tensors
    that are not matching contiguous 2-D f32 of the first level's shape, no
    level or more than COARSE_CYCLE_MAX_LEVELS, a level whose interior is
    not half the one before, levels beyond one block's shared memory, or a
    negative sweep count."""
    check_warm_inputs(p, rhs, 0)
    if min(int(nu1), int(nu2), int(coarse_sweeps)) < 0:
        raise ValueError(f"sweep counts must be >= 0, got nu1={nu1}, "
                         f"nu2={nu2}, coarse_sweeps={coarse_sweeps}")
    if not 1 <= len(levels) <= COARSE_CYCLE_MAX_LEVELS:
        raise ValueError(f"coarse_cycle takes 1 to {COARSE_CYCLE_MAX_LEVELS} "
                         f"levels, got {len(levels)}")
    shapes = [tuple(int(n) for n in lvl[0]) for lvl in levels]
    if tuple(p.shape) != shapes[0]:
        raise ValueError(f"p {tuple(p.shape)} is not of the first level's "
                         f"shape {shapes[0]}")
    for fine, coarse in zip(shapes, shapes[1:]):
        if min(coarse) < 3 or any(f - 2 != 2 * (c - 2)
                                  for f, c in zip(fine, coarse)):
            raise ValueError(f"level {coarse} does not halve the interior "
                             f"of level {fine}")
    need = cycle_shared_bytes(levels)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"coarse_cycle on levels {shapes} needs {need} bytes of shared "
            f"memory in one block; a block may use at most "
            f"{MAX_SHARED_BYTES}")


def coarse_cycle_plain(p: torch.Tensor, rhs: torch.Tensor, levels,
                       nu1: int = 2, nu2: int = 2,
                       coarse_sweeps: int = 32) -> torch.Tensor:
    """coarse_cycle in plain PyTorch: ops/mg.py's V-cycle on the plain
    smoother, level by level."""
    from .. import mg  # mg imports this module

    return mg.v_cycle_plain(p, rhs, list(levels), nu1, nu2, coarse_sweeps)


def coarse_cycle(p: torch.Tensor, rhs: torch.Tensor, levels, nu1: int = 2,
                 nu2: int = 2, coarse_sweeps: int = 32) -> torch.Tensor:
    """One V(nu1, nu2) cycle on A p = rhs over `levels` (finest first, p and
    rhs of its shape) with coarse_sweeps sweeps on the last, into a new
    tensor whose ghost ring is p's: the plain version for a CPU tensor, the
    CUDA kernel (one launch, every level in one block's shared memory) for
    a CUDA one."""
    global CYCLE_LAUNCHES
    if not _cuda_tensor(p):
        return coarse_cycle_plain(p, rhs, levels, nu1, nu2, coarse_sweeps)
    check_cycle_inputs(p, rhs, levels, nu1, nu2, coarse_sweeps)
    lib = _build.load()
    shapes, consts = [], []
    for shape, dx2_inv, dy2_inv in levels:
        shapes += [int(shape[0]), int(shape[1])]
        consts += [*warm_constants(1.0, dx2_inv, dy2_inv),
                   2.0 * (float(dx2_inv) + float(dy2_inv))]
    out = torch.empty_like(p)
    status = lib.nsp_mg_coarse_cycle(
        out.data_ptr(), p.data_ptr(), rhs.data_ptr(),
        (ctypes.c_int * len(shapes))(*shapes),
        (ctypes.c_float * len(consts))(*consts), len(levels), int(nu1),
        int(nu2), int(coarse_sweeps), *_build.device_and_stream(p))
    _build.check_status(status, "nsp_mg_coarse_cycle")
    CYCLE_LAUNCHES += 1
    return out


# --- the extended-block kernel of the sharded inner -------------------------------

def ext_constants(params_or_consts):
    """(i_max, j_max, constants) of ext_sweeps' last argument: a Params (the
    grid and sweep_constants) or a tuple (i_max, j_max, omega, dx2_inv,
    dy2_inv) (warm_constants), e.g. one multigrid level."""
    if isinstance(params_or_consts, Params):
        prm = params_or_consts
        return prm.i_max, prm.j_max, sweep_constants(prm)
    i_max, j_max, omega, dx2_inv, dy2_inv = params_or_consts
    return int(i_max), int(j_max), warm_constants(omega, dx2_inv, dy2_inv)


def ext_masks(ext_shape, H: int, origin, i_max: int, j_max: int,
              dx2_inv: float, dy2_inv: float, device="cpu"):
    """(interior, red, black, self_coef) of an extended block (JAX
    deep_halo._ext_masks): extended cell (a, b) is global padded cell
    (ox - H + 1 + a, oy - H + 1 + b), (ox, oy) = origin the shard's global
    interior origin."""
    rows, cols = ext_shape
    ox, oy = (int(o) for o in origin)
    ii = torch.arange(rows, device=device).view(rows, 1) + (ox - H + 1)
    jj = torch.arange(cols, device=device).view(1, cols) + (oy - H + 1)
    red, black, self_coef = _masks(ii, jj, i_max, j_max, dx2_inv, dy2_inv)
    return red | black, red, black, self_coef


def ext_sweeps_plain(delta_ext: torch.Tensor, rhs_ext: torch.Tensor, ns: int,
                     origin, H: int, params_or_consts) -> torch.Tensor:
    """ext_sweeps in plain PyTorch, as the JAX package's _ext_sweeps_jnp
    computes it: ns red-black sweeps by circular rolls of the whole block
    (the wrap lands only within 2 ns cells of the block's edge), masks
    from the global indices."""
    i_max, j_max, constants = ext_constants(params_or_consts)
    _, red, black, self_coef = ext_masks(delta_ext.shape, H, origin, i_max,
                                         j_max, *constants[2:],
                                         device=delta_ext.device)
    d = delta_ext.to(torch.float32, copy=True)
    rhs = rhs_ext.to(torch.float32)
    for _ in range(int(ns)):
        d = _half_sweep(d, rhs, red, self_coef, constants)
        d = _half_sweep(d, rhs, black, self_coef, constants)
    return d


def ext_shared_bytes(ns: int) -> int:
    """Shared memory of one block of the extended-block kernel: delta, f32,
    over its tile and a halo of 2 ns cells on each side."""
    return tiled_shared_bytes(EXT_TILE_ROWS, max(int(ns), 0))


def check_ext_inputs(delta_ext: torch.Tensor, rhs_ext: torch.Tensor, ns: int,
                     H: int) -> None:
    """Raise on anything the extended-block kernel does not take: ns
    outside [0, H / 2] (the core would not be exact), a tile beyond one
    block's shared memory, or blocks that are not matching contiguous 2-D
    f32 tensors on one device."""
    check_warm_inputs(delta_ext, rhs_ext, 0)
    if not 0 <= int(ns) <= int(H) // 2:
        raise ValueError(f"ext_sweeps takes 0 <= ns <= H / 2 = {int(H) // 2}"
                         f" sweeps, got {ns}")
    need = ext_shared_bytes(ns)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"ext_sweeps with ns={ns} needs {need} bytes of shared memory per "
            f"block ({EXT_TILE_ROWS} x {TILE_COLS} tile, halo {2 * int(ns)});"
            f" a block may use at most {MAX_SHARED_BYTES}")


def ext_sweeps(delta_ext: torch.Tensor, rhs_ext: torch.Tensor, ns: int,
               origin, H: int, params_or_consts) -> torch.Tensor:
    """ns <= H / 2 f32 red-black sweeps on one shard's extended block from
    delta_ext, into a new tensor: the plain version for a CPU tensor, the
    CUDA kernel (one launch) for a CUDA one.  Cells of the core (H deep
    inside the block) equal a sweep of the whole grid; the kernel and its
    twin agree on every cell at least 2 ns from the block's edge."""
    global EXT_LAUNCHES
    if not _cuda_tensor(delta_ext):
        return ext_sweeps_plain(delta_ext, rhs_ext, ns, origin, H,
                                params_or_consts)
    check_ext_inputs(delta_ext, rhs_ext, ns, H)
    i_max, j_max, constants = ext_constants(params_or_consts)
    ox, oy = (int(o) for o in origin)
    lib = _build.load()
    rows, cols = delta_ext.shape
    out = torch.empty_like(delta_ext)
    status = lib.nsp_sor_ext_sweeps(
        out.data_ptr(), delta_ext.data_ptr(), rhs_ext.data_ptr(), rows, cols,
        int(ns), ox, oy, int(H), i_max, j_max, EXT_TILE_ROWS, TILE_COLS,
        *constants, *_build.device_and_stream(delta_ext))
    _build.check_status(status, "nsp_sor_ext_sweeps")
    EXT_LAUNCHES += 1
    return out
