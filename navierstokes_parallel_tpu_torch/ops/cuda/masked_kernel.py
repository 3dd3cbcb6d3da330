"""The masked multigrid's V-cycle on the card (``csrc/masked_cycle.cu``).

``ops/masked.py::_v_cycle_masked`` runs its cycle through these wrappers
when p, rhs and the level are float32 on a CUDA device and nothing needs a
gradient (``usable``); everywhere else it runs its plain functions, which
are the kernels' twins bit for bit:

  * ``cycle``: from ``one_block_depth`` on, the rest of the cycle in one
    launch of one block, every level in shared memory;
  * ``half_sweeps``: n masked red-black sweeps of a level in device
    memory, one launch a half-sweep (ops/masked.py::_masked_half_sweep);
  * ``restrict``: the level's negated residual restricted to the next
    level, one launch (``masked_residual`` and ``_restrict``);
  * ``prolong``: the coarse correction added on the fluid cells, one
    launch.

A level's weights go to the kernels packed (``pack_level``): the east and
north couplings padded with a zero ghost ring (the west and south ones are
the same arrays one cell over), the f32 diagonal and one fluid byte a
cell.  Whole levels only: the colours are the level's own checkerboard
(parity 0), as ``device_levels`` makes them.  Every wrapper takes CUDA
tensors only and checks its inputs before the launch.  Launches are
counted in utils/timing.py's table: ``launch.masked_cycle``,
``launch.masked_half_sweep`` (one a half-sweep), ``launch.masked_restrict``
and ``launch.masked_prolong``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ...utils import timing
from . import _build
from .sor_kernel import MAX_SHARED_BYTES, _require_cuda

# The most levels one block takes (csrc/masked_cycle.cu::kMaxLevels).
MAX_LEVELS = 8
# The V-cycle's smoother is Gauss-Seidel: omega and 1 - omega, in float32.
OMEGA = (1.0, 0.0)


class Packed(NamedTuple):
    """One level's weights as the kernels read them."""

    we: torch.Tensor     # (ni + 2, nj + 2) f32: east coupling, 0 on the ring
    wn: torch.Tensor     # (ni + 2, nj + 2) f32: north coupling
    diag: torch.Tensor   # (ni, nj) f32
    fluid: torch.Tensor  # (ni, nj) uint8


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a, b)
                and torch.equal(torch.signbit(a), torch.signbit(b)))


def pack_level(w) -> Packed:
    """The kernels' arrays of an f32 level ``w`` (ops/masked.py's
    _DeviceWeights), on w's device.  Raises ValueError unless w's west and
    south couplings equal the east and north ones one cell over, bit for
    bit (the kernels read them so)."""
    if w.w_e.dtype != torch.float32:
        raise TypeError(f"masked kernels take float32 weights, got "
                        f"{w.w_e.dtype}")
    ni, nj = w.fluid.shape
    we = w.w_e.new_zeros((ni + 2, nj + 2))
    wn = w.w_n.new_zeros((ni + 2, nj + 2))
    we[1:-1, 1:-1] = w.w_e
    wn[1:-1, 1:-1] = w.w_n
    if not (_same_bits(we[:-2, 1:-1], w.w_w)
            and _same_bits(wn[1:-1, :-2], w.w_s)):
        raise ValueError("the level's west / south couplings are not its "
                         "east / north ones one cell over")
    return Packed(we=we, wn=wn, diag=w.diag.contiguous(),
                  fluid=w.fluid.to(torch.uint8).contiguous())


def level_shared_bytes(ni: int, nj: int) -> int:
    """Shared memory of one level of ni x nj interior cells in the
    one-block cycle: p, we, wn padded and rhs, diag interior in f32, one
    fluid byte a cell."""
    padded, interior = (ni + 2) * (nj + 2), ni * nj
    return 4 * (3 * padded + 2 * interior) + interior


def cycle_shared_bytes(shapes: Sequence[Tuple[int, int]]) -> int:
    """Shared memory of the one-block cycle over levels of these interior
    shapes."""
    return sum(level_shared_bytes(ni, nj) for ni, nj in shapes)


@functools.lru_cache(maxsize=64)
def one_block_depth(shapes: Tuple[Tuple[int, int], ...]) -> int:
    """The first level (of interior `shapes`, finest first) from which the
    rest of the hierarchy fits one block's shared memory (MAX_SHARED_BYTES)
    and MAX_LEVELS levels; len(shapes) where none does.  At 440 x 82 it is
    level 1 (220 x 41, 195,732 B): level 0 alone needs 770,256 B."""
    for depth in range(len(shapes)):
        tail = shapes[depth:]
        if (len(tail) <= MAX_LEVELS
                and cycle_shared_bytes(tail) <= MAX_SHARED_BYTES):
            return depth
    return len(shapes)


def launches_per_cycle(shapes: Tuple[Tuple[int, int], ...], nu1: int = 2,
                       nu2: int = 2, coarse_sweeps: int = 32) -> dict:
    """The launches of one cycle from level 0 on the card, by counter:
    half-sweeps, restrictions and prolongations on the levels above
    ``one_block_depth``, and one block for the rest (the coarsest level's
    sweeps by half-sweeps where no level fits)."""
    t = one_block_depth(tuple(shapes))
    above = min(t, len(shapes) - 1)
    half = 2 * (nu1 + nu2) * above
    if t == len(shapes):
        half += 2 * coarse_sweeps
    return {"masked_cycle": int(t < len(shapes)), "masked_half_sweep": half,
            "masked_restrict": above, "masked_prolong": above}


def usable(p: torch.Tensor, rhs: torch.Tensor, w) -> bool:
    """Whether the kernels run this level: p and rhs float32 on a CUDA
    device, neither needing a gradient, and the level packed
    (``device_levels`` packs its float32 levels on a CUDA device)."""
    return (w.packed is not None
            and p.device.type == "cuda" and rhs.device.type == "cuda"
            and p.dtype == torch.float32 and rhs.dtype == torch.float32
            and not (p.requires_grad or rhs.requires_grad))


def _check(x: torch.Tensor, name: str, shape, dtype, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(x.shape)} is not of shape "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the level on {device}")


def check_packed(w: Packed) -> None:
    """Raise unless `w` holds a level's arrays as pack_level makes them."""
    ni, nj = w.fluid.shape
    device = w.fluid.device
    _check(w.fluid, "fluid", (ni, nj), torch.uint8, device)
    _check(w.diag, "diag", (ni, nj), torch.float32, device)
    _check(w.we, "we", (ni + 2, nj + 2), torch.float32, device)
    _check(w.wn, "wn", (ni + 2, nj + 2), torch.float32, device)


def check_level_inputs(p: torch.Tensor, rhs: torch.Tensor, w: Packed,
                       n_sweeps: int = 0) -> None:
    """Raise on what the level kernels do not take: p not the level's
    padded float32 array, rhs not its interior one, either strided or on
    another device than the level, a negative sweep count."""
    check_packed(w)
    ni, nj = w.fluid.shape
    _check(p, "p", (ni + 2, nj + 2), torch.float32, w.fluid.device)
    _check(rhs, "rhs", (ni, nj), torch.float32, w.fluid.device)
    if int(n_sweeps) < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")


def check_cycle_inputs(p: torch.Tensor, rhs: torch.Tensor,
                       levels: Sequence[Packed], nu1: int, nu2: int,
                       coarse_sweeps: int) -> None:
    """Raise on what the one-block cycle does not take: no level or more
    than MAX_LEVELS, a level whose interior is not half the one before,
    levels beyond one block's shared memory, a negative sweep count, or
    p, rhs or a level as check_level_inputs refuses them."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the masked cycle takes 1 to {MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    if min(int(nu1), int(nu2), int(coarse_sweeps)) < 0:
        raise ValueError(f"sweep counts must be >= 0, got nu1={nu1}, "
                         f"nu2={nu2}, coarse_sweeps={coarse_sweeps}")
    check_level_inputs(p, rhs, levels[0])
    shapes = [tuple(w.fluid.shape) for w in levels]
    for fine, coarse, w in zip(shapes, shapes[1:], levels[1:]):
        check_packed(w)
        if any(f != 2 * c for f, c in zip(fine, coarse)):
            raise ValueError(f"level {coarse} does not halve level {fine}")
    need = cycle_shared_bytes(shapes)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"the masked cycle on levels {shapes} needs {need} bytes of "
            f"shared memory in one block; a block may use at most "
            f"{MAX_SHARED_BYTES}")


def half_sweeps(p: torch.Tensor, rhs: torch.Tensor, w: Packed,
                n_sweeps: int) -> torch.Tensor:
    """n_sweeps masked red-black Gauss-Seidel sweeps in place on p
    (padded), rhs the level's interior: 2 n launches.  Returns p."""
    _require_cuda(p, "half_sweeps")
    check_level_inputs(p, rhs, w, n_sweeps)
    ni, nj = w.fluid.shape
    status = _build.load().nsp_masked_half_sweeps(
        p.data_ptr(), rhs.data_ptr(), w.we.data_ptr(), w.wn.data_ptr(),
        w.diag.data_ptr(), w.fluid.data_ptr(), ni, nj, int(n_sweeps),
        *OMEGA, *_build.device_and_stream(p))
    _build.check_status(status, "nsp_masked_half_sweeps")
    timing.count("launch.masked_half_sweep", 2 * int(n_sweeps))
    return p


def restrict(p: torch.Tensor, rhs: torch.Tensor, w: Packed,
             coarse: Packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e_c, r_c): a zero correction of the coarse level's padded shape and
    the level's negated residual restricted to the coarse interior, 0 on
    coarse-solid cells.  One launch."""
    _require_cuda(p, "restrict")
    check_level_inputs(p, rhs, w)
    check_packed(coarse)
    ni, nj = w.fluid.shape
    if tuple(coarse.fluid.shape) != (ni // 2, nj // 2) or ni % 2 or nj % 2:
        raise ValueError(f"level {tuple(coarse.fluid.shape)} does not halve "
                         f"level {(ni, nj)}")
    e_c = torch.empty((ni // 2 + 2, nj // 2 + 2), dtype=p.dtype,
                      device=p.device)
    r_c = torch.empty((ni // 2, nj // 2), dtype=p.dtype, device=p.device)
    status = _build.load().nsp_masked_restrict(
        e_c.data_ptr(), r_c.data_ptr(), p.data_ptr(), rhs.data_ptr(),
        w.we.data_ptr(), w.wn.data_ptr(), w.diag.data_ptr(),
        w.fluid.data_ptr(), coarse.fluid.data_ptr(), ni, nj,
        *_build.device_and_stream(p))
    _build.check_status(status, "nsp_masked_restrict")
    timing.count("launch.masked_restrict")
    return e_c, r_c


def prolong(p: torch.Tensor, e_c: torch.Tensor, w: Packed) -> torch.Tensor:
    """p += e_c of the covering coarse cell on the level's fluid cells (+ 0
    on solid ones), in place.  One launch.  Returns p."""
    _require_cuda(p, "prolong")
    check_packed(w)
    ni, nj = w.fluid.shape
    _check(p, "p", (ni + 2, nj + 2), torch.float32, w.fluid.device)
    _check(e_c, "e_c", (ni // 2 + 2, nj // 2 + 2), torch.float32,
           w.fluid.device)
    if ni % 2 or nj % 2:
        raise ValueError(f"level {(ni, nj)} has no coarser level")
    status = _build.load().nsp_masked_prolong(
        p.data_ptr(), e_c.data_ptr(), w.fluid.data_ptr(), ni, nj,
        *_build.device_and_stream(p))
    _build.check_status(status, "nsp_masked_prolong")
    timing.count("launch.masked_prolong")
    return p


def cycle(p: torch.Tensor, rhs: torch.Tensor, levels: Sequence[Packed],
          nu1: int = 2, nu2: int = 2,
          coarse_sweeps: int = 32) -> torch.Tensor:
    """One masked V(nu1, nu2) cycle over `levels` (finest first, p padded
    and rhs interior of the first), coarse_sweeps sweeps on the last, in
    place on p, in one launch of one block.  Returns p."""
    _require_cuda(p, "cycle")
    check_cycle_inputs(p, rhs, levels, nu1, nu2, coarse_sweeps)
    arrays, shapes = [], []
    for w in levels:
        arrays += [w.we.data_ptr(), w.wn.data_ptr(), w.diag.data_ptr(),
                   w.fluid.data_ptr()]
        shapes += [int(n) for n in w.fluid.shape]
    status = _build.load().nsp_masked_cycle(
        p.data_ptr(), rhs.data_ptr(), (ctypes.c_void_p * len(arrays))(*arrays),
        (ctypes.c_int * len(shapes))(*shapes), len(levels), int(nu1),
        int(nu2), int(coarse_sweeps), *OMEGA, *_build.device_and_stream(p))
    _build.check_status(status, "nsp_masked_cycle")
    timing.count("launch.masked_cycle")
    return p
