#!/usr/bin/env python3
"""Times the temporal-blocked SOR tile (kernels B1, B3, B4, B6) on one GPU.

    python3 tile_bench.py                      # the checkout's csrc/
    python3 tile_bench.py --src DIR            # the kernels of another csrc/
    python3 tile_bench.py --src DIR --preset ablate   # DIR holds the first
                                   # tile (nsp_sor_tile.cuh before its
                                   # redesign): also time ablated copies
    python3 tile_bench.py --preset blocks   # the current tile's block
                                   # shapes; --preset loads: no sweep, and
                                   # delta through cp.async
    python3 tile_bench.py --tile 64x128 --preset wide  # (--tile 128x64
                                   # --preset tall) the main-path kernel
                                   # compiled for a wider (taller) tile
    python3 tile_bench.py --preset geometry --b1 32x32x8,32x64x8,64x64x4,\
64x64x8,32x32x4 --grids 256,512,1024,2048 --b3 64x64,32x64,32x32
                                   # the whole-grid kernel B1 (64 sweeps)
                                   # per tile ROWSxCOLSxK and grid, and the
                                   # smoother B3 (2 sweeps at
                                   # 2050^2) per tile; `geometry` compiles
                                   # a kernel for each of those shapes and
                                   # for other block shapes of B1's and
                                   # B3's own tiles
    python3 tile_bench.py --cycle   # also one V-cycle at 2048^2 with the
                                   # coarse cycle entered at 130^2 (as the
                                   # port does) and at 66^2
    python3 tile_bench.py --preset momentum --momentum
                                   # also the fused momentum kernel B2 at
                                   # 258^2 and 2050^2 with its tile as it
                                   # is and with other tiles

Builds sor_tiled.cu, sor_ext.cu, sor.cu and momentum.cu of the given
source directory into a private library under build/tile_bench/ (nvcc for sm_90a with
``-Xptxas -v``, whose register and spill lines it prints), then times with
CUDA events, on configs/4.in's grid:

  * B4 (nsp_sor_tiled_sweeps) at 2050^2: one chunk of K = 8 sweeps and a
    64-sweep call, default tile (64 x 64);
  * B6 (nsp_sor_ext_sweeps) on the 2080^2 extended block of the 1x1 mesh,
    8 sweeps (and 0 sweeps: the load and the store alone);
  * two torch.zeros of 2050^2 f32, what B4's wrapper allocated per call
    before it took torch.empty;
  * with --b1: B1 (nsp_sor_tiled_sweeps with the tile given), 64 sweeps
    from delta = 0 on each --grids grid with each tile, beside its first
    kernel
    (nsp_sor_sweeps_simple, one launch per half-sweep), and whether the two
    agree bit for bit;
  * with --b3: B3 (nsp_sor_warm_sweeps), 2 sweeps at 2050^2
    with each tile, beside nsp_sor_warm_sweeps_simple;
  * with --cycle: one V-cycle of ops/mg.py at 2050^2 through the port's
    own wrappers and library, the coarse cycle entered where
    sor_kernel.coarse_cycle_depth says (130^2) and one level further down
    (66^2; the smoother then takes 130^2), in two turns;
  * with --momentum: B2 (nsp_momentum_rhs) at configs/1.in's 258^2 and
    configs/4.in's 2050^2, dt and gamma as device scalars: device time per
    call of 20 calls in a CUDA graph (two turns, its first kernel
    nsp_momentum_rhs_simple between them) and call time with CUDA events,
    and whether F, G and rhs equal the first kernel's bit for bit.

A preset applies text edits to the sources, each variant in a copy under
build/tile_bench/ (never in place), and times each copy the same way,
after the sources as they are (``as_is``); each line says whether the
variant's 64 sweeps equal ``as_is``'s bit for bit.  ``ablate`` (of the
first tile) computes wrong values and serves only to split the time:
``no_sweep`` (load and store, no half-sweep loop), ``sync_only`` (the 16
barriers but no update), ``no_mask`` (no interior test, no self_coef),
``no_rhs_load`` (rhs not read in the update), ``no_sync`` (no barrier
between half-sweeps); ``loads``'s ``no_sweep`` likewise (the compiler
then drops the unused rhs loads too).  One JSON line per variant goes to
stdout and to build/tile_bench/tile_bench.jsonl.  The first line printed
is the card's name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "tile_bench"
UNITS = ("sor.cu", "sor_tiled.cu", "sor_ext.cu", "momentum.cu")
# {preset: {variant: [(file, old text, new text), ...]}}.  "ablate": of the
# first tile (no_mask also drops self_coef, nsp_sor.cuh); the others: of the
# current tile's main-path kernel (nsp_sor_tile.cuh).
_TILE = "nsp_sor_tile.cuh"


def _row(ti, tj, halo, rs, m, min_blocks):
    """A row of the tile's table of compiled shapes (kHotShapes)."""
    return f"    {{{ti}, {tj}, {halo}, {rs}, {m}, {min_blocks}}},"


_B4_ROW = dict(ti=64, tj=64, halo=16, rs=12, m=8, min_blocks=2)
_B3_ROW = dict(ti=32, tj=64, halo=4, rs=10, m=4, min_blocks=2)
_B1_ROW = dict(ti=32, tj=32, halo=16, rs=16, m=4, min_blocks=1)


def _hot(row=None, **values):
    """An edit of one row of the table (B4's and B6's unless given)."""
    row = row or _B4_ROW
    return [(_TILE, _row(**row), _row(**{**row, **values}))]


# Compiled shapes for the tiles --b1 and --b3 may name beside the table's
# own: 32 x 64 and 32 x 32 centres at K = 8 and 4, 64 x 64 at K = 4, and
# 64 x 64 and 32 x 32 tiles with the smoother's 4-deep halo.
_MORE_ROWS = [dict(ti=32, tj=64, halo=16, rs=16, m=4, min_blocks=1),
              dict(ti=64, tj=64, halo=8, rs=20, m=4, min_blocks=1),
              dict(ti=32, tj=32, halo=8, rs=12, m=4, min_blocks=2),
              dict(ti=64, tj=64, halo=4, rs=18, m=4, min_blocks=1),
              dict(ti=32, tj=32, halo=4, rs=10, m=4, min_blocks=2)]


def _with_more_rows(edits=()):
    return [*edits, (_TILE, _row(**_B4_ROW),
                     "\n".join([_row(**_B4_ROW),
                                *(_row(**r) for r in _MORE_ROWS)]))]


_LOAD_OLD = """      float d0 = 0.0f, d1 = 0.0f;
      if (!t.zero_src) {
        load_pair(t.src, t.dom.rows, t.dom.cols, k.a0 + r, b, vec_src, d0,
                  d1);
      }
"""
_LOAD_CP_ASYNC = """      {
        const int a = k.a0 + r;
        const bool row_in = !t.zero_src && a >= 0 && a < t.dom.rows;
        const float* g = t.src + static_cast<size_t>(row_in ? a : 0) * t.dom.cols;
        const int f0 = r * k.pc + k.k;
        const bool in0 = row_in && b >= 0 && b < t.dom.cols;
        const bool in1 = row_in && b + 1 >= 0 && b + 1 < t.dom.cols;
        const unsigned s0 = static_cast<unsigned>(
            __cvta_generic_to_shared((k.q ? col1 : col0) + f0));
        const unsigned s1 = static_cast<unsigned>(
            __cvta_generic_to_shared((k.q ? col0 : col1) + f0));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s0),
                     "l"(g + (in0 ? b : 0)), "r"(in0 ? 4 : 0));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s1),
                     "l"(g + (in1 ? b + 1 : 0)), "r"(in1 ? 4 : 0));
      }
"""
_STORE_OLD = """      const int f = r * k.pc + k.k;
      col0[f] = k.q ? d1 : d0;
      col1[f] = k.q ? d0 : d1;
    }
  }
  __syncthreads();
"""
_STORE_CP_ASYNC = """    }
  }
  asm volatile("cp.async.wait_all;" ::);
  __syncthreads();
"""
_NO_SWEEP = (_TILE, "  for (int h = 0; h < 2 * t.ns; h += 2) {",
             "  for (int h = 0; h < 0; h += 2) {")
_CP_ASYNC = [(_TILE, _LOAD_OLD, _LOAD_CP_ASYNC),
             (_TILE, _STORE_OLD, _STORE_CP_ASYNC)]
PRESETS = {
    "blocks": {
        "min_blocks_1": _hot(min_blocks=1),
        "min_blocks_3": _hot(min_blocks=3),
        "rows_12_step_8": _hot(rs=8, m=12),
        "rows_12_step_8_min_3": _hot(rs=8, m=12, min_blocks=3),
        "rows_6_step_16": _hot(rs=16, m=6),
        "rows_6_step_16_min_1": _hot(rs=16, m=6, min_blocks=1),
    },
    "loads": {"no_sweep": [_NO_SWEEP], "cp_async": _CP_ASYNC,
              "cp_async_no_sweep": [*_CP_ASYNC, _NO_SWEEP]},
    "wide": {
        f"cols_128_step_{rs}": _hot(tj=128, rs=rs, m=96 // rs, min_blocks=1)
        for rs in (12, 8, 6)},
    "tall": {
        "rows_128_step_20": _hot(ti=128, rs=20, min_blocks=1),
        "rows_128_step_10": _hot(ti=128, rs=10, m=16, min_blocks=1),
        "rows_128_step_10_min_2": _hot(ti=128, rs=10, m=16),
    },
    # The shapes --b1 and --b3 may name, compiled; then other blocks for
    # B1's small-grid tile (8 or 2 rows per thread instead of 4) and for
    # B3's tile (2 or 8 rows per thread instead of 4; 3 blocks per SM; 64
    # x 64 tiles with 6 rows per thread).
    "geometry": {
        "more_shapes": _with_more_rows(),
        "b1_rows_8": _with_more_rows(_hot(_B1_ROW, rs=8, m=8)),
        "b1_rows_8_min_2": _with_more_rows(_hot(_B1_ROW, rs=8, m=8,
                                                min_blocks=2)),
        "b1_rows_2": _with_more_rows(_hot(_B1_ROW, rs=32, m=2)),
        "b3_rows_2": _with_more_rows(_hot(_B3_ROW, rs=20, m=2, min_blocks=1)),
        "b3_rows_8": _with_more_rows(_hot(_B3_ROW, rs=6, m=8)),
        "b3_min_3": _with_more_rows(_hot(_B3_ROW, min_blocks=3)),
        "b3_64x64_rows_6": [(_TILE, _row(**_B4_ROW), "\n".join([
            _row(**_B4_ROW),
            _row(ti=64, tj=64, halo=4, rs=12, m=6, min_blocks=2)]))],
    },
}
# The fused momentum kernel's tile (B2): kTileI x kTileJ output cells, a
# block of kTileJ / 2 x kThreadsI threads, two columns per thread.
_MOMENTUM = "momentum.cu"
_MOMENTUM_TILE = """constexpr int kTileI = 16;     // output rows (i, x) of a block
constexpr int kTileJ = 64;     // output columns (j, y, contiguous)
constexpr int kThreadsJ = 32;  // blockDim.x
constexpr int kThreadsI = 8;   // blockDim.y
"""


def _momentum_tile(ti: int, tj: int, threads_i: int):
    return [(_MOMENTUM, _MOMENTUM_TILE,
             f"constexpr int kTileI = {ti};\nconstexpr int kTileJ = {tj};\n"
             f"constexpr int kThreadsJ = {tj // 2};\n"
             f"constexpr int kThreadsI = {threads_i};\n")]


PRESETS["momentum"] = {
    f"momentum_{ti}x{tj}_{ti // ti_threads}_rows": _momentum_tile(
        ti, tj, ti_threads)
    for ti, tj, ti_threads in ((8, 64, 8), (16, 64, 16), (32, 64, 8),
                               (32, 64, 16), (8, 128, 4), (16, 128, 4))}
PRESETS["ablate"] = {
    "no_sweep": [("nsp_sor_tile.cuh", "for (int h = 0; h < 2 * ns; ++h) {",
                  "for (int h = 0; h < 0; ++h) {")],
    "sync_only": [(
        "nsp_sor_tile.cuh",
        "for (int r = 1 + threadIdx.y; r < ei - 1; r += blockDim.y) {",
        "for (int r = 1 + threadIdx.y; r < 0; r += blockDim.y) {")],
    "no_mask": [
        ("nsp_sor_tile.cuh",
         "if (c == 0 || !rb_updates(i, j, dom.ni, dom.nj, parity)) continue;",
         "if (c == 0) continue;"),
        ("nsp_sor.cuh", "const float self_coef =\n",
         "const float self_coef = 0.0f; (void)\n")],
    "no_rhs_load": [("nsp_sor_tile.cuh", "rb_update(sd, sr[e], e,",
                     "rb_update(sd, 0.0f, e,")],
    "no_sync": [("nsp_sor_tile.cuh", "\n    __syncthreads();\n  }\n",
                 "\n  }\n")],
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "nsp_sor_sweeps_simple": (_P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "nsp_sor_warm_sweeps": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                            _F, _F, _I, _P),
    "nsp_sor_warm_sweeps_simple": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                                   _P),
    "nsp_sor_tiled_sweeps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                             _F, _I, _P),
    "nsp_sor_ext_sweeps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _F, _F, _I, _P),
    "nsp_momentum_rhs": (_P, _P, _F, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _I, _P),
    "nsp_momentum_rhs_simple": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _F, _F, _F, _F, _F, _F, _I, _P),
}


def variants(src: Path, edits: dict) -> dict:
    """{name: csrc directory}: src itself, and a copy of it per entry of
    `edits` with that entry's text edits applied."""
    out = {"as_is": src}
    for name, changes in edits.items():
        dst = OUT / f"src_{name}"
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
        for fname, old, new in changes:
            text = (dst / fname).read_text()
            if old not in text:
                raise SystemExit(f"{name}: the text to edit is not in "
                                 f"{src / fname}")
            (dst / fname).write_text(text.replace(old, new, 1))
        out[name] = dst
    return out


def build_all(srcs: dict) -> dict:
    """One library per source directory, all nvcc processes at once;
    prints each tile kernel's register and spill lines."""
    from navierstokes_parallel_tpu_torch.ops.cuda import _build

    nvcc = _build.find_nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for name, src in srcs.items():
        lib = OUT / f"lib_{name}.so"
        lib.unlink(missing_ok=True)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               str(lib), *(str(src / u) for u in UNITS)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        libs[name] = lib
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        fn = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif fn and ("chunk" in fn or "tile" in fn
                         or "momentum" in fn) and (
                    "registers" in line or "spill" in line):
                print(f"[ptxas] {name} {fn[:60]}: {line.strip()}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for fname, argtypes in SIGNATURES.items():
            if not hasattr(lib, fname):  # --src of an earlier csrc/
                continue
            getattr(lib, fname).argtypes = list(argtypes)
            getattr(lib, fname).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def cuda_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _grid(torch, n: int):
    """(constants, rhs) of an n x n cavity with configs/4.in's omega."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    prm = Params(i_max=n, j_max=n, omega=1.7)
    rng = np.random.default_rng(n)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((n, n))
    return sor_kernel.sweep_constants(prm), torch.from_numpy(rhs).cuda()


def time_b1(torch, lib, tiles, grids, n_sweeps: int = 64) -> dict:
    """ms per n_sweeps-sweep call of nsp_sor_tiled_sweeps for each tile
    'ROWSxCOLSxK' on each N^2 grid (mean of two turns, the first kernel
    nsp_sor_sweeps_simple timed between them), and whether the two kernels
    agree bit for bit."""
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n in grids:
        consts, rhs = _grid(torch, n)
        ni, nj = rhs.shape
        d, scratch = torch.empty_like(rhs), torch.empty_like(rhs)

        def simple():
            d.zero_()
            st = lib.nsp_sor_sweeps_simple(d.data_ptr(), rhs.data_ptr(), ni,
                                           nj, n_sweeps, *consts, 0, stream)
            assert st == 0, st

        def tiled(rows, cols, k):
            def run():
                st = lib.nsp_sor_tiled_sweeps(
                    d.data_ptr(), scratch.data_ptr(), rhs.data_ptr(), ni, nj,
                    n_sweeps, rows, cols, k, *consts, 0, stream)
                assert st == 0, st
            return run

        simple()
        want = d.clone()
        reps = 50 if n <= 1024 else 10
        runs = {t: tiled(*(int(x) for x in t.split("x"))) for t in tiles}
        first = {t: cuda_ms(torch, fn, reps) for t, fn in runs.items()}
        out[f"b1_{n}_simple_ms"] = cuda_ms(torch, simple, reps)
        for t, fn in reversed(runs.items()):
            out[f"b1_{n}_{t}_ms"] = (first[t] + cuda_ms(torch, fn, reps)) / 2
            k = int(t.split("x")[2])
            got = scratch if -(-n_sweeps // k) % 2 else d
            torch.cuda.synchronize()
            out[f"b1_{n}_{t}_equals_simple"] = bool(torch.equal(got, want))
    return out


def time_b3(torch, lib, tiles, n: int = 2048, n_sweeps: int = 2) -> dict:
    """ms per call of nsp_sor_warm_sweeps (n_sweeps sweeps from a random p0
    on the padded n^2 level, one launch) for each tile 'ROWSxCOLS', the
    first kernel nsp_sor_warm_sweeps_simple between the two turns, and
    whether they agree bit for bit."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    stream = torch.cuda.current_stream().cuda_stream
    consts = sor_kernel.warm_constants(1.0, float(n) ** 2, float(n) ** 2)
    rng = np.random.default_rng(n)
    p0, rhs = (torch.from_numpy(rng.standard_normal((n + 2, n + 2)).astype(
        np.float32)).cuda() for _ in range(2))
    got, want = torch.empty_like(p0), torch.empty_like(p0)

    def simple():
        st = lib.nsp_sor_warm_sweeps_simple(
            want.data_ptr(), p0.data_ptr(), rhs.data_ptr(), n + 2, n + 2,
            n_sweeps, *consts, 0, stream)
        assert st == 0, st

    def tiled(rows, cols):
        def run():
            st = lib.nsp_sor_warm_sweeps(
                got.data_ptr(), got.data_ptr(), p0.data_ptr(), rhs.data_ptr(),
                n + 2, n + 2, n_sweeps, rows, cols, 8, *consts, 0, stream)
            assert st == 0, st
        return run

    runs = {t: tiled(*(int(x) for x in t.split("x"))) for t in tiles}
    first = {t: cuda_ms(torch, fn, 100) for t, fn in runs.items()}
    out = {f"b3_{n}_simple_ms": cuda_ms(torch, simple, 100)}
    for t, fn in reversed(runs.items()):
        out[f"b3_{n}_{t}_ms"] = (first[t] + cuda_ms(torch, fn, 100)) / 2
        torch.cuda.synchronize()
        out[f"b3_{n}_{t}_equals_simple"] = bool(torch.equal(got, want))
    return out


def time_momentum(torch, lib) -> dict:
    """B2 (nsp_momentum_rhs) at configs/1.in's and configs/4.in's grids:
    us of device time per call in a CUDA graph (mean of two turns, the first
    kernel nsp_momentum_rhs_simple between them), ms per call with CUDA
    events, and whether F, G and rhs equal the first kernel's bit for
    bit."""
    from chip_smoke import graph_ms
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

    out = {}
    for cfg in ("1.in", "4.in"):
        prm = Params.from_file(str(ROOT / "configs" / cfg))
        ni, nj = prm.shape
        rng = np.random.default_rng(ni)
        u, v = (torch.from_numpy(rng.standard_normal(prm.shape).astype(
            np.float32)).cuda() for _ in range(2))
        dt = torch.tensor(1e-3, device="cuda")
        gamma = torch.tensor(0.5, device="cuda")
        scal = torch.stack([dt, gamma])
        got, want = (torch.empty((3, ni, nj), device="cuda")
                     for _ in range(2))
        args = (ni, nj, prm.i_max, prm.j_max,
                *momentum_kernel.kernel_constants(prm), 0)

        # The stream is read at each call: a CUDA graph captures on its own.
        def fused():
            st = lib.nsp_momentum_rhs(
                dt.data_ptr(), gamma.data_ptr(), 0.0, 0.0, u.data_ptr(),
                v.data_ptr(), *(x.data_ptr() for x in got), *args,
                torch.cuda.current_stream().cuda_stream)
            assert st == 0, st

        def simple():
            st = lib.nsp_momentum_rhs_simple(
                scal.data_ptr(), u.data_ptr(), v.data_ptr(),
                *(x.data_ptr() for x in want), *args,
                torch.cuda.current_stream().cuda_stream)
            assert st == 0, st

        key = f"b2_{ni}"
        first = graph_ms(torch, fused)
        out[f"{key}_simple_graph_us"] = graph_ms(torch, simple) * 1e3
        out[f"{key}_graph_us"] = (first + graph_ms(torch, fused)) * 1e3 / 2
        out[f"{key}_call_ms"] = cuda_ms(torch, fused, 100)
        torch.cuda.synchronize()
        out[f"{key}_equals_simple"] = bool(torch.equal(got, want))
    return out


def time_cycle(torch) -> dict:
    """ms per V-cycle (ops/mg.py::v_cycle from delta = 0) at configs/4.in's
    2048^2, the coarse cycle entered at sor_kernel.coarse_cycle_depth and
    one level further down, mean of two turns each, and whether the two
    give the same bits."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels = mg.build_levels(Params.from_file(str(ROOT / "configs" / "4.in")))
    depth = sor_kernel.coarse_cycle_depth(levels)
    rng = np.random.default_rng(4)
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((levels[0].shape[0] - 2,
                                           levels[0].shape[1] - 2))
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)

    def entered_at(d):
        def run():
            saved = sor_kernel.coarse_cycle_depth
            sor_kernel.coarse_cycle_depth = lambda _levels: d
            try:
                return mg.v_cycle(p0, rhs, levels)
            finally:
                sor_kernel.coarse_cycle_depth = saved
        return run

    runs = {levels[d].shape[0]: entered_at(d) for d in (depth, depth + 1)}
    first = {n: cuda_ms(torch, fn, 20) for n, fn in runs.items()}
    out = {}
    for n, fn in reversed(runs.items()):
        out[f"cycle_from_{n}_ms"] = (first[n] + cuda_ms(torch, fn, 20)) / 2
    a, b = (fn() for fn in runs.values())
    torch.cuda.synchronize()
    out["cycle_depths_equal"] = bool(torch.equal(a, b))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path,
                    default=ROOT / "navierstokes_parallel_tpu_torch" / "csrc")
    ap.add_argument("--preset", action="append", default=[],
                    choices=sorted(PRESETS))
    ap.add_argument("--tag", default="")
    ap.add_argument("--tile", default="64x64",
                    help="ROWSxCOLS of the tile of both kernels")
    ap.add_argument("--b1", default="", metavar="RxCxK,...",
                    help="also time B1 with these tiles and sweeps per chunk")
    ap.add_argument("--grids", default="256", metavar="N,...",
                    help="the N^2 interior grids of --b1")
    ap.add_argument("--b3", default="", metavar="RxC,...",
                    help="also time B3 with these tiles")
    ap.add_argument("--momentum", action="store_true",
                    help="also time the fused momentum kernel at 258^2 and "
                         "2050^2")
    ap.add_argument("--cycle", action="store_true",
                    help="also time one V-cycle at 2048^2 with the coarse "
                         "cycle entered at 130^2 and at 66^2")
    args = ap.parse_args(argv)
    tile_rows, tile_cols = (int(x) for x in args.tile.split("x"))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available")
        return 1
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    edits = {}
    for preset in args.preset:
        edits.update(PRESETS[preset])
    libs = build_all(variants(args.src.resolve(), edits))

    prm = Params.from_file(str(ROOT / "configs" / "4.in"))
    consts = sor_kernel.sweep_constants(prm)
    ni, nj = prm.shape
    rng = np.random.default_rng(0)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs).cuda()
    H, ext = 16, prm.i_max + 32
    d_ext = torch.from_numpy(rng.standard_normal((ext, ext)).astype(
        np.float32)).cuda()
    r_ext = torch.from_numpy(rng.standard_normal((ext, ext)).astype(
        np.float32)).cuda()
    d, scratch, out = (torch.zeros_like(rhs), torch.zeros_like(rhs),
                       torch.empty_like(d_ext))
    stream = torch.cuda.current_stream().cuda_stream

    def tiled(lib, n):
        def run():
            st = lib.nsp_sor_tiled_sweeps(
                d.data_ptr(), scratch.data_ptr(), rhs.data_ptr(), ni, nj, n,
                tile_rows, tile_cols, 8, *consts, 0, stream)
            assert st == 0, st
        return run

    def ext_call(lib, ns):
        def run():
            st = lib.nsp_sor_ext_sweeps(
                out.data_ptr(), d_ext.data_ptr(), r_ext.data_ptr(), ext, ext,
                ns, 0, 0, H, prm.i_max, prm.j_max, tile_rows, tile_cols,
                *consts, 0,
                stream)
            assert st == 0, st
        return run

    zeros_ms = cuda_ms(torch, lambda: (torch.zeros((ni, nj), device="cuda"),
                                       torch.zeros((ni, nj), device="cuda")),
                       50)
    print(f"[time] two torch.zeros of {ni}x{nj} f32: {zeros_ms:.4f} ms")
    reference = None
    for name, lib in libs.items():
        row = {"tag": args.tag, "src": str(args.src), "variant": name,
               "tile": args.tile,
               "card": card, "zeros2_ms": zeros_ms}
        # Two turns each, in the order chunk, 64, ext, ext0, ..., reversed.
        cases = [("b4_chunk8_ms", tiled(lib, 8), 100),
                 ("b4_64_ms", tiled(lib, 64), 20),
                 ("b6_ns8_ms", ext_call(lib, 8), 100),
                 ("b6_ns0_ms", ext_call(lib, 0), 100)]
        first = {key: cuda_ms(torch, fn, reps) for key, fn, reps in cases}
        for key, fn, reps in reversed(cases):
            row[key] = (first[key] + cuda_ms(torch, fn, reps)) / 2
        # 64 sweeps are 8 chunks: the result is in d.
        tiled(lib, 64)()
        torch.cuda.synchronize()
        if reference is None:
            reference = d.clone()
        row["b4_64_equals_as_is"] = bool(torch.equal(d, reference))
        if args.b1:
            row.update(time_b1(torch, lib, args.b1.split(","),
                               [int(n) for n in args.grids.split(",")]))
        if args.b3:
            row.update(time_b3(torch, lib, args.b3.split(",")))
        if args.momentum:
            row.update(time_momentum(torch, lib))
        print(f"[time] {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()
            if k.endswith(("_ms", "_us"))))
        print(json.dumps(row))
        with open(OUT / "tile_bench.jsonl", "a") as fh:
            fh.write(json.dumps(row) + "\n")
    if args.cycle:
        row = {"tag": args.tag, "card": card, **time_cycle(torch)}
        print("[time] V-cycle at 2050^2: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k.endswith("_ms")))
        print(json.dumps(row))
        with open(OUT / "tile_bench.jsonl", "a") as fh:
            fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
