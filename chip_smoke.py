#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

    python3 chip_smoke.py --profile   # also a torch.profiler split of one
                                      # 2048^2 outer pass: mg, SOR, sharded,
                                      # and one 256^2 outer pass of SOR

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version (and each SOR sweep kernel against the first
whole-grid kernels, sor_sweeps_simple and sor_warm_sweeps_simple, which
launch once per half-sweep and share nothing with the temporal-blocked tile
but the cell update; the compressed kernel also against its first kernel,
and the fused momentum kernel against its first, two-launch kernel) on the
card with error 0.0 (every kernel rounds each f32 operation once, as its
plain twin does: csrc/nsp_round.cuh), times them beside those first
kernels, drives the paths and checks each answer against the JAX package's
recorded answer:

  * SOR: ``python -m navierstokes_parallel_tpu_torch configs/1.in --stats``
    through ``cli.main`` (kernels sor_sweeps and momentum_rhs), at the
    CLI's K = 64 sweeps per outer pass and again with ``--refine-every
    2048``;
  * multigrid: ``... configs/4.in --method mg --stats`` through
    ``cli.main``, the 2048^2 cavity (kernels sor_warm_sweeps, the smoother
    of the four levels from 2050^2 to 258^2, mg_coarse_cycle, the rest of
    each V-cycle from 130^2 down in one launch, and momentum_rhs), with
    both plain twins barred;
  * tiled SOR: ``... configs/4.in --max-steps 2 --stats`` through
    ``cli.main``, the default method on the 2048^2 cavity, which routes the
    sweeps to the temporal-blocked kernel sor_tiled_sweeps, with the
    whole-grid kernel and the plain sweeps barred; then the same 2 steps
    through ``solver.solve`` on the tiled route and on the first whole-grid
    kernel, which must give the same fields bit for bit;
  * compressed SOR: configs/1.in through ``solver.solve`` with
    ``sor_kernel.USE_COMPRESSED`` (kernel sor_compressed_sweeps, B1's tile
    over colour-compacted arrays), the whole-grid kernel barred; it must
    give the JAX record exactly and the whole-grid route's and the first
    whole-grid kernel's fields bit for bit, and prints its solve time beside
    the whole-grid route's;
  * sharded SOR: ``... configs/4.in --backend sharded --mesh 1x1
    --max-steps 2 --stats`` through ``cli.main`` on a one-rank NCCL group,
    every chunk of sweeps through the extended-block kernel sor_ext_sweeps,
    with every other SOR kernel and every plain sweep function barred; then
    the same steps through ``solve_sharded`` against ``solver.solve`` on the
    tiled route;

then runs small converging cavities (SOR and mg) on the GPU and on the CPU
and compares them.  Before the paths, the "decomposition" check cuts whole
grids into the blocks of 1x1, 2x2 and 2x4 meshes, sweeps each block's
extended block with sor_ext_sweeps and holds the assembled cores against
the whole-grid kernels bit for bit (the deep-halo exactness argument,
parallel/deep_halo.py).  The "cycle" phase times one V-cycle at 2048^2 and
counts its kernel launches under the profiler, as it is and as it was with
the first smoother kernel on every level.  Each path runs with the launch
counts set to 0 just before it and read just after; the JSON record's
``launches`` sums a kernel's counts over the paths.  Each phase prints its
seconds.  Any failed phase prints ``FAIL: ...`` and exits 1 before the last
line; on success the last two lines are the kernels' JSON record (with each
kernel's bound: the least time the card could take for its timed call,
from the bytes it must move and the f32 operations it must do) and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The JAX package's answer on configs/1.in (256^2 cavity, Re=1000, T=0.01,
# SOR omega=1.7, eps=1e-4, max_it=20000, f32 state, K=64), recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/1.in --stats
# which printed U-CENTER: -0.003054, V-CENTER: 0.000017 and
# steps=3 sor_iterations=60000 sor_failures=3 last_res_norm=2.637e-04.
JAX_U_CENTER = -0.003054
JAX_V_CENTER = 0.000017
JAX_STATS = {"steps": 3, "sor_iterations": 60000, "sor_failures": 3}
# The JAX package's answer on configs/4.in (2048^2 cavity, Re=1000, T=0.01,
# f32 state) with the multigrid pressure solve, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --method mg --stats
# which printed U-CENTER: -0.002993, V-CENTER: 0.000003 and
# steps=168 sor_iterations=673 sor_failures=0 last_res_norm=1.182e-04
# (sor_iterations counts V-cycles).
JAX_MG_U_CENTER = -0.002993
JAX_MG_V_CENTER = 0.000003
JAX_MG_STATS = {"steps": 168, "sor_iterations": 673, "sor_failures": 0}
# The JAX package's answer on configs/4.in with its default method (the SOR
# route; on the TPU the strip-tiled kernel, on the CPU _roll_sweeps_xla, the
# same sweeps), stopped after 2 steps, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --backend pallas --max-steps 2 --stats
# which printed U-CENTER: -0.000006, V-CENTER: 0.000000 and
# steps=2 sor_iterations=40000 sor_failures=2 last_res_norm=1.075e+02
# (both steps run into max_it).
TILED_STEPS = 2
JAX_TILED_U_CENTER = -0.000006
JAX_TILED_V_CENTER = 0.000000
JAX_TILED_STATS = {"steps": 2, "sor_iterations": 40000, "sor_failures": 2}
# Its last residual norm, printed to 4 digits; held to 2e-3 relative.
JAX_TILED_RES_NORM = 1.075e2
RES_NORM_RTOL = 2e-3
# The JAX package's sharded backend on configs/4.in over a one-device mesh
# (the deep-halo SOR inner), stopped after 2 steps, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --backend sharded --mesh 1x1 --max-steps 2 --stats
# printed the single-device record above: U-CENTER: -0.000006, V-CENTER:
# 0.000000 and steps=2 sor_iterations=40000 sor_failures=2
# last_res_norm=1.075e+02.  The sharded path is held to the same numbers.
SHARDED_ARGV = ["--backend", "sharded", "--mesh", "1x1", "--max-steps",
                str(TILED_STEPS), "--stats"]
# The reference comparator's contract: 1e-4, absolute where |x| <= 1,
# relative above (tests/conftest.py::assert_close_reference_contract).
CONTRACT = 1e-4
SOR_SWEEPS = 64  # the main path's K: one kernel call = 64 sweeps
# The refinement interval of the benchmark's SOR arm; the main path runs a
# second time with it.
BENCH_REFINE_EVERY = 2048
MG_SWEEPS = 2    # one multigrid smoother call (V(2,2)); 32 on the coarsest
# configs/4.in's finest multigrid level: 2048^2 cells, padded, 1/dx^2.
MG_FINE_SHAPE = (2050, 2050)
MG_FINE_DX2_INV = 2048.0 ** 2
# The tiled kernel's tile heights held against the plain twin: the default
# (64) and 256, whose rhs no longer fits the threads' registers (the
# kernel reads it from device memory; 110,592 B of shared memory).
TILE_SIZES = (64, 256)
# The extended-block kernel's cases: (tag, interior, mesh, sweeps per call,
# warm).  A 1x1 block of configs/4.in (the sharded path on one card: ext
# 2080^2, H = 16), the four blocks of a 2x2 cut of the same grid, a padded
# 99 x 63 interior over 2x4, and the multigrid use (a warm start from a
# non-zero delta with its ghost ring, omega = 1, H = 2 ns) over 2x2.
EXT_CASES = [("configs/4.in 1x1", (2048, 2048), (1, 1), (1, 8), False),
             ("2048^2 2x2", (2048, 2048), (2, 2), (1, 8), False),
             ("99x63 2x4", (99, 63), (2, 4), (1, 8), False),
             ("mg 130^2 2x2", (130, 130), (2, 2), (MG_SWEEPS,), True)]
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per cell update of a red-black sweep (csrc/nsp_sor.cuh:
# 7 in the neighbour sum, 4 in the relaxation; self_coef not counted) and
# per interior cell of the momentum pass (csrc/momentum.cu: 57 for F, 57
# for G, 2 for the gamma factors, 6 for rhs).
SWEEP_FLOPS_PER_CELL = 11
MOMENTUM_FLOPS_PER_CELL = 122


class PhaseFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def contract_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    big = (np.abs(a) > 1.0) | (np.abs(b) > 1.0)
    denom = np.maximum(np.abs(a), np.abs(b))
    rel = np.abs(a - b) / np.where(denom == 0, 1.0, denom)
    return float(np.max(np.where(big, rel, np.abs(a - b))))


@contextlib.contextmanager
def barred(module, names, where: str):
    """Replace module.<name> for each name by a function that fails the
    phase, for the duration of the block."""
    saved = {name: getattr(module, name) for name in names}

    def refusal(name):
        def refuse(*_args, **_kw):
            raise PhaseFailed(f"{where} ran {name}")
        return refuse

    for name in names:
        setattr(module, name, refusal(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def timed_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")
    return out


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card: CUDA events around `reps`
    calls, after two warm-up calls."""
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


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device milliseconds per call: `calls` calls of fn captured in
    one CUDA graph (after a warm-up call on a side stream), the graph
    replayed `reps` times between CUDA events, so the host's cost per call
    is left out (what is left of it: one graph launch per `calls` calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def phase_device(torch) -> str:
    check(torch.cuda.is_available(), "CUDA is not available")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from navierstokes_parallel_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")


def phase_compare(torch) -> dict:
    """Each kernel against its plain version at its paths' shapes and at an
    odd non-square one, every SOR sweep kernel also against the first
    whole-grid kernels (one launch per half-sweep, no tile); returns the
    max abs error per kernel."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    rng = np.random.default_rng(0)
    errs = {"sor": compare_whole_grid(torch, rng), "momentum": 0.0,
            "sor_tiled": 0.0, "sor_compressed": 0.0}
    # The fused momentum kernel at the main path's 258^2, the mg path's
    # 2050^2 and at 99 x 63, against its twin and its first kernel
    # (momentum_rhs_simple: two launches), dt and gamma as the time step
    # passes them (0-d f32 tensors on the card).
    for i_max, j_max in ((256, 256), (2048, 2048), (97, 61)):
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     g_x=0.1, g_y=-0.2, omega=1.7)
        shape = prm.shape
        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        u, v = u.cuda(), v.cuda()
        dt = torch.tensor(0.004, device="cuda")
        gamma = torch.tensor(0.7, device="cuda")
        got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
        want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
        first = momentum_kernel.momentum_rhs_simple(u, v, dt, gamma, prm)
        torch.cuda.synchronize()
        for name, g, w, f in zip(("F", "G", "rhs"), got, want, first):
            err = float((g - w).abs().max())
            same = torch.equal(g, f)
            print(f"[compare] momentum {name} {shape}: max abs err "
                  f"{err:.3e} vs the plain twin (expected 0), equals "
                  f"momentum_rhs_simple {same}")
            check(err == 0.0 and same,
                  f"momentum kernel disagrees on {name} at {shape}")
            errs["momentum"] = max(errs["momentum"], err)

    errs["sor_warm"] = compare_warm(torch, rng)
    errs["mg_coarse_cycle"] = compare_coarse_cycle(torch, rng)

    # The tiled kernel at the SOR paths' 258^2 and 2050^2 and at 99 x 63,
    # over one sweep, one chunk, the path's 64 and 20 (a short last chunk),
    # at two tile heights; the compressed kernel at 258^2, 98 x 64, 64 x 62
    # and 99 x 64 (odd rows) over no sweep, one, a short chunk and 64.  Both
    # must equal their plain twins and the first whole-grid kernel (no
    # tile) bit for bit, the compressed one also its first kernel
    # (inner_sweeps_compressed_simple: one launch per half-sweep).
    cases = [("sor_tiled", (i_max, j_max), n, tile)
             for i_max, j_max in ((256, 256), (2048, 2048), (97, 61))
             for n in (1, sor_kernel.SWEEPS_PER_CHUNK, SOR_SWEEPS, 20)
             for tile in TILE_SIZES]
    cases += [("sor_compressed", shape, n, None)
              for shape in ((256, 256), (96, 62), (62, 60), (97, 62))
              for n in (0, 1, 7, SOR_SWEEPS)]
    for key, (i_max, j_max), n, tile in cases:
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     omega=1.7)
        rhs = np.zeros(prm.shape, np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((i_max, j_max))
        rhs_d = torch.from_numpy(rhs).cuda()
        if key == "sor_tiled":
            got = sor_kernel.inner_sweeps_tiled(rhs_d, n, prm, tile_rows=tile)
            want = sor_kernel.inner_sweeps_tiled_plain(rhs_d, n, prm,
                                                       tile_rows=tile)
        else:
            got = sor_kernel.inner_sweeps_compressed(rhs_d, n, prm)
            want = sor_kernel.inner_sweeps_compressed_plain(rhs_d, n, prm)
        whole = sor_kernel.whole_grid_sweeps_simple(rhs_d, n, prm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, whole)
        also = ""
        if key == "sor_compressed":
            first = torch.equal(got, sor_kernel.inner_sweeps_compressed_simple(
                rhs_d, n, prm))
            same = same and first
            also = f", sor_compressed_sweeps_simple {first}"
        print(f"[compare] {key} {prm.shape} n={n}"
              f"{'' if tile is None else f' tile={tile}'}: max abs err "
              f"{err:.3e} (expected 0), equals sor_sweeps_simple "
              f"{torch.equal(got, whole)}{also}")
        check(err == 0.0 and same, f"{key} kernel disagrees at {prm.shape}, "
                                   f"n={n}, tile={tile}")
        errs[key] = max(errs[key], err)
    errs["sor_ext"] = compare_ext(torch, rng)
    return errs


def compare_whole_grid(torch, rng) -> float:
    """sor_sweeps (the temporal tile) against its plain twin and against
    its first kernel sor_sweeps_simple, at the SOR paths' 258^2 and 2050^2
    and at 99 x 63 and 98 x 64, for no sweep, one, a short chunk, the
    path's 64 and one outer pass of the benchmark's K = 2048: error 0.0
    (the plain twin is left out where it would take minutes).  Returns the
    max abs error."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    worst = 0.0
    for i_max, j_max in ((256, 256), (2048, 2048), (97, 61), (96, 62)):
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     omega=1.7)
        rhs = random_grid(torch, rng, (i_max, j_max), ring=False)
        tile = "x".join(map(str, sor_kernel.whole_grid_tile(prm.shape)))
        for n in (0, 1, 7, SOR_SWEEPS, BENCH_REFINE_EVERY):
            got = sor_kernel.whole_grid_sweeps(rhs, n, prm)
            first = sor_kernel.whole_grid_sweeps_simple(rhs, n, prm)
            err = float((got - first).abs().max())
            with_plain = n * rhs.numel() <= SOR_SWEEPS * 2050 * 2050
            if with_plain:
                want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
                err = max(err, float((got - want).abs().max()))
            torch.cuda.synchronize()
            print(f"[compare] sor {prm.shape} n={n} tile={tile}: max abs err "
                  f"{err:.3e} vs sor_sweeps_simple"
                  f"{' and the plain twin' if with_plain else ''} "
                  f"(expected 0)")
            check(err == 0.0, f"sor kernel disagrees at {prm.shape}, n={n}")
            worst = max(worst, err)
    return worst


def mg_levels():
    """The multigrid levels of configs/4.in and the depth from which the
    coarse cycle takes them."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels = mg.build_levels(Params.from_file(str(ROOT / "configs" / "4.in")))
    return levels, sor_kernel.coarse_cycle_depth(levels)


def compare_warm(torch, rng) -> float:
    """sor_warm_sweeps at the four levels the mg path gives it (2050^2,
    1026^2, 514^2, 258^2), at levels smaller than a few tiles (130^2, 66^2,
    10^2) and at 99 x 63, against its plain twin and against its first
    kernel sor_warm_sweeps_simple, for omega 1 and 1.7 and 0, 1, 2 and 32
    sweeps (32 sweeps are four launches), from a p0 whose ghost ring is not
    0: error 0.0 and the ring kept.  Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels, _ = mg_levels()
    cases = [(lv.shape, lv.dx2_inv, lv.dy2_inv) for lv in levels
             if lv.shape[0] in (2050, 1026, 514, 258, 130, 66, 10)]
    cases.append(((99, 63), 97.0 ** 2, (61 / 0.7) ** 2))
    worst = 0.0
    for shape, dx2, dy2 in cases:
        for omega in (1.0, 1.7):
            for n in (0, 1, MG_SWEEPS, 32):
                p0, rhs = (random_grid(torch, rng,
                                       (shape[0] - 2, shape[1] - 2),
                                       ring=True) for _ in range(2))
                got = sor_kernel.warm_sweeps(p0, rhs, n, omega, dx2, dy2)
                want = sor_kernel.warm_sweeps_plain(p0, rhs, n, omega, dx2,
                                                    dy2)
                first = sor_kernel.warm_sweeps_simple(p0, rhs, n, omega, dx2,
                                                      dy2)
                torch.cuda.synchronize()
                err = max(float((got - want).abs().max()),
                          float((got - first).abs().max()))
                ring_kept = all(torch.equal(a, b) for a, b in (
                    (got[0], p0[0]), (got[-1], p0[-1]), (got[:, 0], p0[:, 0]),
                    (got[:, -1], p0[:, -1])))
                print(f"[compare] sor_warm {shape} omega={omega} "
                      f"n={n}: max abs err {err:.3e} vs the plain twin and "
                      f"sor_warm_sweeps_simple (expected 0), ghost ring kept "
                      f"{ring_kept}")
                check(err == 0.0 and ring_kept,
                      f"warm-start kernel disagrees at {shape}, "
                      f"omega={omega}, n={n}")
                worst = max(worst, err)
    return worst


def cycle_on_simple(p, rhs, levels):
    """ops/mg.py's V-cycle from levels[0] down with the first smoother
    kernel (sor_warm_sweeps_simple) on every level and no coarse cycle:
    the cycle as it ran before the smoother's redesign."""
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    def smooth(q, rhs_l, lvl, n):
        return sor_kernel.warm_sweeps_simple(q, rhs_l, n, 1.0, lvl.dx2_inv,
                                             lvl.dy2_inv)

    return mg._cycle(p, rhs, levels, 0, 2, 2, 32, smooth, len(levels))


def compare_coarse_cycle(torch, rng) -> float:
    """mg_coarse_cycle on the tail of configs/4.in's hierarchy (from the
    depth the mg path enters it, and one level further down) against its
    plain twin coarse_cycle_plain and against the same recursion on
    sor_warm_sweeps_simple, from a random p and rhs (ghost rings not 0):
    error 0.0.  Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels, depth = mg_levels()
    worst = 0.0
    for d in (depth, depth + 1):
        tail = levels[d:]
        size = (tail[0].shape[0] - 2, tail[0].shape[1] - 2)
        p, rhs = (random_grid(torch, rng, size, ring=True) for _ in range(2))
        got = sor_kernel.coarse_cycle(p, rhs, tail)
        want = sor_kernel.coarse_cycle_plain(p, rhs, tail)
        first = cycle_on_simple(p, rhs, tail)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float((got - first).abs().max()))
        print(f"[compare] mg_coarse_cycle {len(tail)} levels from "
              f"{tail[0].shape} ({sor_kernel.cycle_shared_bytes(tail)} B of "
              f"shared memory): max abs err {err:.3e} vs coarse_cycle_plain "
              f"and the recursion on sor_warm_sweeps_simple (expected 0)")
        check(err == 0.0, f"coarse cycle disagrees from {tail[0].shape}")
        worst = max(worst, err)
    return worst


def ext_setup(tag: str, size, mesh, warm: bool):
    """(ext_sweeps' last argument, li, lj, K, the blocks' global origins)
    of an EXT_CASES cut: configs/4.in's Params, another grid's, or (warm)
    a multigrid level's constants with omega = 1 and K = its sweeps."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.parallel import deep_halo, topology

    li, lj = topology.local_block_dims(mesh, *size)
    origins = [(ax * li, ay * lj) for ax in range(mesh[0])
               for ay in range(mesh[1])]
    if warm:
        return ((*size, 1.0, 0.9 * size[0] ** 2, 1.3 * size[1] ** 2), li, lj,
                MG_SWEEPS, origins)
    if tag.startswith("configs/4.in"):
        prm = Params.from_file(str(ROOT / "configs" / "4.in"))
    else:
        prm = Params(i_max=size[0], j_max=size[1], a=1.0, b=0.7, Re=1000.0,
                     omega=1.7)
    return prm, li, lj, deep_halo.comm_depth(prm, li, lj), origins


def random_grid(torch, rng, size, ring: bool):
    """A padded f32 grid on the card, random on the interior (and on the
    ghost ring when `ring`), else 0."""
    shape = (size[0] + 2, size[1] + 2)
    g = rng.standard_normal(shape).astype(np.float32)
    if not ring:
        g[0], g[-1], g[:, 0], g[:, -1] = 0, 0, 0, 0
    return torch.from_numpy(g).cuda()


def compare_ext(torch, rng) -> float:
    """sor_ext_sweeps against its twin ext_sweeps_plain on every block of
    every EXT_CASES cut, on every cell at least 2 ns from the block's edge
    (the twin's rolls wrap around there, the kernel reads zeros): error
    0.0, and the cells outside the global interior keep their input.
    Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    worst = 0.0
    for tag, size, mesh, sweeps, warm in EXT_CASES:
        consts, li, lj, K, origins = ext_setup(tag, size, mesh, warm)
        H = 2 * K
        i_max, j_max, (_, _, dx2, dy2) = sor_kernel.ext_constants(consts)
        delta0 = random_grid(torch, rng, size, ring=warm)
        rhs = random_grid(torch, rng, size, ring=warm)
        for ns in sweeps:
            err, kept = 0.0, True
            for origin in origins:
                d_ext = deep_halo.cut_ext_block(delta0, origin, li, lj, H)
                r_ext = deep_halo.cut_ext_block(rhs, origin, li, lj, H)
                got = sor_kernel.ext_sweeps(d_ext, r_ext, ns, origin, H,
                                            consts)
                want = sor_kernel.ext_sweeps_plain(d_ext, r_ext, ns, origin,
                                                   H, consts)
                interior = sor_kernel.ext_masks(got.shape, H, origin, i_max,
                                                j_max, dx2, dy2,
                                                device=got.device)[0]
                torch.cuda.synchronize()
                e = 2 * ns
                inner = (slice(e, got.shape[0] - e),
                         slice(e, got.shape[1] - e))
                err = max(err, float((got[inner] - want[inner]).abs().max()))
                kept = kept and torch.equal(got[~interior], d_ext[~interior])
            print(f"[compare] sor_ext {tag}: {len(origins)} blocks of ext "
                  f"{li + 2 * H}x{lj + 2 * H}, H={H}, ns={ns}: max abs err "
                  f"{err:.3e} on cells >= {2 * ns} from the edge (expected 0)"
                  f", cells outside the interior kept {kept}")
            check(err == 0.0 and kept,
                  f"extended-block kernel disagrees ({tag}, ns={ns})")
            worst = max(worst, err)
    return worst


def phase_decomposition(torch) -> None:
    """For every EXT_CASES cut: n sweeps block by block through
    sor_ext_sweeps in chunks of K (each chunk's blocks cut from the grid
    the chunk before left: the deep exchange), the cores assembled, equal
    the whole-grid kernels on the whole grid bit for bit: sor_sweeps_simple
    (the first kernel, no tile), sor_sweeps and sor_tiled_sweeps from
    delta = 0, sor_warm_sweeps_simple and sor_warm_sweeps for the warm
    start."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    rng = np.random.default_rng(5)
    for tag, size, mesh, sweeps, warm in EXT_CASES:
        consts, li, lj, K, origins = ext_setup(tag, size, mesh, warm)
        H = 2 * K
        rhs = random_grid(torch, rng, size, ring=warm)
        start = (random_grid(torch, rng, size, ring=True) if warm
                 else torch.zeros_like(rhs))
        # A cold start also runs two chunks (K + 5 sweeps).
        for n in sweeps if warm else (*sweeps, K + 5):
            delta, done = start, 0
            while done < n:
                ns = min(K, n - done)
                nxt = delta.clone()
                for ox, oy in origins:
                    ext = sor_kernel.ext_sweeps(
                        deep_halo.cut_ext_block(delta, (ox, oy), li, lj, H),
                        deep_halo.cut_ext_block(rhs, (ox, oy), li, lj, H),
                        ns, (ox, oy), H, consts)
                    ri, rj = min(li, size[0] - ox), min(lj, size[1] - oy)
                    nxt[1 + ox:1 + ox + ri, 1 + oy:1 + oy + rj] = \
                        ext[H:H + ri, H:H + rj]
                delta, done = nxt, done + ns
            if warm:
                refs = {"sor_warm_sweeps_simple":
                        sor_kernel.warm_sweeps_simple(start, rhs, n,
                                                      *consts[2:]),
                        "sor_warm_sweeps": sor_kernel.warm_sweeps(
                            start, rhs, n, *consts[2:])}
            else:
                refs = {"sor_sweeps_simple":
                        sor_kernel.whole_grid_sweeps_simple(rhs, n, consts),
                        "sor_sweeps": sor_kernel.whole_grid_sweeps(
                            rhs, n, consts),
                        "sor_tiled_sweeps": sor_kernel.inner_sweeps_tiled(
                            rhs, n, consts)}
            torch.cuda.synchronize()
            same = {name: torch.equal(delta, ref)
                    for name, ref in refs.items()}
            print(f"[decomposition] {tag}: {len(origins)} blocks, n={n} in "
                  f"chunks of {K}: assembled cores equal {same}")
            check(all(same.values()),
                  f"the decomposition differs from the whole grid ({tag}, "
                  f"n={n})")


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes through device memory and do n_flops f32 operations, the larger
    of the two at the published peaks, and which one it is."""
    t_mem = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_F32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def sweeps_bound(shape, arrays: int, updated_cells: int, n_sweeps: int):
    """bound() of n_sweeps red-black sweeps over `updated_cells` cells of
    an f32 array of `shape`, with `arrays` such arrays read once or written
    once (rhs and delta from delta = 0: 2; delta0, rhs and delta: 3)."""
    return bound(arrays * 4 * shape[0] * shape[1],
                 SWEEP_FLOPS_PER_CELL * updated_cells * n_sweeps)


def cycle_bound(levels, nu1: int = 2, nu2: int = 2, coarse_sweeps: int = 32):
    """bound() of one coarse cycle: p and rhs of the first level read and p
    written once; the sweeps' updates, 12 operations per cell for the
    residual (self_coef not counted), 4 per coarse cell for the restriction
    and 1 per cell for the correction."""
    flops, last = 0, len(levels) - 1
    for k, lvl in enumerate(levels):
        cells = (lvl.shape[0] - 2) * (lvl.shape[1] - 2)
        if k == last:
            flops += SWEEP_FLOPS_PER_CELL * cells * coarse_sweeps
        else:
            flops += (SWEEP_FLOPS_PER_CELL * (nu1 + nu2) + 12 + 1 + 1) * cells
    shape = levels[0].shape
    return bound(3 * 4 * shape[0] * shape[1], flops)


def tile_note(sor_kernel, tile_rows: int, ns: int, halo: int,
              updates: int, k_ms: float) -> str:
    """The tile's geometry on the card, its cell updates per written cell
    and the call's useful cell updates per second (`updates` in k_ms)."""
    g = sor_kernel.tile_report(tile_rows, sor_kernel.TILE_COLS, halo)
    per_cell = sor_kernel.tile_updates_per_cell(tile_rows,
                                                sor_kernel.TILE_COLS, ns)
    return (f"; tile {tile_rows}x{sor_kernel.TILE_COLS} + halo {halo} "
            f"({g['rows']}x{g['cols']} in shared memory), {ns} sweeps per "
            f"launch, {g['threads']} threads, {g['shared_bytes']} B shared, "
            f"{g['blocks_per_sm']} blocks per SM, {g['registers']} registers,"
            f" rows per thread {g['rows_per_thread']}; "
            f"{per_cell:.3f} updates per written cell; "
            f"{updates / (k_ms * 1e-3) / 1e9:.2f} G cell updates/s")


def phase_time(torch) -> dict:
    """Kernel and plain times at the SOR main path's 258^2 padded grid, (the
    smoother) at the mg path's finest 2050^2 level and (the tiled kernel) at
    the tiled path's 2050^2, in turns (plain, kernel, kernel, plain), the
    whole-grid kernel and the smoother with their first kernels
    (sor_sweeps_simple, sor_warm_sweeps_simple) between the turns; the
    smoother at 66^2 for 2 and 32 sweeps and the coarse cycle from 130^2
    and from 66^2 down the same way; the momentum kernel (time_momentum)
    and the compressed kernel (time_compressed) beside their first
    kernels; the tiled kernel with the first whole-grid kernel and the
    current one beside it (plain, kernel, simple, sor_sweeps, kernel,
    plain); the extended-block kernel at the sharded path's 2080^2 block of
    configs/4.in, one call of K = 8 sweeps, with one 8-sweep chunk of the
    tiled kernel at 2050^2 beside it.  Returns (kernel ms, plain ms,
    bound ms, bound by) per kernel: the tiled kernel's and the momentum
    kernel's at 2050^2."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    rng = np.random.default_rng(1)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs).cuda()
    p_fine = torch.from_numpy(
        rng.standard_normal(MG_FINE_SHAPE).astype(np.float32)).cuda()
    rhs_fine = torch.from_numpy(
        rng.standard_normal(MG_FINE_SHAPE).astype(np.float32)).cuda()
    warm_args = (p_fine, rhs_fine, MG_SWEEPS, 1.0, MG_FINE_DX2_INV,
                 MG_FINE_DX2_INV)
    prm4 = Params.from_file(str(ROOT / "configs" / "4.in"))
    rhs4 = np.zeros(prm4.shape, np.float32)
    rhs4[1:-1, 1:-1] = rng.standard_normal((prm4.i_max, prm4.j_max))
    rhs4 = torch.from_numpy(rhs4).cuda()

    levels, depth = mg_levels()
    tail = levels[depth:]
    p_tail, rhs_tail = (torch.from_numpy(rng.standard_normal(
        tail[0].shape).astype(np.float32)).cuda() for _ in range(2))
    # name: (kernel, plain, first kernel or None, kernel reps, plain reps)
    cases = {
        "sor": (lambda: sor_kernel.inner_sweeps(rhs, SOR_SWEEPS, prm),
                lambda: sor_kernel.inner_sweeps_plain(rhs, SOR_SWEEPS, prm),
                lambda: sor_kernel.whole_grid_sweeps_simple(rhs, SOR_SWEEPS,
                                                            prm),
                50, 3),
        "sor_warm": (lambda: sor_kernel.warm_sweeps(*warm_args),
                     lambda: sor_kernel.warm_sweeps_plain(*warm_args),
                     lambda: sor_kernel.warm_sweeps_simple(*warm_args),
                     100, 10),
        "mg_coarse_cycle": (
            lambda: sor_kernel.coarse_cycle(p_tail, rhs_tail, tail),
            lambda: sor_kernel.coarse_cycle_plain(p_tail, rhs_tail, tail),
            lambda: cycle_on_simple(p_tail, rhs_tail, tail), 100, 5),
    }
    interior = prm.i_max * prm.j_max
    bounds = {"sor": sweeps_bound(prm.shape, 2, interior, SOR_SWEEPS),
              "sor_warm": sweeps_bound(MG_FINE_SHAPE, 3,
                                       (MG_FINE_SHAPE[0] - 2)
                                       * (MG_FINE_SHAPE[1] - 2), MG_SWEEPS),
              "mg_coarse_cycle": cycle_bound(tail),
              "sor_tiled": sweeps_bound(prm4.shape, 2,
                                        prm4.i_max * prm4.j_max, SOR_SWEEPS),
              "sor_compressed": sweeps_bound(prm.shape, 2, interior,
                                             SOR_SWEEPS)}
    times = {}
    for name, (kernel, plain, first, k_reps, p_reps) in cases.items():
        p1 = cuda_ms(torch, plain, p_reps)
        k1 = cuda_ms(torch, kernel, k_reps)
        f_ms = cuda_ms(torch, first, k_reps) if first else None
        k2 = cuda_ms(torch, kernel, k_reps)
        p2 = cuda_ms(torch, plain, p_reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *bounds[name])
        shape, per = prm.shape, ""
        if name == "sor":
            per = (f" ({SOR_SWEEPS} sweeps, tile "
                   f"{'x'.join(map(str, sor_kernel.whole_grid_tile(shape)))})")
        elif name == "sor_warm":
            shape, per = MG_FINE_SHAPE, f" ({MG_SWEEPS} sweeps, omega=1)"
        elif name == "mg_coarse_cycle":
            shape, per = tail[0].shape, f" ({len(tail)} levels, V(2,2), 32)"
        simple = ""
        if first:
            what = ("the recursion on the first kernel"
                    if name == "mg_coarse_cycle" else "first kernel")
            simple = f", {what} (one launch per half-sweep) {f_ms:.4f} ms"
        print(f"[time] {name} at {shape}{per}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms{simple} per call")

    # The smoother at 66^2 (two tiles), a V-cycle's 2 sweeps and the coarse
    # solve's 32, and the coarse cycle entered one level further down
    # (66^2), each beside the first kernel.
    lv66 = next(lv for lv in levels if lv.shape[0] == 66)
    p66, rhs66 = (torch.from_numpy(rng.standard_normal(lv66.shape).astype(
        np.float32)).cuda() for _ in range(2))
    for n in (MG_SWEEPS, 32):
        args66 = (p66, rhs66, n, 1.0, lv66.dx2_inv, lv66.dy2_inv)
        k1 = cuda_ms(torch, lambda: sor_kernel.warm_sweeps(*args66), 200)
        f_ms = cuda_ms(torch, lambda: sor_kernel.warm_sweeps_simple(*args66),
                       200)
        k2 = cuda_ms(torch, lambda: sor_kernel.warm_sweeps(*args66), 200)
        b_ms, by = sweeps_bound(lv66.shape, 3, 64 * 64, n)
        print(f"[time] sor_warm at {lv66.shape} ({n} sweeps): kernel "
              f"{k1:.4f} / {k2:.4f} ms, first kernel {f_ms:.4f} ms per call; bound "
              f"{b_ms * 1e3:.4f} us ({by})")
    tail66 = levels[depth + 1:]
    k1 = cuda_ms(torch, lambda: sor_kernel.coarse_cycle(p66, rhs66, tail66),
                 200)
    f_ms = cuda_ms(torch, lambda: cycle_on_simple(p66, rhs66, tail66), 20)
    k2 = cuda_ms(torch, lambda: sor_kernel.coarse_cycle(p66, rhs66, tail66),
                 200)
    print(f"[time] mg_coarse_cycle at {tail66[0].shape} ({len(tail66)} "
          f"levels): kernel {k1:.4f} / {k2:.4f} ms, the recursion on the "
          f"first kernel {f_ms:.4f} ms per call")

    times["momentum"] = time_momentum(torch, rng, prm)
    times["sor_compressed"] = time_compressed(torch, prm, rhs, bounds)

    # The tiled kernel at 258^2 and 2050^2, each beside its plain twin, the
    # first whole-grid kernel and the current one, 64 sweeps.
    side_by_side = [
        ("sor_tiled", prm, rhs, sor_kernel.inner_sweeps_tiled,
         sor_kernel.inner_sweeps_tiled_plain, 10),
        ("sor_tiled", prm4, rhs4, sor_kernel.inner_sweeps_tiled,
         sor_kernel.inner_sweeps_tiled_plain, 2)]
    for name, p_, r_, kernel, plain, p_reps in side_by_side:
        def run(fn, p_=p_, r_=r_):
            return lambda: fn(r_, SOR_SWEEPS, p_)
        p1 = cuda_ms(torch, run(plain), p_reps)
        k1 = cuda_ms(torch, run(kernel), 20)
        b1 = cuda_ms(torch, run(sor_kernel.whole_grid_sweeps_simple), 20)
        b2 = cuda_ms(torch, run(sor_kernel.whole_grid_sweeps), 20)
        k2 = cuda_ms(torch, run(kernel), 20)
        p2 = cuda_ms(torch, run(plain), p_reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *bounds[name])
        K = sor_kernel.SWEEPS_PER_CHUNK
        note = tile_note(sor_kernel, sor_kernel.TILE_ROWS, K, 2 * K,
                         p_.i_max * p_.j_max * SOR_SWEEPS, (k1 + k2) / 2)
        print(f"[time] {name} at {p_.shape} ({SOR_SWEEPS} sweeps): kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"sor_sweeps_simple {b1:.4f} ms, sor_sweeps {b2:.4f} ms per "
              f"call; per sweep kernel "
              f"{(k1 + k2) / 2 * 1e3 / SOR_SWEEPS:.3f} us, sor_sweeps "
              f"{b2 * 1e3 / SOR_SWEEPS:.3f} us{note}")
    for tile in TILE_SIZES[1:]:
        def tiled(tile=tile):
            return sor_kernel.inner_sweeps_tiled(rhs4, SOR_SWEEPS, prm4,
                                                 tile_rows=tile)
        t1, t2 = cuda_ms(torch, tiled, 20), cuda_ms(torch, tiled, 20)
        K = sor_kernel.SWEEPS_PER_CHUNK
        note = tile_note(sor_kernel, tile, K, 2 * K,
                         prm4.i_max * prm4.j_max * SOR_SWEEPS, (t1 + t2) / 2)
        print(f"[time] sor_tiled at {prm4.shape} tile={tile} ({SOR_SWEEPS} "
              f"sweeps): kernel {t1:.4f} / {t2:.4f} ms per call{note}")

    # The extended-block kernel on the sharded path's one block of
    # configs/4.in (li = lj = 2048, K = 8, H = 16): one call of K sweeps,
    # beside one K-sweep chunk of the tiled kernel on the whole grid.
    K = deep_halo.comm_depth(prm4, prm4.i_max, prm4.j_max)
    H = 2 * K
    delta4 = np.zeros(prm4.shape, np.float32)
    delta4[1:-1, 1:-1] = rng.standard_normal((prm4.i_max, prm4.j_max))
    d_ext, r_ext = (deep_halo.cut_ext_block(g, (0, 0), prm4.i_max,
                                            prm4.j_max, H)
                    for g in (torch.from_numpy(delta4).cuda(), rhs4))

    def ext(fn):
        return lambda: fn(d_ext, r_ext, K, (0, 0), H, prm4)

    p1 = cuda_ms(torch, ext(sor_kernel.ext_sweeps_plain), 5)
    k1 = cuda_ms(torch, ext(sor_kernel.ext_sweeps), 50)
    b1 = cuda_ms(torch, lambda: sor_kernel.inner_sweeps_tiled(rhs4, K, prm4),
                 50)
    b2 = cuda_ms(torch, lambda: sor_kernel.inner_sweeps_tiled(rhs4, K, prm4),
                 50)
    k2 = cuda_ms(torch, ext(sor_kernel.ext_sweeps), 50)
    p2 = cuda_ms(torch, ext(sor_kernel.ext_sweeps_plain), 5)
    times["sor_ext"] = ((k1 + k2) / 2, (p1 + p2) / 2,
                        *sweeps_bound(d_ext.shape, 3,
                                      prm4.i_max * prm4.j_max, K))
    note = tile_note(sor_kernel, sor_kernel.EXT_TILE_ROWS, K, H,
                     prm4.i_max * prm4.j_max * K, (k1 + k2) / 2)
    print(f"[time] sor_ext at {tuple(d_ext.shape)} ({K} sweeps, H={H}): "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"sor_tiled ({K} sweeps at {prm4.shape}) {b1:.4f} / {b2:.4f} ms "
          f"per call{note}")
    for name, (k_ms, _, b_ms, by) in times.items():
        print(f"[time] {name}: bound {b_ms * 1e3:.3f} us ({by}), kernel "
              f"{k_ms * 1e3:.3f} us, {b_ms / k_ms:.4f} of the bound")
    k_ms, p_ms = times["sor"][:2]
    print(f"[time] sor per sweep: kernel {k_ms * 1e3 / SOR_SWEEPS:.3f} us, "
          f"plain {p_ms * 1e3 / SOR_SWEEPS:.3f} us")
    k_ms, p_ms = times["sor_warm"][:2]
    print(f"[time] sor_warm per sweep at {MG_FINE_SHAPE}: kernel "
          f"{k_ms * 1e3 / MG_SWEEPS:.3f} us, plain "
          f"{p_ms * 1e3 / MG_SWEEPS:.3f} us")
    return times


def time_momentum(torch, rng, prm1):
    """The fused momentum kernel at configs/1.in's 258^2 and at the mg
    path's 2050^2, in turns with its plain twin and its first kernel
    (momentum_rhs_simple, two launches): plain, kernel, first, kernel,
    first, plain.  Returns (kernel ms, plain ms, bound ms, bound by) at
    2050^2, where ~169 of a path's calls run."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

    prm4 = Params.from_file(str(ROOT / "configs" / "4.in"))
    out = None
    for prm, reps, p_reps in ((prm1, 200, 20), (prm4, 100, 5)):
        u, v = (torch.from_numpy(rng.standard_normal(prm.shape).astype(
            np.float32)).cuda() for _ in range(2))
        dt = torch.tensor(1e-3, device="cuda")
        gamma = torch.tensor(0.5, device="cuda")

        def run(fn, u=u, v=v, dt=dt, gamma=gamma, prm=prm):
            return lambda: fn(u, v, dt, gamma, prm)

        p1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_plain), p_reps)
        k1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs), reps)
        f1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_simple), reps)
        k2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs), reps)
        f2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_simple), reps)
        p2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_plain), p_reps)
        g_k1 = graph_ms(torch, run(momentum_kernel.momentum_rhs))
        g_f = graph_ms(torch, run(momentum_kernel.momentum_rhs_simple))
        g_k2 = graph_ms(torch, run(momentum_kernel.momentum_rhs))
        b_ms, by = bound(5 * 4 * prm.shape[0] * prm.shape[1],
                         MOMENTUM_FLOPS_PER_CELL * prm.i_max * prm.j_max)
        print(f"[time] momentum at {prm.shape}: kernel {k1:.4f} / {k2:.4f} "
              f"ms, first kernel (two launches) {f1:.4f} / {f2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms per call; device time in a "
              f"CUDA graph: kernel {g_k1 * 1e3:.3f} / {g_k2 * 1e3:.3f} us, "
              f"first kernel {g_f * 1e3:.3f} us; bound {b_ms * 1e3:.3f} us "
              f"({by}), kernel call {b_ms / ((k1 + k2) / 2):.4f} of it, "
              f"device time {b_ms / ((g_k1 + g_k2) / 2):.4f}")
        out = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, by)
    return out


def time_compressed(torch, prm, rhs, bounds):
    """The compressed kernel at configs/1.in's 258^2, 64 sweeps, in turns
    with its plain twin, its first kernel (inner_sweeps_compressed_simple,
    one launch per half-sweep), the whole-grid kernel B1 (the same tile on
    the full grid), B1's first kernel, its kernel part alone (on a
    compacted rhs: no compaction, no expansion) and the compaction and
    expansion alone.  Returns (kernel ms, plain ms, bound ms, bound by)."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    colours = sor_kernel._compress_planar(rhs)
    runs = {
        "plain": (lambda: sor_kernel.inner_sweeps_compressed_plain(
            rhs, SOR_SWEEPS, prm), 3),
        "kernel": (lambda: sor_kernel.inner_sweeps_compressed(
            rhs, SOR_SWEEPS, prm), 50),
        "first kernel": (lambda: sor_kernel.inner_sweeps_compressed_simple(
            rhs, SOR_SWEEPS, prm), 20),
        "kernel part": (lambda: sor_kernel.compressed_colour_sweeps(
            colours, SOR_SWEEPS, prm), 50),
        "sor_sweeps": (lambda: sor_kernel.whole_grid_sweeps(
            rhs, SOR_SWEEPS, prm), 50),
        "compaction + expansion": (lambda: sor_kernel._expand_planar(
            sor_kernel._compress_planar(rhs)), 50),
        "sor_sweeps_simple": (lambda: sor_kernel.whole_grid_sweeps_simple(
            rhs, SOR_SWEEPS, prm), 20)}
    order = ["plain", "kernel", "first kernel", "kernel part", "sor_sweeps",
             "compaction + expansion", "sor_sweeps_simple", "sor_sweeps",
             "kernel part", "kernel", "plain"]
    ms = {}
    for name in order:
        fn, reps = runs[name]
        ms.setdefault(name, []).append(cuda_ms(torch, fn, reps))
    print(f"[time] sor_compressed at {prm.shape} ({SOR_SWEEPS} sweeps, tile "
          f"{'x'.join(map(str, sor_kernel.whole_grid_tile(prm.shape)))}), "
          f"ms per call: " + ", ".join(
              f"{name} {' / '.join(f'{t:.4f}' for t in ts)}"
              for name, ts in ms.items()))
    mean = {name: sum(ts) / len(ts) for name, ts in ms.items()}
    # Device time of the kernel part and of B1, the same tile on the full
    # grid: what the compacted loads and stores change.
    g = [graph_ms(torch, runs[name][0])
         for name in ("kernel part", "sor_sweeps", "sor_sweeps",
                      "kernel part")]
    print(f"[time] sor_compressed kernel part / sor_sweeps: "
          f"{mean['kernel part'] / mean['sor_sweeps']:.3f} per call; device "
          f"time in a CUDA graph: kernel part {g[0] * 1e3:.3f} / "
          f"{g[3] * 1e3:.3f} us, sor_sweeps {g[1] * 1e3:.3f} / "
          f"{g[2] * 1e3:.3f} us; kernel / first kernel: "
          f"{mean['kernel'] / mean['first kernel']:.3f}")
    return (mean["kernel"], mean["plain"], *bounds["sor_compressed"])


def reset_launches() -> None:
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    sor_kernel.LAUNCHES = sor_kernel.WARM_LAUNCHES = 0
    sor_kernel.TILED_LAUNCHES = sor_kernel.COMPRESSED_LAUNCHES = 0
    sor_kernel.EXT_LAUNCHES = sor_kernel.CYCLE_LAUNCHES = 0
    momentum_kernel.LAUNCHES = 0


def read_launches() -> dict:
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    return {"sor": sor_kernel.LAUNCHES, "sor_warm": sor_kernel.WARM_LAUNCHES,
            "mg_coarse_cycle": sor_kernel.CYCLE_LAUNCHES,
            "momentum": momentum_kernel.LAUNCHES,
            "sor_tiled": sor_kernel.TILED_LAUNCHES,
            "sor_compressed": sor_kernel.COMPRESSED_LAUNCHES,
            "sor_ext": sor_kernel.EXT_LAUNCHES}


def check_only(launches: dict, kernels, where: str) -> None:
    """Every kernel in `kernels` ran in the path and no other SOR kernel."""
    for name in kernels:
        check(launches[name] > 0, f"{where} launched no {name} kernel")
    for name in ("sor", "sor_warm", "mg_coarse_cycle", "sor_tiled",
                 "sor_compressed", "sor_ext"):
        if name not in kernels:
            check(launches[name] == 0, f"{where} launched the {name} kernel")


def run_cli(tag: str, argv: list, u_want: float, v_want: float,
            stats_want: dict, rc_want: int = 0):
    """One CLI run, its answer held to a JAX record; returns its stats line
    as a dict and the kernels' launch counts in that run.  A run stopped by
    --max-steps before T exits with rc_want = 3."""
    from navierstokes_parallel_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    launches = read_launches()
    print(f"[{tag}] stdout:", out.getvalue().strip().replace("\n", " | "))
    print(f"[{tag}] stderr:", err.getvalue().strip().replace("\n", " | "))
    check(rc == rc_want, f"cli.main returned {rc}, expected {rc_want}")
    lines = out.getvalue().splitlines()
    uc = float(lines[0].split()[1])
    vc = float(lines[1].split()[1])
    # The stats line (a library warning may precede it on stderr).
    stats = dict(tok.split("=") for tok in next(
        line for line in err.getvalue().splitlines()
        if line.startswith("steps=")).split())
    for key, want in stats_want.items():
        check(int(stats[key]) == want,
              f"{key}={stats[key]}, JAX recorded {want}")
    du, dv = contract_err(uc, u_want), contract_err(vc, v_want)
    print(f"[{tag}] U-CENTER {uc:.6f} vs JAX {u_want:.6f} (err {du:.2e})"
          f", V-CENTER {vc:.6f} vs JAX {v_want:.6f} (err {dv:.2e}), "
          f"contract {CONTRACT:.0e}")
    check(max(du, dv) <= CONTRACT, "centre values outside the contract")
    stats["solve_seconds"] = float(err.getvalue().splitlines()[-1])
    print(f"[{tag}] solve seconds {stats['solve_seconds']}; "
          f"launches {launches}")
    return stats, launches


def phase_main_path() -> dict:
    """configs/1.in through the CLI at its K = 64 sweeps per outer pass,
    then with the benchmark's --refine-every 2048: the JAX record both
    times (every step runs into max_it, so the counts do not depend on K),
    one sor_sweeps call per outer pass and one for the CLI's warm-up.
    Returns the first run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params

    config = str(ROOT / "configs" / "1.in")
    prm = Params.from_file(config)
    runs = {}
    for tag, K, argv in (
            ("main", prm.sor_refine_every, []),
            (f"main K={BENCH_REFINE_EVERY}", BENCH_REFINE_EVERY,
             ["--refine-every", str(BENCH_REFINE_EVERY)])):
        stats, launches = run_cli(tag, [config, *argv, "--stats"],
                                  JAX_U_CENTER, JAX_V_CENTER, JAX_STATS)
        check_only(launches, ("sor", "momentum"), "the main path")
        calls = JAX_STATS["steps"] * -(-prm.max_it // K) + 1
        check(launches["sor"] == calls,
              f"{launches['sor']} sor_sweeps calls at K={K}, expected {calls}")
        runs[K] = (stats["solve_seconds"], launches)
    for K, (seconds, launches) in runs.items():
        print(f"[main] configs/1.in at K={K}: solve {seconds:.6f} s, "
              f"{launches['sor']} sor_sweeps calls")
    return runs[prm.sor_refine_every][1]


def phase_mg_path() -> dict:
    """configs/4.in with --method mg through the CLI, the plain twins of
    the smoother and of the coarse cycle barred (and the first smoother
    kernel); returns the kernels' launch counts.  With the coarse cycle
    entered at depth t, each V-cycle smooths twice on each of the t levels
    above it and calls the coarse cycle once, and the CLI's warm-up runs
    one cycle."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    config = ROOT / "configs" / "4.in"
    levels = mg.build_levels(Params.from_file(str(config)))
    depth = sor_kernel.coarse_cycle_depth(levels)
    print(f"[mg] {len(levels)} levels: "
          f"{' '.join('x'.join(map(str, lv.shape)) for lv in levels)}; the "
          f"coarse cycle from depth {depth} ({levels[depth].shape}, "
          f"{sor_kernel.cycle_shared_bytes(levels[depth:])} B of shared "
          f"memory)")
    check(0 < depth < len(levels), "the coarse cycle is not on the mg path")

    with barred(sor_kernel, ("warm_sweeps_plain", "coarse_cycle_plain",
                             "warm_sweeps_simple"), "the mg path"):
        stats, launches = run_cli(
            "mg", [str(config), "--method", "mg", "--stats"],
            JAX_MG_U_CENTER, JAX_MG_V_CENTER, JAX_MG_STATS)
    cycles = int(stats["sor_iterations"])
    smooths = (cycles + 1) * 2 * depth
    print(f"[mg] {cycles} V-cycles in {stats['steps']} steps "
          f"({cycles / int(stats['steps']):.3f} per step); smoother calls "
          f"expected ({cycles} + 1) x 2 x {depth} = {smooths}, launched "
          f"{launches['sor_warm']}; coarse cycles expected {cycles + 1}, "
          f"launched {launches['mg_coarse_cycle']}")
    check(launches["sor_warm"] == smooths,
          "warm-start kernel launches differ from the smoother calls")
    check(launches["mg_coarse_cycle"] == cycles + 1,
          "coarse-cycle launches differ from the V-cycles")
    check_only(launches, ("sor_warm", "mg_coarse_cycle", "momentum"),
               "the mg path")
    return launches


def solve_on_card(torch, tag, prm, first_kernel: bool = False, **kw):
    """solver.solve on the card with the launch counts from 0; returns the
    state, its stats, the counts and the seconds on the host's clock around
    the call (to a synchronize; the time step's first use included).
    first_kernel: with PREFER_TILED off and sor_sweeps_simple, which counts
    no launch, in sor_sweeps' place."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    reset_launches()
    t0 = time.perf_counter()
    saved = (sor_kernel.PREFER_TILED, sor_kernel.whole_grid_sweeps)
    if first_kernel:
        sor_kernel.PREFER_TILED = False
        sor_kernel.whole_grid_sweeps = sor_kernel.whole_grid_sweeps_simple
    try:
        state, stats = solver.solve(prm, device="cuda",
                                    pressure_method="pallas_sor", **kw)
    finally:
        sor_kernel.PREFER_TILED, sor_kernel.whole_grid_sweeps = saved
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] {stats} in {seconds:.3f} s; launches {launches}")
    return state, stats, launches, seconds


def check_same_fields(a, b, what: str) -> None:
    same = {name: bool(getattr(a, name).equal(getattr(b, name)))
            for name in ("u", "v", "p")}
    print(f"[{what}] fields equal bit for bit: {same}")
    check(all(same.values()), f"{what}: the fields differ")


def phase_tiled_path(torch) -> dict:
    """configs/4.in --max-steps 2 through the CLI with the default method:
    the sweeps take the tiled kernel, with the whole-grid kernel and the
    plain sweeps barred.  One inner call per outer pass of K = 64 sweeps
    plus one for the CLI's warm-up.  Then the same steps through
    solver.solve on the tiled route and on the first whole-grid kernel (no
    tile): the same fields, bit for bit.  (sor_sweeps at 2050^2 is the
    tiled kernel with the same tile, so it is no second check.)  Returns
    the CLI run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    config = ROOT / "configs" / "4.in"
    prm = Params.from_file(str(config))
    check(sor_kernel.route(prm) == "tiled",
          f"configs/4.in routes to {sor_kernel.route(prm)}, not tiled")
    plain = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
             "whole_grid_sweeps", "whole_grid_sweeps_simple")
    with barred(sor_kernel, plain, "the tiled path"):
        stats, launches = run_cli(
            "tiled", [str(config), "--max-steps", str(TILED_STEPS), "--stats"],
            JAX_TILED_U_CENTER, JAX_TILED_V_CENTER, JAX_TILED_STATS,
            rc_want=3)
    res = float(stats["last_res_norm"])
    print(f"[tiled] last_res_norm {res:.4e} vs JAX {JAX_TILED_RES_NORM:.4e}")
    check(abs(res - JAX_TILED_RES_NORM) <= RES_NORM_RTOL * JAX_TILED_RES_NORM,
          "last_res_norm differs from the JAX record")
    # Every step ran into max_it: ceil(max_it / K) outer passes each.
    passes = TILED_STEPS * -(-prm.max_it // prm.sor_refine_every)
    print(f"[tiled] tiled kernel calls expected {passes} + 1 warm-up, "
          f"launched {launches['sor_tiled']}")
    check(launches["sor_tiled"] == passes + 1,
          "tiled kernel launches differ from the outer passes")
    check_only(launches, ("sor_tiled", "momentum"), "the tiled path")

    with barred(sor_kernel, plain, "the tiled solve"):
        tiled, tstats, tl, _ = solve_on_card(torch, "tiled", prm,
                                             max_steps=TILED_STEPS)
    first, fstats, fl, _ = solve_on_card(torch, "tiled/sor_sweeps_simple",
                                         prm, first_kernel=True,
                                         max_steps=TILED_STEPS)
    check(tstats == fstats,
          "the tiled and first-kernel solves' stats differ")
    check(tl["sor_tiled"] == passes and fl["sor"] == 0,
          "the solves' kernel calls differ from the outer passes")
    check_same_fields(tiled, first, "tiled vs sor_sweeps_simple")
    return launches


def phase_compressed_path(torch) -> dict:
    """configs/1.in through solver.solve on the colour-compressed kernel,
    the whole-grid kernel and the plain sweeps barred: the JAX record
    exactly, one kernel call per outer pass, and the whole-grid route's
    and the first whole-grid kernel's fields bit for bit.  Returns its
    launch counts."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    sor_kernel.USE_COMPRESSED = True
    try:
        check(sor_kernel.route(prm) == "compressed",
              f"configs/1.in routes to {sor_kernel.route(prm)}")
        with barred(sor_kernel, ("inner_sweeps_plain",
                                 "inner_sweeps_compressed_plain",
                                 "inner_sweeps_compressed_simple",
                                 "whole_grid_sweeps",
                                 "whole_grid_sweeps_simple"),
                    "the compressed path"):
            state, stats, launches, seconds = solve_on_card(
                torch, "compressed", prm)
    finally:
        sor_kernel.USE_COMPRESSED = False
    uc, vc = solver.center_values(state, prm)
    got = (stats.steps, stats.total_sor_iterations, stats.sor_failures,
           f"{uc:.6f}", f"{vc:.6f}")
    want = (*JAX_STATS.values(), f"{JAX_U_CENTER:.6f}", f"{JAX_V_CENTER:.6f}")
    print(f"[compressed] steps, sweeps, failures, U/V-CENTER {got}; JAX "
          f"{want}")
    check(got == want, "the compressed path differs from the JAX record")
    passes = stats.steps * -(-prm.max_it // prm.sor_refine_every)
    check(launches["sor_compressed"] == passes,
          f"compressed kernel calls {launches['sor_compressed']}, expected "
          f"{passes}")
    check_only(launches, ("sor_compressed", "momentum"), "the compressed path")
    whole, wstats, _, w_seconds = solve_on_card(torch, "compressed/sor_sweeps",
                                                prm)
    first, fstats, _, _ = solve_on_card(torch, "compressed/sor_sweeps_simple",
                                        prm, first_kernel=True)
    print(f"[compressed] solve {seconds:.6f} s on sor_compressed_sweeps "
          f"({launches['sor_compressed']} calls), {w_seconds:.6f} s on "
          f"sor_sweeps (host clock around solver.solve)")
    check(stats == wstats == fstats,
          "the compressed, whole-grid and first-kernel solves differ")
    check_same_fields(state, whole, "compressed vs sor_sweeps")
    check_same_fields(state, first, "compressed vs sor_sweeps_simple")
    return launches


def phase_sharded_path(torch) -> dict:
    """configs/4.in --backend sharded --mesh 1x1 --max-steps 2 through the
    CLI (a one-rank NCCL group): the JAX record, every chunk of K sweeps one
    sor_ext_sweeps call, with the whole-grid, tiled and compressed kernels
    and every plain sweep function barred.  Then the same steps through
    solve_sharded beside solver.solve on the tiled route: equal counts,
    fields within the contract.  Returns the CLI run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import (deep_halo, sharded,
                                                          topology)
    from navierstokes_parallel_tpu_torch.utils import distributed

    config = ROOT / "configs" / "4.in"
    prm = Params.from_file(str(config))
    # Each step runs into max_it: max_it // R outer passes of R sweeps and
    # one of the rest, each in chunks of K (R = sor_refine_every = 64,
    # K = 8: 312 passes of 8 chunks and one pass of 32 sweeps in 4).
    K = deep_halo.comm_depth(prm, prm.i_max, prm.j_max)
    R = prm.sor_refine_every
    per_step = (prm.max_it // R) * -(-R // K) + -(-(prm.max_it % R) // K)
    barred_fns = ("whole_grid_sweeps", "inner_sweeps_tiled",
                  "inner_sweeps_compressed", "inner_sweeps_plain",
                  "inner_sweeps_tiled_plain", "inner_sweeps_compressed_plain",
                  "warm_sweeps_plain", "ext_sweeps_plain",
                  "whole_grid_sweeps_simple", "warm_sweeps_simple",
                  "coarse_cycle_plain")
    with barred(sor_kernel, barred_fns, "the sharded path"):
        stats, launches = run_cli(
            "sharded", [str(config), *SHARDED_ARGV], JAX_TILED_U_CENTER,
            JAX_TILED_V_CENTER, JAX_TILED_STATS, rc_want=3)
    res = float(stats["last_res_norm"])
    print(f"[sharded] last_res_norm {res:.4e} vs JAX {JAX_TILED_RES_NORM:.4e}")
    check(abs(res - JAX_TILED_RES_NORM) <= RES_NORM_RTOL * JAX_TILED_RES_NORM,
          "last_res_norm differs from the JAX record")
    # The CLI's warm-up step runs one pass of one sweep: one more call.
    want = TILED_STEPS * per_step + 1
    print(f"[sharded] extended-block kernel calls expected {TILED_STEPS} x "
          f"{per_step} + 1 warm-up = {want}, launched {launches['sor_ext']}")
    check(launches["sor_ext"] == want,
          "extended-block kernel launches differ from the chunks")
    check_only(launches, ("sor_ext",), "the sharded path")

    reset_launches()
    t0 = time.perf_counter()
    with barred(sor_kernel, barred_fns, "the sharded solve"), \
            distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        state, sstats = sharded.solve_sharded(prm, mesh=mesh,
                                              max_steps=TILED_STEPS)
        torch.cuda.synchronize()
    ext_calls = read_launches()["sor_ext"]
    print(f"[sharded] solve_sharded {sstats} in {time.perf_counter() - t0:.3f}"
          f" s; extended-block kernel calls {ext_calls}")
    check(ext_calls == TILED_STEPS * per_step,
          "solve_sharded's kernel calls differ from the chunks")
    tiled, tstats, _, _ = solve_on_card(torch, "sharded/tiled", prm,
                                        max_steps=TILED_STEPS)
    check(sstats[:3] == tstats[:3],
          "the sharded and tiled solves' counts differ")
    errs = {name: contract_err(getattr(state, name).cpu().numpy(),
                               getattr(tiled, name).cpu().numpy())
            for name in ("u", "v", "p")}
    same = {name: bool(getattr(state, name).equal(getattr(tiled, name)))
            for name in ("u", "v", "p")}
    print(f"[sharded] vs the tiled route: contract errors {errs} (tol "
          f"{CONTRACT:.0e}), max {max(errs.values()):.3e}; fields equal bit "
          f"for bit: {same}")
    check(max(errs.values()) <= CONTRACT,
          "the sharded and tiled solves differ beyond the contract")
    return launches


def device_kernels(prof):
    """The profile's device-side events (kernels and copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def device_us(evt) -> float:
    """A profile event's own device time, microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def phase_cycle(torch) -> None:
    """One V-cycle at configs/4.in's 2048^2 from delta = 0: CUDA-event time
    and kernel launches counted under the profiler, for the cycle as it
    runs (the smoother on the four fine levels, the coarse cycle from
    130^2) and as it ran with the first smoother kernel on every level and
    no coarse cycle.  Both give the same bits."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.ops import mg

    levels, depth = mg_levels()
    rng = np.random.default_rng(4)
    inner = rng.standard_normal((levels[0].shape[0] - 2,
                                 levels[0].shape[1] - 2))
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = inner - inner.mean()
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)

    cases = [(f"coarse cycle from {levels[depth].shape}",
              lambda: mg.v_cycle(p0, rhs, levels)),
             ("first smoother kernel on every level, no coarse cycle",
              lambda: cycle_on_simple(p0, rhs, levels))]
    # Every time first, in two turns, then the profiles: once the profiler
    # has run, every later launch costs the host more.
    turns = [[cuda_ms(torch, fn, 20) for _, fn in cases] for _ in range(2)]
    # A process's first profile can miss launches while the tracer starts:
    # one throw-away profile before the counted ones.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cases[0][1]()
        torch.cuda.synchronize()
    results = []
    for k, (what, fn) in enumerate(cases):
        ms = [turn[k] for turn in turns]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        n_launches = sum(e.count for e in kernels)
        check(n_launches > 0, "the profiler saw no device kernel")
        results.append(out)
        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        print(f"[cycle] one V-cycle at {levels[0].shape}, {what}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms (CUDA events, mean of 20), "
              f"{n_launches} kernel launches, {busy_ms:.4f} ms of device "
              f"time under the profiler")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            print(f"[cycle]   {device_us(e) / 1e3:9.4f} ms  {e.count:6d} x"
                  f"  {e.key[:90]}")
    same = all(torch.equal(results[0], r) for r in results[1:])
    print(f"[cycle] the two cycles give the same bits: {same}")
    check(same, "the V-cycle differs between its routes")


def phase_cpu_gpu(torch) -> None:
    """A small converging cavity on the GPU and on the CPU through the
    port: equal iteration counts, fields within the contract."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params

    prm = Params(problem=1, i_max=64, j_max=64, T=0.06, Re=100.0, tau=0.5,
                 omega=1.7, epsilon=1e-4, max_it=20000, dtype="float32")
    for method in ("pallas_sor", "mg"):
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            state, stats = solver.solve(prm, device=device,
                                        pressure_method=method)
            runs[device] = (state, stats)
            print(f"[cpu-gpu] {method} {device}: {stats} in "
                  f"{time.perf_counter() - t0:.3f} s")
        (sg, tg), (sc, tc) = runs["cuda"], runs["cpu"]
        check(tg.sor_failures == 0, f"the converging {method} cavity hit "
                                    f"max_it")
        check((tg.steps, tg.total_sor_iterations, tg.sor_failures)
              == (tc.steps, tc.total_sor_iterations, tc.sor_failures),
              f"GPU and CPU iteration counts differ ({method})")
        errs = {name: contract_err(getattr(sg, name).cpu().numpy(),
                                   getattr(sc, name).numpy())
                for name in ("u", "v", "p")}
        print(f"[cpu-gpu] {method} contract errors {errs} "
              f"(tol {CONTRACT:.0e})")
        check(max(errs.values()) <= CONTRACT,
              f"GPU and CPU fields differ ({method})")


def phase_profile(torch, trace_prefix) -> None:
    """One outer pass of the pressure solve at configs/4.in's 2048^2, for
    mg (f64 defect, one V-cycle, f64 defect and norm, one host sync), for
    the SOR route (the same around K = 64 sweeps of the tiled kernel) and
    for the sharded backend on one rank (the same around 8 chunks of a deep
    exchange and 8 sweeps of the extended-block kernel), and one of the SOR
    route at configs/1.in's 256^2 (K = 64 sweeps of the whole-grid kernel),
    each through profile_pass."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg, sor
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import (deep_halo, sharded,
                                                          topology)
    from navierstokes_parallel_tpu_torch.utils import distributed

    rng = np.random.default_rng(3)

    def inputs(prm):
        """(p0, a zero-mean rhs) on the card."""
        rhs = np.zeros(prm.shape, np.float32)
        inner = rng.standard_normal((prm.i_max, prm.j_max))
        rhs[1:-1, 1:-1] = inner - inner.mean()
        return (torch.zeros(prm.shape, device="cuda"),
                torch.from_numpy(rhs).cuda())

    prm = Params.from_file(str(ROOT / "configs" / "4.in"))
    p0, rhs = inputs(prm)
    K = prm.sor_refine_every
    prm1 = Params.from_file(str(ROOT / "configs" / "1.in"))
    p1, rhs1 = inputs(prm1)
    li, lj = prm.i_max, prm.j_max
    one_pass = prm.replace(max_it=K)
    with distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        deep = deep_halo.make_deep_inner(prm, li, lj, mesh)
        # (name, grid, what the inner stage is, the inner stage, one outer
        # pass)
        cases = [("mg", "2048^2",
                  f"one V-cycle on {len(mg.build_levels(prm))} levels",
                  lambda: mg.inner_v_cycle(rhs, 1, prm),
                  lambda: sor.solve_pressure(p0, rhs, prm.replace(max_it=1),
                                             method="mg")),
                 ("pallas_sor", "2048^2",
                  f"{K} sweeps on the {sor_kernel.route(prm)} route",
                  lambda: sor_kernel.inner_sweeps(rhs, K, prm),
                  lambda: sor.solve_pressure(p0, rhs, one_pass,
                                             method="pallas_sor")),
                 ("sharded", "2048^2",
                  f"{K} sweeps of the deep-halo inner (1x1 mesh)",
                  lambda: deep(rhs, K),
                  lambda: sharded._sharded_pressure_solve(
                      p0, rhs, one_pass, "rb_sor", li, lj, None, mesh)),
                 ("pallas_sor_256", "256^2",
                  f"{prm1.sor_refine_every} sweeps on the "
                  f"{sor_kernel.route(prm1)} route",
                  lambda: sor_kernel.inner_sweeps(
                      rhs1, prm1.sor_refine_every, prm1),
                  lambda: sor.solve_pressure(
                      p1, rhs1, prm1.replace(max_it=prm1.sor_refine_every),
                      method="pallas_sor"))]
        for case in cases:
            profile_pass(torch, *case, trace_prefix)


def profile_pass(torch, method: str, grid: str, what: str, inner_stage,
                 outer_pass, trace_prefix) -> None:
    """CUDA event times of one outer pass and of its inner stage, then a
    torch.profiler split of one pass by device kernel."""
    from torch.profiler import ProfilerActivity, profile

    inner_ms = cuda_ms(torch, inner_stage, 20)
    pass_ms = cuda_ms(torch, outer_pass, 20)
    print(f"[profile] {method} at {grid}: {what} {inner_ms:.4f} ms, one "
          f"outer pass (inner + f64 outer) {pass_ms:.4f} ms (CUDA "
          f"events, mean of 20)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outer_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_prefix:
        path = f"{trace_prefix}.{method}.json"
        prof.export_chrome_trace(path)
        print(f"[profile] chrome trace: {path}")
    kernels = device_kernels(prof)
    busy_us = sum(device_us(e) for e in kernels)
    n_launches = sum(e.count for e in kernels)
    print(f"[profile] {method}: one outer pass under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms (share "
          f"{busy_us / 1e3 / wall_ms:.3f}) over {n_launches} kernel "
          f"launches")
    check(n_launches > 0, "the profiler saw no device kernel")
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f"[profile]   {device_us(e) / 1e3:9.4f} ms  {e.count:6d} x"
              f"  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one 2048^2 outer pass of mg, of "
                         "the SOR route and of the sharded backend, and "
                         "one 256^2 outer pass of the SOR route")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="with --profile, write the chrome traces to "
                         "PREFIX.mg.json, PREFIX.pallas_sor.json, "
                         "PREFIX.sharded.json and "
                         "PREFIX.pallas_sor_256.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available")
        return 1
    try:
        import navierstokes_parallel_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e}); run from the "
              f"root of a checkout")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_device(torch)
        timed_phase("build", phase_build)
        errs = timed_phase("compare", phase_compare, torch)
        timed_phase("decomposition", phase_decomposition, torch)
        times = timed_phase("time", phase_time, torch)
        paths = [timed_phase("main path", phase_main_path),
                 timed_phase("mg path", phase_mg_path),
                 timed_phase("tiled path", phase_tiled_path, torch),
                 timed_phase("compressed path", phase_compressed_path, torch),
                 timed_phase("sharded path", phase_sharded_path, torch)]
        timed_phase("cpu-gpu", phase_cpu_gpu, torch)
        # After the paths: once the profiler has run in a process, every
        # later launch costs the host more.
        timed_phase("cycle", phase_cycle, torch)
        if args.profile:
            phase_profile(torch, args.trace)
    except PhaseFailed as e:
        print(f"FAIL: {e}")
        return 1

    launches = {key: sum(path[key] for path in paths) for key in paths[0]}
    tpu = "navierstokes_parallel_tpu/ops/pallas/"
    sources = {"sor": ("sor_sweeps", "sor_tiled.cu",
                       f"{tpu}sor_kernel.py:67"),
               "sor_warm": ("sor_warm_sweeps", "sor.cu",
                            f"{tpu}sor_kernel.py:67 (warm_start=True)"),
               "mg_coarse_cycle": ("mg_coarse_cycle", "mg_cycle.cu",
                                   f"{tpu}sor_kernel.py:67 (warm_start=True,"
                                   f" the smoother of the V-cycle's coarse "
                                   f"levels)"),
               "momentum": ("momentum_rhs", "momentum.cu",
                            f"{tpu}momentum_kernel.py:36"),
               "sor_tiled": ("sor_tiled_sweeps", "sor_tiled.cu",
                             f"{tpu}sor_kernel.py:207 (and :293, "
                             f"double-buffered)"),
               "sor_compressed": ("sor_compressed_sweeps", "sor_compressed.cu",
                                  f"{tpu}sor_kernel.py:782"),
               "sor_ext": ("sor_ext_sweeps", "sor_ext.cu",
                           "navierstokes_parallel_tpu/parallel/"
                           "deep_halo.py:226")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"navierstokes_parallel_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": times[key][2],
                "bound_by": times[key][3], "library_ms": None}
               for key, (name, src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
