#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version on the card, times both, drives the main path
(``python -m navierstokes_parallel_tpu_torch configs/1.in --stats``, through
``cli.main``) and checks its answer against the JAX package's recorded
answer, then runs a small converging cavity on the GPU and on the CPU and
compares the two.  Any failed phase prints ``FAIL: ...`` and exits 1 before
the last line; on success the last two lines are the kernels' JSON record
and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

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
# The reference comparator's contract: 1e-4, absolute where |x| <= 1,
# relative above (tests/conftest.py::assert_close_reference_contract).
CONTRACT = 1e-4
# Kernel vs plain PyTorch on the card, as max |kernel - plain| / max |plain|.
# The kernels round every operation once (csrc/nsp_round.cuh: no FMA
# contraction), as the plain versions do, so the expected error is 0; the
# bound leaves room for one f32 rounding step (2^-23 ~ 1.2e-7) amplified
# through 64 sweeps.
KERNEL_RTOL = 1e-5
SOR_SWEEPS = 64  # the main path's K: one kernel call = 64 sweeps


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
    """Each kernel against its plain version at the main path's shape and
    at an odd non-square one; returns the max abs error per kernel."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    rng = np.random.default_rng(0)
    errs = {"sor": 0.0, "momentum": 0.0}
    for i_max, j_max in ((256, 256), (97, 61)):
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     g_x=0.1, g_y=-0.2, omega=1.7)
        shape = prm.shape

        rhs = np.zeros(shape, np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((i_max, j_max))
        rhs_d = torch.from_numpy(rhs).cuda()
        got = sor_kernel.inner_sweeps(rhs_d, SOR_SWEEPS, prm)
        want = sor_kernel.inner_sweeps_plain(rhs_d, SOR_SWEEPS, prm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"[compare] sor {shape} n={SOR_SWEEPS}: max abs err {err:.3e}"
              f", rel {rel:.3e} (tol {KERNEL_RTOL:.0e})")
        check(rel <= KERNEL_RTOL, f"sor kernel disagrees at {shape}")
        errs["sor"] = max(errs["sor"], err)

        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        u, v = u.cuda(), v.cuda()
        dt = torch.tensor(0.004, device="cuda")
        gamma = torch.tensor(0.7, device="cuda")
        got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
        want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
        torch.cuda.synchronize()
        for name, g, w in zip(("F", "G", "rhs"), got, want):
            err = float((g - w).abs().max())
            rel = err / float(w.abs().max())
            print(f"[compare] momentum {name} {shape}: max abs err "
                  f"{err:.3e}, rel {rel:.3e} (tol {KERNEL_RTOL:.0e})")
            check(rel <= KERNEL_RTOL,
                  f"momentum kernel disagrees on {name} at {shape}")
            errs["momentum"] = max(errs["momentum"], err)
    return errs


def phase_time(torch) -> dict:
    """Kernel and plain times at the main path's 258^2 padded grid, in
    turns (plain, kernel, kernel, plain)."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    rng = np.random.default_rng(1)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs).cuda()
    u = torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32))
    u, v = u.cuda(), v.cuda()
    dt = torch.tensor(1e-3, device="cuda")
    gamma = torch.tensor(0.5, device="cuda")

    cases = {
        "sor": (lambda: sor_kernel.inner_sweeps(rhs, SOR_SWEEPS, prm),
                lambda: sor_kernel.inner_sweeps_plain(rhs, SOR_SWEEPS, prm),
                20, 3),
        "momentum": (lambda: momentum_kernel.momentum_rhs(u, v, dt, gamma,
                                                          prm),
                     lambda: momentum_kernel.momentum_rhs_plain(u, v, dt,
                                                                gamma, prm),
                     200, 20),
    }
    times = {}
    for name, (kernel, plain, k_reps, p_reps) in cases.items():
        p1 = cuda_ms(torch, plain, p_reps)
        k1 = cuda_ms(torch, kernel, k_reps)
        k2 = cuda_ms(torch, kernel, k_reps)
        p2 = cuda_ms(torch, plain, p_reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        per = f" ({SOR_SWEEPS} sweeps)" if name == "sor" else ""
        print(f"[time] {name} at {prm.shape}{per}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per call")
    k_ms, p_ms = times["sor"]
    print(f"[time] sor per sweep: kernel {k_ms * 1e3 / SOR_SWEEPS:.3f} us, "
          f"plain {p_ms * 1e3 / SOR_SWEEPS:.3f} us")
    print(f"[time] momentum per call: kernel {times['momentum'][0] * 1e3:.3f}"
          f" us, plain {times['momentum'][1] * 1e3:.3f} us")
    return times


def phase_main_path() -> dict:
    """configs/1.in through the CLI; returns the kernels' launch counts."""
    from navierstokes_parallel_tpu_torch import cli
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    out, err = io.StringIO(), io.StringIO()
    sor_kernel.LAUNCHES = 0
    momentum_kernel.LAUNCHES = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(ROOT / "configs" / "1.in"), "--stats"])
    launches = {"sor": sor_kernel.LAUNCHES,
                "momentum": momentum_kernel.LAUNCHES}
    print("[main] stdout:", out.getvalue().strip().replace("\n", " | "))
    print("[main] stderr:", err.getvalue().strip().replace("\n", " | "))
    check(rc == 0, f"cli.main returned {rc}")
    lines = out.getvalue().splitlines()
    uc = float(lines[0].split()[1])
    vc = float(lines[1].split()[1])
    stats = dict(tok.split("=") for tok in
                 err.getvalue().strip().splitlines()[0].split())
    for key, want in JAX_STATS.items():
        check(int(stats[key]) == want,
              f"{key}={stats[key]}, JAX recorded {want}")
    du, dv = contract_err(uc, JAX_U_CENTER), contract_err(vc, JAX_V_CENTER)
    print(f"[main] U-CENTER {uc:.6f} vs JAX {JAX_U_CENTER:.6f} (err {du:.2e})"
          f", V-CENTER {vc:.6f} vs JAX {JAX_V_CENTER:.6f} (err {dv:.2e}), "
          f"contract {CONTRACT:.0e}")
    check(max(du, dv) <= CONTRACT, "centre values outside the contract")
    print(f"[main] solve seconds {float(err.getvalue().splitlines()[-1])}; "
          f"launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path launched no {name} kernel")
    return launches


def phase_cpu_gpu(torch) -> None:
    """A small converging cavity on the GPU and on the CPU through the
    port: equal iteration counts, fields within the contract."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params

    prm = Params(problem=1, i_max=64, j_max=64, T=0.06, Re=100.0, tau=0.5,
                 omega=1.7, epsilon=1e-4, max_it=20000, dtype="float32")
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state, stats = solver.solve(prm, device=device,
                                    pressure_method="pallas_sor")
        runs[device] = (state, stats)
        print(f"[cpu-gpu] {device}: {stats} in "
              f"{time.perf_counter() - t0:.3f} s")
    (sg, tg), (sc, tc) = runs["cuda"], runs["cpu"]
    check(tg.sor_failures == 0, "the converging cavity hit max_it")
    check((tg.steps, tg.total_sor_iterations, tg.sor_failures)
          == (tc.steps, tc.total_sor_iterations, tc.sor_failures),
          "GPU and CPU iteration counts differ")
    errs = {name: contract_err(getattr(sg, name).cpu().numpy(),
                               getattr(sc, name).numpy())
            for name in ("u", "v", "p")}
    print(f"[cpu-gpu] contract errors {errs} (tol {CONTRACT:.0e})")
    check(max(errs.values()) <= CONTRACT, "GPU and CPU fields differ")


def main() -> int:
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
        phase_build()
        errs = phase_compare(torch)
        times = phase_time(torch)
        launches = phase_main_path()
        phase_cpu_gpu(torch)
    except PhaseFailed as e:
        print(f"FAIL: {e}")
        return 1

    sources = {"sor": ("sor_sweeps", "sor.cu",
                       "navierstokes_parallel_tpu/ops/pallas/sor_kernel.py:67"),
               "momentum": ("momentum_rhs", "momentum.cu",
                            "navierstokes_parallel_tpu/ops/pallas/"
                            "momentum_kernel.py:36")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"navierstokes_parallel_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1]}
               for key, (name, src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
