#!/usr/bin/env python3
"""Times the direct pressure solve's residual-check chunking on one GPU.

    python3 direct_bench.py                    # the workloads below
    python3 direct_bench.py --chunks 1,32 --workload 64 --device cpu

The direct solve (ops/sor.py::_solve_pressure_direct: an f64 state, the
residual checked after every sweep) runs its sweeps in chunks of
sor.DIRECT_CHUNK and reads the chunk's norms once; the chunk in which it
stops is run again to the exact sweep (a chunk of 1 reads after every
sweep).  Each workload is a whole f64 cavity solve through solver.solve
with method rb_sor:

  * 64, 128: a 64^2 / 128^2 cavity at Re = 100 whose solves converge
    (max_it 50000), T = 0.05 / 0.005;
  * 1.in: configs/1.in (256^2, Re = 1000), one step, which runs into
    max_it = 20000 sweeps.

It is run once to warm up, then under each chunk size in two turns (the
given order, then reversed), and prints seconds per solve (the mean of the
turns), the counts (equal under every chunk size, else FAIL) and whether
the fields equal the first chunk size's bit for bit.  The card's name and power
limit are printed first; rows go to chiprun_out/direct_bench.jsonl.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"


def workloads(names):
    from navierstokes_parallel_tpu_torch.config import Params

    base = dict(Re=100.0, tau=0.5, omega=1.7, epsilon=1e-4, max_it=50000,
                dtype="float64")
    table = {
        "64": (Params(i_max=64, j_max=64, T=0.05, **base), 0),
        "128": (Params(i_max=128, j_max=128, T=0.005, **base), 0),
        "1.in": (Params.from_file(str(ROOT / "configs" / "1.in")).replace(
            dtype="float64"), 1),
    }
    return {name: table[name] for name in names}


def run(torch, prm, max_steps, device, chunk):
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.ops import sor

    sor.DIRECT_CHUNK = chunk
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = solver.solve(prm, device=device, pressure_method="rb_sor",
                                max_steps=max_steps)
    solver.device_fence(state)
    return time.perf_counter() - t0, state, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="32,1,8,128",
                    help="chunk sizes, comma-separated")
    ap.add_argument("--workload", action="append", default=[],
                    choices=("64", "128", "1.in"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("FAIL: CUDA is not available")
        return 1
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    print(card)
    chunks = [int(s) for s in args.chunks.split(",")]
    ok = True
    for name, (prm, max_steps) in workloads(
            args.workload or ["64", "128", "1.in"]).items():
        run(torch, prm, max_steps, args.device, chunks[0])  # warm-up
        secs = {s: [] for s in chunks}
        results = {}
        for order in (chunks, chunks[::-1]):
            for s in order:
                dt, state, stats = run(torch, prm, max_steps, args.device, s)
                secs[s].append(dt)
                results[s] = (state, stats)
        ref_state, ref_stats = results[chunks[0]]
        counts = (ref_stats.steps, ref_stats.total_sor_iterations,
                  ref_stats.sor_failures)
        for s in chunks:
            state, stats = results[s]
            same_counts = (stats.steps, stats.total_sor_iterations,
                           stats.sor_failures) == counts
            same_bits = all(torch.equal(getattr(state, f),
                                        getattr(ref_state, f))
                            for f in ("u", "v", "p"))
            ok = ok and same_counts and same_bits
            row = {"workload": name, "chunk": s,
                   "card": card, "steps": stats.steps,
                   "sweeps": stats.total_sor_iterations,
                   "failures": stats.sor_failures,
                   "s_per_solve": sum(secs[s]) / len(secs[s]),
                   "turns_s": secs[s], "counts_equal": same_counts,
                   "bits_equal": same_bits}
            print(f"[direct] {name} chunk {s}: "
                  f"{row['s_per_solve']:.6f} s (turns {secs[s]}), steps "
                  f"{stats.steps} sweeps {stats.total_sor_iterations} "
                  f"failures {stats.sor_failures}, counts equal "
                  f"{same_counts}, bits equal {same_bits}")
            OUT.mkdir(exist_ok=True)
            with open(OUT / "direct_bench.jsonl", "a") as fh:
                fh.write(json.dumps(row) + "\n")
    if not ok:
        print("FAIL: a chunk size changed the counts or the fields")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
