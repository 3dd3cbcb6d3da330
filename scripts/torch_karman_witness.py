#!/usr/bin/env python3
"""The Kármán shedding runs of the JAX package's tests/test_karman.py,
through the PyTorch port on the GPU, held to the JAX tests' own windows:

    python3 scripts/torch_karman_witness.py            # from a checkout

  * the confined square cylinder, ``square_cylinder(n_per_d=8, T=80)``
    (160 x 64, staircase), masked mg from ``initial_state``: no pressure
    failure, the wake probe's Strouhal number in [0.155, 0.235] and its
    amplitude above 0.1 (test_square_cylinder_sheds);
  * the Schäfer-Turek 2D-2 circle, ``schafer_turek(n_per_d=10, T=85)``
    (220 x 41, immersed-boundary velocity BCs and cut-cell pressure),
    masked mg with ``surface_force_record_fn``, analysed over the last 30 %:
    no failure, amplitude above 0.2, St, cd_max, cl_max, dp_mean, cd_s_max
    and cl_s_max each within 3 % of JAX's value, |cl_mean| and |cl_s_mean|
    below 0.15 (test_schafer_turek_circle_strouhal_and_forces).

Every run is ``models/karman.py::shedding_signal`` over ``solver.Stepper``
on the card: plain PyTorch, as the JAX package runs these paths in jnp (no
kernel stands behind the masked solvers).  Prints each run's readings, its
steps, V-cycles and seconds, and the card's name and power limit; the last
line is a JSON object of all of it.  Exits 1 on any reading outside its
window.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # run as a script from a checkout

# JAX's values at 10 cells per diameter (tests/test_karman.py), each held
# within WINDOW_RTOL.
JAX_CIRCLE = {"st": 0.2626, "cd_max": 3.6127, "cl_max": 0.6310,
              "dp_mean": 2.3130, "cd_s_max": 2.8473, "cl_s_max": 0.5553}
WINDOW_RTOL = 0.03
SQUARE_ST = (0.155, 0.235)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _timed_trace(torch, params, device, **kw):
    from navierstokes_parallel_tpu_torch.models import karman

    t0 = time.perf_counter()
    trace = karman.shedding_signal(params, device=device, method="mg", **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return trace, {"steps": trace.stats.steps,
                   "v_cycles": trace.stats.total_sor_iterations,
                   "sor_failures": trace.stats.sor_failures,
                   "seconds": seconds}


def square_run(torch, device, T: float = 80.0):
    """(readings, misses) of the square cylinder."""
    from navierstokes_parallel_tpu_torch.models import karman

    params = karman.square_cylinder(n_per_d=8, T=T)
    trace, out = _timed_trace(torch, params, device)
    out["st"], out["amp"] = karman.strouhal(trace.t, trace.v)
    misses = []
    if out["sor_failures"]:
        misses.append(f"{out['sor_failures']} pressure failures")
    if not out["amp"] > 0.1:
        misses.append(f"amp {out['amp']} <= 0.1 (the wake never saturated)")
    if not SQUARE_ST[0] <= out["st"] <= SQUARE_ST[1]:
        misses.append(f"St {out['st']} outside {SQUARE_ST}")
    return out, misses


def circle_run(torch, device, T: float = 85.0):
    """(readings, misses) of the Schäfer-Turek circle."""
    from navierstokes_parallel_tpu_torch.models import karman

    params = karman.schafer_turek(n_per_d=10, T=T)
    rec = karman.surface_force_record_fn(params, 5,
                                         *karman.probe_node(params))
    trace, out = _timed_trace(torch, params, device, record_fn=rec)
    out["st"], out["amp"] = karman.strouhal(trace.t, trace.v, skip_frac=0.7)
    out.update(karman.coefficients(trace, params, skip_frac=0.7))
    misses = []
    if out["sor_failures"]:
        misses.append(f"{out['sor_failures']} pressure failures")
    if not out["amp"] > 0.2:
        misses.append(f"amp {out['amp']} <= 0.2 (the wake never saturated)")
    for key, want in JAX_CIRCLE.items():
        if not abs(out[key] - want) <= WINDOW_RTOL * abs(want):
            misses.append(f"{key} {out[key]} not within {WINDOW_RTOL:.0%} "
                          f"of JAX's {want}")
    for key in ("cl_mean", "cl_s_mean"):
        if not abs(out[key]) < 0.15:
            misses.append(f"|{key}| = {abs(out[key])} >= 0.15")
    return out, misses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback)")
    args = ap.parse_args(argv)
    import torch

    from navierstokes_parallel_tpu_torch.grid import resolve_device

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"[witness] card: {card}", flush=True)
    result, failed = {"card": card, "device": str(device)}, []
    for name, run in (("square_cylinder", square_run),
                      ("schafer_turek", circle_run)):
        out, misses = run(torch, device)
        result[name] = out
        print(f"[witness] {name}: " + ", ".join(
            f"{k} {v}" for k, v in out.items()), flush=True)
        for miss in misses:
            print(f"[witness] {name}: MISS {miss}", flush=True)
        failed += misses
    result["ok"] = not failed
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
