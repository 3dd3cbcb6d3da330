#!/usr/bin/env python3
"""configs/dambreak.in whole (the Martin & Moyce column collapse: 160 x 96,
a 1 x 2 column, ppc 3, about 18,400 marker particles, T = 2.0) with
free-slip walls through the PyTorch port on the GPU, held to the JAX
package's record of the same run on the CPU and to JAX's own dam-break
bounds:

    python3 scripts/torch_dambreak_witness.py          # from a checkout

  * the steps, the sweeps and the failures beside the JAX record
    (tests/jax_free_records.json, "free", written by ``tests/jax_records.py
    free``): steps and sweeps within 1 %, failures equal;
  * the front position and the column height at t = 0.5, 1.0, 1.5 and the
    end, each interpolated in t, within 2 % of JAX's (a marker that
    crosses a cell border otherwise than on the CPU moves the flag field,
    so the runs part slowly: the readings are held, not the bits);
  * the fluid volume at the end within 1 % of JAX's and within 8 % of the
    initial one (JAX's bound, tests/test_freesurface.py::
    test_dam_break_physics);
  * the front between x0 + 0.25 sqrt(g h) t and x0 + 2 sqrt(g h) t (the
    shallow-water bound, JAX's test), the column drained by 0.1 at least,
    every particle still active.

Steps through ``freesurface.FreeStepper`` (the CLI's host loop) after its
warm-up step; prints the front position and the column height against
time every 10 steps, the steps, sweeps, fluid volume, the solve seconds,
the kernel launches (all 0: the free-surface step is plain PyTorch) and the
card's name and power limit; the last line is a JSON object of all of it.
Exits 1 on any miss.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # run as a script from a checkout

CONFIG = ROOT / "configs" / "dambreak.in"
RECORDS = ROOT / "tests" / "jax_free_records.json"
COUNT_RTOL = 0.01
READING_RTOL = 0.02
VOLUME_RTOL = 0.01
TIMES = (0.5, 1.0, 1.5)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def at(t, ts, values) -> float:
    """`values` interpolated linearly at time t."""
    return float(np.interp(t, ts, values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fallback)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after N steps (a check of the script; the "
                         "readings are held only on the whole run)")
    args = ap.parse_args(argv)
    import torch

    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.grid import resolve_device
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.solver import run_steps
    from navierstokes_parallel_tpu_torch.utils import timing

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"[witness] card: {card}", flush=True)
    jax = json.loads(RECORDS.read_text())["free"]
    jsteps = jax["per_step"]
    prm = Params.from_file(str(CONFIG))
    fs0 = FS.initial_free_state(prm, device)
    initial = {"fluid_volume": FS.fluid_volume(fs0, prm),
               "front_position": FS.front_position(fs0),
               "column_height": FS.column_height(fs0),
               "particles": int(fs0.pset.active.sum())}
    stepper = FS.FreeStepper(prm, fs0, wall="freeslip")
    stepper.warm()
    start = timing.counts()
    trace = {"t": [], "front_position": [], "column_height": [],
             "fluid_volume": []}

    def after(diag, steps):
        fs = stepper.free_state()
        trace["t"].append(stepper.t)
        trace["front_position"].append(FS.front_position(fs))
        trace["column_height"].append(FS.column_height(fs))
        trace["fluid_volume"].append(FS.fluid_volume(fs, prm))
        if steps % 10 == 0:
            print(f"[witness] step {steps} t {stepper.t:.4f}: front "
                  f"{trace['front_position'][-1]:.5f}, column "
                  f"{trace['column_height'][-1]:.5f}", flush=True)

    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run_steps(stepper, prm, max_steps=args.max_steps, after=after)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: n - start.get(name, 0)
                for name, n in timing.counts().items()
                if name.startswith("launch.")}
    fs = stepper.free_state()
    jax_stats = jax["whole"]["stats"]
    result = {
        "card": card, "device": str(device), "steps": stats.steps,
        "sor_iterations": stats.total_sor_iterations,
        "sor_failures": stats.sor_failures, "initial": initial,
        "final": {key: trace[key][-1] for key in (
            "t", "front_position", "column_height", "fluid_volume")},
        "active": int(fs.pset.active.sum()), "seconds": seconds,
        "launches": launches,
        "jax": {"steps": int(jax_stats["steps"]),
                "sor_iterations": int(jax_stats["sor_iterations"]),
                "sor_failures": int(jax_stats["sor_failures"])}}
    print(f"[witness] {stats.steps} steps (JAX {jax_stats['steps']}), "
          f"{stats.total_sor_iterations} sweeps (JAX "
          f"{jax_stats['sor_iterations']}), {stats.sor_failures} failures "
          f"(JAX {jax_stats['sor_failures']}), {seconds:.3f} s, launches "
          f"{launches}", flush=True)
    misses = []
    for key in ("steps", "sor_iterations"):
        mine, theirs = result[key], result["jax"][key]
        if not abs(mine - theirs) <= COUNT_RTOL * theirs:
            misses.append(f"{key} {mine} not within {COUNT_RTOL:.0%} of "
                          f"JAX's {theirs}")
    if stats.sor_failures != result["jax"]["sor_failures"]:
        misses.append(f"{stats.sor_failures} failures, JAX "
                      f"{result['jax']['sor_failures']}")
    t_end = min(trace["t"][-1], jsteps["t"][-1])
    readings = {}
    for t in (*TIMES, t_end):
        for key in ("front_position", "column_height"):
            mine = at(t, trace["t"], trace[key])
            theirs = at(t, jsteps["t"], jsteps[key])
            err = abs(mine - theirs) / abs(theirs)
            readings[f"{key}@{t:.4f}"] = [mine, theirs, err]
            print(f"[witness] {key} at t = {t:.4f}: {mine:.5f}, JAX "
                  f"{theirs:.5f} (rel {err:.2e}, window {READING_RTOL})",
                  flush=True)
            if not err <= READING_RTOL:
                misses.append(f"{key} at t = {t:.4f} not within "
                              f"{READING_RTOL:.0%} of JAX's")
    result["readings"] = readings
    vol, jvol = trace["fluid_volume"][-1], jsteps["fluid_volume"][-1]
    drift = abs(vol - initial["fluid_volume"]) / initial["fluid_volume"]
    print(f"[witness] fluid volume {vol:.6f}, JAX {jvol:.6f}, initial "
          f"{initial['fluid_volume']:.6f} (drift {drift:.2e})", flush=True)
    if not abs(vol - jvol) <= VOLUME_RTOL * jvol:
        misses.append(f"fluid volume not within {VOLUME_RTOL:.0%} of JAX's")
    if not drift < 0.08:
        misses.append("fluid volume drifted by 8 % or more")
    g, h = abs(prm.g_y), prm.fluid_y1 - prm.fluid_y0
    t_run = trace["t"][-1]
    front = trace["front_position"][-1]
    low = initial["front_position"] + 0.25 * np.sqrt(g * h) * t_run
    high = initial["front_position"] + 2.0 * np.sqrt(g * h) * t_run
    print(f"[witness] front {front:.5f} within ({low:.5f}, {high:.5f}); "
          f"column {trace['column_height'][-1]:.5f} from "
          f"{initial['column_height']:.5f}; {result['active']} of "
          f"{initial['particles']} particles active", flush=True)
    if not low < front < high:
        misses.append("the front left the shallow-water window")
    if not trace["column_height"][-1] < initial["column_height"] - 0.1:
        misses.append("the column did not drain")
    if result["active"] != initial["particles"]:
        misses.append("particles left the box")
    if any(launches.values()):
        misses.append("a kernel ran on the free-surface path")
    if args.max_steps:
        print("[witness] --max-steps: a cut run, readings not held",
              flush=True)
        misses = []
    for miss in misses:
        print(f"[witness] MISS {miss}", flush=True)
    result["ok"] = not misses
    print(json.dumps(result))
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
