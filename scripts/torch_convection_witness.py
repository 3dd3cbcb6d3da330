#!/usr/bin/env python3
"""configs/convection.in whole (the de Vahl Davis cavity at Ra = 1e4, 64^2,
T = 30: about 11,700 steps) through the PyTorch port on the GPU, by the
CLI's default method there (pallas_sor: the SOR kernel in the f64
refinement), held to the JAX package's record of the same run on the CPU
and to the benchmark:

    python3 scripts/torch_convection_witness.py        # from a checkout

  * the hot- and cold-wall mean Nusselt numbers within 0.5 % of the JAX
    record (tests/jax_thermal_records.json, "thermal" / "witness",
    written by ``tests/jax_records.py thermal``, rb_sor on the CPU: the
    same refinement and sweeps);
  * the hot-wall Nusselt number within 2 % of de Vahl Davis's 2.243
    (``models/convection.py::DE_VAHL_DAVIS_NU``);
  * no pressure failure.

The run is the CLI's loop (``convection.thermal_solve``: ``run_steps`` over
a ``ThermalStepper``) after ``convection.warm_up``.  Prints the steps,
sweeps, failures and centre values beside JAX's, the solve seconds, the
SOR kernel's launches (and the fused momentum kernel's, which must be 0:
a thermal step takes the plain F/G), and the card's name and power limit;
the last line is a JSON object of all of it.  Exits 1 on any miss.
Imports nothing of JAX.
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

CONFIG = ROOT / "configs" / "convection.in"
RECORDS = ROOT / "tests" / "jax_thermal_records.json"
JAX_RTOL = 0.005
BENCHMARK_RTOL = 0.02


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


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
    from navierstokes_parallel_tpu_torch.models import convection
    from navierstokes_parallel_tpu_torch.ops.sor import default_method
    from navierstokes_parallel_tpu_torch.solver import center_values
    from navierstokes_parallel_tpu_torch.utils import timing

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"[witness] card: {card}", flush=True)
    jax = json.loads(RECORDS.read_text())["thermal"]["witness"]
    prm = Params.from_file(str(CONFIG))
    cfg = convection.config_from_params(prm)
    method = default_method(prm, device)
    convection.warm_up(prm, cfg, device, method)
    start = timing.counts()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = convection.thermal_solve(prm, cfg, device=device,
                                            pressure_method=method,
                                            max_steps=args.max_steps)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    now = timing.counts()
    sor_launches, momentum_launches = (
        now.get(name, 0) - start.get(name, 0)
        for name in ("launch.sor_whole_grid", "launch.momentum"))
    result = {
        "card": card, "device": str(device), "method": method,
        "steps": stats.steps, "sor_iterations": stats.total_sor_iterations,
        "sor_failures": stats.sor_failures,
        "centre": list(center_values(state, prm)),
        "nusselt_hot": convection.nusselt_hot_wall(state.T, prm,
                                                   cfg.t_left),
        "nusselt_cold": convection.nusselt_cold_wall(state.T, prm,
                                                     cfg.t_right),
        "seconds": seconds, "sor_launches": sor_launches,
        "momentum_launches": momentum_launches, "jax": jax}
    print(f"[witness] {method}: {stats.steps} steps (JAX {jax['steps']}), "
          f"{stats.total_sor_iterations} sweeps (JAX "
          f"{jax['sor_iterations']}), {stats.sor_failures} failures, centre "
          f"{result['centre']} (JAX {jax['centre']}), {seconds:.3f} s, "
          f"{sor_launches} SOR kernel launches, "
          f"{momentum_launches} momentum kernel launches", flush=True)
    nu_ref = convection.DE_VAHL_DAVIS_NU[prm.Ra]
    misses = []
    for key in ("nusselt_hot", "nusselt_cold"):
        err = abs(result[key] - jax[key]) / abs(jax[key])
        print(f"[witness] {key} {result[key]:.6f}, JAX {jax[key]:.6f} "
              f"(rel {err:.2e}, window {JAX_RTOL})", flush=True)
        if not err <= JAX_RTOL:
            misses.append(f"{key} {result[key]} not within {JAX_RTOL:.1%} "
                          f"of JAX's {jax[key]}")
    err = abs(result["nusselt_hot"] - nu_ref) / nu_ref
    print(f"[witness] hot-wall Nu {result['nusselt_hot']:.6f} vs de Vahl "
          f"Davis {nu_ref} (rel {err:.2e}, window {BENCHMARK_RTOL})",
          flush=True)
    if not err <= BENCHMARK_RTOL:
        misses.append(f"nusselt_hot not within {BENCHMARK_RTOL:.0%} of "
                      f"{nu_ref}")
    if stats.sor_failures:
        misses.append(f"{stats.sor_failures} pressure failures")
    if momentum_launches:
        misses.append("the fused momentum kernel ran on a thermal step")
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
