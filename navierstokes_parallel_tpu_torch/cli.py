"""Command-line entry point, protocol-compatible with the JAX package's CLI and
the reference executables (src/serial/main.c:31-158):

    python -m navierstokes_parallel_tpu_torch <param-file> [options]

  * argv[1] = 15-line parameter file (defaults to parameters.txt)
  * stdout: "U-CENTER: %.6f" / "V-CENTER: %.6f" (main.c:148-149)
  * stderr: with --stats, the SOR statistics line and an empty line; then
    a single "%.6f" float — solver seconds (main.c:153's protocol)

The kernels are built and launched once before the timer starts, as the JAX
CLI compiles before it starts its timer.  The JAX CLI's other options
(backends, meshes, AB2, obstacles, output frames, checkpoints, history) are
not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import Params
from .grid import allocate_state, resolve_device
from .ops.sor import default_method
from .solver import center_values, solve, warm_up
from .utils.checks import validate_state
from .utils.timing import device_fence, mlups


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="navierstokes_parallel_tpu_torch",
        description="Incompressible Navier-Stokes cavity solver "
                    "(PyTorch + CUDA)",
    )
    ap.add_argument("param_file", nargs="?", default="parameters.txt",
                    help="15-line parameter file (reference .in format)")
    ap.add_argument("--method",
                    choices=["rb_sor", "pallas_sor", "jacobi", "mg", "cg",
                             "fft"],
                    default="rb_sor",
                    help="pressure solver; rb_sor and pallas_sor both run "
                         "the f64-refined red-black SOR (the others are not "
                         "ported yet)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="override dtype (default: config / float32)")
    ap.add_argument("--refine-every", type=int, default=None,
                    help="f64 re-baseline / convergence-check interval K of "
                         "the SOR solve (default 64)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; there is no silent "
                         "fallback to the CPU)")
    ap.add_argument("--stats", action="store_true",
                    help="print SOR iteration / convergence stats to stderr")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.refine_every is not None:
        if args.refine_every < 1:
            print(f"error: --refine-every must be >= 1, got "
                  f"{args.refine_every}", file=sys.stderr)
            return 1
        overrides["sor_refine_every"] = args.refine_every
    try:
        params = Params.from_file(args.param_file, **overrides)
    except (OSError, ValueError) as e:
        print(f"error: cannot load parameter file {args.param_file!r}: {e}",
              file=sys.stderr)
        return 1
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    pressure_method = args.method
    if pressure_method == "rb_sor":
        pressure_method = default_method(params, device)
    try:
        warm_up(params, device, pressure_method)
    except NotImplementedError as e:  # an unported route, found at once
        print(f"error: {e}", file=sys.stderr)
        return 1
    state = allocate_state(params, device)

    start = time.perf_counter()
    state, stats = solve(params, state, pressure_method=pressure_method)
    device_fence(state)
    elapsed = time.perf_counter() - start

    validate_state(state, where="end of integration")
    uc, vc = center_values(state, params)
    print(f"U-CENTER: {uc:.6f}")
    print(f"V-CENTER: {vc:.6f}")

    if args.stats:
        print(
            f"steps={stats.steps} "
            f"sor_iterations={stats.total_sor_iterations} "
            f"sor_failures={stats.sor_failures} "
            f"last_res_norm={stats.last_res_norm:.3e} "
            f"mlups={mlups(stats.total_sor_iterations, params.i_max, params.j_max, elapsed):.1f}",
            file=sys.stderr,
        )
        print("", file=sys.stderr)

    print(f"{elapsed:.6f}", file=sys.stderr, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
