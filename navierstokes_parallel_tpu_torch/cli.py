"""Command-line entry point, protocol-compatible with the JAX package's CLI and
the reference executables (src/serial/main.c:31-158):

    python -m navierstokes_parallel_tpu_torch <param-file> [tile-size] [options]

  * argv[1] = 15-line parameter file (defaults to parameters.txt)
  * argv[2] = optional tile size, the rows of a tile of the tiled SOR kernel
    (the reference's CUDA block-size argument; sor_kernel.set_default_tile)
  * stdout: "U-CENTER: %.6f" / "V-CENTER: %.6f" (main.c:148-149)
  * stderr: with --stats, the SOR statistics line and an empty line; then
    a single "%.6f" float — solver seconds (main.c:153's protocol)

The kernels are built and launched once before the timer starts, as the JAX
CLI compiles before it starts its timer.  ``--max-steps N`` stops after N
steps and exits with code 3 while t < T remains, as the JAX CLI does.  The
JAX CLI's other options (backends, meshes, AB2, obstacles, output frames,
checkpoints, history) are not ported yet (ROADMAP A4).  Unlike the JAX CLI,
a tile size of 0 is refused rather than ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import Params
from .grid import allocate_state, resolve_device
from .ops.cuda import sor_kernel
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
    ap.add_argument("tile_size", nargs="?", type=int, default=None,
                    help="rows of a tile of the tiled SOR kernel, in "
                         "[1, 4096] and within one block's shared memory "
                         "(reference CUDA block-size analogue)")
    ap.add_argument("--method",
                    choices=["rb_sor", "pallas_sor", "jacobi", "mg", "cg",
                             "fft"],
                    default="rb_sor",
                    help="pressure solver; rb_sor and pallas_sor both run "
                         "the f64-refined red-black SOR, mg geometric "
                         "multigrid V-cycles and cg conjugate gradients in "
                         "the same refinement (jacobi and fft are not "
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
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after N steps (exit code 3 if t < T remains; "
                         "0, the default, runs to T)")
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
    if args.max_steps < 0:
        print(f"error: --max-steps must be >= 0, got {args.max_steps}",
              file=sys.stderr)
        return 1
    if args.tile_size is not None:
        try:
            sor_kernel.set_default_tile(args.tile_size)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
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
    state, stats = solve(params, state, pressure_method=pressure_method,
                         max_steps=args.max_steps)
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
    # T in the state's dtype, as solve compares it.
    if args.max_steps and float(state.t) < float(state.t.new_tensor(params.T)):
        return 3  # stopped by --max-steps before T
    return 0


if __name__ == "__main__":
    sys.exit(main())
