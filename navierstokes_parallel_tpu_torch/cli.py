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
steps and exits with code 3 while t < T remains, as the JAX CLI does.

``--backend sharded`` runs the sharded solver (parallel/sharded.py) over a
``torch.distributed`` group, one rank per shard of a ``--mesh PxQ`` mesh
(P * Q must equal the number of ranks): a one-rank group by itself, or the
ranks ``torchrun`` starts.  Only rank 0 prints; the timer brackets the
solve between a barrier and a synchronize.  ``jnp`` and ``pallas`` are the
single-device route, as in the JAX CLI; ``gspmd`` is not ported.  The JAX
CLI's other options (AB2, obstacles, output frames, checkpoints, history)
are not ported yet (ROADMAP A4).  Unlike the JAX CLI, a tile size of 0 is
refused rather than ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from .config import Params
from .grid import allocate_state, resolve_device
from .ops.cuda import sor_kernel
from .ops.sor import default_method
from .solver import center_values, solve, warm_up
from .utils import distributed
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
    ap.add_argument("--backend",
                    choices=["auto", "jnp", "pallas", "sharded", "gspmd"],
                    default="auto",
                    help="compute path: auto, jnp and pallas run on one "
                         "device (pallas forces pallas_sor); sharded runs one "
                         "rank per shard of --mesh over torch.distributed; "
                         "gspmd is not ported")
    ap.add_argument("--method",
                    choices=["rb_sor", "pallas_sor", "rb_sor_sync", "jacobi",
                             "mg", "cg", "fft"],
                    default="rb_sor",
                    help="pressure solver; rb_sor and pallas_sor both run "
                         "the f64-refined red-black SOR (on the sharded "
                         "backend with the deep-halo inner), mg geometric "
                         "multigrid V-cycles, cg conjugate gradients and fft "
                         "direct DCT solves in the same refinement, jacobi "
                         "damped Jacobi sweeps (omega clamped to 0.8); "
                         "rb_sor_sync exchanges halos before every "
                         "half-sweep on the sharded backend and is rb_sor "
                         "off it.  A float64 state (or rb_sor / jacobi on "
                         "the jnp backend) takes the direct solve in its "
                         "dtype")
    ap.add_argument("--mesh", default=None, metavar="PxQ",
                    help="process mesh of the sharded backend, e.g. 2x2; "
                         "P * Q must equal the number of ranks (default: "
                         "the pad-optimal mesh over them)")
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

    if args.backend == "gspmd":
        print("error: --backend gspmd is not ported (XLA's SPMD partitioner "
              "has no PyTorch counterpart; ROADMAP \"Left out of the "
              "port\"); use --backend sharded", file=sys.stderr)
        return 1
    try:
        mesh_shape = parse_mesh_arg(args.mesh)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if mesh_shape is not None and args.backend != "sharded":
        print(f"error: --mesh applies to the sharded backend, not "
              f"{args.backend!r}", file=sys.stderr)
        return 1

    pressure_method = args.method
    if pressure_method == "rb_sor_sync" and args.backend != "sharded":
        pressure_method = "rb_sor"  # sync vs deep only differs across shards
    if args.backend == "pallas":
        pressure_method = "pallas_sor"
    elif args.backend == "auto" and pressure_method == "rb_sor":
        pressure_method = default_method(params, device)
    if args.backend == "sharded":
        return _main_sharded(args, params, device, mesh_shape,
                             pressure_method)
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
    return _report(args, params, state, stats, elapsed)


def _main_sharded(args, params: Params, device, mesh_shape,
                  pressure_method: str) -> int:
    """The sharded backend inside a process group; rank 0 reports."""
    from .parallel import sharded
    from .parallel.topology import make_grid_mesh

    with distributed.process_group(device) as rank_device:
        try:
            mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max,
                                  shape=mesh_shape, device=rank_device)
            sharded.warm_up(params, mesh, pressure_method)
        except (NotImplementedError, ValueError) as e:
            if dist.get_rank() == 0:
                print(f"error: {e}", file=sys.stderr)
            return 1
        local = sharded.scatter_state(params, None, mesh)
        dist.barrier()
        start = time.perf_counter()
        local, stats = sharded.run_local(params, local, mesh,
                                         pressure_method=pressure_method,
                                         max_steps=args.max_steps)
        if rank_device.type == "cuda":
            torch.cuda.synchronize(rank_device)
        elapsed = time.perf_counter() - start
        state = sharded.gather_state(params, local, mesh)
        if dist.get_rank() != 0:
            return _exit_code(args, params, state)
        return _report(args, params, state, stats, elapsed)


def parse_mesh_arg(spec):
    """'PxQ' -> (P, Q); None -> None (the backend picks its mesh)."""
    if spec is None:
        return None
    try:
        px, py = (int(tok) for tok in spec.lower().split("x"))
        if px < 1 or py < 1:
            raise ValueError
    except ValueError:
        raise ValueError(f"--mesh expects PxQ (e.g. 2x4), got {spec!r}")
    return px, py


def _exit_code(args, params: Params, state) -> int:
    # T in the state's dtype, as solve compares it.
    if args.max_steps and float(state.t) < float(state.t.new_tensor(params.T)):
        return 3  # stopped by --max-steps before T
    return 0


def _report(args, params: Params, state, stats, elapsed: float) -> int:
    """Check the state, print the protocol's lines; returns the exit code."""
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
    return _exit_code(args, params, state)


if __name__ == "__main__":
    sys.exit(main())
