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
CLI compiles before it starts its timer.

The reference protocol's files, as the JAX CLI writes them (the reference
comments its own n_print output out, main.c:138-143):

  * ``--output-dir D`` writes ``D/<k>_{u,v,p}.txt`` (utils/io.py, the
    reference's text grids) before every step whose absolute step number
    n is a multiple of n_print, k = n / n_print; a worker thread formats
    and writes them while the next steps run, and a writer error is raised
    at the next frame or at the end;
  * ``--final-output-prefix P`` writes ``P_{u,v,p}.txt`` of the final state;
  * ``--checkpoint-every N --checkpoint-path F`` saves the state to F
    (utils/checkpoint.py, the JAX package's .npz) after every N-th step,
    and ``--resume F`` starts from it: frame numbers follow the absolute
    step count, and the history CSV is appended to (its columns must be
    this run's);
  * ``--history-file H`` writes one CSV row per step (step, t, dt,
    sor_iterations, res_norm), ``--history-physics`` adds the monitors of
    utils/diagnostics.py; ``--log-every N`` prints a row on stderr;
  * ``--max-steps N`` stops after N steps and exits with code 3 while
    t < T remains;
  * ``--debug-nans`` checks the state after every step and stops at the
    first step that leaves a NaN or Inf (utils/checks.py; JAX faults at
    the first NaN-producing operation instead).

Every run is the host loop (``run_host_loop``): ``solver.run_steps``
over ``solver.Stepper`` on one device, which is ``solver.solve``'s loop
(same kernels, same bits), or over ``parallel/sharded.py::ShardedStepper``,
with the files these flags ask for written between the steps.

``--backend sharded`` runs the sharded solver (parallel/sharded.py) over a
``torch.distributed`` group, one rank per shard of a ``--mesh PxQ`` mesh
(P * Q must equal the number of ranks): a one-rank group by itself, or the
ranks ``torchrun`` starts.  Every rank runs the host loop and gathers the
state at the same steps; only rank 0 prints and writes files, and after
each step's writes every rank learns whether one failed, so a write error
on rank 0 ends every rank with exit code 1 instead of leaving them waiting
in the next gather.  The timer brackets the solve between a barrier and a
synchronize; the final gather follows it.  ``jnp`` and
``pallas`` are the single-device route, as in the JAX CLI.  ``--backend
gspmd`` (parallel/gspmd.py) runs the same way over the ranks of a
``--mesh PxQ`` (default: near-square; a 1xN mesh of more than one rank is
refused, as in the JAX CLI) and gives one device's results: every method
but pallas_sor, on any grid, problems 1-6 (problem 5 through
``convection.ThermalGspmdStepper``, problem 6 through the sharded
backend's free-surface stepper, as ``freesurface.solve_free(mesh=...)``).  ``--outer compensated`` runs the two-float refinement outer
(ops/sor.py, ops/compensated.py) on one device and on the sharded
backend, as in the JAX CLI.  Unlike the JAX CLI, a tile size of 0 is
refused rather than ignored.

``--obstacle I0:I1:J0:J1`` (repeatable) makes an interior cell rectangle
solid, 1-based and inclusive, as the JAX CLI parses it: a flag-field domain
(ops/obstacles.py) whose pressure solve is the masked rb_sor or mg
(ops/masked.py; the default method is rb_sor on every device), and on the
sharded backend the masked deep-halo rb_sor (parallel/sharded.py; any
other method is the JAX backend's ValueError).

Problem 5 (natural convection, models/convection.py; ``configs/
convection.in``) starts from the conduction state (``allocate_thermal``)
and runs the same host loop over a ``ThermalStepper``; its frames add
``<k>_temp.txt`` and its checkpoints the temperature T (a problem-5 run
refuses an isothermal checkpoint).  On the sharded backend it steps with
``parallel/sharded_thermal.py::ThermalShardedStepper`` by any sharded
method.

Problem 6 (free surfaces, models/freesurface.py; ``configs/dambreak.in``)
starts from the liquid box of the parameter file's lines 16-19 and runs the
host loop over a ``FreeStepper`` with ``--free-wall`` (noslip or freeslip)
as its container walls; its checkpoints carry the marker particles (a
problem-6 run refuses a checkpoint without them).  Its pressure solve is
the free-surface operator, so ``--method`` and ``--backend pallas`` are
ignored with the JAX CLI's warnings.  On the sharded backend every rank
holds the state and the pressure sweeps are partitioned
(``parallel/sharded_free.py``).

``--time-order 2`` steps with Adams-Bashforth 2 (``solver.step_ab2``, and
``convection.thermal_step_ab2`` on problem 5) on both backends, as the JAX
CLI does: it warns on standard error when tau > 0.5 (beyond AB2's
stability bound on the viscous dt limit) and refuses problem 6, and
problem 5 on the sharded backend.  A checkpoint holds the state only, so a
resumed AB2 run starts again from the Euler bootstrap and is not bit-equal
to the straight run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from .config import Params
from .grid import State, allocate_state, resolve_device
from .models import convection, freesurface
from .ops.cuda import sor_kernel
from .ops.sor import default_method
from .solver import SolveStats, Stepper, center_values, run_steps, warm_up
from .utils import distributed
from .utils import io as nsio
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.checks import NonFiniteStateError, check_step, validate_state
from .utils.diagnostics import monitor_values, physics_monitors
from .utils.timing import device_fence, mlups


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="navierstokes_parallel_tpu_torch",
        description="Incompressible Navier-Stokes solver "
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
                         "gspmd runs one device's program on the same "
                         "blocks (any method but pallas_sor, any grid)")
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
    ap.add_argument("--time-order", type=int, choices=[1, 2], default=1,
                    help="momentum time integrator: 1 = the reference's "
                         "explicit Euler (default), 2 = variable-step "
                         "Adams-Bashforth 2 (solver.step_ab2; stable for "
                         "tau <= 0.5; not for problem 6).  A resumed run "
                         "re-bootstraps with one Euler step (checkpoints "
                         "carry the state, not the AB2 tendency)")
    ap.add_argument("--mesh", default=None, metavar="PxQ",
                    help="process mesh of the sharded/gspmd backends, e.g. "
                         "2x2; P * Q must equal the number of ranks "
                         "(default: the pad-optimal mesh over them for "
                         "sharded, near-square for gspmd).  gspmd rejects "
                         "1xN/Nx1 meshes of more than one rank")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="override dtype (default: config / float32)")
    ap.add_argument("--refine-every", type=int, default=None,
                    help="f64 re-baseline / convergence-check interval K of "
                         "the SOR solve (default 64)")
    ap.add_argument("--outer", choices=["float64", "compensated"],
                    default=None,
                    help="refinement-outer precision: float64 (the default; "
                         "native on the GPU) or compensated (the two-float "
                         "f32 outer, ops/compensated.py)")
    ap.add_argument("--obstacle", action="append", default=None,
                    metavar="I0:I1:J0:J1",
                    help="an interior cell rectangle made solid (1-based, "
                         "inclusive; repeatable): a flag-field obstacle "
                         "domain, solved by the masked rb_sor or mg")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; there is no silent "
                         "fallback to the CPU)")
    ap.add_argument("--output-dir", default=None,
                    help="write <n>_{u,v,p}.txt frames every n_print steps")
    ap.add_argument("--final-output-prefix", default=None,
                    help="write one final <prefix>_{u,v,p}.txt")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N steps (0 = off)")
    ap.add_argument("--checkpoint-path", default="checkpoint.npz")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint file (of either package)")
    ap.add_argument("--stats", action="store_true",
                    help="print SOR iteration / convergence stats to stderr")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check the state after every step and stop with "
                         "an error naming the first step that leaves a NaN "
                         "or Inf (PyTorch has no counterpart of "
                         "jax_debug_nans, which faults at the first "
                         "NaN-producing operation)")
    ap.add_argument("--history-file", default=None,
                    help="write per-step diagnostics CSV (step,t,dt,"
                         "sor_iterations,res_norm)")
    ap.add_argument("--history-physics", action="store_true",
                    help="append physics monitor columns (kinetic_energy,"
                         "enstrophy,max_divergence,psi_min — "
                         "utils/diagnostics.py) to the --history-file CSV")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print per-step diagnostics to stderr every N steps")
    ap.add_argument("--free-wall", choices=["noslip", "freeslip"],
                    default="noslip",
                    help="problem-6 container-wall condition (freeslip is "
                         "the usual dam-break setting)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after N steps (exit code 3 if t < T remains; "
                         "with --checkpoint-every and --resume, a run in "
                         "pieces)")
    return ap


def _history_columns(args) -> str:
    """The --history-file CSV header of this run's flags (the header
    written, and the one a resumed run must find)."""
    cols = "step,t,dt,sor_iterations,res_norm"
    if args.history_physics:
        cols += ",kinetic_energy,enstrophy,max_divergence,psi_min"
    return cols


def _check_args(args) -> str:
    """The message refusing these arguments before any work, or ''."""
    for flag in ("max_steps", "checkpoint_every", "log_every"):
        if getattr(args, flag) < 0:
            return (f"--{flag.replace('_', '-')} must be >= 0, got "
                    f"{getattr(args, flag)}")
    if args.refine_every is not None and args.refine_every < 1:
        return f"--refine-every must be >= 1, got {args.refine_every}"
    if args.history_physics and not args.history_file:
        return "--history-physics requires --history-file"
    if args.resume and args.history_file and \
            os.path.exists(args.history_file) and \
            os.path.getsize(args.history_file) > 0:
        # A resumed run appends: rows under another header would be ragged.
        with open(args.history_file) as fh:
            have = fh.readline().strip()
        want = _history_columns(args)
        if have != want:
            return (f"--history-file {args.history_file!r} has columns "
                    f"[{have}] but this run would append [{want}] — pass "
                    f"the same --history-physics setting as the original "
                    f"run, or use a fresh --history-file")
    return ""


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    problem = _check_args(args)
    if problem:
        print(f"error: {problem}", file=sys.stderr)
        return 1
    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.refine_every is not None:
        overrides["sor_refine_every"] = args.refine_every
    if args.outer:
        overrides["outer_precision"] = args.outer
    if args.obstacle:
        rects = []
        for spec in args.obstacle:
            parts = spec.split(":")
            if len(parts) != 4 or not all(
                    p.lstrip("-").isdigit() for p in parts):
                print(f"error: --obstacle expects I0:I1:J0:J1 (got "
                      f"{spec!r})", file=sys.stderr)
                return 1
            rects.append(tuple(int(p) for p in parts))
        overrides["obstacles"] = tuple(rects)
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

    try:
        mesh_shape = parse_mesh_arg(args.mesh)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if mesh_shape is not None and args.backend not in ("sharded", "gspmd"):
        print(f"error: --mesh applies to the sharded backend or the gspmd "
              f"backend, not {args.backend!r}", file=sys.stderr)
        return 1

    state = None
    if args.resume:
        # The sharded and gspmd backends scatter the state from the host.
        where = "cpu" if args.backend in ("sharded", "gspmd") else device
        try:
            state = load_checkpoint(args.resume, params, where)
        except (OSError, ValueError, KeyError, NotImplementedError) as e:
            print(f"error: cannot resume from {args.resume!r}: {e}",
                  file=sys.stderr)
            return 1

    pressure_method = args.method
    if pressure_method == "rb_sor_sync" and args.backend != "sharded":
        pressure_method = "rb_sor"  # sync vs deep only differs across shards
    if args.backend == "pallas":
        pressure_method = "pallas_sor"
    elif args.backend == "auto" and pressure_method == "rb_sor":
        pressure_method = default_method(params, device)
    if args.time_order == 2:
        if params.problem == 6:
            # As the JAX CLI: the free-surface reflagging changes the fluid
            # domain between steps, so a carried tendency is ill-defined.
            print("error: --time-order 2 does not apply to problem 6 "
                  "(free surfaces reflag the fluid domain every step; an "
                  "Adams-Bashforth tendency carried across a reflag is "
                  "ill-defined)", file=sys.stderr)
            return 1
        if params.problem == 5 and args.backend in ("sharded", "gspmd"):
            print("error: --time-order 2 for problem 5 runs single-chip "
                  "(the multi-chip thermal steppers integrate first-order; "
                  "drop --backend or --time-order)", file=sys.stderr)
            return 1
        if params.tau > 0.5:
            # AB2's real-axis stability interval is half of Euler's.
            print(f"warning: --time-order 2 with tau={params.tau} > 0.5 "
                  "exceeds the AB2 stability bound on the viscous dt "
                  "limit; expect blow-up (use tau <= 0.5)",
                  file=sys.stderr)
    if args.backend == "sharded":
        return _main_sharded(args, params, device, mesh_shape,
                             pressure_method, state)
    if params.problem == 6:
        # The free-surface operator is the problem's own (JAX CLI).
        if args.method != "rb_sor":
            print(f"warning: problem 6 uses the free-surface traced pressure "
                  f"operator; --method {args.method!r} is ignored",
                  file=sys.stderr)
        if args.backend == "pallas":
            print("warning: problem 6 runs the plain free-surface path; "
                  "--backend pallas is ignored", file=sys.stderr)
    if args.backend == "gspmd":
        return _main_sharded(args, params, device, mesh_shape,
                             pressure_method, state)
    if params.problem == 6:
        stepper = freesurface.FreeStepper(
            params, state or freesurface.initial_free_state(params, device),
            wall=args.free_wall)
        stepper.warm()
        return _run_timed(args, params, stepper)
    cfg = (convection.config_from_params(params) if params.problem == 5
           else None)
    try:
        if cfg is None:
            warm_up(params, device, pressure_method, args.time_order)
        else:
            convection.warm_up(params, cfg, device, pressure_method,
                               args.time_order)
    except NotImplementedError as e:  # an unported route, found at once
        print(f"error: {e}", file=sys.stderr)
        return 1
    if cfg is None:
        stepper = Stepper(params, state or allocate_state(params, device),
                          pressure_method, args.time_order)
    else:
        stepper = convection.ThermalStepper(
            params, cfg, state or convection.allocate_thermal(params, cfg,
                                                              device),
            pressure_method, args.time_order)
    return _run_timed(args, params, stepper)


def _run_timed(args, params: Params, stepper) -> int:
    """The one-device host loop under the timer, then the report."""
    start = time.perf_counter()
    try:
        stats = run_host_loop(params, stepper, args)
    except (NonFiniteStateError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    state = stepper.state()
    device_fence(state)
    elapsed = time.perf_counter() - start
    return _report(args, params, state, stats, elapsed)


def _main_sharded(args, params: Params, device, mesh_shape,
                  pressure_method: str, state) -> int:
    """The sharded or the gspmd backend inside a process group; rank 0
    reports."""
    from .parallel import gspmd
    from .parallel.topology import make_grid_mesh

    with distributed.process_group(device) as rank_device:
        rank0 = dist.get_rank() == 0
        try:
            if args.backend == "gspmd":
                mesh = (gspmd._default_mesh(rank_device)
                        if mesh_shape is None else
                        make_grid_mesh(shape=mesh_shape, device=rank_device))
                stepper = _gspmd_stepper(args, params, mesh, pressure_method,
                                         state)
            else:
                mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max,
                                      shape=mesh_shape, device=rank_device)
                stepper = _sharded_stepper(args, params, mesh,
                                           pressure_method, state)
        except (NotImplementedError, ValueError) as e:
            if rank0:
                print(f"error: {e}", file=sys.stderr)
            return 1
        dist.barrier()
        start = time.perf_counter()
        try:
            stats = run_host_loop(params, stepper, args, writer=rank0)
        except (NonFiniteStateError, OSError) as e:
            if rank0:
                print(f"error: {e}", file=sys.stderr)
            return 1
        if rank_device.type == "cuda":
            torch.cuda.synchronize(rank_device)
        elapsed = time.perf_counter() - start
        state = stepper.state()
        if not rank0:
            return _exit_code(args, params, state)
        return _report(args, params, state, stats, elapsed)


def _sharded_stepper(args, params: Params, mesh, pressure_method: str,
                     state):
    """The warmed stepper of the problem on the sharded backend: the
    thermal stepper for problem 5, the free-surface stepper with the
    partitioned sweeps for problem 6 (its state replicated on each rank),
    else ``sharded.ShardedStepper``."""
    from .parallel import sharded, sharded_free, sharded_thermal

    if params.problem == 6:
        fs = (freesurface.initial_free_state(params, mesh.device)
              if state is None else freesurface.to_device(state, mesh.device))
        stepper = sharded_free.make_free_stepper(params, fs, mesh,
                                                 wall=args.free_wall)
        stepper.warm()
        return stepper
    if params.problem == 5:
        # Every --method choice is a sharded method, so the JAX CLI's
        # fallback to rb_sor for an unsupported one never applies here.
        cfg = convection.config_from_params(params)
        sharded_thermal.warm_up(params, cfg, mesh, pressure_method)
        return sharded_thermal.ThermalShardedStepper(
            params, cfg, state if state is not None
            else convection.allocate_thermal(params, cfg, mesh.device),
            mesh, pressure_method)
    sharded.warm_up(params, mesh, pressure_method, args.time_order)
    return sharded.ShardedStepper(params, state, mesh, pressure_method,
                                  args.time_order)


def _gspmd_stepper(args, params: Params, mesh, pressure_method: str, state):
    """The warmed stepper of the problem on the gspmd backend: the thermal
    stepper for problem 5, the sharded backend's free-surface stepper for
    problem 6 (``freesurface.solve_free(mesh=...)``'s), else
    ``gspmd.GspmdStepper``."""
    from .parallel import gspmd, sharded_free

    if params.problem == 6:
        gspmd._check_mesh(mesh)
        fs = (freesurface.initial_free_state(params, mesh.device)
              if state is None else freesurface.to_device(state, mesh.device))
        stepper = sharded_free.make_free_stepper(params, fs, mesh,
                                                 wall=args.free_wall)
    elif params.problem == 5:
        cfg = convection.config_from_params(params)
        stepper = convection.ThermalGspmdStepper(
            params, cfg, state if state is not None
            else convection.allocate_thermal(params, cfg, mesh.device),
            mesh, pressure_method)
    else:
        stepper = gspmd.GspmdStepper(params, state, mesh, pressure_method,
                                     args.time_order)
    stepper.warm()
    return stepper


class _FrameWriter:
    """The host loop's frames, written in order by one worker thread: the
    fields are copied to the host when the frame is taken, and formatting
    and disk I/O overlap the next steps.  A writer error is raised at the
    next frame, or by ``close``."""

    def __init__(self, params: Params):
        self._params = params
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def _drain(self, block: bool) -> None:
        pending = []
        for fut in self._pending:
            if block or fut.done():
                fut.result()  # raises the writer's exception
            else:
                pending.append(fut)
        self._pending = pending

    def submit(self, state: State, prefix: str) -> None:
        # A copy even of a CPU tensor: the worker reads it after the next
        # steps have begun.
        u, v, p = (x.detach().to("cpu", copy=True).numpy()
                   for x in state[:3])
        temp = (state.T.detach().to("cpu", copy=True).numpy()
                if hasattr(state, "T") else None)
        self._drain(block=False)
        self._pending.append(self._pool.submit(
            nsio.output, u, v, p, float(state.t), self._params.a,
            self._params.b, prefix, verbose=False, temperature=temp))

    def close(self) -> None:
        """Wait for every frame; raises a writer error."""
        self._drain(block=True)

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self._pool.shutdown()
        return False


def _open_history(args):
    """The history CSV, appended to by a resumed run that finds one, else
    written anew under its header."""
    if args.resume and os.path.exists(args.history_file) and \
            os.path.getsize(args.history_file) > 0:
        return open(args.history_file, "a")
    fh = open(args.history_file, "w")
    fh.write(_history_columns(args) + "\n")
    return fh


def run_host_loop(params: Params, stepper, args, writer: bool = True
                  ) -> SolveStats:
    """Step to t >= T (or --max-steps) with ``solver.run_steps``, with the
    frames, checkpoints, history rows, log lines and NaN checks that `args`
    asks for (the JAX CLI's ``_run_host_loop``).  `stepper` is a
    ``solver.Stepper`` or a ``sharded.ShardedStepper``; on the sharded
    backend every rank runs this loop and gathers the state at the same
    steps (``stepper.state()``, at most once before a step and once after
    it), and only the `writer` rank writes and prints.  A write error is
    held until the end of the step, where every rank learns of it
    (``stepper.any_rank``) and raises.  Returns the solve's stats; the
    final state stays in `stepper`."""
    n_print = max(params.n_print, 1)
    files = bool(args.output_dir or args.history_file or args.checkpoint_every)
    failed = []  # the writer's OSError, raised on every rank by agree()

    def write(fn) -> None:
        if writer and not failed:
            try:
                fn()
            except OSError as e:
                failed.append(e)

    def agree() -> None:
        if files and stepper.any_rank(bool(failed)):
            raise failed[0] if failed else OSError(
                "a file write failed on rank 0")

    with contextlib.ExitStack() as stack:
        hist = frames = None

        def open_files() -> None:
            nonlocal hist, frames
            if args.history_file:
                hist = stack.enter_context(_open_history(args))
            if args.output_dir:
                frames = stack.enter_context(_FrameWriter(params))

        write(open_files)
        agree()

        def before() -> None:
            # Frames follow the absolute step count (state.n), so a resumed
            # run continues the numbering.
            n_abs = stepper.n
            if args.output_dir and n_abs % n_print == 0:
                st = stepper.state()
                write(lambda: frames.submit(st, os.path.join(
                    args.output_dir, str(n_abs // n_print))))

        def after(diag, steps: int) -> None:
            checkpoint = bool(args.checkpoint_every
                              and steps % args.checkpoint_every == 0)
            post = None
            if args.history_physics or args.debug_nans or checkpoint:
                post = stepper.state()
            if args.debug_nans:
                check_step(post, stepper.n)
            if args.history_file:
                row = (f"{stepper.n},{stepper.t:.8f},{float(diag.dt):.8f},"
                       f"{diag.sor_iterations},{diag.sor_res_norm:.6e}")
                if args.history_physics and writer:
                    ke, ens, div, psi = monitor_values(
                        physics_monitors(post.u, post.v, params))
                    row += f",{ke:.8e},{ens:.8e},{div:.6e},{psi:.8e}"
                write(lambda: hist.write(row + "\n"))
            if writer and args.log_every and steps % args.log_every == 0:
                print(f"step={steps} t={stepper.t:.5f} "
                      f"dt={float(diag.dt):.5f} "
                      f"sor_iters={diag.sor_iterations} "
                      f"res={diag.sor_res_norm:.3e}", file=sys.stderr)
            if checkpoint:
                write(lambda: save_checkpoint(args.checkpoint_path, post))
            agree()

        stats = run_steps(stepper, params, max_steps=args.max_steps,
                          before=before, after=after)
        if frames is not None:
            write(frames.close)
        if hist is not None:
            write(hist.close)
        agree()
    return stats


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
    """Check the state, print the protocol's lines and write the final
    output; returns the exit code."""
    validate_state(state, where="end of integration")
    uc, vc = center_values(state, params)
    print(f"U-CENTER: {uc:.6f}")
    print(f"V-CENTER: {vc:.6f}")

    if args.final_output_prefix:
        nsio.output(state.u, state.v, state.p, float(state.t), params.a,
                    params.b, args.final_output_prefix,
                    temperature=getattr(state, "T", None))

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
