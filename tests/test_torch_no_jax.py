"""The port must run without JAX: the machine with the GPU has none.

A subprocess blocks every ``jax`` import with a ``sys.meta_path`` finder
that raises, imports every module of the port, runs one CPU time step
with each ported pressure method (SOR, multigrid, CG), two Adams-Bashforth
2 steps of a small channel and an Euler step of the Taylor-Green box
(models/channel.py, models/taylorgreen.py), a step of the
backward-facing step by each masked solver and a short shedding trace of
the sharp Schäfer-Turek cylinder (ops/obstacles.py, ops/masked.py,
models/step.py, models/karman.py), a step of the heated-block convection
by Euler and by Adams-Bashforth 2 (ops/energy.py, models/convection.py),
a free-surface step of a small dam break and a particle trace
(particles.py, ops/surface.py, models/freesurface.py), the plain twins
of the tiled and colour-compressed SOR kernels and of the multigrid
coarse cycle, one step of the
sharded backend on a one-rank process group, with and without an
obstacle, of the sharded convection and of the sharded free surface, and
of the gspmd backend by mg, its convection and its free surface
(parallel/, including the extended-block twin and the masked sweeps,
parallel/gspmd.py and utils/distributed.py), and one step of the CLI's
host loop that writes a frame, a checkpoint and a history row with the
physics monitors (utils/io.py and its native writer, utils/checkpoint.py,
utils/diagnostics.py), then a gradient through one differentiable step
(diff.py), a step through the compensated outer (ops/compensated.py) and
a two-member ensemble (solver.solve_ensemble).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    import navierstokes_parallel_tpu_torch as port
    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        if not mod.name.endswith("__main__"):  # that one runs the CLI
            importlib.import_module(mod.name)
    from navierstokes_parallel_tpu_torch import Params, allocate_state, step
    prm = Params(i_max=8, j_max=8, T=0.01, Re=100.0, tau=0.5, max_it=200)
    state, diag = step(allocate_state(prm, "cpu"), prm)
    assert state.n == 1 and diag.sor_iterations > 0, diag
    for method in ("mg", "cg"):  # ops/mg.py: the V-cycle and CG's Laplacian
        _, d = step(allocate_state(prm, "cpu"), prm, pressure_method=method)
        assert d.sor_iterations > 0 and d.sor_converged, (method, d)
    # An AB2 step on a small channel (its BCs and deflation) and on the
    # Taylor-Green box (models/).
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.models import channel, taylorgreen
    chan = channel.plane_channel(nx=12, ny=6, T=0.05)
    ab2 = solver.ab2_init(allocate_state(chan, "cpu"))
    for _ in range(2):
        ab2, d = solver.step_ab2(ab2, chan)
        assert d.sor_converged and float(ab2.dt_prev) > 0, d
    assert max(channel.profile_errors(ab2.s.u, chan)) < 1.0
    tg, tg_state = taylorgreen.taylor_green(n=8, device="cpu")
    tg_state, d = step(tg_state, tg)
    assert d.sor_converged and taylorgreen.errors(tg_state, tg)["u"] < 0.1
    from navierstokes_parallel_tpu_torch.models import karman, step as bfs
    chan = bfs.backward_facing_step(nx=16, ny=8, T=0.1)
    for method in ("rb_sor", "mg"):
        _, d = solver.step(allocate_state(chan, "cpu"), chan,
                           pressure_method=method)
        assert d.sor_converged, (method, d)
    st = karman.schafer_turek(n_per_d=10, T=0.05, max_it=2)
    trace = karman.shedding_signal(
        st, device="cpu", method="mg", chunk=2,
        record_fn=karman.surface_force_record_fn(st, 5))
    assert trace.stats.steps == 2 and "fsx" in trace.rec
    from navierstokes_parallel_tpu_torch.models import convection
    hb, hb_cfg = convection.heated_block_setup(Ra=1e4, n=12)
    for order in (1, 2):
        _, d = convection.thermal_solve(hb.replace(T=1.0), hb_cfg,
                                        device="cpu",
                                        pressure_method="rb_sor",
                                        max_steps=2, time_order=order)
        assert d.steps == 2 and d.sor_failures == 0, (order, d)
    from navierstokes_parallel_tpu_torch import particles
    from navierstokes_parallel_tpu_torch.models import freesurface
    dam, fs = freesurface.dam_break(n=4, device="cpu")
    fs, d = freesurface.free_step(fs, dam, wall="freeslip")
    assert d.sor_converged and fs.state.n == 1, d
    assert freesurface.fluid_volume(fs, dam) > 0
    *_, hist = particles.trace_particles(
        prm, particles.grid_of_particles(prm, 2, 2, device="cpu"),
        max_steps=1)
    assert hist.shape == (2, 4, 3)
    import torch
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel as sk
    rhs = torch.zeros(prm.shape)
    rhs[1:-1, 1:-1] = torch.linspace(-1.0, 1.0, 64).view(8, 8)
    whole = sk.inner_sweeps_plain(rhs, 9, prm)
    assert torch.equal(sk.inner_sweeps_tiled_plain(rhs, 9, prm, 3), whole)
    assert torch.equal(sk.inner_sweeps_compressed_plain(rhs, 9, prm), whole)
    assert "navierstokes_parallel_tpu_torch.ops.mg" in sys.modules
    from navierstokes_parallel_tpu_torch.ops import mg
    levels = mg.build_levels(Params(i_max=32, j_max=16))
    tail = sk.coarse_cycle(rhs.new_zeros(levels[1].shape),
                           torch.ones(levels[1].shape), levels[1:])
    assert torch.equal(tail, sk.coarse_cycle_plain(
        rhs.new_zeros(levels[1].shape), torch.ones(levels[1].shape),
        levels[1:]))
    from navierstokes_parallel_tpu_torch.utils import timing
    assert sk.coarse_cycle_depth(levels) == 0
    assert "launch.mg_coarse_cycle" not in timing.counts()
    from navierstokes_parallel_tpu_torch.parallel import (
        gspmd, sharded, sharded_free, sharded_thermal)
    from navierstokes_parallel_tpu_torch.utils import distributed
    dvd, dvd_cfg = convection.convection_setup(Ra=1e4, n=8)
    with distributed.process_group("cpu"):
        sh_state, sh_stats = sharded.solve_sharded(prm, max_steps=1)
        _, ob_stats = sharded.solve_sharded(chan, max_steps=1)
        _, th_stats = sharded_thermal.solve_sharded_thermal(
            dvd, dvd_cfg, max_steps=1)
        _, fr_stats = sharded_free.solve_free_sharded(dam, fs, max_steps=1)
        # The gspmd backend (parallel/gspmd.py): mg over one device's
        # levels, convection and the free surface by mesh=.
        mesh = gspmd._default_mesh()
        _, gs_stats = gspmd.solve_gspmd(prm, mesh=mesh, max_steps=1,
                                        pressure_method="mg")
        _, gt_stats = convection.thermal_solve(dvd, dvd_cfg, mesh=mesh,
                                               max_steps=1)
        _, gf_stats = freesurface.solve_free(dam, fs, mesh=mesh,
                                             max_steps=1)
    assert sh_stats.steps == 1 and sh_stats.total_sor_iterations > 0
    assert ob_stats.steps == 1 and ob_stats.sor_failures == 0
    assert th_stats.steps == 1 and th_stats.sor_failures == 0
    assert fr_stats.steps == 1 and fr_stats.sor_failures == 0
    for stats in (gs_stats, gt_stats, gf_stats):
        assert stats.steps == 1 and stats.sor_failures == 0, stats
    for name in ("parallel.topology", "parallel.halo", "parallel.deep_halo",
                 "parallel.sharded", "parallel.sharded_thermal",
                 "parallel.sharded_free", "parallel.gspmd",
                 "utils.distributed"):
        assert "navierstokes_parallel_tpu_torch." + name in sys.modules, name
    import contextlib, io, os
    from navierstokes_parallel_tpu_torch import cli
    out = sys.argv[1]
    prm.replace(T=0.5).to_file(os.path.join(out, "p.in"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main([os.path.join(out, "p.in"), "--device", "cpu",
                       "--max-steps", "1", "--output-dir", out,
                       "--checkpoint-every", "1", "--checkpoint-path",
                       os.path.join(out, "ck.npz"), "--history-file",
                       os.path.join(out, "h.csv"), "--history-physics"])
    assert rc == 3 and printed.getvalue().startswith("U-CENTER"), rc
    assert sorted(f for f in os.listdir(out) if f != "p.in") == [
        "0_p.txt", "0_u.txt", "0_v.txt", "ck.npz", "h.csv"]
    with open(os.path.join(out, "h.csv")) as fh:
        assert len(fh.read().splitlines()) == 2
    for name in ("utils.io", "utils.checkpoint", "utils.diagnostics",
                 "models.cavity"):
        assert "navierstokes_parallel_tpu_torch." + name in sys.modules, name
    # A9: one diff_step gradient, one compensated solve, a two-member
    # ensemble.
    from navierstokes_parallel_tpu_torch import diff
    grad_prm = prm.replace(dtype="float64", epsilon=1e-9)
    lid = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    new, _ = diff.diff_step(allocate_state(grad_prm, "cpu"), grad_prm,
                            diff.default_controls(grad_prm, "cpu")._replace(
                                lid_scale=lid))
    (new.u[1:-1, 1:-1] ** 2).sum().backward()
    assert float(lid.grad) > 0, lid.grad
    comp = prm.replace(outer_precision="compensated")
    _, d = step(allocate_state(comp, "cpu"), comp)
    assert d.sor_converged and d.sor_iterations > 0, d
    assert "navierstokes_parallel_tpu_torch.ops.compensated" in sys.modules
    ens, ens_stats = solver.solve_ensemble(prm, solver.stack_states(
        [allocate_state(prm, "cpu")] * 2))
    assert ens.u.shape[0] == 2 and ens_stats.steps.tolist()[0] > 0
    assert torch.equal(ens.u[0], ens.u[1])
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("OK", diag.sor_iterations)
""")


def test_port_imports_and_steps_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_no_jax_import_in_sources():
    """Neither the port nor chip_smoke.py, tile_bench.py, direct_bench.py
    or the witness scripts (scripts/torch_*_witness.py) imports jax or the
    JAX package."""
    pkg = os.path.join(ROOT, "navierstokes_parallel_tpu_torch")
    paths = [os.path.join(ROOT, name) for name in (
        "chip_smoke.py", "tile_bench.py", "direct_bench.py",
        os.path.join("scripts", "torch_channel_witness.py"),
        os.path.join("scripts", "torch_karman_witness.py"),
        os.path.join("scripts", "torch_convection_witness.py"),
        os.path.join("scripts", "torch_dambreak_witness.py"))]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    banned = ("import jax", "from jax", "import navierstokes_parallel_tpu\n",
              "from navierstokes_parallel_tpu ",
              "from navierstokes_parallel_tpu.")
    offenders = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                if line.strip().startswith(banned) or \
                        line.strip() + "\n" in banned:
                    offenders.append(f"{path}: {line.strip()}")
    scanned = {os.path.relpath(p, pkg) for p in paths}
    for name in ("topology", "halo", "deep_halo", "sharded",
                 "sharded_thermal", "sharded_free"):
        assert os.path.join("parallel", f"{name}.py") in scanned, name
    for name in ("distributed", "io", "checkpoint", "diagnostics"):
        assert os.path.join("utils", f"{name}.py") in scanned, name
    for name in ("cavity", "channel", "taylorgreen", "step", "karman",
                 "convection", "freesurface"):
        assert os.path.join("models", f"{name}.py") in scanned, name
    for name in ("obstacles", "masked", "energy", "surface", "compensated"):
        assert os.path.join("ops", f"{name}.py") in scanned, name
    assert "particles.py" in scanned and "diff.py" in scanned
    assert len(paths) > 10 and not offenders, offenders
