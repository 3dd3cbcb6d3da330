"""The port's gspmd backend (parallel/gspmd.py) against the JAX package's
GSPMD backend and its one-device program.

  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback runs on a 2x2 mesh every method of ``GSPMD_METHODS`` at 16^2
    (divisible), 17^2 (padded) and 18^2 (divisible, odd blocks), the AB2
    and obstacle cases (masked rb_sor, masked mg on blocks and, at 18^2,
    gathered at level 0) of tests/jax_records.py's GSPMD_CASES, each step
    by step through ``GspmdStepper``; a 64^2 mg solve whose V-cycle
    smoother calls are recorded (block-sized fine levels); convection by
    ``thermal_solve(mesh=...)``, ``solve_convection(mesh=...)`` and the
    CLI's problem 5, and the heated block (an obstacle domain); the dam break by ``solve_free(mesh=...)`` and the
    CLI's problem 6; and the CLI's problem 1 straight and in two pieces
    (--max-steps, --resume) with every protocol file.
  * Against the JAX package: each run's steps, per-step iterations and
    convergence equal to JAX's one-device steps (computed in this process
    while the ranks run; fft on JAX's real-FFT route, the port's) and to
    JAX's GSPMD stepper on a 2x2 mesh of four CPU devices (its matmul DCT
    route under ``disable_pallas``, with the same counts here;
    tests/jax_gspmd_records.json "mesh_2x2", written by
    ``JAX_PLATFORMS=cpu python tests/jax_records.py gspmd``), u, v and p
    within the 1e-4 contract of JAX's one-device fields, and the centre
    values within it of the JAX GSPMD record's.
  * One rank: the V-cycle count on a 1x1 mesh at 64^2 equals one device's
    (the sharded backend's levels go one deeper there), fft gathered on a
    grid whose pencils do not tile, the refusals (pallas_sor, a 1x4 mesh,
    masked fft, problems 5 and 6 through the isothermal stepper) with the
    JAX package's messages in substance, and ``choose_mesh_shape_square``
    against JAX's.

The spawned workers import this module, which imports no jax at its top:
the JAX side runs in the test process only.
"""

import datetime
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu_torch import cli
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import convection as cv
from navierstokes_parallel_tpu_torch.models import freesurface as FS
from navierstokes_parallel_tpu_torch.ops import mg
from navierstokes_parallel_tpu_torch.parallel import gspmd, topology
from navierstokes_parallel_tpu_torch.solver import center_values, run_steps
from navierstokes_parallel_tpu_torch.utils import distributed
from test_torch_sharded import (PROBE_T, _assert_same_protocol_files,
                                _free_port, _host_loop_argv, _probe_state)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
MESH = (2, 2)
WORKER_TIMEOUT_S = 300
CONTRACT = 1e-4
with open(os.path.join(HERE, "jax_gspmd_records.json")) as _fh:
    RECORDS = json.load(_fh)["mesh_2x2"]
SMALL = {"problem": 1, "T": 0.05, "Re": 100.0, "tau": 0.5, "omega": 1.7,
         "epsilon": 1e-4, "max_it": 500, "dtype": "float32"}
CASES = {tag: rec for tag, rec in RECORDS.items() if tag != "cli"}
CASE_TAGS = sorted(CASES)
# The convection and free-surface runs: de Vahl Davis at Ra 1e4 on 16^2 by
# mg, THERMAL_STEPS steps; configs/convection.in through the CLI,
# CLI_STEPS; the dam break at n = 4 (20 x 12) with free-slip walls,
# FREE_STEPS, and configs/dambreak.in through the CLI, CLI_STEPS.
THERMAL_STEPS, FREE_STEPS, CLI_STEPS, BLOCK_STEPS = 6, 3, 2, 4
MG_BLOCKS_N = 64


def _params(fields) -> Params:
    kw = {**SMALL, **fields}
    if "obstacles" in kw:
        kw["obstacles"] = tuple(tuple(o) for o in kw["obstacles"])
    return Params(**kw)


def _stepped(stepper, params, **kw):
    """(per-step iterations, convergence and t, stats) of the run."""
    iters, conv, ts = [], [], []

    def after(diag, _):
        iters.append(int(diag.sor_iterations))
        conv.append(bool(diag.sor_converged))
        ts.append(stepper.t)

    stats = run_steps(stepper, params, after=after, **kw)
    return np.asarray(iters), np.asarray(conv), np.asarray(ts), stats


def _cli_quiet(argv):
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _gloo_worker(rank, port, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=180))
    try:
        mesh = topology.make_grid_mesh(shape=MESH, device="cpu")
        out = {}
        for tag in CASE_TAGS:
            rec = CASES[tag]
            prm = _params(rec["fields"])
            stepper = gspmd.GspmdStepper(prm, None, mesh, rec["method"],
                                         rec["time_order"])
            out[f"{tag}/block"] = np.asarray(stepper._local.u.shape)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # jacobi's omega clamp
                iters, conv, ts, stats = _stepped(stepper, prm)
            state = stepper.state()
            out.update({f"{tag}/iterations": iters, f"{tag}/converged": conv,
                        f"{tag}/t": ts, f"{tag}/failures": stats.sor_failures,
                        f"{tag}/centre": center_values(state, prm)})
            for name in "uvp":
                out[f"{tag}/{name}"] = getattr(state, name).numpy()
        # The CFL-seed probe (tests/test_torch_sharded.py): one device's
        # corner seed, the corner carried.
        state, st = gspmd.solve_gspmd(_params({"i_max": 24, "j_max": 24,
                                               "T": PROBE_T}),
                                      _probe_state(), mesh)
        out["probe/steps_t"] = np.asarray([st.steps, float(state.t)])
        out["probe/corner"] = state.u[0, 0].numpy()
        # The fine levels of a 64^2 V-cycle are blocks: the shapes every
        # smoother call sees.
        seen = []
        smooth = mg._smooth_sharded

        def spy(p, rhs, level, n, mesh_, omega=1.0):
            seen.append(tuple(p.shape))
            return smooth(p, rhs, level, n, mesh_, omega)

        mg._smooth_sharded = spy
        try:
            prm = _params({"i_max": MG_BLOCKS_N, "j_max": MG_BLOCKS_N})
            _, st = gspmd.solve_gspmd(prm, mesh=mesh, pressure_method="mg",
                                      max_steps=2)
        finally:
            mg._smooth_sharded = smooth
        out["mg64/smoothed"] = np.asarray(sorted(set(seen)))
        out["mg64/iterations"] = st.total_sor_iterations
        # Natural convection by mesh=: thermal_solve, the stepper with
        # solve_convection's steady-state loop, and the CLI's problem 5.
        prm, cfg = cv.convection_setup(Ra=1e4, n=16)
        ts, st = cv.thermal_solve(prm, cfg, mesh=mesh, pressure_method="mg",
                                  max_steps=THERMAL_STEPS)
        for name in "uvpT":
            out[f"thermal/{name}"] = getattr(ts, name).numpy()
        out["thermal/stats"] = np.asarray(
            [st.steps, st.total_sor_iterations, st.sor_failures])
        ts, info = cv.solve_convection(prm, cfg, mesh=mesh, chunk=4,
                                       max_steps=8, pressure_method="mg")
        out["convection/T"] = ts.T.numpy()
        out["convection/info"] = np.asarray(
            [info["steps"], info["sor_failures"], info["dT_rate"]])
        # The heated block (an obstacle domain): one device's thermal step
        # on the gathered fields.
        bprm, bcfg = cv.heated_block_setup(Ra=1e4, n=16)
        ts, st = cv.thermal_solve(bprm, bcfg, mesh=mesh,
                                  pressure_method="rb_sor",
                                  max_steps=BLOCK_STEPS)
        for name in "uvpT":
            out[f"block/{name}"] = getattr(ts, name).numpy()
        out["block/stats"] = np.asarray(
            [st.steps, st.total_sor_iterations, st.sor_failures])
        conv_cli = _cli_quiet([os.path.join(ROOT, "configs/convection.in"),
                               "--device", "cpu", "--backend", "gspmd",
                               "--method", "mg", "--max-steps",
                               str(CLI_STEPS), "--stats"])
        # The dam break by mesh=, and the CLI's problem 6.
        dam, fs = FS.dam_break(n=4, device="cpu")
        fs, st = FS.solve_free(dam, fs, wall="freeslip", mesh=mesh,
                               max_steps=FREE_STEPS)
        for name in "uvp":
            out[f"free/{name}"] = getattr(fs.state, name).numpy()
        out["free/particles"] = np.stack([fs.pset.x.numpy(),
                                          fs.pset.y.numpy()])
        out["free/active"] = fs.pset.active.numpy()
        out["free/stats"] = np.asarray(
            [st.steps, st.total_sor_iterations, st.sor_failures])
        free_cli = _cli_quiet([os.path.join(ROOT, "configs/dambreak.in"),
                               "--device", "cpu", "--backend", "gspmd",
                               "--free-wall", "freeslip", "--max-steps",
                               str(CLI_STEPS), "--stats"])
        # The CLI's problem 1: the recorded run, then straight and in two
        # pieces with every protocol file.
        path = os.path.join(outdir, "gspmd16.in")
        rc = [_cli_quiet([a.format(path=path) for a in RECORDS["cli"]["argv"]]
                         + ["--device", "cpu"])]
        for tag, extra in (("straight", []), ("pieces", ["--max-steps", "2"]),
                           ("pieces", ["--resume",
                                       "{outdir}/pieces.npz"])):
            rc.append(_cli_quiet([path, "--device", "cpu", "--backend",
                                  "gspmd", "--mesh", "2x2", "--method", "mg",
                                  *_host_loop_argv(outdir, tag, extra)]))
        if rank == 0:
            with open(os.path.join(outdir, "cli.json"), "w") as fh:
                json.dump({"main": rc, "convection": conv_cli,
                           "free": free_cli}, fh)
            np.savez(os.path.join(outdir, "gloo.npz"), **out)
    finally:
        dist.destroy_process_group()


def _jax_one_device():
    """JAX's one-device runs of the cases, the convection and the dam
    break, step by step (each case's step compiled in a thread)."""
    from concurrent.futures import ThreadPoolExecutor

    from navierstokes_parallel_tpu import solver as js
    from navierstokes_parallel_tpu.config import Params as JaxParams
    from navierstokes_parallel_tpu.grid import allocate_state as jalloc
    from navierstokes_parallel_tpu.models import convection as jcv
    from navierstokes_parallel_tpu.models import freesurface as jfs

    def steps(fn, carry, base, prm, n=None):
        iters, conv, ts = [], [], []
        T = float(np.float32(prm.T))
        while (len(iters) < n) if n else (float(base(carry).t) < T):
            carry, diag = fn(carry)
            iters.append(int(diag.sor_iterations))
            conv.append(bool(diag.sor_converged))
            ts.append(float(base(carry).t))
        return carry, {"iterations": iters, "converged": conv, "t": ts}

    def case(tag):
        rec = CASES[tag]
        kw = {**SMALL, **rec["fields"]}
        if "obstacles" in kw:
            kw["obstacles"] = tuple(tuple(o) for o in kw["obstacles"])
        prm = JaxParams(**kw)
        if rec["time_order"] == 2:
            fn = js.make_ab2_step_fn(prm, rec["method"])
            carry, out = steps(fn, js.ab2_init(jalloc(prm)), lambda c: c.s,
                               prm)
            carry = carry.s
        else:
            fn = js.make_step_fn(prm, rec["method"])
            carry, out = steps(fn, jalloc(prm), lambda c: c, prm)
        out.update({name: np.asarray(getattr(carry, name)) for name in "uvp"})
        return out

    def thermal():
        prm, cfg = jcv.convection_setup(Ra=1e4, n=16)
        ts0 = jcv.allocate_thermal(prm, cfg)
        fn = jcv.make_thermal_step_fn(prm, cfg, "mg")
        ts, out = steps(fn, ts0, lambda c: c, prm, THERMAL_STEPS)
        out.update({name: np.asarray(getattr(ts, name)) for name in "uvpT"})
        state, info = jcv.solve_convection(prm, cfg, chunk=4, max_steps=8,
                                           pressure_method="mg")
        out["convection_T"] = np.asarray(state.T)
        out["convection_info"] = info
        cprm = JaxParams.from_file(os.path.join(ROOT, "configs",
                                                "convection.in"))
        ccfg = jcv.config_from_params(cprm)
        ts, cli_steps = steps(jcv.make_thermal_step_fn(cprm, ccfg, "mg"),
                              jcv.allocate_thermal(cprm, ccfg), lambda c: c,
                              cprm, CLI_STEPS)
        out["cli"] = cli_steps
        out["cli_centre"] = [float(x) for x in js.center_values(ts, cprm)]
        bprm, bcfg = jcv.heated_block_setup(Ra=1e4, n=16)
        ts, out["block"] = steps(jcv.make_thermal_step_fn(bprm, bcfg,
                                                          "rb_sor"),
                                 jcv.allocate_thermal(bprm, bcfg),
                                 lambda c: c, bprm, BLOCK_STEPS)
        out["block"].update({name: np.asarray(getattr(ts, name))
                             for name in "uvpT"})
        return out

    def free():
        prm, fs0 = jfs.dam_break(n=4)
        fn = jfs.make_free_step_fn(prm, "freeslip")
        end, out = steps(fn, fs0, lambda c: c.state, prm, FREE_STEPS)
        out.update({name: np.asarray(getattr(end.state, name))
                    for name in "uvp"})
        out["particles"] = np.stack([np.asarray(end.pset.x),
                                     np.asarray(end.pset.y)])
        out["active"] = np.asarray(end.pset.active)
        dprm = JaxParams.from_file(os.path.join(ROOT, "configs",
                                                "dambreak.in"))
        end, cli_steps = steps(jfs.make_free_step_fn(dprm, "freeslip"),
                               jfs.initial_free_state(dprm),
                               lambda c: c.state, dprm, CLI_STEPS)
        out["cli"] = cli_steps
        out["cli_centre"] = [float(x) for x in
                             js.center_values(end.state, dprm)]
        return out

    # fft on the real-FFT route, the port's only one (below 512^2 JAX's CPU
    # default is its dense-matrix DCT); cleared caches, so that no earlier
    # trace on the other route is reused.
    import jax
    from navierstokes_parallel_tpu.ops import fft as jfft

    prefer, jfft.PREFER_RFFT = jfft.PREFER_RFFT, True
    jax.clear_caches()
    try:
        with ThreadPoolExecutor(6) as pool:
            cases = dict(zip(CASE_TAGS, pool.map(case, CASE_TAGS)))
            th, fr = pool.submit(thermal), pool.submit(free)
            return {"cases": cases, "thermal": th.result(),
                    "free": fr.result()}
    finally:
        jfft.PREFER_RFFT = prefer


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four ranks' results and JAX's one-device runs, computed while
    the ranks run."""
    outdir = str(tmp_path_factory.mktemp("gspmd_gloo4"))
    _params({"i_max": 16, "j_max": 16, "T": 0.2}).to_file(
        os.path.join(outdir, "gspmd16.in"))
    ctx = mp.start_processes(_gloo_worker, args=(_free_port(), outdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        jax_out = _jax_one_device()
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gloo workers ran past {WORKER_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    with np.load(os.path.join(outdir, "gloo.npz")) as data:
        mesh = dict(data)
    with open(os.path.join(outdir, "cli.json")) as fh:
        clis = json.load(fh)
    return {"mesh": mesh, "jax": jax_out, "cli": clis, "outdir": outdir}


def _assert_contract(a, b, tol=CONTRACT):
    from conftest import assert_close_reference_contract

    assert_close_reference_contract(np.asarray(a, np.float64),
                                    np.asarray(b, np.float64), tol=tol)


@pytest.mark.parametrize("tag", CASE_TAGS)
def test_gspmd_counts_match_jax_one_device_and_gspmd(gloo4, tag):
    got = gloo4["mesh"]
    want = gloo4["jax"]["cases"][tag]
    for key in ("iterations", "converged"):
        assert list(got[f"{tag}/{key}"]) == list(want[key]) == \
            list(CASES[tag][key]), key
    assert int(got[f"{tag}/failures"]) == CASES[tag]["converged"].count(
        False)
    np.testing.assert_allclose(got[f"{tag}/t"], want["t"], rtol=1e-6)
    np.testing.assert_allclose(got[f"{tag}/t"], CASES[tag]["t"], rtol=1e-6)


@pytest.mark.parametrize("tag", CASE_TAGS)
def test_gspmd_fields_match_jax(gloo4, tag):
    got = gloo4["mesh"]
    for name in "uvp":
        _assert_contract(got[f"{tag}/{name}"],
                         gloo4["jax"]["cases"][tag][name])
    _assert_contract(got[f"{tag}/centre"], CASES[tag]["centre"])


def _one_device_probe():
    from navierstokes_parallel_tpu_torch import solver

    return solver.solve(_params({"i_max": 24, "j_max": 24, "T": PROBE_T}),
                        _probe_state())


def test_gspmd_cfl_seed_is_one_devices(gloo4):
    """The probe on four ranks: one device's corner seed and 3 steps, the
    corner u[0, 0] = 5 carried (the sharded stepper takes 1 step)."""
    state, stats = _one_device_probe()
    steps, t = gloo4["mesh"]["probe/steps_t"]
    assert int(steps) == stats.steps == 3
    assert t == pytest.approx(float(state.t), rel=1e-6)
    assert float(gloo4["mesh"]["probe/corner"]) == 5.0


def test_gspmd_ranks_hold_blocks(gloo4):
    """Each rank's state is its (li + 2, lj + 2) block; the 64^2 V-cycle
    smooths 34^2 and 18^2 blocks (levels 64^2 and 32^2 over 2x2) and no
    whole-grid level."""
    for tag in CASE_TAGS:
        n = CASES[tag]["fields"]["i_max"]
        li = -(-n // 2)
        assert tuple(gloo4["mesh"][f"{tag}/block"]) == (li + 2, li + 2)
    seen = {tuple(s) for s in gloo4["mesh"]["mg64/smoothed"]}
    assert (34, 34) in seen and (18, 18) in seen
    assert all(s[0] <= 34 for s in seen) and (66, 66) not in seen


def test_gspmd_mg_takes_one_devices_levels(gloo4):
    prm = _params({"i_max": MG_BLOCKS_N, "j_max": MG_BLOCKS_N})
    levels = mg.build_levels_gspmd(prm, MESH)
    assert [lvl.g_dims for lvl in levels] == [
        (lv.shape[0] - 2, lv.shape[1] - 2) for lv in mg.build_levels(prm)]
    assert [lvl.shape for lvl in levels[:-1]] == [(34, 34), (18, 18),
                                                  (10, 10)]
    # 17^2 does not divide the mesh: the whole cycle is gathered.
    assert len(mg.build_levels_gspmd(_params({"i_max": 17, "j_max": 17}),
                                     MESH)) == 1


def test_gspmd_convection_matches_jax_one_device(gloo4):
    got, want = gloo4["mesh"], gloo4["jax"]["thermal"]
    steps, sweeps, failures = got["thermal/stats"]
    assert steps == THERMAL_STEPS and failures == 0
    assert sweeps == sum(want["iterations"])
    for name in "uvpT":
        _assert_contract(got[f"thermal/{name}"], want[name])
    info = got["convection/info"]
    jinfo = want["convection_info"]
    assert info[0] == jinfo["steps"] and info[1] == jinfo["sor_failures"]
    assert info[2] == pytest.approx(jinfo["dT_rate"], rel=1e-4)
    _assert_contract(got["convection/T"], want["convection_T"])


def test_gspmd_heated_block_matches_jax_one_device(gloo4):
    got, want = gloo4["mesh"], gloo4["jax"]["thermal"]["block"]
    steps, sweeps, failures = got["block/stats"]
    assert steps == BLOCK_STEPS
    assert sweeps == sum(want["iterations"])
    assert failures == want["converged"].count(False)
    for name in "uvpT":
        _assert_contract(got[f"block/{name}"], want[name])


def test_gspmd_free_surface_matches_jax_one_device(gloo4):
    got, want = gloo4["mesh"], gloo4["jax"]["free"]
    steps, sweeps, failures = got["free/stats"]
    assert steps == FREE_STEPS and failures == 0
    assert sweeps == sum(want["iterations"])
    assert np.array_equal(got["free/active"], want["active"])
    _assert_contract(got["free/particles"], want["particles"])
    for name in "uvp":
        _assert_contract(got[f"free/{name}"], want[name])


@pytest.mark.parametrize("which", ["convection", "free"])
def test_gspmd_cli_problems_5_and_6_match_jax(gloo4, which):
    rc, out, err = gloo4["cli"][which]
    want = gloo4["jax"]["thermal" if which == "convection" else "free"]
    assert rc == 3
    stats = dict(tok.split("=") for tok in err.splitlines()[0].split()[:3])
    assert int(stats["steps"]) == CLI_STEPS
    assert int(stats["sor_iterations"]) == sum(want["cli"]["iterations"])
    assert int(stats["sor_failures"]) == want["cli"]["converged"].count(False)
    _assert_contract([float(line.split()[1]) for line in out.splitlines()],
                     want["cli_centre"])


def test_gspmd_cli_matches_jax_cli(gloo4):
    rc, out, err = gloo4["cli"]["main"][0]
    want = RECORDS["cli"]
    assert rc == want["rc"] == 0
    got = dict(tok.split("=") for tok in err.splitlines()[0].split())
    for key in ("steps", "sor_iterations", "sor_failures"):
        assert got[key] == want["stats"][key], key
    _assert_contract([float(line.split()[1]) for line in out.splitlines()],
                     [float(line.split()[1]) for line in want["stdout"]])


def test_gspmd_cli_resume_is_bit_for_bit(gloo4):
    rcs = [rc for rc, _, _ in gloo4["cli"]["main"][1:]]
    assert rcs == [0, 3, 0]
    outdir = gloo4["outdir"]
    _assert_same_protocol_files(outdir, "straight", outdir, "pieces",
                                exact=True)


# --- one rank ---------------------------------------------------------------


@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


def test_one_rank_cfl_seed_is_one_devices(one_rank):
    state, stats = _one_device_probe()
    g, gstats = gspmd.solve_gspmd(_params({"i_max": 24, "j_max": 24,
                                           "T": PROBE_T}), _probe_state(),
                                  one_rank)
    assert gstats.steps == stats.steps == 3
    assert float(g.t) == float(state.t)
    for name in "uvp":
        _assert_contract(getattr(g, name), getattr(state, name))


def test_one_rank_mg_v_cycles_are_one_devices(one_rank):
    """At 64^2 on one rank the sharded backend's levels go down to a block
    of 4 cells (one level deeper than one device's 8^2); gspmd takes one
    device's levels and its V-cycles."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.grid import allocate_state
    from navierstokes_parallel_tpu_torch.parallel import sharded

    prm = _params({"i_max": 64, "j_max": 64, "epsilon": 1e-6})
    one = solver.Stepper(prm, allocate_state(prm, "cpu"), "mg")
    want = [one.step().sor_iterations for _ in range(3)]
    g = gspmd.GspmdStepper(prm, None, one_rank, "mg")
    got = [g.step().sor_iterations for _ in range(3)]
    assert got == want
    assert torch.equal(g.state().u, one.state().u)
    assert len(sharded.mg.build_levels_sharded(prm, 64, 64)) == \
        len(mg.build_levels(prm)) + 1


def test_one_rank_fft_gathers_where_pencils_do_not_tile(one_rank):
    """A 1x1 mesh tiles any grid; fft_solves_per_outer 2 runs the pencils'
    defect loop.  Both give one device's steps."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.grid import allocate_state
    from navierstokes_parallel_tpu_torch.ops import fft

    for fields in ({"i_max": 17, "j_max": 13}, {"i_max": 16, "j_max": 16,
                                                "fft_solves_per_outer": 2}):
        prm = _params(fields)
        one = solver.Stepper(prm, allocate_state(prm, "cpu"), "fft")
        g = gspmd.GspmdStepper(prm, None, one_rank, "fft")
        for _ in range(2):
            assert g.step().sor_iterations == one.step().sor_iterations
        _assert_contract(g.state().p, one.state().p)
    assert not fft.pencils_tile(_params({"i_max": 17, "j_max": 16}), (2, 2))
    assert fft.pencils_tile(_params({"i_max": 16, "j_max": 16}), (2, 2))


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("x", "y"))


@pytest.mark.parametrize("case", ["pallas_sor", "mesh_1x4", "masked_fft"])
def test_gspmd_refusals_match_jax(case):
    """The JAX backend's ValueErrors, raised before any collective."""
    from navierstokes_parallel_tpu.config import Params as JaxParams
    from navierstokes_parallel_tpu.parallel import gspmd as jg

    fields = {**SMALL, "i_max": 16, "j_max": 16}
    method, shape = "rb_sor", MESH
    if case == "pallas_sor":
        method = "pallas_sor"
    elif case == "mesh_1x4":
        shape = (1, 4)
    else:
        method, fields["obstacles"] = "fft", ((6, 10, 6, 10),)
    mesh = topology.Mesh(shape, (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError) as got:
        gspmd.GspmdStepper(Params(**fields), None, mesh, method)
    if case == "masked_fft":
        from navierstokes_parallel_tpu.grid import allocate_state as jalloc
        from navierstokes_parallel_tpu.ops import masked as jm

        jprm = JaxParams(**fields)
        s = jalloc(jprm)
        with pytest.raises(ValueError) as want:
            jm.solve_pressure_masked(s.p, s.p, jprm, method="fft")
    else:
        with pytest.raises(ValueError) as want:
            if case == "pallas_sor":
                jg._check_method(method)
            else:
                jg._check_mesh(_jax_mesh(shape))
    assert str(got.value) == str(want.value)


def test_gspmd_isothermal_stepper_names_the_problem_modules():
    mesh = topology.Mesh(MESH, (0, 0), torch.device("cpu"), None)
    for problem, needle in ((5, "ThermalGspmdStepper"), (6, "solve_free")):
        with pytest.raises(ValueError, match=needle):
            gspmd.GspmdStepper(_params({"i_max": 8, "j_max": 8,
                                        "problem": problem}), None, mesh)


@pytest.mark.parametrize("n", range(1, 10))
def test_choose_mesh_shape_square_matches_jax(n):
    from navierstokes_parallel_tpu.parallel import topology as jt

    try:
        want = jt.choose_mesh_shape_square(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            topology.choose_mesh_shape_square(n)
        assert str(got.value) == str(e)
        return
    assert topology.choose_mesh_shape_square(n) == want
