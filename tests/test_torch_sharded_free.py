"""The port's sharded free surfaces (parallel/sharded_free.py) vs the JAX
package's and the single-device solve.

  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback runs FREE_CASES with the partitioned sweeps: the dam break at
    n = 15 (75 x 45, ragged on both meshes: 2x2 pads it to 76 x 46, 1x4 to
    75 x 48) to T = 0.25, the free-slip sloshing wave on an 18^2 box over
    1x4 (ragged) step by step, and the half-blocked wide dam break on 2x2;
    and configs/dambreak.in through the CLI on 2x2 (--max-steps, the
    final output).  Against JAX's ``solve_free_sharded`` /
    ``make_free_step_sharded`` on the same mesh shapes (8 virtual CPU
    devices): equal steps, sweeps and failures, u/v/p and the particles
    within 1e-4, the ``active`` masks equal, the fluid volume within 1e-12
    relative; against the port's single-device runs: bit for bit (the
    windows' cores are the whole-grid sweeps exactly); the obstacle case
    equals its narrow twin on the common cells (JAX's test).
  * One rank: ``solve_free_sharded`` on a 1x1 mesh is ``solve_free`` bit
    for bit, and the CLI's ``--backend sharded --mesh 1x1`` on a cut
    configs/dambreak.in gives the JAX whole-run record's sweeps.

The spawned workers import this module, which imports no jax at its top.
"""

import datetime
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu_torch import cli
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.models import freesurface as FS
from navierstokes_parallel_tpu_torch.parallel import sharded_free, topology
from navierstokes_parallel_tpu_torch.utils import distributed
from test_torch_sharded import _free_port, _jax_mesh

WORLD = 4
WORKER_TIMEOUT_S = 240
CONTRACT = 1e-4
HERE = os.path.dirname(os.path.abspath(__file__))
DAMBREAK = os.path.join(HERE, "..", "configs", "dambreak.in")
RECORDS = os.path.join(HERE, "jax_free_records.json")
CLI_STEPS = 3
# (tag, setup, keyword arguments, wall, mesh, steps: 0 = to T).
FREE_CASES = [
    ("dam_break_2x2", "dam_break", dict(n=15, T=0.25), "noslip", (2, 2), 0),
    ("dam_break_1x4", "dam_break", dict(n=15, T=0.25), "freeslip", (1, 4),
     0),
    ("sloshing_1x4", "sloshing", dict(n=18, T=1.0), "freeslip", (1, 4), 3),
]


class _StepFn:
    """A stepper over a ``step(fs) -> (fs, diag)`` function (the sloshing
    case steps ``make_free_step_sharded``'s, as JAX's test steps its)."""

    def __init__(self, step, fs):
        self._step, self._fs = step, fs

    @property
    def t(self):
        return float(self._fs.state.t)

    def step(self):
        self._fs, diag = self._step(self._fs)
        return diag

    def free_state(self):
        return self._fs


def _setup(name, kw):
    return getattr(FS, name)(**kw, device="cpu")


def _wide(n=8, T=0.4):
    """The wide dam break with its right fifth blocked (JAX's obstacle
    composition test) and its narrow twin."""
    pw, _ = FS.dam_break(n=n, a=5.0, b=3.0, T=T, device="cpu")
    pw = pw.replace(obstacles=((4 * n + 1, 5 * n, 1, 3 * n),))
    fw = FS.FreeSurfaceState(allocate_state(pw, "cpu"),
                             FS.fill_region(pw, 0.0, 1.0, 0.0, 2.0,
                                            device="cpu"))
    pn, fn = FS.dam_break(n=n, a=4.0, b=3.0, T=T, device="cpu")
    return pw, fw, pn, fn


def _stepped(stepper, prm, steps):
    """(per-step iterations, per-step dt) to T, or `steps` steps."""
    T = float(torch.tensor(prm.T, dtype=prm.torch_dtype))
    iters, dts = [], []
    while (len(iters) < steps if steps else stepper.t < T):
        diag = stepper.step()
        iters.append(int(diag.sor_iterations))
        dts.append(float(diag.dt))
    return iters, dts


def _save(out, tag, fs):
    for name in ("u", "v", "p"):
        out[f"{tag}_{name}"] = getattr(fs.state, name).numpy()
    for name in ("x", "y", "active"):
        out[f"{tag}_{name}"] = getattr(fs.pset, name).numpy()


def _gloo_worker(rank, port, outdir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for tag, name, kw, wall, shape, steps in FREE_CASES:
            prm, fs = _setup(name, kw)
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            if steps:
                stepper = _StepFn(sharded_free.make_free_step_sharded(
                    prm, mesh, wall=wall), fs)
            else:
                stepper = sharded_free.make_free_stepper(prm, fs, mesh,
                                                         wall=wall)
            iters, dts = _stepped(stepper, prm, steps)
            _save(out, tag, stepper.free_state())
            out[f"{tag}_iters"] = np.asarray(iters)
            out[f"{tag}_dts"] = np.asarray(dts)
        pw, fw, _, _ = _wide()
        fw, stats = sharded_free.solve_free_sharded(
            pw, fw, topology.make_grid_mesh(shape=(2, 2), device="cpu"))
        _save(out, "wide_2x2", fw)
        out["wide_2x2_stats"] = np.asarray(stats[:3])
        # The CLI on four ranks: only rank 0 writes the final output.
        out["cli_rc"] = np.asarray(cli.main([
            DAMBREAK, "--device", "cpu", "--backend", "sharded", "--mesh",
            "2x2", "--free-wall", "freeslip", "--max-steps", str(CLI_STEPS),
            "--final-output-prefix", os.path.join(outdir, "sharded")]))
        if rank == 0:
            np.savez(os.path.join(outdir, "gloo.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four-rank run's results (rank 0's npz) and its directory."""
    outdir = str(tmp_path_factory.mktemp("gloo4_free"))
    ctx = mp.start_processes(_gloo_worker, args=(_free_port(), outdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
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
        out = dict(data)
    out["outdir"] = outdir
    return out


def _assert_same(gloo4, tag, fs, tol):
    """The saved run `tag` against a FreeSurfaceState (port or JAX): equal
    active masks, fields and positions within `tol` (0: bit for bit)."""
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(gloo4[f"{tag}_{name}"],
                                   np.asarray(getattr(fs.state, name)),
                                   rtol=0, atol=tol, err_msg=name)
    for name in ("x", "y"):
        np.testing.assert_allclose(gloo4[f"{tag}_{name}"],
                                   np.asarray(getattr(fs.pset, name)),
                                   rtol=0, atol=tol, err_msg=name)
    np.testing.assert_array_equal(gloo4[f"{tag}_active"],
                                  np.asarray(fs.pset.active))


@pytest.mark.parametrize("case", FREE_CASES, ids=lambda c: c[0])
def test_gloo_sharded_free_matches_jax_and_single_device(gloo4, case):
    from navierstokes_parallel_tpu.models import freesurface as JF
    from navierstokes_parallel_tpu.parallel import sharded_free as JSF

    tag, name, kw, wall, shape, steps = case
    prm, fs = _setup(name, kw)
    single = FS.FreeStepper(prm, fs, wall=wall)
    iters, dts = _stepped(single, prm, steps)
    assert list(gloo4[f"{tag}_iters"]) == iters and len(iters) > 2
    assert list(gloo4[f"{tag}_dts"]) == dts
    _assert_same(gloo4, tag, single.free_state(), 0.0)
    jprm, jfs = getattr(JF, name)(**kw)
    jstep = JSF.make_free_step_sharded(jprm, _jax_mesh(shape), wall=wall)
    jiters = []
    T = float(np.float64(jprm.T))
    while (len(jiters) < steps if steps else float(jfs.state.t) < T):
        jfs, jdiag = jstep(jfs)
        jiters.append(int(jdiag.sor_iterations))
    assert jiters == iters
    _assert_same(gloo4, tag, jfs, CONTRACT)
    got = FS.fluid_volume(single.free_state(), prm)
    want = JF.fluid_volume(jfs, jprm)
    assert abs(got - want) <= 1e-12 * want


def test_gloo_obstacle_composition(gloo4):
    """The half-blocked wide dam break with partitioned sweeps equals its
    narrow twin on the common cells (JAX's test), and JAX's sharded run of
    it with equal counts."""
    from navierstokes_parallel_tpu.grid import allocate_state as jallocate
    from navierstokes_parallel_tpu.models import freesurface as JF
    from navierstokes_parallel_tpu.parallel import sharded_free as JSF

    n = 8
    pw, _, pn, fn = _wide(n)
    outn, _ = FS.solve_free(pn, fn)
    ue = 4 * n + 1
    np.testing.assert_allclose(gloo4["wide_2x2_u"][:ue], outn.state.u[:ue],
                               rtol=0, atol=1e-9)
    jprm = JF.dam_break(n=n, a=5.0, b=3.0, T=0.4)[0].replace(
        obstacles=pw.obstacles)
    jfw = JF.FreeSurfaceState(jallocate(jprm),
                              JF.fill_region(jprm, 0.0, 1.0, 0.0, 2.0))
    jout, jstats = JSF.solve_free_sharded(jprm, jfw, _jax_mesh((2, 2)))
    assert list(gloo4["wide_2x2_stats"]) == [int(jstats.steps),
                                             int(jstats.total_sor_iterations),
                                             int(jstats.sor_failures)]
    _assert_same(gloo4, "wide_2x2", jout, CONTRACT)


def test_gloo_cli_matches_single_device_cli(gloo4, tmp_path, capsys):
    """configs/dambreak.in --backend sharded --mesh 2x2 on four ranks:
    every rank exits 3, and rank 0's final output is the single-device
    CLI's byte for byte."""
    assert int(gloo4["cli_rc"]) == 3
    rc = cli.main([DAMBREAK, "--device", "cpu", "--free-wall", "freeslip",
                   "--max-steps", str(CLI_STEPS), "--final-output-prefix",
                   str(tmp_path / "single")])
    capsys.readouterr()
    assert rc == 3
    for s in "uvp":
        with open(os.path.join(gloo4["outdir"], f"sharded_{s}.txt"),
                  "rb") as a, open(tmp_path / f"single_{s}.txt", "rb") as b:
            assert a.read() == b.read(), s


# --- one rank -------------------------------------------------------------------

@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


def test_one_rank_equals_solve_free(one_rank):
    prm, fs = FS.dam_break(n=8, T=0.3, width=1.0, height=1.5, a=2.0, b=2.0,
                           device="cpu")
    out, stats = sharded_free.solve_free_sharded(prm, fs, one_rank)
    ref, rstats = FS.solve_free(prm, fs)
    assert stats == rstats and stats.steps > 1
    for a, b in zip((*out.state[:3], *out.pset), (*ref.state[:3],
                                                  *ref.pset)):
        assert torch.equal(a, b)


def test_one_rank_cli_matches_jax_record(capsys):
    """configs/dambreak.in --backend sharded --mesh 1x1 --max-steps
    CLI_STEPS: the stats are the JAX whole-run record's first steps."""
    with open(RECORDS) as fh:
        rec = json.load(fh)["free"]
    rc = cli.main([DAMBREAK, "--device", "cpu", "--backend", "sharded",
                   "--mesh", "1x1", "--free-wall", "freeslip",
                   "--max-steps", str(CLI_STEPS), "--stats"])
    out, err = capsys.readouterr()
    assert rc == 3
    stats = dict(tok.split("=") for tok in err.splitlines()[0].split())
    assert int(stats["steps"]) == CLI_STEPS
    assert int(stats["sor_iterations"]) == sum(
        rec["per_step"]["iterations"][:CLI_STEPS])
    assert int(stats["sor_failures"]) == 0
    assert out.splitlines() == rec["cut_cli"]["stdout"]
