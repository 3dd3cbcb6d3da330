"""The port's sharded natural convection (parallel/sharded_thermal.py) vs the
JAX package's sharded thermal backend and the single-device thermal solve.

  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback steps THERMAL_CASES to their end time with
    ``ThermalShardedStepper`` on 2x2 and 1x4 meshes: de Vahl Davis by
    rb_sor, mg and fft, Rayleigh-Benard with free-slip sidewalls from a
    seeded mode, ``gamma_fixed``, and two ragged grids (17 x 14 on 2x2,
    13 x 18 on 1x4).  Against JAX's ``ThermalShardedStepper`` on the same
    mesh shapes (8 virtual CPU devices) and the port's single-device
    ``thermal_solve``: equal steps, per-step iterations and convergence;
    u, v, p and T within the reference contract (1e-4), the ghost ring
    included.
  * One rank: configs/convection.in through the CLI's ``--backend sharded
    --mesh 1x1`` by rb_sor and mg, the JAX CLI's record
    (tests/jax_sharded_thermal_records.json) step by step; the refusals
    of obstacles and of unknown sidewall and heating modes, with JAX's
    messages.

The spawned workers import this module, which imports no jax at its top.
"""

import dataclasses
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
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import convection
from navierstokes_parallel_tpu_torch.parallel import sharded_thermal, topology
from navierstokes_parallel_tpu_torch.utils import distributed
from test_torch_sharded import _assert_contract, _free_port, _jax_mesh

WORLD = 4
WORKER_TIMEOUT_S = 240
HERE = os.path.dirname(os.path.abspath(__file__))
RECORDS = os.path.join(HERE, "jax_sharded_thermal_records.json")
CLI_STEPS = 30
BASE = dict(problem=5, i_max=16, j_max=16, T=0.3, Ra=5000.0, Pr=0.71,
            tau=0.5, epsilon=1e-6, max_it=5000)

# (tag, Params fields or None for the Rayleigh-Benard setup, mesh, method).
THERMAL_CASES = [
    ("dvd_rb_sor_2x2", BASE, (2, 2), "rb_sor"),
    ("dvd_mg_2x2", BASE, (2, 2), "mg"),
    ("dvd_mg_1x4", dict(BASE, j_max=32), (1, 4), "mg"),
    ("dvd_fft_2x2", BASE, (2, 2), "fft"),
    ("dvd_fft_1x4", dict(BASE, j_max=32), (1, 4), "fft"),
    ("rb_freeslip_1x4", None, (1, 4), "rb_sor"),
    ("gamma_fixed_2x2", dict(BASE, T=0.08, gamma_fixed=0.4), (2, 2),
     "rb_sor"),
    ("ragged_17x14_2x2", dict(BASE, i_max=17, j_max=14, T=0.12, Ra=4000.0),
     (2, 2), "rb_sor"),
    ("ragged_13x18_1x4", dict(BASE, i_max=13, j_max=18, T=0.12, Ra=4000.0),
     (1, 4), "pallas_sor"),
]


def _setup(fields):
    """(Params, ThermalConfig, initial ThermalState on the CPU) of a case:
    the conduction state, or Rayleigh-Benard at Ra = 3000 with free-slip
    sidewalls from its seeded single-roll mode (JAX's test)."""
    if fields is None:
        prm, cfg = convection.rayleigh_benard_setup(
            Ra=3000.0, n=16, sidewalls="freeslip", aspect=1.0)
        prm = prm.replace(T=0.5)
        ts = convection.seed_rb_perturbation(
            convection.allocate_thermal(prm, cfg, "cpu"), prm, cfg, amp=1e-3)
        return prm, cfg, ts
    prm = Params(**fields)
    cfg = convection.config_from_params(prm)
    return prm, cfg, convection.allocate_thermal(prm, cfg, "cpu")


def _run(stepper):
    """Step to the end time (in f32, the states' dtype): (per-step
    iterations, per-step convergence)."""
    T = float(np.float32(stepper.params.T))
    iters, conv = [], []
    while stepper.t < T:
        diag = stepper.step()
        iters.append(int(diag.sor_iterations))
        conv.append(bool(diag.sor_converged))
    return iters, conv


def _gloo_worker(rank, port, outdir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for tag, fields, shape, method in THERMAL_CASES:
            prm, cfg, ts0 = _setup(fields)
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            stepper = sharded_thermal.ThermalShardedStepper(
                prm, cfg, ts0, mesh, method)
            iters, conv = _run(stepper)
            state = stepper.state()
            for name in ("u", "v", "p", "T"):
                out[f"{tag}_{name}"] = getattr(state, name).numpy()
                out[f"{tag}_{name}0"] = getattr(ts0, name).numpy()
            out[f"{tag}_iters"] = np.asarray(iters)
            out[f"{tag}_conv"] = np.asarray(conv)
        if rank == 0:
            np.savez(os.path.join(outdir, "gloo.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four-rank run's results (rank 0's npz)."""
    outdir = str(tmp_path_factory.mktemp("gloo4_thermal"))
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
        return dict(data)


def _jax_thermal(prm, cfg, arrays):
    """JAX's (Params, ThermalConfig, ThermalState) of the same case, its
    state from the port's initial arrays."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.config import Params as JaxParams
    from navierstokes_parallel_tpu.models import convection as jc

    jprm = JaxParams(**dataclasses.asdict(prm))
    state = jc.ThermalState(*(jnp.asarray(arrays[k], jnp.float32)
                              for k in "uvpT"),
                            t=jnp.asarray(0.0, jnp.float32),
                            n=jnp.asarray(0, jnp.int32))
    return jprm, jc.ThermalConfig(**cfg._asdict()), state


@pytest.mark.parametrize("case", THERMAL_CASES, ids=lambda c: c[0])
def test_gloo_sharded_thermal_matches_jax_and_single_device(gloo4, case):
    """Every step of a four-rank run against JAX's sharded thermal stepper
    on the same mesh shape and the port's single-device solve from the
    same state: equal iterations and convergence per step, u/v/p/T within
    the contract, ghost ring included."""
    from navierstokes_parallel_tpu.parallel import sharded_thermal as jsht

    tag, fields, shape, method = case
    prm, cfg, _ = _setup(fields)
    arrays = {k: gloo4[f"{tag}_{k}0"] for k in "uvpT"}
    jprm, jcfg, jts0 = _jax_thermal(prm, cfg, arrays)
    jstepper = jsht.ThermalShardedStepper(jprm, jcfg, jts0, _jax_mesh(shape),
                                          pressure_method=method)
    jiters, jconv = _run(jstepper)
    jstate = jstepper.state()
    assert list(gloo4[f"{tag}_iters"]) == jiters
    assert list(gloo4[f"{tag}_conv"]) == jconv and all(jconv)
    ts0 = convection.thermal_state_from_numpy(*(arrays[k] for k in "uvpT"),
                                              device="cpu")
    single, stats = convection.thermal_solve(prm, cfg, ts0,
                                             pressure_method=method)
    assert stats.steps == len(jiters) and stats.sor_failures == 0
    for name in ("u", "v", "p", "T"):
        got = gloo4[f"{tag}_{name}"]
        _assert_contract(got, np.asarray(getattr(jstate, name)))
        _assert_contract(got, getattr(single, name))


# --- one rank -------------------------------------------------------------------

@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_cli_sharded_convection_matches_jax_record(method, capsys):
    """configs/convection.in --backend sharded --mesh 1x1 for CLI_STEPS
    steps: the stats line's counts are the sum of the JAX sharded record's
    first CLI_STEPS steps (tests/jax_records.py sharded-thermal)."""
    with open(RECORDS) as fh:
        rec = json.load(fh)["sharded_thermal"][method]
    argv = [os.path.join(HERE, "..", "configs", "convection.in"),
            "--device", "cpu", "--backend", "sharded", "--mesh", "1x1",
            "--method", method, "--max-steps", str(CLI_STEPS), "--stats"]
    assert cli.main(argv) == 3
    out, err = capsys.readouterr()
    stats = dict(tok.split("=") for tok in err.splitlines()[0].split())
    assert int(stats["steps"]) == CLI_STEPS
    assert int(stats["sor_iterations"]) == sum(rec["iterations"][:CLI_STEPS])
    assert int(stats["sor_failures"]) == 0
    assert len(out.splitlines()) == 2
    assert rec["stats"]["steps"] == str(len(rec["iterations"]))


def test_one_rank_stepper_equals_single_device(one_rank):
    """On one rank the sharded thermal step by rb_sor is the single-device
    ``thermal_step`` bit for bit (the deep-halo inner on a 1x1 mesh is the
    whole-grid sweeps), and ``solve_sharded_thermal`` gives its stats."""
    prm, cfg, ts0 = _setup(dict(BASE, T=0.1))
    state, stats = sharded_thermal.solve_sharded_thermal(
        prm, cfg, ts0, one_rank, pressure_method="rb_sor")
    single, sstats = convection.thermal_solve(prm, cfg, ts0,
                                              pressure_method="rb_sor")
    assert (stats.steps, stats.total_sor_iterations) == \
        (sstats.steps, sstats.total_sor_iterations)
    for name in ("u", "v", "p", "T"):
        assert torch.equal(getattr(state, name), getattr(single, name)), name


@pytest.mark.parametrize("case", ["obstacles", "sidewalls", "heating"])
def test_check_thermal_refuses_as_jax(case):
    """The JAX backend's ValueErrors, up to its remedy for obstacles (the
    port has no gspmd backend: it names the single device)."""
    from navierstokes_parallel_tpu.parallel import sharded_thermal as jsht

    prm, cfg, _ = _setup(BASE)
    if case == "obstacles":
        prm = prm.replace(obstacles=((6, 10, 6, 10),))
    elif case == "sidewalls":
        cfg = cfg._replace(sidewalls="periodic")
    else:
        cfg = cfg._replace(heating="above")
    mesh = topology.Mesh((2, 2), (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError) as got:
        sharded_thermal._check_thermal(prm, cfg, mesh, "rb_sor")
    jprm, jcfg, _ = _jax_thermal(prm, cfg, {k: np.zeros(prm.shape)
                                            for k in "uvpT"})
    with pytest.raises(ValueError) as want:
        jsht._check_thermal(jprm, jcfg, _jax_mesh((2, 2)), "rb_sor")
    assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
    if case == "obstacles":
        assert "single device" in str(got.value)
