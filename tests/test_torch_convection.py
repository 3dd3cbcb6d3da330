"""The port's natural convection (models/convection.py, problem 5) vs the
JAX package's, on the same configurations:

  * the four setups and ``config_from_params`` give equal Params and
    ThermalConfigs; ``allocate_thermal`` is bit for bit;
  * ``thermal_step`` and ``thermal_step_ab2`` for 5 steps from the
    conduction state at 12^2-16^2 (de Vahl Davis, Rayleigh-Benard with
    free-slip sidewalls, mixed convection under a lid, the heated block):
    equal iterations and convergence per step, u/v/p/T within the
    reference contract (1e-4);
  * the Nusselt numbers, the block's heat flux, the RB seed and kinetic
    energy on the same fields, within 1e-6 relative; ``solve_convection``
    and ``rb_growth_rate`` against JAX's on tiny grids;
  * the CLI on a 12^2 problem-5 file against the JAX CLI: stats and
    U/V-CENTER (by Euler, AB2 and mg), the temperature frames and final
    output within the contract, a checkpoint and resume bit for bit with
    the straight run, the refusal of an isothermal checkpoint, and of AB2
    on the sharded backend.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import convection
from navierstokes_parallel_tpu_torch.utils import checkpoint

CONTRACT = 1e-4
REL = 1e-6
STEPS = 5
# (tag, setup, keyword arguments).
SETUPS = [
    ("de_vahl_davis", "convection_setup", {"Ra": 1e4, "n": 12}),
    ("rayleigh_benard_freeslip", "rayleigh_benard_setup",
     {"Ra": 5e3, "n": 12, "aspect": 1.25, "sidewalls": "freeslip"}),
    ("mixed_lid", "mixed_convection_setup", {"Re_lid": 100.0, "Gr": 1e4,
                                             "n": 12}),
    ("heated_block", "heated_block_setup", {"Ra": 1e4, "n": 16}),
]


def _jax_params(prm):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**dataclasses.asdict(prm))


def _setups(setup, kw):
    from navierstokes_parallel_tpu.models import convection as jc

    return (getattr(convection, setup)(**kw), getattr(jc, setup)(**kw))


def _assert_contract(a, b):
    from conftest import assert_close_reference_contract

    assert_close_reference_contract(np.asarray(a, np.float64),
                                    np.asarray(b, np.float64),
                                    tol=CONTRACT)


@pytest.mark.parametrize("case", SETUPS, ids=lambda c: c[0])
def test_setups_and_allocate_thermal_match_jax(case):
    _, setup, kw = case
    (prm, cfg), (jprm, jcfg) = _setups(setup, kw)
    assert _jax_params(prm) == jprm and tuple(cfg) == tuple(jcfg)
    from navierstokes_parallel_tpu.models import convection as jc

    ts = convection.allocate_thermal(prm, cfg, "cpu")
    jts = jc.allocate_thermal(jprm, jcfg)
    for name in ("u", "v", "p", "T"):
        assert np.array_equal(getattr(ts, name).numpy(),
                              np.asarray(getattr(jts, name)))
    assert ts.n == 0 and float(ts.t) == 0.0


def test_config_from_params_matches_jax():
    from navierstokes_parallel_tpu.models import convection as jc

    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "convection.in")
    prm = Params.from_file(path)
    assert tuple(convection.config_from_params(prm)) == tuple(
        jc.config_from_params(_jax_params(prm)))
    with pytest.raises(ValueError, match="problem=5"):
        convection.config_from_params(prm.replace(problem=1))


@pytest.mark.parametrize("order", [1, 2], ids=["euler", "ab2"])
@pytest.mark.parametrize("case", SETUPS, ids=lambda c: c[0])
def test_thermal_steps_match_jax(case, order):
    import jax

    from navierstokes_parallel_tpu.models import convection as jc

    _, setup, kw = case
    (prm, cfg), (jprm, jcfg) = _setups(setup, kw)
    ts = convection.allocate_thermal(prm, cfg, "cpu")
    jts = jc.allocate_thermal(jprm, jcfg)
    if order == 1:
        carry, jcarry, fn = ts, jts, convection.thermal_step
        jfn = jax.jit(lambda s: jc.thermal_step(s, jprm, jcfg, "rb_sor"))
    else:
        carry, jcarry = convection.thermal_ab2_init(ts), jc.thermal_ab2_init(
            jts)
        fn = convection.thermal_step_ab2
        jfn = jax.jit(lambda s: jc.thermal_step_ab2(s, jprm, jcfg, "rb_sor"))
    for _ in range(STEPS):
        carry, (dt, max_dT, diag) = fn(carry, prm, cfg, "rb_sor")
        jcarry, (jdt, jmax_dT, res) = jfn(jcarry)
        assert diag.sor_iterations == int(res.iterations) > 0
        assert diag.sor_converged == bool(res.converged)
        assert float(dt) == pytest.approx(float(jdt), rel=REL)
        assert float(max_dT) == pytest.approx(float(jmax_dT), rel=1e-4,
                                              abs=1e-6)
    s = carry if order == 1 else carry.ts
    js = jcarry if order == 1 else jcarry.ts
    assert s.n == int(js.n) == STEPS
    for name in ("u", "v", "p", "T"):
        _assert_contract(getattr(s, name), getattr(js, name))


def test_observables_match_jax():
    """Nusselt numbers (all four walls), the block's heat flux, the RB seed
    and the kinetic energy on the same fields."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.models import convection as jc

    rng = np.random.default_rng(5)
    (prm, cfg), (jprm, jcfg) = _setups("heated_block_setup",
                                       {"Ra": 1e4, "n": 16})
    T = (0.3 * rng.standard_normal(prm.shape)).astype(np.float32)
    for fn in ("nusselt_hot_wall", "nusselt_cold_wall", "nusselt_bottom",
               "nusselt_top"):
        got = getattr(convection, fn)(torch.from_numpy(T), prm)
        assert got == pytest.approx(getattr(jc, fn)(jnp.asarray(T), jprm),
                                    rel=REL), fn
        assert getattr(convection, fn)(T, prm) == got  # numpy input
    assert convection.block_heat_flux(torch.from_numpy(T), prm, 0.5) == \
        pytest.approx(jc.block_heat_flux(jnp.asarray(T), jprm, 0.5),
                      rel=1e-12)
    (prm, cfg), (jprm, jcfg) = _setups(
        "rayleigh_benard_setup", {"Ra": 2000.0, "n": 8, "aspect": 1.5,
                                  "sidewalls": "freeslip"})
    ts = convection.seed_rb_perturbation(
        convection.allocate_thermal(prm, cfg, "cpu"), prm, cfg, amp=1e-2,
        mode=2)
    jts = jc.seed_rb_perturbation(jc.allocate_thermal(jprm, jcfg), jprm,
                                  jcfg, amp=1e-2, mode=2)
    np.testing.assert_allclose(ts.T.numpy(), np.asarray(jts.T), rtol=0,
                               atol=1e-7)
    u = rng.standard_normal(prm.shape).astype(np.float32)
    k = convection.kinetic_energy(ts._replace(u=torch.from_numpy(u)))
    assert float(k) == pytest.approx(float(jc.kinetic_energy(
        jts._replace(u=jnp.asarray(u)))), rel=REL)
    assert convection.DE_VAHL_DAVIS_NU == jc.DE_VAHL_DAVIS_NU
    assert convection.OUERTATANI_RB_NU == jc.OUERTATANI_RB_NU
    assert convection.RB_CRITICAL_ASPECT == pytest.approx(
        jc.RB_CRITICAL_ASPECT, rel=1e-15)


def test_solve_convection_matches_jax():
    from navierstokes_parallel_tpu.models import convection as jc

    kw = {"Ra": 1e3, "n": 8}
    (prm, cfg), (jprm, jcfg) = _setups("convection_setup", kw)
    state, info = convection.solve_convection(prm, cfg, chunk=4,
                                              max_steps=8, device="cpu",
                                              pressure_method="rb_sor")
    jstate, jinfo = jc.solve_convection(jprm, jcfg, chunk=4, max_steps=8,
                                        pressure_method="rb_sor")
    assert info["steps"] == jinfo["steps"] == 8 and state.n == 8
    assert info["sor_failures"] == jinfo["sor_failures"] == 0
    assert info["steady"] is bool(jinfo["steady"]) is False
    assert info["dT_rate"] == pytest.approx(jinfo["dT_rate"], rel=1e-4)
    _assert_contract(state.T, jstate.T)
    # On a mesh the steps are the gspmd backend's, which refuses a mesh of
    # more than one device with a trivial axis before any collective, as
    # the JAX package's does (tests/test_torch_gspmd.py runs it).
    from navierstokes_parallel_tpu_torch.parallel import topology

    with pytest.raises(ValueError, match="rejects the 1x4 mesh"):
        convection.solve_convection(prm, cfg, mesh=topology.Mesh(
            (1, 4), (0, 0), torch.device("cpu"), None))


def test_thermal_solve_and_rb_growth_rate_match_jax():
    from navierstokes_parallel_tpu.models import convection as jc

    (prm, cfg), (jprm, jcfg) = _setups("convection_setup",
                                       {"Ra": 1e4, "n": 8})
    prm, jprm = prm.replace(T=0.5), jprm.replace(T=0.5)
    for order in (1, 2):
        fn = convection.thermal_solve if order == 1 else \
            convection.thermal_solve_ab2
        jfn = jc.thermal_solve if order == 1 else jc.thermal_solve_ab2
        state, stats = fn(prm, cfg, device="cpu", pressure_method="rb_sor")
        jstate, jstats = jfn(jprm, jcfg, pressure_method="rb_sor")
        assert (stats.steps, stats.total_sor_iterations,
                stats.sor_failures) == (int(jstats.steps),
                                        int(jstats.total_sor_iterations),
                                        int(jstats.sor_failures))
        _assert_contract(state.T, jstate.T)
    kw = dict(n=8, t_transient=0.4, t_measure=0.4, chunk=10,
              pressure_method="rb_sor")
    got = convection.rb_growth_rate(1800.0, device="cpu", **kw)
    want = jc.rb_growth_rate(1800.0, **kw)
    assert got["t1"] == pytest.approx(want["t1"], rel=REL)
    assert got["sigma"] == pytest.approx(want["sigma"], rel=1e-3, abs=1e-4)


def test_solver_step_refuses_problem_5_as_jax():
    """solver.step is isothermal: on problem 5 it raises the JAX step's
    ValueError (its boundary.lid_velocity refuses the problem)."""
    from navierstokes_parallel_tpu import solver as jsolver
    from navierstokes_parallel_tpu.grid import allocate_state as jallocate

    prm = Params(problem=5, i_max=8, j_max=8, Ra=1e4)
    with pytest.raises(ValueError) as got:
        solver.step(solver.allocate_state(prm, "cpu"), prm)
    with pytest.raises(ValueError) as want:
        jsolver.step(jallocate(_jax_params(prm)), _jax_params(prm))
    assert str(got.value) == str(want.value) == "unknown problem type 5"


# --- the CLI --------------------------------------------------------------------

def _config(tmp_path, n=12, T=0.5):
    """configs/convection.in at n^2 and end time T."""
    src = os.path.join(os.path.dirname(__file__), "..", "configs",
                       "convection.in")
    lines = open(src).read().splitlines()
    lines[2], lines[3], lines[6] = str(n), str(n), str(T)
    path = tmp_path / "conv.in"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _stats(err):
    return next(line for line in err.splitlines()
                if line.startswith("steps=")).split()[:3]


@pytest.mark.parametrize("argv", [[], ["--time-order", "2"],
                                  ["--method", "mg"]],
                         ids=["euler", "ab2", "mg"])
def test_cli_matches_jax_cli(tmp_path, capsys, argv):
    """Stats and centre values, and the frames (temp included) and the
    final output within the contract."""
    from navierstokes_parallel_tpu import cli as jcli
    from navierstokes_parallel_tpu.utils import io as jio

    path = _config(tmp_path)
    files = ["--stats", "--output-dir", "{d}/frames",
             "--final-output-prefix", "{d}/final"]

    def argv_in(d):
        return [a.format(d=d) for a in files] + argv

    rc, out, err = _run(cli.main, [path, "--device", "cpu",
                                   *argv_in(tmp_path / "port")], capsys)
    jrc, jout, jerr = _run(jcli.main, [path, *argv_in(tmp_path / "jax")],
                           capsys)
    assert rc == jrc == 0
    assert _stats(err) == _stats(jerr)
    assert int(_stats(err)[0].split("=")[1]) > 2
    centre = [line for line in out.splitlines() if "CENTER" in line]
    jcentre = [line for line in jout.splitlines() if "CENTER" in line]
    _assert_contract([float(x.split()[1]) for x in centre],
                     [float(x.split()[1]) for x in jcentre])
    frames = sorted(os.listdir(tmp_path / "port" / "frames"))
    assert frames == sorted(os.listdir(tmp_path / "jax" / "frames"))
    assert "0_temp.txt" in frames and len(frames) % 4 == 0
    pairs = [(tmp_path / "port" / "frames" / f, tmp_path / "jax" / "frames"
              / f) for f in frames]
    pairs += [(tmp_path / "port" / f"final_{s}.txt",
               tmp_path / "jax" / f"final_{s}.txt")
              for s in ("u", "v", "p", "temp")]
    for a, b in pairs:
        assert jio.compare_outputs_with_tolerance(str(a), str(b)), a


def test_cli_checkpoint_resume_bit_for_bit(tmp_path, capsys):
    """A run stopped after 3 steps and resumed from its checkpoint ends
    with the straight run's state bit for bit, temperature included; the
    checkpoint carries T under the JAX package's key."""
    from navierstokes_parallel_tpu.models import convection as jc
    from navierstokes_parallel_tpu.utils import checkpoint as jck

    path = _config(tmp_path)
    prm = Params.from_file(path)

    def run(*extra):
        return _run(cli.main, [path, "--device", "cpu", "--stats", *extra],
                    capsys)

    assert run("--checkpoint-every", "1", "--checkpoint-path",
               str(tmp_path / "straight.npz"))[0] == 0
    assert run("--max-steps", "3", "--checkpoint-every", "3",
               "--checkpoint-path", str(tmp_path / "piece.npz"))[0] == 3
    rc, _, err = run("--resume", str(tmp_path / "piece.npz"),
                     "--checkpoint-every", "1", "--checkpoint-path",
                     str(tmp_path / "resumed.npz"))
    assert rc == 0
    with np.load(tmp_path / "straight.npz") as a, \
            np.load(tmp_path / "resumed.npz") as b:
        assert sorted(a.files) == sorted(b.files) == \
            ["T", "n", "p", "t", "u", "v"]
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    # Either package reads the other's thermal checkpoint.
    mine = checkpoint.load_checkpoint(str(tmp_path / "piece.npz"), prm,
                                      "cpu")
    theirs = jck.load_checkpoint(str(tmp_path / "piece.npz"),
                                 _jax_params(prm))
    assert isinstance(mine, convection.ThermalState)
    assert isinstance(theirs, jc.ThermalState) and mine.n == 3
    assert np.array_equal(mine.T.numpy(), np.asarray(theirs.T))


def test_cli_refuses_isothermal_checkpoint_and_sharded_ab2(tmp_path, capsys):
    path = _config(tmp_path)
    iso = tmp_path / "iso.npz"
    z = np.zeros((14, 14), np.float32)
    np.savez(iso, u=z, v=z, p=z, t=np.float32(0.0), n=np.int32(0))
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--resume",
                                   str(iso)], capsys)
    assert rc == 1 and out == "" and "no temperature field" in err
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--backend",
                                   "sharded", "--time-order", "2"], capsys)
    assert rc == 1 and out == "" and "runs single-chip" in err
    # Euler on the sharded backend runs (parallel/sharded_thermal.py): one
    # rank gives the single-device CLI's stats and centre values.
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--backend",
                                   "sharded", "--stats"], capsys)
    src, sout, serr = _run(cli.main, [path, "--device", "cpu", "--stats"],
                           capsys)
    assert rc == src == 0 and out == sout
    assert _stats(err) == _stats(serr)


@pytest.mark.parametrize("fn", ["thermal_solve", "thermal_solve_ab2",
                                "solve_convection", "rb_growth_rate"])
def test_entry_points_need_state_or_device(fn):
    # No entry point picks a device for the caller: without a state or a
    # device each raises instead of running on the CPU.
    prm, cfg = convection.convection_setup(1e3, n=8)
    args = (1800.0,) if fn == "rb_growth_rate" else (prm, cfg)
    with pytest.raises(ValueError, match="needs a"):
        getattr(convection, fn)(*args)
