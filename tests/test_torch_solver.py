"""The port's main path end to end vs the JAX package: step, solve and the
CLI on small cavities, f32 state, K = 64.

Fields are held to the reference contract (1e-4); steps, SOR iteration
totals and max_it hits must be equal.  The configurations were chosen so
that no refinement check lands near the stopping threshold, where a
rounding difference could move a count by one K-quantum.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.grid import state_from_arrays
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import (allocate_state, interior,
                                                  state_from_numpy)
from navierstokes_parallel_tpu_torch.utils import checks, timing

from conftest import assert_close_reference_contract

CASES = {
    # name: JAX Params fields
    "16x16": dict(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5),
    "32x24": dict(i_max=32, j_max=24, T=0.05, Re=100.0, tau=0.5),
    "lid2": dict(problem=2, f=3.0, i_max=20, j_max=12, T=0.1, Re=50.0,
                 tau=0.5),
    "max_it": dict(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5, max_it=100),
}


def _params(name):
    ref = JaxParams(dtype="float32", epsilon=1e-4, omega=1.7,
                    sor_refine_every=64, **{"max_it": 2000, **CASES[name]})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _assert_states_close(got, want):
    for name in ("u", "v", "p"):
        assert_close_reference_contract(getattr(got, name).numpy(),
                                        np.asarray(getattr(want, name)))
    assert float(got.t) == float(want.t)


@pytest.mark.parametrize("method", ["pallas_sor", "rb_sor"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_matches_jax(name, method):
    prm, ref = _params(name)
    state, stats = solver.solve(prm, device="cpu",
                                pressure_method="pallas_sor")
    jstate, jstats = jsolver.solve(ref, pressure_method=method)
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(jstats.steps), int(jstats.total_sor_iterations),
        int(jstats.sor_failures))
    assert stats.steps == state.n > 1
    assert (stats.sor_failures > 0) == (name == "max_it")
    _assert_states_close(state, jstate)
    uc, vc = solver.center_values(state, prm)
    juc, jvc = jsolver.center_values(jstate, ref)
    assert_close_reference_contract([uc, vc], [juc, jvc])


def test_step_from_a_jax_state():
    """One step from the same mid-run state in both packages."""
    prm, ref = _params("32x24")
    jstate, _ = jsolver.solve(ref.replace(T=0.02), pressure_method="pallas_sor")
    state = state_from_numpy(*(np.asarray(x) for x in jstate[:3]),
                             t=np.asarray(jstate.t), n=int(jstate.n),
                             device="cpu")
    before = [x.clone() for x in state[:3]]
    new, diag = solver.step(state, prm, pressure_method="pallas_sor")
    for x, y in zip(state[:3], before):  # the input state is not modified
        assert torch.equal(x, y)
    jnew, jdiag = jsolver.step(jstate, ref, pressure_method="pallas_sor")
    _assert_states_close(new, jnew)
    assert new.n == int(jnew.n)
    assert float(diag.dt) == float(jdiag.dt)
    assert diag.sor_iterations == int(jdiag.sor_iterations)
    assert diag.sor_converged == bool(jdiag.sor_converged)


def test_grid_helpers():
    prm, _ = _params("16x16")
    state = allocate_state(prm, "cpu")
    assert state.u.shape == prm.shape and state.u.dtype == torch.float32
    assert state.t.shape == () and state.n == 0
    assert interior(state.p).shape == (16, 16)
    assert allocate_state(prm.replace(dtype="float64"),
                          "cpu").p.dtype == torch.float64
    ref = state_from_arrays(np.ones(prm.shape), np.zeros(prm.shape),
                            np.zeros(prm.shape), t=0.5, n=3)
    got = state_from_numpy(*(np.asarray(x) for x in ref[:3]), t=0.5, n=3,
                           device="cpu")
    assert torch.equal(got.u, torch.ones(prm.shape)) and got.n == 3


def test_solve_needs_state_or_device():
    prm, _ = _params("16x16")
    with pytest.raises(ValueError):
        solver.solve(prm)


def test_unported_problem_raises():
    # Problem 5 steps with models/convection.py and problem 6 with
    # models/freesurface.py; solver.step raises the JAX step's ValueError
    # for both.
    prm, _ = _params("16x16")
    state = allocate_state(prm, "cpu")
    with pytest.raises(ValueError, match="unknown problem type 5"):
        solver.step(state, prm.replace(problem=5))
    with pytest.raises(ValueError, match="unknown problem type 6"):
        solver.step(state, prm.replace(problem=6))


def test_validate_state_and_timing():
    prm, _ = _params("16x16")
    state = allocate_state(prm, "cpu")
    assert checks.validate_state(state) is state
    state.p[3, 4] = float("nan")
    with pytest.raises(checks.NonFiniteStateError, match="p"):
        checks.validate_state(state, where="here")
    state.u[:] = 2.0
    assert timing.device_fence(state) == 2.0
    assert timing.mlups(1000, 10, 10, 0.5) == pytest.approx(0.2)
    assert timing.mlups(1, 1, 1, 0.0) == float("inf")


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


@pytest.mark.parametrize("name", ["16x16", "max_it"])
def test_cli_matches_jax_cli(name, tmp_path, capsys):
    _, ref = _params(name)
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    rc, out, err = _run_cli(cli.main, [path, "--device", "cpu", "--stats"],
                            capsys)
    jrc, jout, jerr = _run_cli(jcli.main, [path, "--stats"], capsys)
    assert rc == jrc == 0
    assert [line.split(":")[0] for line in out] == ["U-CENTER", "V-CENTER"]
    assert [line.split(":")[0] for line in jout] == ["U-CENTER", "V-CENTER"]
    got = [float(line.split()[1]) for line in out]
    want = [float(line.split()[1]) for line in jout]
    assert_close_reference_contract(got, want)
    # stderr: stats line, empty line, then the solve seconds (no newline).
    assert len(err) == len(jerr) == 3 and err[1] == jerr[1] == ""
    float(err[2])
    stats = err[0].split()
    jstats = jerr[0].split()
    # steps, sor_iterations, sor_failures agree; last_res_norm and mlups
    # are printed by both.
    assert stats[:3] == jstats[:3]
    assert [s.split("=")[0] for s in stats] == [s.split("=")[0]
                                                for s in jstats]


def test_cli_refine_every_and_dtype(tmp_path, capsys):
    _, ref = _params("16x16")
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    rc, out, err = _run_cli(cli.main, [path, "--device", "cpu", "--stats",
                                       "--refine-every", "16", "--method",
                                       "pallas_sor"], capsys)
    jrc, jout, jerr = _run_cli(jcli.main, [path, "--stats", "--refine-every",
                                           "16", "--backend", "pallas"],
                               capsys)
    assert rc == jrc == 0
    assert err[0].split()[:3] == jerr[0].split()[:3]
    # An f64 state runs the direct solve, as the JAX CLI does.
    rc, out, err = _run_cli(cli.main, [path, "--device", "cpu", "--dtype",
                                       "float64", "--stats"], capsys)
    jrc, jout, jerr = _run_cli(jcli.main, [path, "--dtype", "float64",
                                           "--stats"], capsys)
    assert rc == jrc == 0
    assert err[0].split()[:3] == jerr[0].split()[:3]
    assert_close_reference_contract([float(x.split()[1]) for x in out],
                                    [float(x.split()[1]) for x in jout])


@pytest.mark.parametrize("argv,needle", [
    (["--device", "cpu", "--backend", "gspmd", "--method", "pallas_sor"],
     "gspmd backend supports"),
    (["--device", "cpu", "--refine-every", "0"], "refine-every"),
    (["--device", "cuda"], "CUDA"),
])
def test_cli_errors(argv, needle, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ref = _params("16x16")
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    rc, out, err = _run_cli(cli.main, [path, *argv], capsys)
    assert rc == 1 and not out
    assert needle in "\n".join(err)


def test_cli_bad_or_unported_param_file(tmp_path, capsys):
    bad = tmp_path / "bad.in"
    bad.write_text("nonsense\n")
    rc, _, err = _run_cli(cli.main, [str(bad), "--device", "cpu"], capsys)
    assert rc == 1 and "error" in err[0]
    # Natural convection (problem 5) runs on the sharded backend too
    # (parallel/sharded_thermal.py): one step of configs/convection.in.
    conv = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "convection.in")
    rc, out, err = _run_cli(cli.main, [conv, "--device", "cpu", "--backend",
                                       "sharded", "--max-steps", "1",
                                       "--stats"], capsys)
    assert rc == 3 and err[0].startswith("steps=1 ") and len(out) == 2
