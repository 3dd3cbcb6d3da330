"""The port's diagnostics (utils/diagnostics.py), Ghia validation
(models/cavity.py), checks and timing helpers vs the JAX package's, on the
same seeded fields.

Tolerances: the stream function is a cumulative sum, exact in f64 and
within 1e-6 of max|psi| in f32 (PyTorch and XLA sum in other orders); the
monitors' sums within 1e-5 relative in f32; max_divergence, a difference
of O(1/dx) terms that cancel, within 1e-5 absolute.  Everything from
numpy (the cavity model, the vortex location, the Ghia errors) is exact.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.models import cavity as jcavity
from navierstokes_parallel_tpu.utils import checks as jchecks
from navierstokes_parallel_tpu.utils import diagnostics as jdiag
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import cavity
from navierstokes_parallel_tpu_torch.utils import checks, diagnostics, timing

SHAPES = [(16, 16), (20, 12)]


def _params(i_max, j_max, dtype="float32"):
    return Params(i_max=i_max, j_max=j_max, a=1.0, b=1.5, Re=100.0,
                  dtype=dtype)


def _jparams(prm):
    return JaxParams(**dataclasses.asdict(prm))


def _uv(prm, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(prm.shape).astype(dtype)
                 for _ in range(2))


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "20x12"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fields_and_monitors_match_jax(shape, dtype):
    prm = _params(*shape, dtype=dtype)
    jprm = _jparams(prm)
    u, v = _uv(prm, seed=sum(shape), dtype=np.dtype(dtype))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    f32 = dtype == "float32"

    psi = diagnostics.stream_function(tu, prm)
    jpsi = np.asarray(jdiag.stream_function(u, jprm))
    assert psi.shape == jpsi.shape == (shape[0] + 1, shape[1] + 1)
    assert psi.dtype == tu.dtype
    _close(psi, jpsi, atol=1e-6 * np.abs(jpsi).max() if f32 else 1e-15)
    om = diagnostics.vorticity(tu, tv, prm)
    _close(om, jdiag.vorticity(u, v, jprm), rtol=1e-6 if f32 else 1e-15,
           atol=1e-6 if f32 else 0.0)

    got = diagnostics.physics_monitors(tu, tv, prm)
    want = jdiag.physics_monitors(jnp.asarray(u), jnp.asarray(v), jprm)
    assert all(x.dim() == 0 and x.dtype == tu.dtype for x in got)
    values = diagnostics.monitor_values(got)
    assert values == tuple(float(x) for x in got)
    for name, mine, theirs in zip(got._fields, values, want):
        if name == "max_divergence":
            _close(mine, theirs, atol=1e-5 if f32 else 1e-12)
        else:
            _close(mine, theirs, rtol=1e-5 if f32 else 1e-12)

    vort = diagnostics.primary_vortex(psi, prm)
    jvort = jdiag.primary_vortex(jpsi, jprm)
    assert (vort.x, vort.y) == (jvort.x, jvort.y)
    _close(vort.psi, jvort.psi, atol=1e-6 * abs(jvort.psi))


def test_ghia_vortex_errors_match_jax():
    prm = _params(32, 32, dtype="float64")
    u, _ = _uv(prm, seed=5, dtype=np.float64)
    for Re in (100, 1000):
        assert diagnostics.ghia_vortex_errors(u, prm, Re) == \
            jdiag.ghia_vortex_errors(u, _jparams(prm), Re)
    with pytest.raises(ValueError, match="no Ghia vortex data"):
        diagnostics.ghia_vortex_errors(u, prm, 123)
    assert diagnostics.GHIA_PSI_MIN == jdiag.GHIA_PSI_MIN
    assert diagnostics.GHIA_VORTEX_CENTER == jdiag.GHIA_VORTEX_CENTER


def test_cavity_model_matches_jax():
    for name in ("GHIA_Y", "GHIA_X"):
        np.testing.assert_array_equal(getattr(cavity, name),
                                      getattr(jcavity, name))
    for name in ("GHIA_U", "GHIA_V"):
        mine, theirs = getattr(cavity, name), getattr(jcavity, name)
        assert mine.keys() == theirs.keys()
        for Re in mine:
            np.testing.assert_array_equal(mine[Re], theirs[Re])
    assert cavity.GHIA_EXCLUDED_V == jcavity.GHIA_EXCLUDED_V
    assert cavity.GHIA_EXCLUDED_U == jcavity.GHIA_EXCLUDED_U
    for fn in ("lid_driven_cavity", "oscillating_lid"):
        prm = getattr(cavity, fn)(n=24, T=0.5, max_it=300)
        jprm = getattr(jcavity, fn)(n=24, T=0.5, max_it=300)
        assert isinstance(prm, Params)
        assert prm == Params.from_mapping(dataclasses.asdict(jprm))


@pytest.mark.parametrize("Re", [100, 400, 1000, 10000])
def test_centerlines_and_ghia_errors_match_jax(Re):
    prm = _params(32, 32, dtype="float64").replace(b=1.0)
    u, v = _uv(prm, seed=Re, dtype=np.float64)
    jprm = _jparams(prm)
    for mine, theirs in zip(
            cavity.centerline_profiles(torch.from_numpy(u),
                                       torch.from_numpy(v), prm),
            jcavity.centerline_profiles(u, v, jprm)):
        np.testing.assert_array_equal(mine, theirs)
    assert cavity.ghia_errors(torch.from_numpy(u), torch.from_numpy(v), prm,
                              Re) == jcavity.ghia_errors(u, v, jprm, Re)


def test_ghia_validation_of_a_solved_cavity():
    """A short Re=100 run through the port: the tools read its state on
    the device it ran on, and agree with JAX's on the same arrays."""
    prm = cavity.lid_driven_cavity(Re=100.0, n=16, T=0.3, max_it=500)
    state, _ = solver.solve(prm, device="cpu", pressure_method="pallas_sor")
    errs = cavity.ghia_errors(state.u, state.v, prm, 100)
    jerrs = jcavity.ghia_errors(state.u.numpy(), state.v.numpy(),
                                _jparams(prm), 100)
    assert errs == jerrs and 0 < errs.max_u_err < 1.0
    vortex = diagnostics.ghia_vortex_errors(state.u, prm, 100)
    assert vortex == jdiag.ghia_vortex_errors(state.u.numpy(), _jparams(prm),
                                              100)


def test_checks_match_jax():
    prm = _params(20, 12)
    u, v = _uv(prm, seed=9)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    _close(checks.divergence_norm(tu, tv, prm),
           jchecks.divergence_norm(u, v, _jparams(prm)), rtol=1e-5)
    mine = checks.cfl_report(tu, tv, prm)
    theirs = jchecks.cfl_report(jnp.asarray(u), jnp.asarray(v),
                                _jparams(prm))
    assert mine.keys() == theirs.keys()
    for key in mine:
        _close(mine[key], theirs[key], rtol=1e-7)
    zero = torch.zeros(prm.shape)
    assert checks.cfl_report(zero, zero, prm)["dt_convective_x"] == \
        float("inf")


def test_check_step_names_the_step():
    prm = _params(8, 8)
    state = solver.allocate_state(prm, "cpu")
    assert checks.check_step(state, 4) is state
    state.v[2, 3] = float("inf")
    with pytest.raises(checks.NonFiniteStateError, match="in v at step 7"):
        checks.check_step(state, 7)


def test_timer_and_profiler_trace(tmp_path):
    """A profiler_trace capture of a 24^2 pallas_sor solve holds one
    ``nsp.pressure.pass`` span for each outer pass counted."""
    prm = Params(i_max=24, j_max=24, Re=1000.0, T=0.3, tau=0.5,
                 epsilon=1e-12, max_it=300)
    before = timing.counts()
    with timing.profiler_trace(str(tmp_path / "trace")) as where:
        solver.solve(prm, device="cpu", pressure_method="pallas_sor",
                     max_steps=2)
    passes = (timing.counts()["pressure.passes"]
              - before.get("pressure.passes", 0))
    assert where == str(tmp_path / "trace")
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "nsp.pressure.pass"
             and e.get("cat") == "user_annotation"]
    assert passes == 2 * 5 and len(spans) == passes
