"""The Kármán models of the port (models/karman.py) and the surface
quadrature (ops/obstacles.py::surface_force) vs the JAX package, on the CPU.

  * The rasterizer, the model constructors, the initial state (bit for
    bit), the probe and the control volume equal JAX's.
  * The force records on seeded states within REC_TOL of the record's
    scale (sums in another order); the surface quadrature exact on a
    manufactured linear pressure, as JAX's test holds it.
  * ``strouhal`` and ``coefficients`` (copied numpy) equal JAX's on the
    same inputs; ``shedding_signal`` in whole chunks against JAX's on a
    short trace: equal steps, iteration totals and failures, times and
    records within the contract.
  * Two steps of the Schäfer-Turek cylinder at 220 x 41 (sharp) under mg
    against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.grid import State as JaxState
from navierstokes_parallel_tpu.models import karman as jkarman
from navierstokes_parallel_tpu.ops import obstacles as jobs
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state, state_from_numpy
from navierstokes_parallel_tpu_torch.models import karman
from navierstokes_parallel_tpu_torch.ops import obstacles as obs

from conftest import assert_close_reference_contract

# A record of f32 sums over a face or a control volume against XLA's, in
# another order: relative to max(1, |record|).
REC_TOL = 1e-5


def _pair(ctor, **kw):
    prm, jprm = getattr(karman, ctor)(**kw), getattr(jkarman, ctor)(**kw)
    assert prm == Params.from_mapping(dataclasses.asdict(jprm))
    return prm, jprm


def _jax_state(prm, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    u, v, p = (scale * rng.standard_normal(prm.shape).astype(np.float32)
               for _ in range(3))
    return u, v, p


@pytest.mark.parametrize("args", [(2.0, 2.0, 1.0, 0.1, 0.1, 220, 41),
                                  (2.0, 2.0, 1.0, 0.05, 0.05, 440, 82),
                                  (3.1, 1.7, 0.9, 0.07, 0.09, 80, 40)])
def test_circle_rects(args):
    assert karman.circle_rects(*args) == jkarman.circle_rects(*args)
    assert np.array_equal(karman.circle_cells(*args),
                          jkarman.circle_cells(*args))


def test_constructor_errors_are_jax_s():
    for ctor, args in ((karman.circle_rects, (2.0, 2.0, 0.01, 0.1, 0.1, 220,
                                              41)),
                       (karman.schafer_turek, (16,))):
        jctor = getattr(jkarman, ctor.__name__)
        with pytest.raises(ValueError) as got:
            ctor(*args)
        with pytest.raises(ValueError) as want:
            jctor(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ctor,kw,perturb", [
    ("schafer_turek", {"n_per_d": 10}, 0.3),
    ("schafer_turek", {"n_per_d": 20}, 0.3),
    ("square_cylinder", {"n_per_d": 8}, 0.3),
    ("square_cylinder", {"n_per_d": 8}, 0.0)])
def test_initial_state_probe_and_control_volume(ctor, kw, perturb):
    """initial_state equals JAX's u and v bit for bit; the probe node,
    the cylinder extent and the control volume equal JAX's."""
    prm, jprm = _pair(ctor, **kw)
    state = karman.initial_state(prm, perturb=perturb, device="cpu")
    jstate = jkarman.initial_state(jprm, perturb=perturb)
    for name in ("u", "v", "p", "t"):
        assert np.array_equal(getattr(state, name).numpy(),
                              np.asarray(getattr(jstate, name)))
    assert karman.probe_node(prm) == jkarman.probe_node(jprm)
    assert karman.probe_node(prm, (7.3, 1.1)) == \
        jkarman.probe_node(jprm, (7.3, 1.1))
    assert karman.cylinder_extent(prm) == jkarman.cylinder_extent(jprm)
    for margin in (4, 5, 30):
        assert karman.control_volume(prm, margin) == \
            jkarman.control_volume(jprm, margin)


def _close_records(got, want, tol=REC_TOL):
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key], np.float64), np.asarray(want[key],
                                                            np.float64)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=key)


@pytest.mark.parametrize("ctor,kw,record", [
    ("schafer_turek", {"n_per_d": 10}, "surface_force_record_fn"),
    ("square_cylinder", {"n_per_d": 8}, "force_record_fn")])
def test_force_records(ctor, kw, record):
    """The per-step records of a seeded state (smooth enough to keep the
    sums O(1)) against JAX's."""
    prm, jprm = _pair(ctor, **kw)
    u, v, p = _jax_state(prm, seed=3, scale=0.1)
    probe = karman.probe_node(prm)
    got = getattr(karman, record)(prm, 5, *probe)(
        state_from_numpy(u, v, p, device="cpu"))
    want = getattr(jkarman, record)(jprm, 5, *probe)(
        JaxState(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                 jnp.asarray(0.0, jnp.float32), 0))
    _close_records({k: x.numpy() for k, x in got.items()}, want)


def test_control_volume_force_zero_on_uniform_flow():
    """JAX's test: on u = 0.7, v = 0, p = 0 every face integral cancels and
    the CV momentum is 0.7 times the CV's fluid area."""
    prm, _ = _pair("schafer_turek", n_per_d=10, T=1.0)
    rec = karman.force_record_fn(prm, 4, *karman.probe_node(prm))
    state = allocate_state(prm, "cpu")
    out = rec(state._replace(u=state.u + 0.7))
    for key in ("sx", "sy", "dp", "my"):
        assert abs(float(out[key])) < 1e-12
    I0, I1, J0, J1 = karman.control_volume(prm, 4)
    area = obs.fluid_mask(prm)[I0:I1 + 1, J0:J1 + 1].sum() * prm.dx * prm.dy
    np.testing.assert_allclose(float(out["mx"]), 0.7 * area, rtol=1e-5)


def test_surface_force_linear_pressure_exact():
    """JAX's manufactured state: p = 3x + 2y, u = v = 0 (f64) integrates to
    the divergence-theorem force -grad(p) pi r^2 to machine precision; the
    same f32 fields give JAX's f32 force within REC_TOL."""
    prm, jprm = _pair("schafer_turek", n_per_d=20, T=1.0)
    ni, nj = prm.shape
    x = (np.arange(ni)[:, None] - 0.5) * prm.dx
    y = (np.arange(nj)[None, :] - 0.5) * prm.dy
    p = 3.0 * x + 2.0 * y
    z = np.zeros((ni, nj))
    fx, fy = obs.surface_force(*(torch.from_numpy(a) for a in (z, z, p)), prm)
    exact = -np.pi * 0.25 * np.array([3.0, 2.0])
    np.testing.assert_allclose([float(fx), float(fy)], exact, rtol=0,
                               atol=1e-10)
    u, v, p32 = _jax_state(prm, seed=4, scale=0.1)
    got = obs.surface_force(*(torch.from_numpy(a) for a in (u, v, p32)), prm,
                            return_samples=True)
    want = jobs.surface_force(*(jnp.asarray(a) for a in (u, v, p32)), jprm,
                              return_samples=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=REC_TOL,
                                   atol=REC_TOL)


def test_strouhal_synthetic():
    """JAX's synthetic signal: the frequency and amplitude recovered, and
    the port's numbers equal JAX's."""
    rng = np.random.default_rng(0)
    t = np.cumsum(0.02 + 0.01 * rng.random(4000))
    sig = 0.3 * np.sin(2 * np.pi * 0.21 * t) + 0.05
    st, amp = karman.strouhal(t, sig, d=1.0, u_mean=1.0)
    assert (st, amp) == jkarman.strouhal(t, sig, d=1.0, u_mean=1.0)
    assert abs(st - 0.21) / 0.21 < 0.01 and abs(amp - 0.3) < 0.01
    assert karman.strouhal(t, np.full_like(t, 0.7))[0] == 0.0


@pytest.mark.parametrize("order", [1, 2])
def test_shedding_signal_and_coefficients(order):
    """A short trace of the 40 x 16 square cylinder in chunks of 4 steps,
    both packages: whole chunks (the step count a multiple of the chunk,
    the state past T), equal counts, times and records within REC_TOL,
    and ``coefficients`` of each trace within REC_TOL of the other's."""
    prm, jprm = _pair("square_cylinder", n_per_d=2, T=0.5)
    rec = karman.force_record_fn(prm, 2, *karman.probe_node(prm))
    jrec = jkarman.force_record_fn(jprm, 2, *jkarman.probe_node(jprm))
    trace = karman.shedding_signal(prm, device="cpu", method="mg", chunk=4,
                                   record_fn=rec, time_order=order)
    jtrace = jkarman.shedding_signal(jprm, method="mg", chunk=4,
                                     record_fn=jrec, time_order=order)
    assert trace.stats.steps % 4 == 0 and float(trace.state.t) >= prm.T
    assert trace.stats[:3] == tuple(int(x) for x in jtrace.stats[:3])
    assert len(trace.t) == trace.stats.steps
    np.testing.assert_allclose(trace.t, jtrace.t, rtol=1e-6)
    _close_records(trace.rec, jtrace.rec)
    np.testing.assert_array_equal(trace.v, trace.rec["v"])
    co, jco = (karman.coefficients(trace, prm, skip_frac=0.25),
               jkarman.coefficients(jtrace, jprm, skip_frac=0.25))
    _close_records(co, jco, tol=1e-4)
    assert karman.coefficients(jtrace, prm, skip_frac=0.25) == jco
    for name in ("u", "v", "p"):
        assert_close_reference_contract(
            getattr(trace.state, name).numpy(),
            np.asarray(getattr(jtrace.state, name)))
    with pytest.raises(ValueError, match="raise params.T"):
        karman.shedding_signal(prm, trace.state, record_fn=rec)


def test_schafer_turek_two_steps_under_mg():
    """The sharp cylinder at 220 x 41 (one masked level: a V-cycle is 32
    coarse sweeps), 2 steps from initial_state: per-step V-cycles and
    convergence equal, fields within the contract."""
    prm, jprm = _pair("schafer_turek", n_per_d=10, T=1.0)
    jstate = jkarman.initial_state(jprm)
    state = karman.initial_state(prm, device="cpu")
    jfn = jsolver.make_step_fn(jprm, "mg")
    for _ in range(2):
        state, diag = solver.step(state, prm, pressure_method="mg")
        jstate, jdiag = jfn(jstate)
        assert diag.sor_iterations == int(jdiag.sor_iterations)
        assert diag.sor_converged and bool(jdiag.sor_converged)
    for name in ("u", "v", "p"):
        assert_close_reference_contract(getattr(state, name).numpy(),
                                        np.asarray(getattr(jstate, name)))
