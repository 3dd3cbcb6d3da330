"""The plane channel (problem 3), the free-slip Taylor-Green box (problem 4)
and Adams-Bashforth 2 time stepping of the port vs the JAX package, on the
CPU, f32 state, K = 64.

  * The boundary functions on seeded random fields: bit for bit where they
    only copy, negate or zero; the channel's flux-balanced outflow edge
    within FLUX_TOL (q_in and q_out are f32 sums that PyTorch and XLA add
    in other orders).
  * ``step`` and ``step_ab2`` on both problems from the same state and the
    same AB2 carry (``grid.ab2_state_from_numpy``): fields within
    STEP_TOL, dt and the iteration count equal; the first ``step_ab2``
    equals ``step`` exactly.
  * ``solve`` and ``solve_ab2`` on channels of 32 x 16 and 24 x 12 for
    rb_sor, mg, cg and fft, and on 16^2 Taylor-Green boxes: equal steps,
    iteration totals and failures, fields within the reference contract
    (1e-4); the channel's p less its mean (it is fixed only up to a
    constant, which cg leaves to the summation order: 2.2e-4 apart on the
    24 x 12 Euler channel, uniformly).
  * The model helpers against the JAX package's.
"""

import dataclasses
import importlib.util
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.grid import State as JaxState
from navierstokes_parallel_tpu.models import channel as jchannel
from navierstokes_parallel_tpu.models import taylorgreen as jtg
from navierstokes_parallel_tpu.ops import boundary as jbc
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import (ab2_state_from_numpy,
                                                  state_from_numpy)
from navierstokes_parallel_tpu_torch.models import channel, taylorgreen
from navierstokes_parallel_tpu_torch.ops import boundary, sor
from navierstokes_parallel_tpu_torch.ops import stencils as st

from conftest import assert_close_reference_contract

# The flux-balanced outflow edge: f32 sums of j_max O(1) terms in another
# order differ by a few ulps of the sum, spread over j_max cells.
FLUX_TOL = 1e-6
# One step from the same state: the SOR twins differ from JAX's
# interpreted kernels by XLA's FMA contraction (1e-6..5e-6 of max|delta|,
# tests/test_torch_sor.py), which the projection carries into u and v.
STEP_TOL = 2e-5
CHANNELS = [(32, 16), (24, 12)]
METHODS = ["rb_sor", "mg", "cg", "fft"]


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _channel(i_max=32, j_max=16, **kw):
    ref = JaxParams(**{**dict(problem=3, a=2.0, b=1.0, Re=10.0, T=0.05,
                              tau=0.5, omega=1.7, epsilon=1e-4, max_it=20000,
                              dtype="float32", sor_refine_every=64),
                       "i_max": i_max, "j_max": j_max, **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _tg(n=16, **kw):
    kw = {"T": 0.01, **kw}
    ref, jstate = jtg.taylor_green(n=n, **kw)
    prm, state = taylorgreen.taylor_green(n=n, device="cpu", **kw)
    assert prm == Params.from_mapping(dataclasses.asdict(ref))
    return prm, ref, state, jstate


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_states_close(got, want, tol=1e-4, p_up_to_constant=False):
    """u, v and p within the contract; with `p_up_to_constant`, p less its
    interior mean (an outflow problem fixes p only up to a constant, which
    cg's restarts leave to the summation order) on every cell but the four
    ghost corners, which no step writes."""
    edges = np.ones(got.p.shape, bool)
    edges[[0, 0, -1, -1], [0, -1, 0, -1]] = False
    for name in ("u", "v", "p"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "p" and p_up_to_constant:
            a = a - edges * a[1:-1, 1:-1].mean(dtype=np.float64)
            b = b - edges * b[1:-1, 1:-1].mean(dtype=np.float64)
        assert_close_reference_contract(a, b, tol)


# --- boundary conditions ------------------------------------------------------

@pytest.mark.parametrize("side", list(boundary.Side), ids=lambda s: s.value)
@pytest.mark.parametrize("which", ["freeslip", "outflow"])
def test_copy_bcs_bit_for_bit(which, side):
    """set_freeslip and set_outflow only copy and zero: the JAX bits."""
    u, v = _fields((14, 11), seed=1)
    fn = getattr(boundary, f"set_{which}")
    jfn = getattr(jbc, f"set_{which}")
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    got = fn(tu, tv, side)
    want = jfn(jnp.asarray(u), jnp.asarray(v), jbc.Side(side.value))
    assert got[0] is tu and got[1] is tv  # in place
    for g, w in zip(got, want):
        _assert_equal(g, w)


def test_freeslip_box_bit_for_bit():
    u, v = _fields((18, 18), seed=2)
    got = boundary.apply_freeslip_box(torch.from_numpy(u.copy()),
                                      torch.from_numpy(v.copy()))
    want = jbc.apply_freeslip_box(jnp.asarray(u), jnp.asarray(v))
    for g, w in zip(got, want):
        _assert_equal(g, w)


@pytest.mark.parametrize("shape", CHANNELS)
def test_channel_bcs(shape):
    """Every cell but the flux-corrected outflow edge and the wall ghosts
    that read it (the corner ghosts of BOTTOM/TOP at i = i_max) bit for
    bit; those within FLUX_TOL.  The inflow is JAX's f64 parabola rounded
    once."""
    prm, ref = _channel(*shape)
    u, v = _fields(prm.shape, seed=3)
    got = boundary.apply_channel_bcs(torch.from_numpy(u.copy()),
                                     torch.from_numpy(v.copy()), prm)
    want = [np.asarray(x) for x in jbc.apply_channel_bcs(
        jnp.asarray(u), jnp.asarray(v), ref)]
    _assert_equal(got[1], want[1])
    np.testing.assert_array_equal(
        boundary.poiseuille_profile(prm),
        np.asarray(jbc.poiseuille_profile(ref)))
    edge = np.zeros(prm.shape, bool)
    edge[-2, :] = True
    np.testing.assert_array_equal(got[0].numpy()[~edge], want[0][~edge])
    np.testing.assert_allclose(got[0].numpy()[edge], want[0][edge], rtol=0,
                               atol=FLUX_TOL)
    # The outflow flux equals the inflow flux after the correction.
    assert abs(float(got[0][-2, 1:-1].sum() - got[0][0, 1:-1].sum())) < 1e-5
    # With an obstacle (A7): the per-span inflow and the balance over the
    # outflow column's fluid rows, as JAX's obstacle arm gives them.
    rects = ((4, 6, 4, 6), (prm.i_max - 2, prm.i_max, 1, 3))
    got = boundary.apply_channel_bcs(torch.from_numpy(u.copy()),
                                     torch.from_numpy(v.copy()),
                                     prm.replace(obstacles=rects))
    want = [np.asarray(x) for x in jbc.apply_channel_bcs(
        jnp.asarray(u), jnp.asarray(v), ref.replace(obstacles=rects))]
    _assert_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].numpy()[~edge], want[0][~edge])
    np.testing.assert_allclose(got[0].numpy()[edge], want[0][edge], rtol=0,
                               atol=FLUX_TOL)
    fluid = torch.ones(prm.j_max, dtype=torch.bool)
    fluid[:3] = False  # the second obstacle's rows of the outflow column
    assert abs(float(got[0][-2, 1:-1][fluid].sum()
                     - got[0][0, 1:-1].sum())) < 1e-5


# --- the deflation ----------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS + ["jacobi"])
def test_deflated_solve_pressure(method):
    """Problem 3's deflation on a rhs with a constant mode: counts equal,
    p within the contract (the deflated constant sums in another order)."""
    prm, ref = _channel(24, 12, max_it=4000)
    rng = np.random.default_rng(4)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((24, 12)) + 0.25
    p0 = np.zeros(prm.shape, np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # jacobi's omega clamp, in both
        got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                                 prm, method=method)
        want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                                   method=method)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.converged or method == "jacobi"
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))
    # Without the deflation the constant mode stalls the solve.
    if method == "rb_sor":
        cavity = sor.solve_pressure(torch.from_numpy(p0),
                                    torch.from_numpy(rhs),
                                    prm.replace(problem=1), method=method)
        assert not cavity.converged


@pytest.mark.parametrize("method", METHODS + ["pallas_sor"])
def test_mean_fn_hook_is_used(method):
    """A caller's mean_fn reaches the rhs and every defect of every
    refined method (a sharded caller's is the all-reduced mean)."""
    prm, _ = _channel(16, 8, max_it=640)
    rhs = torch.zeros(prm.shape)
    rhs[1:-1, 1:-1] = 1.0
    calls = []

    def mean_fn(arr):
        calls.append(arr.dtype)
        return torch.mean(arr)

    res = sor.solve_pressure(torch.zeros(prm.shape), rhs, prm,
                             method=method, mean_fn=mean_fn)
    assert res.converged
    assert calls[0] == torch.float32 and set(calls[1:]) == {torch.float64}
    # The first defect, then one per outer pass.
    assert len(calls) >= 3
    if method in ("rb_sor", "pallas_sor"):
        assert res.iterations == 64 and len(calls) == 1 + 1 + 1


# --- steps ------------------------------------------------------------------------------

def _jax_ab2_after(ref, jstate, n_steps, method):
    ab2 = jsolver.ab2_init(jstate)
    for _ in range(n_steps):
        ab2, _ = jsolver.step_ab2(ab2, ref, pressure_method=method)
    return ab2


def _start(problem):
    """(Params, JAX Params, port state, JAX state) two steps into a run."""
    if problem == 3:
        prm, ref = _channel(24, 12)
        jstate = jsolver.solve(ref.replace(T=0.004))[0]
    else:
        prm, ref, _, jstate = _tg(16)
    return prm, ref, jstate


@pytest.mark.parametrize("problem", [3, 4])
def test_step_from_the_same_state(problem):
    prm, ref, jstate = _start(problem)
    state = state_from_numpy(*(np.asarray(x) for x in jstate[:3]),
                             t=np.asarray(jstate.t), n=int(jstate.n),
                             device="cpu")
    new, diag = solver.step(state, prm, pressure_method="pallas_sor")
    jnew, jdiag = jsolver.step(jstate, ref, pressure_method="pallas_sor")
    _assert_states_close(new, jnew, STEP_TOL)
    assert float(diag.dt) == float(jdiag.dt)
    assert diag.sor_iterations == int(jdiag.sor_iterations)


@pytest.mark.parametrize("problem", [3, 4])
def test_step_ab2_from_the_same_carry(problem):
    """Two AB2 steps in JAX, then one more in both packages from that
    carry: the extrapolation's weight is live (dt_prev > 0)."""
    prm, ref, jstate = _start(problem)
    jab2 = _jax_ab2_after(ref, jstate, 2, "rb_sor")
    ab2 = ab2_state_from_numpy(jab2, device="cpu")
    assert float(ab2.dt_prev) == float(jab2.dt_prev) > 0
    _assert_equal(ab2.ru, jab2.ru)
    before = [x.clone() for x in (*ab2.s[:3], ab2.ru, ab2.rv)]
    new, diag = solver.step_ab2(ab2, prm, pressure_method="rb_sor")
    for x, y in zip((*ab2.s[:3], ab2.ru, ab2.rv), before):
        assert torch.equal(x, y)  # the input carry is not modified
    jnew, jdiag = jsolver.step_ab2(jab2, ref, pressure_method="rb_sor")
    _assert_states_close(new.s, jnew.s, STEP_TOL)
    assert float(diag.dt) == float(jdiag.dt) == float(new.dt_prev)
    assert diag.sor_iterations == int(jdiag.sor_iterations)
    for name in ("ru", "rv"):
        got, want = getattr(new, name).numpy(), np.asarray(getattr(jnew, name))
        interior = np.s_[1:-1, 1:-1]
        np.testing.assert_allclose(got[interior], want[interior], rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("problem", [1, 3, 4])
def test_first_step_ab2_is_euler(problem):
    """The Euler bootstrap (the JAX package's
    test_first_step_bootstraps_to_euler): the first step_ab2 equals step
    exactly on the CPU, where both take the plain momentum formulation."""
    if problem == 3:
        prm, _ = _channel()
        state = channel.developed_state(prm, "cpu")
    elif problem == 4:
        prm, _, state, _ = _tg(32)
    else:
        prm, _ = _channel(problem=1, T=0.01)
        state = solver.allocate_state(prm, "cpu")
    s_euler, d1 = solver.step(state, prm)
    ab2, d2 = solver.step_ab2(solver.ab2_init(state), prm)
    for a, b in zip(s_euler[:3], ab2.s[:3]):
        assert torch.equal(a, b)
    assert float(d1.dt) == float(d2.dt) == float(ab2.dt_prev)
    assert d1.sor_iterations == d2.sor_iterations
    assert torch.isfinite(ab2.ru).all() and torch.isfinite(ab2.rv).all()
    # The second step extrapolates: it differs from Euler's.
    s2, _ = solver.step(s_euler, prm)
    ab2_2, _ = solver.step_ab2(ab2, prm)
    assert not torch.equal(s2.u, ab2_2.s.u)


def test_unported_problems_raise():
    # Problem 5 steps with models/convection.py (solver.step and step_ab2
    # raise the JAX steps' ValueError), problem 6 with models/freesurface.py
    # (the same ValueError).
    prm, _ = _channel()
    state = solver.allocate_state(prm, "cpu")
    for problem, error, needle in (
            (5, ValueError, "unknown problem type 5"),
            (6, ValueError, "unknown problem type 6")):
        for fn, arg in ((solver.step, state),
                        (solver.step_ab2, solver.ab2_init(state))):
            with pytest.raises(error, match=needle):
                fn(arg, prm.replace(problem=problem))
    with pytest.raises(ValueError, match="time_order"):
        solver.Stepper(prm, state, time_order=3)


# --- whole solves ---------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2], ids=["euler", "ab2"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", CHANNELS, ids=["32x16", "24x12"])
def test_channel_solve_matches_jax(shape, method, order):
    prm, ref = _channel(*shape)
    if order == 1:
        state, stats = solver.solve(prm, device="cpu",
                                    pressure_method=method)
        jstate, jstats = jsolver.solve(ref, pressure_method=method)
    else:
        state, stats = solver.solve_ab2(prm, device="cpu",
                                        pressure_method=method)
        jstate, jstats = jsolver.solve_ab2(ref, pressure_method=method)
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(jstats.steps), int(jstats.total_sor_iterations),
        int(jstats.sor_failures))
    assert stats.steps == state.n > 3 and stats.sor_failures == 0
    _assert_states_close(state, jstate, p_up_to_constant=True)
    assert_close_reference_contract(
        solver.center_values(state, prm),
        [float(x) for x in jsolver.center_values(jstate, ref)])
    assert_close_reference_contract(
        channel.profile_errors(state.u, prm),
        jchannel.profile_errors(np.asarray(jstate.u), ref))


@pytest.mark.parametrize("order", [1, 2], ids=["euler", "ab2"])
@pytest.mark.parametrize("method", ["rb_sor", "mg", "fft"])
def test_taylor_green_solve_matches_jax(method, order):
    prm, ref, state0, jstate0 = _tg(16, T=0.05)
    solve = solver.solve if order == 1 else solver.solve_ab2
    jsolve = jsolver.solve if order == 1 else jsolver.solve_ab2
    state, stats = solve(prm, state0, pressure_method=method)
    jstate, jstats = jsolve(ref, jstate0, pressure_method=method)
    assert tuple(stats[:3]) == tuple(int(x) for x in jstats[:3])
    assert stats.steps > 1
    _assert_states_close(state, jstate)
    got, want = taylorgreen.errors(state, prm), jtg.errors(jstate, ref)
    for key in ("u", "v", "p"):
        assert got[key] == pytest.approx(want[key], rel=1e-3)
    assert taylorgreen.kinetic_energy(state, prm) == pytest.approx(
        jtg.kinetic_energy(jstate, ref), rel=1e-6)


def test_solve_ab2_max_steps_and_stepper():
    prm, _ = _channel()
    state, stats = solver.solve_ab2(prm, device="cpu", max_steps=2)
    stepper = solver.Stepper(prm, solver.allocate_state(prm, "cpu"),
                             "rb_sor", time_order=2)
    stepper.warm()
    for _ in range(2):
        stepper.step()
    assert stats.steps == state.n == stepper.n == 2
    assert all(torch.equal(a, b) for a, b in zip(state[:4],
                                                 stepper.state()[:4]))
    assert stepper.t == float(state.t) < prm.T


# --- models ---------------------------------------------------------------------------

def test_channel_model_helpers():
    prm = channel.plane_channel(nx=24, ny=12, dtype="float32")
    ref = jchannel.plane_channel(nx=24, ny=12, dtype="float32")
    assert prm == Params.from_mapping(dataclasses.asdict(ref))
    np.testing.assert_array_equal(channel.analytic_u(prm),
                                  jchannel.analytic_u(ref))
    assert channel.analytic_dpdx(prm) == jchannel.analytic_dpdx(ref)
    dev = channel.developed_state(prm, "cpu")
    jdev = jchannel.developed_state(ref)
    for name in ("u", "v", "p"):
        _assert_equal(getattr(dev, name), getattr(jdev, name))
    u = _fields(prm.shape, seed=5)[0]
    assert channel.profile_errors(torch.from_numpy(u), prm) == \
        jchannel.profile_errors(u, ref)
    # One step from the developed profile (a fixed point up to the
    # solve's tolerance) drifts as far as JAX's.
    s, _ = solver.step(dev, prm)
    js, _ = jsolver.step(jdev, ref)
    assert_close_reference_contract(
        channel.profile_errors(s.u, prm),
        jchannel.profile_errors(np.asarray(js.u), ref), 1e-5)


def test_taylor_green_model_helpers():
    prm, ref, state, jstate = _tg(24, Re=80.0, mode=2)
    for name in ("u", "v", "p"):
        _assert_equal(getattr(state, name), getattr(jstate, name))
    for a, b in zip(taylorgreen.exact_fields(prm, 0.1, mode=2),
                    jtg.exact_fields(ref, 0.1, mode=2)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(6)
    u, v, p = (rng.standard_normal(prm.shape).astype(np.float32)
               for _ in range(3))
    mine = state_from_numpy(u, v, p, t=0.05, device="cpu")
    theirs = JaxState(u=jnp.asarray(u), v=jnp.asarray(v), p=jnp.asarray(p),
                      t=jnp.asarray(0.05, jnp.float32),
                      n=jnp.asarray(0, jnp.int32))
    assert taylorgreen.errors(mine, prm, mode=2) == jtg.errors(theirs, ref,
                                                               mode=2)
    assert taylorgreen.kinetic_energy(mine, prm) == pytest.approx(
        jtg.kinetic_energy(theirs, ref), rel=1e-12)
    assert taylorgreen.exact_energy(prm, 0.2, 2) == jtg.exact_energy(ref,
                                                                    0.2, 2)


def test_channel_grids_take_b1_on_a_compiled_tile():
    """configs/channel.in (130 x 66 padded) and its full-width 2048 x 1024
    cut take the whole-grid kernel B1 on the card (within the JAX
    whole-grid budget), on a tile of WHOLE_GRID_TILES, each of which has a
    kernel compiled for its shape
    (tests/test_torch_mg.py::test_compiled_tile_shapes_cover_the_routes)."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    base = Params.from_file(os.path.join(os.path.dirname(__file__), "..",
                                         "configs", "channel.in"))
    for prm, tile in ((base, (32, 32, 8)),
                      (base.replace(i_max=2048, j_max=1024), (64, 64, 8))):
        assert sor_kernel.route(prm) == "whole"
        assert sor_kernel.whole_grid_tile(prm.shape) == tile
        assert tile in sor_kernel.WHOLE_GRID_TILES


def test_division_constants_are_made_once():
    """stencils.scalar makes a 0-d constant once per (value, dtype,
    device), and div by a Python number is the true division by it."""
    cpu = torch.device("cpu")
    ten = st.scalar(10.0, torch.float32, cpu)
    assert ten is st.scalar(10.0, torch.float32, cpu)
    assert ten.dim() == 0 and ten.dtype == torch.float32 and float(ten) == 10
    assert st.scalar(10.0, torch.float64, cpu).dtype == torch.float64
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32))
    assert torch.equal(st.div(x, 10.0), x / ten)
    np.testing.assert_array_equal(st.div(x, 10.0).numpy(),
                                  x.numpy() / np.float32(10.0))


def test_channel_step_gate():
    """chip_smoke.py's per-step gate of the 50-step channel: a step may
    differ from JAX's passes by one pass only where the residual of the
    pass that decided (the last one when it took fewer, the one before
    when it took more) lies within NEAR_THRESHOLD of the threshold."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    near, far = cs.NEAR_THRESHOLD / 2, cs.NEAR_THRESHOLD * 2
    passes = (5, 4, 6, 4, 3, 6)
    margins = [[-near, far], [-near, far], [-far, near], [-far, near],
               [-near, far], [-near, far]]
    assert cs.channel_gate(passes, margins, (5,) * 6) == [
        (1, 4, 5, -near, True), (2, 6, 5, near, True),
        (3, 4, 5, -far, False), (4, 3, 5, -near, False),
        (5, 6, 5, far, False)]
