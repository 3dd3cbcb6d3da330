"""Flag-field obstacle domains of the port (ops/obstacles.py, the obstacle
arms of ops/boundary.py and solver.py, models/step.py, the CLI's
--obstacle) vs the JAX package, on the CPU.

  * The static geometry is the JAX module's numpy code, copied: masks,
    immersed-boundary weights, apertures, surface quadrature and inflow
    profile equal JAX's bit for bit (``np.array_equal``) on the
    backward-facing step, the square cylinder and Schäfer-Turek at 10 and
    20 cells per diameter; the geometry checks raise JAX's errors.
  * The stencils on seeded fields: the copy-only paths (the mirror BCs,
    pin_fg, mask_rhs) bit for bit, the sums (the immersed-boundary BCs,
    poisson_rhs) within SUM_TOL of max|x| (XLA's CPU contracts a*b + c
    into FMAs).
  * Whole steps and solves on small obstacle cases: steps, iterations and
    failures equal, fields within the 1e-4 contract.
  * The CLI's --obstacle against the JAX CLI.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.grid import allocate_state as jallocate
from navierstokes_parallel_tpu.models import karman as jkarman
from navierstokes_parallel_tpu.models import step as jstep
from navierstokes_parallel_tpu.ops import boundary as jbc
from navierstokes_parallel_tpu.ops import obstacles as jobs
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import state_from_numpy
from navierstokes_parallel_tpu_torch.models import karman, step
from navierstokes_parallel_tpu_torch.ops import boundary
from navierstokes_parallel_tpu_torch.ops import obstacles as obs

from conftest import assert_close_reference_contract

# A sum of four f32 products, or a divergence, against XLA's (FMA
# contraction): relative to the field's max |x|.
SUM_TOL = 1e-6

# name: (constructor name, its module in each package, keyword arguments)
GEOMETRIES = {
    "step 64x16": ("backward_facing_step", {}),
    "step 128x32": ("backward_facing_step", {"Re": 150.0, "nx": 128,
                                             "ny": 32}),
    "square 8": ("square_cylinder", {"n_per_d": 8}),
    "schafer_turek 10": ("schafer_turek", {"n_per_d": 10}),
    "schafer_turek 20": ("schafer_turek", {"n_per_d": 20}),
    "schafer_turek 10 staircase": ("schafer_turek", {"n_per_d": 10,
                                                     "sharp": False}),
}


def _model(name):
    """(port Params, JAX Params) of GEOMETRIES[name], each built by its
    own package's constructor."""
    ctor, kw = GEOMETRIES[name]
    port, ref = ((step, jstep) if ctor == "backward_facing_step"
                 else (karman, jkarman))
    prm, jprm = getattr(port, ctor)(**kw), getattr(ref, ctor)(**kw)
    assert prm == Params.from_mapping(dataclasses.asdict(jprm))
    return prm, jprm


def _fields(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _assert_tuple_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _assert_tuple_equal(g, w)
        else:
            assert np.array_equal(g, w), type(got).__name__


def _close(got, want, tol=SUM_TOL):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# --- the static geometry, bit for bit ------------------------------------------

@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_geometry_bit_for_bit(name):
    prm, jprm = _model(name)
    _assert_tuple_equal(obs.masks(prm), jobs.masks(jprm))
    assert np.array_equal(obs.inflow_profile(prm),
                          jobs.inflow_profile(jprm))
    assert obs.n_fluid_cells(prm) == jobs.n_fluid_cells(jprm)
    assert obs.aperture_active(prm) == jobs.aperture_active(jprm)
    if prm.obstacle_surfaces:
        _assert_tuple_equal(obs.ib_weights(prm), jobs.ib_weights(jprm))
        _assert_tuple_equal(obs.apertures(prm), jobs.apertures(jprm))
        _assert_tuple_equal(obs.surface_quadrature(prm),
                            jobs.surface_quadrature(jprm))


# The JAX package's tests/test_obstacles.py::test_geometry_validation cases.
_OK = dict(problem=1, i_max=16, j_max=16)
BAD_GEOMETRIES = {
    "outside": ((0, 4, 1, 4),),
    "arity": ((1, 2, 3),),
    "thin": ((8, 8, 1, 16),),
    "enclosed": ((4, 8, 4, 5), (4, 8, 7, 8), (4, 5, 6, 6), (7, 8, 6, 6)),
    "disconnected": ((8, 9, 1, 16),),
}


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", list(BAD_GEOMETRIES))
def test_geometry_errors_are_jax_s(case):
    """Params and masks refuse each bad geometry with JAX's message."""
    rects = BAD_GEOMETRIES[case]
    got = _error(lambda: obs.masks(Params(obstacles=rects, **_OK)))
    want = _error(lambda: jobs.masks(JaxParams(obstacles=rects, **_OK)))
    assert got is not None and got == want


def test_surface_quadrature_refuses_a_square():
    prm, jprm = _model("square 8")
    got = _error(lambda: obs.surface_quadrature(prm))
    assert got is not None and got == _error(
        lambda: jobs.surface_quadrature(jprm))


# --- the stencils ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["square 8", "step 64x16",
                                  "schafer_turek 10 staircase",
                                  "schafer_turek 10"])
def test_apply_obstacle_bcs(name):
    """In place; the mirror arm bit for bit, the immersed-boundary arm
    (a sum of products) within SUM_TOL."""
    prm, jprm = _model(name)
    u, v = _fields(prm.shape, seed=5)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    got = obs.apply_obstacle_bcs(tu, tv, prm)
    want = jobs.apply_obstacle_bcs(jnp.asarray(u), jnp.asarray(v), jprm)
    assert got[0] is tu and got[1] is tv
    for g, w in zip(got, want):
        if prm.obstacle_surfaces:
            _close(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["step 64x16", "schafer_turek 10 staircase",
                                  "schafer_turek 10"])
def test_pin_fg_mask_rhs_poisson_rhs(name):
    """pin_fg and mask_rhs copy (bit for bit); poisson_rhs, the staircase
    divergence or the aperture-weighted one, within SUM_TOL."""
    prm, jprm = _model(name)
    F, G, u, v = _fields(prm.shape, seed=6, n=4)
    dt = np.float32(0.0123)
    got = obs.pin_fg(*(torch.from_numpy(x) for x in (F, G, u, v)), prm)
    want = jobs.pin_fg(*(jnp.asarray(x) for x in (F, G, u, v)), jprm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        obs.mask_rhs(torch.from_numpy(F), prm).numpy(),
        np.asarray(jobs.mask_rhs(jnp.asarray(F), jprm)))
    rhs = obs.poisson_rhs(got[0], got[1], torch.tensor(dt), prm)
    jrhs = jobs.poisson_rhs(want[0], want[1], jnp.asarray(dt), jprm)
    _close(rhs, jrhs)
    assert not rhs.numpy()[~obs.masks(prm).fluid].any()


@pytest.mark.parametrize("name", ["step 64x16", "square 8"])
def test_channel_bcs_obstacle_arm(name):
    """The per-span inflow and the flux balance over the outflow column's
    fluid rows: every cell but that column bit for bit, the column within
    1e-6 (q_in and q_out add in other orders); the balanced flux holds."""
    prm, jprm = _model(name)
    u, v = _fields(prm.shape, seed=7)
    got = boundary.apply_channel_bcs(torch.from_numpy(u.copy()),
                                     torch.from_numpy(v.copy()), prm)
    want = [np.asarray(x) for x in jbc.apply_channel_bcs(
        jnp.asarray(u), jnp.asarray(v), jprm)]
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    edge = np.zeros(prm.shape, bool)
    edge[-2, :] = True
    np.testing.assert_array_equal(got[0].numpy()[~edge], want[0][~edge])
    np.testing.assert_allclose(got[0].numpy()[edge], want[0][edge], rtol=0,
                               atol=1e-6)
    fluid = obs.masks(prm).fluid[-2, 1:-1]
    assert abs(float(got[0][-2, 1:-1][torch.from_numpy(fluid)].sum()
                     - got[0][0, 1:-1].sum())) < 1e-5


# --- whole steps and solves -----------------------------------------------------

def _small(name):
    """(port Params, JAX Params, JAX initial state) of a small case."""
    if name == "step 32x8":
        jprm = jstep.backward_facing_step(nx=32, ny=8, T=0.3)
        prm = step.backward_facing_step(nx=32, ny=8, T=0.3)
        return prm, jprm, jallocate(jprm)
    jprm = jkarman.square_cylinder(n_per_d=2, T=0.4)
    prm = karman.square_cylinder(n_per_d=2, T=0.4)
    return prm, jprm, jkarman.initial_state(jprm)


def _port_state(jstate):
    return state_from_numpy(*(np.asarray(x) for x in jstate[:3]),
                            t=np.asarray(jstate.t), n=int(jstate.n),
                            device="cpu")


def _assert_fields_close(got, want):
    for name in ("u", "v", "p"):
        assert_close_reference_contract(getattr(got, name).numpy(),
                                        np.asarray(getattr(want, name)))


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("method", ["rb_sor", "mg"])
@pytest.mark.parametrize("name", ["step 32x8", "square 2"])
def test_steps(name, method, order):
    """Three steps of step / step_ab2 from the same state: dt and the
    iterations equal per step, the fields within the contract."""
    prm, jprm, jstate = _small(name)
    carry, jcarry = _port_state(jstate), jstate
    if order == 2:
        carry, jcarry = solver.ab2_init(carry), jsolver.ab2_init(jcarry)
    fn = solver.step if order == 1 else solver.step_ab2
    jfn = jax.jit(lambda c: (jsolver.step if order == 1 else
                             jsolver.step_ab2)(c, jprm,
                                               pressure_method=method))
    for _ in range(3):
        carry, diag = fn(carry, prm, pressure_method=method)
        jcarry, jdiag = jfn(jcarry)
        assert diag.sor_iterations == int(jdiag.sor_iterations)
        assert diag.sor_converged == bool(jdiag.sor_converged)
        assert float(diag.dt) == pytest.approx(float(jdiag.dt), rel=1e-6)
    if order == 2:
        carry, jcarry = carry.s, jcarry.s
    _assert_fields_close(carry, jcarry)


@pytest.mark.parametrize("name,method,order", [
    ("step 32x8", "rb_sor", 1), ("square 2", "mg", 2)])
def test_solve(name, method, order):
    """solver.solve against the JAX solve to T: equal steps, iteration
    totals and failures, fields within the contract."""
    prm, jprm, jstate = _small(name)
    got, stats = solver.solve(prm, _port_state(jstate), pressure_method=method,
                              time_order=order)
    solve = jsolver.solve if order == 1 else jsolver.solve_ab2
    want, js = solve(jprm, jstate, pressure_method=method)
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(js.steps), int(js.total_sor_iterations), int(js.sor_failures))
    _assert_fields_close(got, want)


def test_reattachment_length():
    """models/step.py's reattachment length of a field, both packages."""
    prm, jprm = _model("step 64x16")
    (u,) = _fields(prm.shape, seed=8, n=1)
    u[17:, 1] = np.abs(u[17:, 1])
    u[17:30, 1] = -1.0
    assert step.reattachment_length(torch.from_numpy(u), prm) == \
        jstep.reattachment_length(jnp.asarray(u), jprm) > 0


# --- the CLI ----------------------------------------------------------------------

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _small_channel(tmp_path):
    path = str(tmp_path / "c.in")
    JaxParams(problem=3, i_max=32, j_max=16, a=2.0, b=1.0, T=0.05, Re=10.0,
              tau=0.5, omega=1.7, epsilon=1e-4, max_it=20000).to_file(path)
    return path


@pytest.mark.parametrize("extra", [[], ["--method", "mg"]],
                         ids=["rb_sor", "mg"])
def test_cli_obstacle_matches_jax_cli(extra, tmp_path):
    """--obstacle on a 32 x 16 channel, 3 steps: the JAX CLI's stats and
    centre values (the contract)."""
    argv = [_small_channel(tmp_path), "--obstacle", "5:8:4:9", "--obstacle",
            "14:16:10:12", "--max-steps", "3", "--stats", *extra]
    rc, out, err = _cli(cli.main, [*argv, "--device", "cpu"])
    jrc, jout, jerr = _cli(jcli.main, argv)
    assert rc == jrc == 3
    stats = err.splitlines()[0].split()[:3]
    assert stats == jerr.splitlines()[0].split()[:3]
    for line, jline in zip(out.splitlines(), jout.splitlines()):
        assert line.split()[0] == jline.split()[0]
        assert abs(float(line.split()[1]) - float(jline.split()[1])) <= 1e-4


@pytest.mark.parametrize("spec", ["1:2:3", "a:2:3:4"])
def test_cli_obstacle_parse_errors(spec, tmp_path):
    path = _small_channel(tmp_path)
    rc, out, err = _cli(cli.main, [path, "--obstacle", spec, "--device",
                                   "cpu"])
    jrc, jout, jerr = _cli(jcli.main, [path, "--obstacle", spec])
    assert rc == jrc == 1 and out == jout == "" and err == jerr
