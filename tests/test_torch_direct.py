"""The port's direct (unrefined) pressure solve and Jacobi vs the JAX package.

The direct solve is the reference algorithm in the state's dtype with the
residual checked after every sweep: the f64 state's route and the
``sor_refine_every = 0`` route.  Same inputs, made with numpy from a seed,
go through both packages on the CPU (JAX with x64, tests/conftest.py).

Tolerances and why:
  * f64 direct solves: equal sweep counts and flags, p within 1e-12 of
    max|p| and the residual norm within 1e-9 relative (XLA's CPU code
    contracts a*b+c into FMAs, the port does not: measured <= 6e-17 in p);
  * f32 solves (refinement off, and Jacobi's refined route): equal counts,
    fields within the reference contract (1e-4);
  * the chunked residual check against a loop that reads the norm after
    every sweep: bit for bit, counts and norms equal;
  * whole solves and the CLI: equal steps, counts and failures, fields and
    centre values within the contract.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import sor

from conftest import assert_close_reference_contract

SHAPES = [(8, 8), (16, 12), (17, 9)]
F64_P_TOL = 1e-12    # of max|p|
F64_RES_RTOL = 1e-9


def _params(i_max, j_max, **kw):
    ref = JaxParams(i_max=i_max, j_max=j_max, a=1.0, b=0.8,
                    **{"omega": 1.7, "dtype": "float64", "epsilon": 1e-6,
                       "max_it": 3000, **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _inputs(shape, dtype=np.float64, seed=0):
    """(p0, a zero-mean rhs), padded."""
    rng = np.random.default_rng(seed)
    p0 = 0.1 * rng.standard_normal((shape[0] + 2, shape[1] + 2))
    rhs = np.zeros_like(p0)
    inner = rng.standard_normal(shape)
    rhs[1:-1, 1:-1] = inner - inner.mean()
    return p0.astype(dtype), rhs.astype(dtype)


def _both(prm, ref, p0, rhs, method):
    """(port result, JAX result) of solve_pressure, warnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                                 prm, method=method)
        want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                                   method=method)
    return got, want


@pytest.mark.parametrize("method", ["rb_sor", "jacobi"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_direct_f64_matches_jax(shape, method):
    prm, ref = _params(*shape)
    got, want = _both(prm, ref, *_inputs(shape), method)
    assert got.p.dtype == torch.float64
    assert got.iterations == int(want.iterations) > 0
    assert got.converged and bool(want.converged)
    want_p = np.asarray(want.p)
    scale = float(np.max(np.abs(want_p)))
    np.testing.assert_allclose(got.p.numpy() / scale, want_p / scale,
                               rtol=0, atol=F64_P_TOL)
    assert got.res_norm == pytest.approx(float(want.res_norm),
                                         rel=F64_RES_RTOL)


@pytest.mark.parametrize("case", ["f32_refine_off", "f64_max_it"])
def test_direct_routes_match_jax(case):
    """The f32 state with the refinement off, and an f64 solve that runs
    into max_it (not converged, max_it sweeps)."""
    if case == "f32_refine_off":
        prm, ref = _params(16, 12, dtype="float32", sor_refine_every=0,
                           epsilon=1e-4)
        dtype = np.float32
    else:
        prm, ref = _params(16, 12, max_it=37)
        dtype = np.float64
    got, want = _both(prm, ref, *_inputs((16, 12), dtype, seed=1), "rb_sor")
    assert got.p.dtype == (torch.float32 if dtype == np.float32
                           else torch.float64)
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged) == (case != "f64_max_it")
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("method", ["rb_sor", "jacobi"])
def test_one_iteration_matches_jax(method, parity):
    """rb_sor_iteration and jacobi_iteration, f64, on a block of either
    parity: within 1e-13 of max|p| (XLA's FMA contraction).  The port's
    functions work in place, so they get a copy of p."""
    prm, _ = _params(17, 9)
    p0, rhs = _inputs((17, 9), seed=4)
    consts = (prm.omega, 1.0 / prm.dx ** 2, 1.0 / prm.dy ** 2)
    masks = [(sor._checkerboard((17, 9), c, parity),
              jsor._checkerboard((17, 9), c, parity)) for c in (0, 1)]
    if method == "rb_sor":
        got = sor.rb_sor_iteration(torch.tensor(p0),
                                   torch.from_numpy(rhs[1:-1, 1:-1]), *consts,
                                   *(m[0] for m in masks))
        want = jsor.rb_sor_iteration(jnp.asarray(p0),
                                     jnp.asarray(rhs[1:-1, 1:-1]), *consts,
                                     *(m[1] for m in masks))
    else:
        got = sor.jacobi_iteration(torch.tensor(p0),
                                   torch.from_numpy(rhs[1:-1, 1:-1]), *consts)
        want = jsor.jacobi_iteration(jnp.asarray(p0),
                                     jnp.asarray(rhs[1:-1, 1:-1]), *consts)
    for a, b in masks:
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=1e-13)


def _per_sweep_loop(p, rhs, prm, method):
    """The direct solve as the JAX while_loop runs it: read the norm after
    every sweep."""
    dtype = p.dtype
    omega, dx2, dy2 = (torch.tensor(x, dtype=dtype) for x in (
        prm.omega, 1.0 / prm.dx ** 2, 1.0 / prm.dy ** 2))
    shape = (p.shape[0] - 2, p.shape[1] - 2)
    red, black = (sor._checkerboard(shape, c) for c in (0, 1))
    it = sor._make_iteration(method, rhs[1:-1, 1:-1], omega, dx2, dy2, red,
                             black)
    p = p.clone()
    threshold = float(prm.epsilon * (sor.l2_norm(p[1:-1, 1:-1], *shape)
                                     + sor.NORM_OFFSET))
    n, res = 0, float("inf")
    while n < prm.max_it and res > threshold:
        p = it(p)
        res = float(sor.l2_norm(sor.residual(p, rhs[1:-1, 1:-1], dx2, dy2),
                                *shape))
        n += 1
    return sor.ghost_fill(p), n, res


@pytest.mark.parametrize("chunk", [1, sor.DIRECT_CHUNK, 7],
                         ids=["per_sweep", "default", "odd"])
@pytest.mark.parametrize("case", ["converges", "max_it", "jacobi"])
def test_chunked_check_equals_per_sweep_loop(case, chunk):
    """Whatever the chunk size, the direct solve stops at the sweep the
    per-sweep loop stops at, with the same bits."""
    max_it = 45 if case == "max_it" else 3000
    method = "jacobi" if case == "jacobi" else "rb_sor"
    prm, _ = _params(17, 9, max_it=max_it, omega=0.8 if case == "jacobi"
                     else 1.7)
    p0, rhs = (torch.from_numpy(a) for a in _inputs((17, 9), seed=2))
    got = sor._solve_pressure_direct(p0, rhs, prm, method=method,
                                     chunk=chunk)
    want_p, want_n, want_res = _per_sweep_loop(p0, rhs, prm, method)
    assert got.iterations == want_n
    assert (want_n == max_it) == (case == "max_it")
    assert got.res_norm == want_res
    assert torch.equal(got.p, want_p)


def test_direct_solve_leaves_its_input_alone():
    prm, _ = _params(8, 8)
    p0, rhs = (torch.from_numpy(a) for a in _inputs((8, 8)))
    before = p0.clone()
    sor.solve_pressure(p0, rhs, prm)
    assert torch.equal(p0, before)
    one = sor.solve_pressure(p0, rhs, prm.replace(max_it=1))
    assert one.iterations == 1 and not one.converged


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_clamps_omega_and_matches_jax(dtype):
    """omega > 1 is clamped to 0.8 with a warning; f32 takes the refined
    route with the plain Jacobi inner, f64 the direct solve."""
    prm, ref = _params(16, 12, dtype=dtype, epsilon=1e-4, max_it=4000,
                       sor_refine_every=64)
    np_dtype = np.float32 if dtype == "float32" else np.float64
    p0, rhs = _inputs((16, 12), np_dtype, seed=3)
    with pytest.warns(UserWarning, match="clamping to 0.8"):
        got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                                 prm, method="jacobi")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                                   method="jacobi")
        damped = sor.solve_pressure(torch.from_numpy(p0),
                                    torch.from_numpy(rhs),
                                    prm.replace(omega=0.8), method="jacobi")
    assert got.iterations == int(want.iterations) == damped.iterations
    assert got.converged and bool(want.converged)
    assert torch.equal(got.p, damped.p)
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))


def test_shard_hooks_refused_by_single_device_methods():
    prm, _ = _params(8, 8, dtype="float32")
    z = torch.zeros(prm.shape)
    for method in ("mg", "cg", "fft", "pallas_sor"):
        with pytest.raises(ValueError, match="single-device"):
            sor.solve_pressure(z, z, prm, method=method,
                               ghost_fn=sor.ghost_fill)


CASES = {
    "16x16": dict(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5),
    "lid2": dict(problem=2, f=3.0, i_max=20, j_max=12, T=0.1, Re=50.0,
                 tau=0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_f64_matches_jax(name):
    """Whole f64 solves: the direct SOR, F/G from the plain formulations."""
    ref = JaxParams(dtype="float64", epsilon=1e-4, omega=1.7, max_it=2000,
                    **CASES[name])
    prm = Params.from_mapping(dataclasses.asdict(ref))
    state, stats = solver.solve(prm, device="cpu", pressure_method="rb_sor")
    jstate, jstats = jsolver.solve(ref, pressure_method="rb_sor")
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(jstats.steps), int(jstats.total_sor_iterations),
        int(jstats.sor_failures))
    assert stats.steps > 1 and state.u.dtype == torch.float64
    for field in ("u", "v", "p"):
        assert_close_reference_contract(getattr(state, field).numpy(),
                                        np.asarray(getattr(jstate, field)))
    assert_close_reference_contract(
        list(solver.center_values(state, prm)),
        list(jsolver.center_values(jstate, ref)))


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


@pytest.mark.parametrize("argv", [["--dtype", "float64"],
                                  ["--method", "jacobi"]],
                         ids=["float64", "jacobi"])
def test_cli_direct_and_jacobi_match_jax_cli(argv, tmp_path, capsys):
    ref = JaxParams(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
                    epsilon=1e-4, omega=1.7, max_it=3000)
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    run = [path, "--device", "cpu", "--stats", *argv]
    if "jacobi" in argv:  # the clamp's warning reaches the user
        with pytest.warns(UserWarning, match="clamping to 0.8"):
            rc, out, err = _run_cli(cli.main, run, capsys)
    else:
        rc, out, err = _run_cli(cli.main, run, capsys)
    jrc, jout, jerr = _run_cli(jcli.main, [path, "--stats", *argv], capsys)
    assert rc == jrc == 0
    got = [float(line.split()[1]) for line in out]
    want = [float(line.split()[1]) for line in jout]
    assert len(got) == len(want) == 2
    assert_close_reference_contract(got, want)
    stats = next(line for line in err if line.startswith("steps="))
    jstats = next(line for line in jerr if line.startswith("steps="))
    assert stats.split()[:3] == jstats.split()[:3]
