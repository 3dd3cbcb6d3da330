"""The port's DCT pressure solve (method="fft") vs the JAX package.

Same inputs, made with numpy from a seed, go through both packages on the
CPU.  The JAX package races two transform routes on the TPU and takes its
dense-matrix route below 512^2 elsewhere; the port runs the real-FFT route
only, so the JAX side is pinned to it (``PREFER_RFFT = True``) where counts
are compared, and held against the matrix route by tolerance.

Tolerances and why:
  * transforms: 1e-6 of max|X| against JAX (both are f32 FFTs, pocketfft
    on both sides, with XLA's FMA contraction in the twiddle products:
    measured <= 1.7e-7), and a round trip within 1e-6 of max|x|;
  * one direct solve: 2e-6 of max|p| against JAX's rfft route (measured
    <= 4e-7), 1e-5 against its matrix route; its residual A p - rhs within
    1e-4 of max|rhs| (f32 transforms);
  * solves: equal solve counts and flags, fields within the reference
    contract (1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import fft as jfft
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import fft, sor

from conftest import assert_close_reference_contract

TRANSFORM_TOL = 1e-6   # of max|X|
SOLVE_TOL = {"rfft": 2e-6, "matmul": 1e-5}  # of max|p|
SHAPES = [(16, 16), (17, 9), (12, 20)]


@pytest.fixture
def jax_rfft(monkeypatch):
    """The JAX package on its real-FFT route, the port's only one."""
    monkeypatch.setattr(jfft, "PREFER_RFFT", True)


def _params(i_max, j_max, **kw):
    ref = JaxParams(i_max=i_max, j_max=j_max, a=1.0, b=0.8,
                    **{"omega": 1.7, "epsilon": 1e-4, "max_it": 100, **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _rhs_int(shape, seed):
    r = np.random.default_rng(seed).standard_normal(shape)
    return (r - r.mean()).astype(np.float32)


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("n", [7, 8, 9, 64, 65])
def test_dct_pair_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    fwd = fft._dct2_rfft(torch.from_numpy(x)).numpy()
    inv = fft._idct2_irfft(torch.from_numpy(x)).numpy()
    assert _rel(fwd, np.asarray(jfft._dct2_rfft(jnp.asarray(x)))) \
        <= TRANSFORM_TOL
    assert _rel(inv, np.asarray(jfft._idct2_irfft(jnp.asarray(x)))) \
        <= TRANSFORM_TOL
    # The orthonormal pair: the inverse undoes the forward, and the forward
    # is the matrix C (k, i) of the JAX package's other route.
    back = fft._idct2_irfft(torch.from_numpy(fwd)).numpy()
    assert _rel(back, x) <= TRANSFORM_TOL
    assert _rel(fwd, x @ jfft._dct_matrix(n).T) <= TRANSFORM_TOL
    assert fft._twiddle(n).dtype == np.complex64


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_poisson_solve_dct_matches_jax(shape, monkeypatch):
    prm, ref = _params(*shape)
    r = _rhs_int(shape, 1)
    got = fft.poisson_solve_dct(torch.from_numpy(r), prm)
    for route in ("rfft", "matmul"):
        monkeypatch.setattr(jfft, "PREFER_RFFT", route == "rfft")
        want = np.asarray(jfft.poisson_solve_dct(jnp.asarray(r), ref))
        assert _rel(got.numpy(), want) <= SOLVE_TOL[route], route
    # It solves A p = rhs (Neumann) with zero mean.
    full = torch.zeros(prm.shape, dtype=torch.float64)
    full[1:-1, 1:-1] = got.double()
    res = sor.residual(sor.ghost_fill(full), torch.from_numpy(r).double(),
                       1.0 / prm.dx ** 2, 1.0 / prm.dy ** 2)
    assert float(res.abs().max()) <= 1e-4 * float(np.abs(r).max())
    assert abs(float(got.double().mean())) <= 1e-6 * float(got.abs().max())


@pytest.mark.parametrize("solves", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_inner_direct_matches_jax(shape, solves, jax_rfft):
    prm, ref = _params(*shape, fft_solves_per_outer=solves)
    full = np.zeros(prm.shape, np.float32)
    full[1:-1, 1:-1] = _rhs_int(shape, 2)
    got = fft.inner_direct(torch.from_numpy(full), solves, prm).numpy()
    want = np.asarray(jfft.inner_direct(jnp.asarray(full), solves, ref))
    assert _rel(got[1:-1, 1:-1], want[1:-1, 1:-1]) <= SOLVE_TOL["rfft"]
    assert got.shape == prm.shape


@pytest.mark.parametrize("solves", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_solve_pressure_fft_matches_jax(shape, solves, jax_rfft):
    """The f64 refinement around the direct solves: iterations count
    direct solves, fft_solves_per_outer per outer pass."""
    prm, ref = _params(*shape, fft_solves_per_outer=solves)
    rng = np.random.default_rng(3)
    p0 = (0.1 * rng.standard_normal(prm.shape)).astype(np.float32)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = _rhs_int(shape, 4)
    got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                             prm, method="fft")
    want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                               method="fft")
    assert got.iterations == int(want.iterations)
    assert got.iterations % solves == 0
    assert got.converged and bool(want.converged)
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))


def test_fft_precision_other_than_highest_is_refused():
    prm, _ = _params(8, 8, fft_precision="high")
    z = torch.zeros(prm.shape)
    with pytest.raises(NotImplementedError, match="Left out"):
        sor.solve_pressure(z, z, prm, method="fft")
    with pytest.raises(NotImplementedError, match="Left out"):
        fft.poisson_solve_dct(z[1:-1, 1:-1], prm)


CASES = {
    "16x16": dict(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5),
    "32x24": dict(i_max=32, j_max=24, T=0.05, Re=100.0, tau=0.5),
    "lid2": dict(problem=2, f=3.0, i_max=20, j_max=12, T=0.1, Re=50.0,
                 tau=0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_fft_matches_jax(name, jax_rfft):
    ref = JaxParams(dtype="float32", epsilon=1e-4, omega=1.7, max_it=2000,
                    **CASES[name])
    prm = Params.from_mapping(dataclasses.asdict(ref))
    state, stats = solver.solve(prm, device="cpu", pressure_method="fft")
    jstate, jstats = jsolver.solve(ref, pressure_method="fft")
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(jstats.steps), int(jstats.total_sor_iterations),
        int(jstats.sor_failures))
    assert stats.steps > 1 and stats.sor_failures == 0
    for field in ("u", "v", "p"):
        assert_close_reference_contract(getattr(state, field).numpy(),
                                        np.asarray(getattr(jstate, field)))
    assert_close_reference_contract(
        list(solver.center_values(state, prm)),
        list(jsolver.center_values(jstate, ref)))


def test_cli_fft_matches_jax_cli(tmp_path, capsys, jax_rfft):
    ref = JaxParams(i_max=24, j_max=24, T=0.05, Re=100.0, tau=0.5,
                    epsilon=1e-4, omega=1.7, max_it=2000)
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    outs = []
    for main, argv in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc = main([path, "--method", "fft", "--stats", *argv])
        cap = capsys.readouterr()
        assert rc == 0
        outs.append((cap.out.splitlines(), cap.err.splitlines()))
    (out, err), (jout, jerr) = outs
    assert_close_reference_contract([float(x.split()[1]) for x in out],
                                    [float(x.split()[1]) for x in jout])
    assert err[0].split()[:3] == jerr[0].split()[:3]
    assert err[0].startswith("steps=3 sor_iterations=3 sor_failures=0")
