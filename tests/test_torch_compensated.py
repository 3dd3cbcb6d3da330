"""The port's compensated (two-float f32) refinement outer against the JAX
package's: ops/compensated.py and ``Params.outer_precision =
"compensated"`` in ops/sor.py.

The error-free transformations are exact (checked in f64, which holds
any single f32 operation's exact result) and equal to JAX's bit for bit;
the compensated defect meets tests/test_compensated.py's error model at
2048^2-scale amplification; whole solves through the compensated outer
give the JAX package's compensated solve (equal counts: the f32 norms
could differ by one K-quantum within the f32 sum's rounding of a
threshold, and here do not) and the port's f64 outer's counts, with the
fields within the 1e-4 contract, for every inner stage and for f64
states.  The sharded outer runs on four gloo ranks in
tests/test_torch_sharded.py (METHOD_CASES "compensated_*") and on one
rank in its test_unported_sharded_branches_raise; the CLI's flag in
tests/test_torch_protocol.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import compensated as jcomp
from navierstokes_parallel_tpu.ops import fft as jfft
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.ops import compensated as comp
from navierstokes_parallel_tpu_torch.ops import sor
from navierstokes_parallel_tpu_torch.ops.stencils import l2_norm

from conftest import assert_close_reference_contract

F32, F64 = torch.float32, torch.float64


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    # Mixed scales: the identities hold whatever the alignment.
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).astype(
        np.float32)
    return a, b


def test_eft_primitives_exact_and_equal_to_jax():
    a, b = _pairs(4096, 0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    wide = a.astype(np.float64), b.astype(np.float64)
    for name, exact in (("two_sum", wide[0] + wide[1]),
                        ("two_prod", wide[0] * wide[1])):
        x, e = getattr(comp, name)(ta, tb)
        assert x.dtype == e.dtype == F32
        np.testing.assert_array_equal(
            x.numpy().astype(np.float64) + e.numpy().astype(np.float64),
            exact)
        jx, je = getattr(jcomp, name)(jnp.asarray(a), jnp.asarray(b))
        assert np.array_equal(x.numpy(), np.asarray(jx))
        assert np.array_equal(e.numpy(), np.asarray(je))
    # quick_two_sum needs |a| >= |b|; split halves the mantissa exactly.
    big, small = np.maximum(np.abs(a), np.abs(b)), np.minimum(np.abs(a),
                                                              np.abs(b))
    s, e = comp.quick_two_sum(torch.from_numpy(big), torch.from_numpy(small))
    np.testing.assert_array_equal(
        s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
        big.astype(np.float64) + small)
    hi, lo = comp.split(ta)
    np.testing.assert_array_equal(
        hi.numpy().astype(np.float64) + lo.numpy().astype(np.float64),
        wide[0])
    assert np.array_equal(np.asarray(jcomp.split(jnp.asarray(a))[0]),
                          hi.numpy())


def test_df_add_normalized():
    """hi is the correctly rounded f32 of the exact sum, |lo| <= ulp/2."""
    rng = np.random.default_rng(1)
    hi = rng.standard_normal(1024).astype(np.float32)
    lo = (rng.standard_normal(1024) * 1e-8).astype(np.float32)
    x = (rng.standard_normal(1024) * 1e-3).astype(np.float32)
    h2, l2 = comp.df_add_f32(*(torch.from_numpy(y) for y in (hi, lo, x)))
    exact = hi.astype(np.float64) + lo + x.astype(np.float64)
    np.testing.assert_array_equal(h2.numpy(), np.float32(exact))
    assert np.all(np.abs(l2.numpy()) <=
                  np.spacing(np.abs(h2.numpy())) / 2 + 1e-45)


def _smooth_pair(n=64, seed=0):
    """tests/test_compensated.py's field: a smooth near-converged pressure
    at dx = 1/2048 (1/dx^2 ~ 4e6) as an f32 pair, and 1/dx^2 in f32."""
    phys = n / 2048.0
    params = JaxParams(i_max=n, j_max=n, a=phys, b=phys)
    dx2 = np.float32(1.0 / (params.dx * params.dx))
    x = (np.arange(n + 2) - 0.5) * params.dx
    X, Y = np.meshgrid(x, x, indexing="ij")
    p64 = np.sin(2 * np.pi * X / phys) * np.cos(2 * np.pi * Y / phys) * 3.0
    hi = np.float32(p64)
    lo = np.float32(p64 - np.float64(hi))
    pair64 = np.float64(hi) + np.float64(lo)
    lap = np.asarray(jsor.residual(jnp.asarray(pair64), jnp.zeros((n, n)),
                                   np.float64(dx2), np.float64(dx2)))
    return p64, hi, lo, pair64, dx2, lap, np.random.default_rng(seed)


def test_residual_df_matches_f64_and_jax_at_high_amplification():
    p64, hi, lo, pair64, dx2, lap, rng = _smooth_pair()
    n = hi.shape[0] - 2
    rhs32 = np.float32(lap + 1e-4 * rng.standard_normal((n, n)))
    r64 = sor.residual(torch.from_numpy(pair64),
                       torch.from_numpy(np.float64(rhs32)),
                       float(dx2), float(dx2)).numpy()
    rdf = comp.residual_df(torch.from_numpy(hi), torch.from_numpy(lo),
                           torch.from_numpy(rhs32), dx2, dx2).numpy()
    eps = np.float64(np.finfo(np.float32).eps)
    bound = (32 * eps ** 2 * np.abs(p64).max() * np.float64(dx2)
             + 8 * eps * np.abs(r64).max())
    assert np.abs(rdf - r64).max() <= bound
    r32 = sor.residual(torch.from_numpy(hi), torch.from_numpy(rhs32),
                       dx2, dx2).numpy()
    assert np.abs(r32 - r64).max() > 100 * np.abs(rdf - r64).max()
    want = np.asarray(jcomp.residual_df(jnp.asarray(hi), jnp.asarray(lo),
                                        jnp.asarray(rhs32), dx2, dx2))
    np.testing.assert_array_equal(rdf, want)


def test_residual_df_float64_rhs_split():
    """The rhs_lo word recovers the full-precision defect of an f64 rhs."""
    p64, hi, lo, pair64, dx2, lap, rng = _smooth_pair(seed=2)
    n = hi.shape[0] - 2
    rhs64 = lap + 1e-4 * rng.standard_normal((n, n))
    rhs_hi = np.float32(rhs64)
    rhs_lo = np.float32(rhs64 - np.float64(rhs_hi))
    r64 = sor.residual(torch.from_numpy(pair64), torch.from_numpy(rhs64),
                       float(dx2), float(dx2)).numpy()
    args = (torch.from_numpy(hi), torch.from_numpy(lo),
            torch.from_numpy(rhs_hi), dx2, dx2)
    err_with = np.abs(comp.residual_df(
        *args, rhs_lo=torch.from_numpy(rhs_lo)).numpy() - r64).max()
    err_without = np.abs(comp.residual_df(*args).numpy() - r64).max()
    assert err_with < 0.1 * np.abs(r64).max()
    assert err_without > 10 * err_with


def _solve_both(method, jax_method=None, **kw):
    fields = dict(i_max=32, j_max=32, T=0.05, Re=1000.0, tau=0.5, omega=1.7,
                  epsilon=1e-4, max_it=3000, dtype="float32",
                  sor_refine_every=64)
    fields.update(kw)
    ref = JaxParams(**fields, outer_precision="compensated")
    prm = Params.from_mapping(dataclasses.asdict(ref))
    got, stats = solver.solve(prm, device="cpu", pressure_method=method)
    want, jstats = jsolver.solve(ref, pressure_method=jax_method or method)
    f64, f64_stats = solver.solve(prm.replace(outer_precision="float64"),
                                  device="cpu", pressure_method=method)
    return (got, stats), (want, jstats), (f64, f64_stats)


def _check(got, want, f64, jax_quantum=0):
    """Equal steps and failures; the port's f64 outer's count exactly, and
    JAX's within `jax_quantum` passes per step (0: exactly)."""
    (state, stats), (jstate, jstats), (f64_state, f64_stats) = got, want, f64
    assert stats.sor_failures == int(jstats.sor_failures) == 0
    assert stats.steps == int(jstats.steps) == f64_stats.steps
    assert stats.total_sor_iterations == f64_stats.total_sor_iterations
    assert abs(stats.total_sor_iterations
               - int(jstats.total_sor_iterations)) <= jax_quantum * stats.steps
    for name in ("u", "v"):
        x = getattr(state, name).numpy()
        assert_close_reference_contract(x, np.asarray(getattr(jstate, name)))
        assert_close_reference_contract(x, getattr(f64_state, name).numpy())


@pytest.mark.parametrize("method", ["rb_sor", "pallas_sor", "mg", "fft",
                                    "cg"])
def test_solve_parity_with_jax_and_the_f64_outer(method):
    """A 32^2 cavity (tests/test_compensated.py's), every outer-wrapped
    method: the rb_sor / pallas_sor kernel route's plain twin, the V-cycle,
    the DCT solve and CG (JAX's pallas_sor solve here is its rb_sor: the
    same sweeps)."""
    _check(*_solve_both(method, "rb_sor" if method == "pallas_sor"
                        else method))


@pytest.mark.parametrize("method", ["mg", "fft"])
def test_solve_parity_float64_state(method, monkeypatch):
    """f64 states split their p and rhs into (hi, lo) words.  By fft JAX
    is held to its rfft DCT route, the one the port ports: below 512^2 its
    CPU run would take the dense-matrix route (ops/fft.py::
    _pick_transform_route), which the port leaves out and whose one f32
    solve leaves the impulsive first step's defect at 1.086 of the
    threshold (a second solve) where the rfft route's, like the port's,
    is at 0.47-0.48 of it, under the f64 outer as under the compensated
    one.  Counts exact.  JAX's caches are cleared first: its own
    tests/test_compensated.py traces these very Params on the CPU's
    default route, and a test process that ran it before would reuse that
    trace whatever PREFER_RFFT says."""
    monkeypatch.setattr(jfft, "PREFER_RFFT", True)
    jax.clear_caches()
    got, want, f64 = _solve_both(method, T=0.02, Re=100.0, max_it=2000,
                                 dtype="float64", sor_refine_every=64)
    _check(got, want, f64)


def test_first_dct_solve_margins_of_the_transform_routes(monkeypatch):
    """What the case above rests on, read: the impulsive first step's
    pressure problem (the port's rhs, given to both), one DCT solve, its
    defect's L2 norm against the threshold eps (||p0|| + 1.5), under both
    outers.  The port's and JAX's rfft route land under the threshold
    (one solve), JAX's dense-matrix route above it (two).  Prints the
    relative margins."""
    fields = dict(i_max=32, j_max=32, T=0.02, Re=100.0, tau=0.5, omega=1.7,
                  epsilon=1e-4, max_it=2000, dtype="float64",
                  sor_refine_every=64)
    for outer in ("compensated", "float64"):
        ref = JaxParams(**fields, outer_precision=outer)
        prm = Params.from_mapping(dataclasses.asdict(ref))
        seen = []
        real = sor.solve_pressure

        def spy(p, rhs, params, **kw):
            seen.append((p, rhs))
            return real(p, rhs, params, **kw)

        monkeypatch.setattr(sor, "solve_pressure", spy)
        solver.step(allocate_state(prm, "cpu"), prm, pressure_method="fft")
        monkeypatch.setattr(sor, "solve_pressure", real)
        p0, rhs = seen[0]
        threshold = prm.epsilon * (float(l2_norm(
            p0[1:-1, 1:-1], prm.i_max, prm.j_max)) + sor.NORM_OFFSET)
        one = dict(max_it=1)
        port = sor.solve_pressure(p0, rhs, prm.replace(**one), method="fft")
        margins = {"port": port.res_norm / threshold - 1}
        for route, prefer in (("JAX rfft", True), ("JAX matmul", False)):
            monkeypatch.setattr(jfft, "PREFER_RFFT", prefer)
            got = jsor.solve_pressure(jnp.asarray(p0.numpy()),
                                      jnp.asarray(rhs.numpy()),
                                      dataclasses.replace(ref, **one),
                                      method="fft")
            margins[route] = float(got.res_norm) / threshold - 1
        print(f"first DCT solve, {outer} outer: (norm - threshold) / "
              f"threshold {margins}")
        assert margins["port"] < 0 and margins["JAX rfft"] < 0
        assert margins["JAX matmul"] > 0


def test_channel_deflation_and_f64_split_in_the_outer():
    """Problem 3: every compensated defect loses its mean, as JAX's does;
    and one solve of an f64 problem returns the ~48-bit pair, not its hi
    word (its p differs from the f32-rounded master)."""
    got, want, f64 = _solve_both("mg", problem=3, i_max=32, j_max=16,
                                 a=2.0, b=1.0, Re=10.0, T=0.1)
    _check(got, want, f64)
    prm = Params(i_max=12, j_max=10, epsilon=1e-6, max_it=2000,
                 dtype="float64", outer_precision="compensated")
    rng = np.random.default_rng(4)
    rhs = torch.zeros(prm.shape, dtype=F64)
    rhs[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((12, 10)))
    rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
    res = sor.solve_pressure(torch.zeros(prm.shape, dtype=F64), rhs, prm,
                             method="mg")
    assert res.converged and res.p.dtype == F64
    assert not torch.equal(res.p, res.p.to(F32).to(F64))
