"""Port SOR sweeps and pressure solve vs the JAX package.

The sweep kernel's plain twin is held against the Pallas kernel
(``sor_kernel.inner_sweeps``, interpret mode on the CPU) to 1e-6 of
max|delta|: both round each f32 operation once in the same order (measured
<= 6e-7 at n = 13).  Against the XLA formulation (``_roll_sweeps_xla``) the
bound is 3e-6: XLA's fused loop rounds differently, and the JAX
package's two formulations already differ from each other by up to 1.6e-6
here.  The refined pressure solve is held to the reference contract (1e-4)
with equal iteration counts and convergence flags.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu.ops.pallas import sor_kernel as jsk
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import sor
from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

from conftest import assert_close_reference_contract

SWEEP_TOL = {"pallas": 1e-6, "xla": 3e-6}  # relative to max|delta|


def _params(i_max, j_max, **kw):
    ref = JaxParams(i_max=i_max, j_max=j_max, a=1.0, b=0.8, omega=1.7,
                    dtype="float32", **kw)
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _rhs(i_max, j_max, seed=0, zero_mean=False):
    rng = np.random.default_rng(seed)
    rhs = np.zeros((i_max + 2, j_max + 2), np.float32)
    inner = rng.standard_normal((i_max, j_max))
    if zero_mean:  # compatible with the Neumann problem
        inner -= inner.mean()
    rhs[1:-1, 1:-1] = inner
    return rhs


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("shape", [(16, 16), (13, 9), (24, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_inner_sweeps_plain_matches_jax(shape, n):
    prm, ref = _params(*shape)
    rhs = _rhs(*shape, seed=n)
    got = sor_kernel.inner_sweeps_plain(torch.from_numpy(rhs), n, prm).numpy()
    kern = np.asarray(jsk.inner_sweeps(jnp.asarray(rhs), n, ref))
    xla = np.asarray(jsk._roll_sweeps_xla(jnp.asarray(rhs), n, ref))
    scale = float(np.max(np.abs(kern)))
    assert scale > 0
    for name, want in (("pallas", kern), ("xla", xla)):
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=SWEEP_TOL[name])
    # The ghost ring is never written: it stays 0.
    assert not got[0].any() and not got[-1].any()
    assert not got[:, 0].any() and not got[:, -1].any()


def test_inner_sweeps_cpu_dispatches_to_plain():
    prm, _ = _params(10, 7)
    rhs = torch.from_numpy(_rhs(10, 7))
    before = sor_kernel.LAUNCHES
    got = sor_kernel.inner_sweeps(rhs, 5, prm)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, 5, prm))
    assert sor_kernel.LAUNCHES == before  # no kernel launched
    assert not sor_kernel.inner_sweeps(rhs, 0, prm).any()


def test_ghost_fill_and_residual():
    prm, ref = _params(9, 6)
    rng = np.random.default_rng(3)
    p = rng.standard_normal(prm.shape)
    rhs_int = rng.standard_normal((9, 6))
    tp = torch.from_numpy(p.copy())
    assert sor.ghost_fill(tp) is tp  # in place
    want = np.asarray(jsor.ghost_fill(jnp.asarray(p)))
    np.testing.assert_array_equal(tp.numpy(), want)
    dx2, dy2 = 1.0 / prm.dx ** 2, 1.0 / prm.dy ** 2
    got = sor.residual(tp, torch.from_numpy(rhs_int), dx2, dy2)
    want_r = jsor.residual(jnp.asarray(want), jnp.asarray(rhs_int), dx2, dy2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_r), rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("case", ["converges", "max_it"])
@pytest.mark.parametrize("shape", [(16, 16), (13, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_solve_pressure_matches_jax(shape, case):
    max_it = 3000 if case == "converges" else 40
    prm, ref = _params(*shape, epsilon=1e-4, max_it=max_it,
                       sor_refine_every=32)
    rng = np.random.default_rng(4)
    p0 = (0.1 * rng.standard_normal(prm.shape)).astype(np.float32)
    rhs = _rhs(*shape, seed=5, zero_mean=True)
    got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                             prm, method="pallas_sor")
    want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                               method="pallas_sor")
    assert got.p.dtype == torch.float32
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged) == (case == "converges")
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))
    assert got.res_norm == pytest.approx(float(want.res_norm), rel=1e-4)


def test_rb_sor_takes_the_refined_route():
    prm, _ = _params(12, 12, max_it=2000)
    rhs = torch.from_numpy(_rhs(12, 12, seed=6, zero_mean=True))
    p0 = torch.zeros(prm.shape)
    a = sor.solve_pressure(p0, rhs, prm, method="rb_sor")
    b = sor.solve_pressure(p0, rhs, prm, method="pallas_sor")
    assert a.iterations == b.iterations and a.converged
    assert torch.equal(a.p, b.p)


@pytest.mark.parametrize("method", sorted(sor.NOT_PORTED))
def test_unported_methods_raise(method):
    prm, _ = _params(8, 8)
    z = torch.zeros(prm.shape)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sor.solve_pressure(z, z, prm, method=method)


@pytest.mark.parametrize("case", ["float64_direct", "refine_off",
                                  "compensated", "problem3"])
def test_unported_routes_raise(case):
    prm, _ = _params(8, 8)
    z = torch.zeros(prm.shape)
    if case == "float64_direct":
        z = z.double()
    elif case == "refine_off":
        prm = prm.replace(sor_refine_every=0)
    elif case == "compensated":
        prm = prm.replace(outer_precision="compensated")
    else:
        prm = prm.replace(problem=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sor.solve_pressure(z, z, prm, method="rb_sor")


def test_unknown_method_and_default_method():
    prm, _ = _params(8, 8)
    z = torch.zeros(prm.shape)
    with pytest.raises(ValueError):
        sor.solve_pressure(z, z, prm, method="nope")
    assert sor.default_method(prm, "cpu") == "rb_sor"
    assert sor.default_method(prm, "cuda") == "pallas_sor"
