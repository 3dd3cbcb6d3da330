"""Port stencils, boundary conditions, momentum and the momentum kernel's
plain twin vs the JAX package (its Pallas kernel in interpret mode).

Inputs come from a seeded numpy generator and go to both packages as numpy
arrays; everything is float32 as on the main path.  Tolerance 1e-6, as
tests/test_momentum_kernel.py holds the Pallas kernel to compute_fg (the
RHS scaled by its max): both packages round each f32 operation once, in
the same order, so they differ at most by XLA's own reassociation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import boundary as jbc
from navierstokes_parallel_tpu.ops import momentum as jmom
from navierstokes_parallel_tpu.ops import stencils as jst
from navierstokes_parallel_tpu.ops.pallas import momentum_kernel as jmk
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import boundary, momentum
from navierstokes_parallel_tpu_torch.ops import stencils as st
from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

TOL = 1e-6
SHAPES = [(24, 24), (20, 13)]  # square and non-square interiors


def _params(i_max, j_max):
    ref = JaxParams(i_max=i_max, j_max=j_max, Re=150.0, g_x=0.3, g_y=-0.2,
                    a=2.0, b=1.0, dtype="float32")
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((shape[0] + 2, shape[1] + 2)).astype(np.float32)
            for _ in range(3)]


def _close(got, want, tol=TOL, scale=1.0):
    np.testing.assert_allclose(np.asarray(got) / scale, np.asarray(want) / scale,
                               rtol=0, atol=tol)


STENCILS_UV = ["du2_dx", "duv_dy", "dv2_dy", "duv_dx"]
STENCILS_X = ["d2_dx2", "d2_dy2", "d2u_dx2", "d2u_dy2", "d2v_dx2", "d2v_dy2",
              "dp_dx", "dp_dy"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", STENCILS_UV)
def test_convective_stencils(name, shape):
    u, v, _ = _fields(shape)
    h, gamma = 0.07, 0.6
    got = getattr(st, name)(torch.from_numpy(u), torch.from_numpy(v), h,
                            torch.tensor(gamma))
    want = getattr(jst, name)(jnp.asarray(u), jnp.asarray(v), h,
                              jnp.float32(gamma))
    assert got.shape == (shape[0], shape[1])
    _close(got, want, scale=float(np.max(np.abs(want))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", STENCILS_X)
def test_derivative_stencils(name, shape):
    x, _, _ = _fields(shape, seed=1)
    got = getattr(st, name)(torch.from_numpy(x), 0.05)
    want = getattr(jst, name)(jnp.asarray(x), 0.05)
    _close(got, want, scale=float(np.max(np.abs(want))))


def test_reductions():
    x, _, _ = _fields((10, 7), seed=2)
    got = st.l2_norm(torch.from_numpy(x[1:-1, 1:-1]), 10, 7)
    want = jst.l2_norm(jnp.asarray(x[1:-1, 1:-1]), 10, 7)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # Signed max seeded with the ghost corner: a corner above every interior
    # value wins; an all-negative interior is not turned into |max|.
    y = -np.abs(x)
    y[0, 0] = -1e-3
    for arr in (x, y):
        assert float(st.max_interior(torch.from_numpy(arr))) == \
            float(jst.max_interior(jnp.asarray(arr)))
    assert float(st.max_interior(torch.from_numpy(y))) == np.float32(-1e-3)


@pytest.mark.parametrize("problem", [1, 2])
def test_cavity_bcs(problem):
    u, v, _ = _fields((9, 6), seed=3)
    t = np.float32(0.37)
    lid = boundary.lid_velocity(problem, 2.5, torch.tensor(t))
    jlid = jbc.lid_velocity(problem, 2.5, jnp.float32(t))
    assert lid.dtype == torch.float32 and float(lid) == float(jlid)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    gu, gv = boundary.apply_cavity_bcs(tu, tv, lid)
    assert gu is tu and gv is tv  # in place
    wu, wv = jbc.apply_cavity_bcs(jnp.asarray(u), jnp.asarray(v), jlid)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("side", list(boundary.Side), ids=lambda s: s.value)
def test_set_inflow_each_side(side):
    u, v, _ = _fields((7, 8), seed=4)
    gu, gv = boundary.set_inflow(torch.from_numpy(u.copy()),
                                 torch.from_numpy(v.copy()), side, 0.5, -0.25)
    wu, wv = jbc.set_inflow(jnp.asarray(u), jnp.asarray(v),
                            jbc.Side(side.value), 0.5, -0.25)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_lid_velocity_rejects_unknown_problem():
    with pytest.raises(ValueError):
        boundary.lid_velocity(3, 1.0, torch.tensor(0.0))


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_fg_rhs_match_jax(shape):
    prm, ref = _params(*shape)
    u, v, _ = _fields(shape, seed=5)
    dt, gamma = np.float32(0.01), np.float32(0.6)
    F, G = momentum.compute_fg(torch.from_numpy(u), torch.from_numpy(v),
                               torch.tensor(dt), torch.tensor(gamma), prm)
    rhs = momentum.compute_rhs(F, G, torch.tensor(dt), prm)
    F0, G0 = jmom.compute_fg(jnp.asarray(u), jnp.asarray(v), jnp.float32(dt),
                             jnp.float32(gamma), ref)
    rhs0 = jmom.compute_rhs(F0, G0, jnp.float32(dt), ref)
    _close(F, F0)
    _close(G, G0)
    _close(rhs, rhs0, scale=float(jnp.max(jnp.abs(rhs0))))


@pytest.mark.parametrize("shape", SHAPES)
def test_momentum_rhs_plain_matches_jax_kernel(shape):
    """The kernel's plain twin vs the Pallas kernel (interpret mode) and vs
    the JAX compute_fg + compute_rhs."""
    prm, ref = _params(*shape)
    u, v, _ = _fields(shape, seed=6)
    dt, gamma = 0.01, 0.6
    got = momentum_kernel.momentum_rhs_plain(torch.from_numpy(u),
                                             torch.from_numpy(v), dt, gamma,
                                             prm)
    kern = jmk.momentum_rhs(jnp.asarray(u), jnp.asarray(v), dt, gamma, ref)
    F0, G0 = jmom.compute_fg(jnp.asarray(u), jnp.asarray(v), dt, gamma, ref)
    xla = (F0, G0, jmom.compute_rhs(F0, G0, dt, ref))
    for want in (kern, xla):
        scale = float(jnp.max(jnp.abs(want[2])))
        _close(got[0], want[0])
        _close(got[1], want[1])
        _close(got[2], want[2], scale=scale)


def test_momentum_rhs_cpu_dispatches_to_plain():
    prm, _ = _params(12, 9)
    u, v, _ = _fields((12, 9), seed=7)
    before = momentum_kernel.LAUNCHES
    got = momentum_kernel.momentum_rhs(torch.from_numpy(u),
                                       torch.from_numpy(v), 0.02, 0.3, prm)
    want = momentum_kernel.momentum_rhs_plain(torch.from_numpy(u),
                                              torch.from_numpy(v), 0.02, 0.3,
                                              prm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert momentum_kernel.LAUNCHES == before  # no kernel launched


@pytest.mark.parametrize("scalars", ["floats", "tensors", "f64_tensors"])
def test_momentum_rhs_cpu_dispatch_takes_floats_and_tensors(scalars):
    """dt and gamma as Python floats, 0-d f32 tensors (what the time step
    passes) or 0-d f64 tensors: the CPU dispatch equals the plain twin on
    the floats and the JAX kernel in interpret mode within TOL."""
    prm, ref = _params(14, 10)
    u, v, _ = _fields((14, 10), seed=11)
    dt, gamma = 0.004, 0.45
    args = {"floats": (dt, gamma),
            "tensors": (torch.tensor(dt), torch.tensor(gamma)),
            "f64_tensors": (torch.tensor(dt, dtype=torch.float64),
                            torch.tensor(gamma, dtype=torch.float64))}
    got = momentum_kernel.momentum_rhs(torch.from_numpy(u),
                                       torch.from_numpy(v), *args[scalars],
                                       prm)
    want = momentum_kernel.momentum_rhs_plain(torch.from_numpy(u),
                                              torch.from_numpy(v), dt, gamma,
                                              prm)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
    kern = jmk.momentum_rhs(jnp.asarray(u), jnp.asarray(v), dt, gamma, ref)
    _close(got[0], kern[0])
    _close(got[1], kern[1])
    _close(got[2], kern[2], scale=float(jnp.max(jnp.abs(kern[2]))))


@pytest.mark.parametrize("x", [0.25, torch.tensor(0.25),
                               torch.tensor(0.25, dtype=torch.float64)],
                         ids=["float", "f32_tensor", "f64_tensor"])
def test_scalar_args_of_the_fused_kernel(x):
    """A Python number or a CPU tensor reaches the kernel by value (f32
    where it meets the kernel's float argument), with no device pointer."""
    assert momentum_kernel._scalar_arg(x, torch.device("cpu")) == (None, 0.25,
                                                                   None)


@pytest.mark.parametrize("shape", SHAPES)
def test_project_velocities(shape):
    prm, ref = _params(*shape)
    u, v, p = _fields(shape, seed=8)
    F, G, _ = _fields(shape, seed=9)
    dt = np.float32(0.01)
    tu, tv = torch.from_numpy(u.copy()), torch.from_numpy(v.copy())
    gu, gv = momentum.project_velocities(tu, tv, torch.from_numpy(F),
                                         torch.from_numpy(G),
                                         torch.from_numpy(p),
                                         torch.tensor(dt), prm)
    assert gu is tu and gv is tv  # in place
    wu, wv = jmom.project_velocities(jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(F), jnp.asarray(G),
                                     jnp.asarray(p), jnp.float32(dt), ref)
    _close(gu, wu)
    _close(gv, wv)


@pytest.mark.parametrize("case", ["random", "zero", "gamma_fixed"])
def test_adaptive_dt_gamma(case):
    prm, ref = _params(16, 11)
    u, v, _ = _fields((16, 11), seed=10)
    if case == "zero":  # zero maxima: dt = +inf terms drop out of the min
        u, v = np.zeros_like(u), np.zeros_like(v)
    if case == "gamma_fixed":
        prm, ref = prm.replace(gamma_fixed=0.25), ref.replace(gamma_fixed=0.25)
    dt, gamma = momentum.adaptive_dt_gamma(torch.from_numpy(u),
                                           torch.from_numpy(v), prm)
    jdt, jgamma = jmom.adaptive_dt_gamma(jnp.asarray(u), jnp.asarray(v), ref)
    assert dt.dtype == torch.float32 and dt.shape == ()
    assert np.isfinite(float(dt))
    assert float(dt) == float(jdt)
    assert float(gamma) == float(jgamma)
