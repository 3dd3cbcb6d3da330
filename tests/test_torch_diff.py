"""The port's differentiable path (navierstokes_parallel_tpu_torch/diff.py)
against the JAX package's (navierstokes_parallel_tpu/diff.py).

The same inputs, made with numpy from a seed, go through ``jax.grad`` of
the JAX function and ``backward()`` of the port's: the gradients agree
within rel 1e-6 (measured ~1e-13: both run the same f64 arithmetic to the
same converged solves).  Each port gradient is also held against central
differences of the port's own forward at the JAX tests' bounds
(tests/test_diff.py: rel 1e-5 for the lid, 1e-4 for directional
derivatives), at the JAX tests' sizes (16^2 and smaller, f64, epsilon
1e-9).  The states are symmetry-broken first, as in the JAX tests: on a
kink of the donor-cell |u| both packages return the same subgradient,
but central differences straddle it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import diff as jdiff
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.grid import allocate_state as jax_allocate
from navierstokes_parallel_tpu.models import channel as jchannel
from navierstokes_parallel_tpu.models import convection as jcv
from navierstokes_parallel_tpu.models import step as jbfs
from navierstokes_parallel_tpu_torch import diff, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import State, allocate_state
from navierstokes_parallel_tpu_torch.models import channel, convection as cv
from navierstokes_parallel_tpu_torch.models import step as bfs

F64 = torch.float64
JAX_REL = 1e-6


def _kw(**kw):
    out = dict(problem=1, i_max=16, j_max=16, a=1.0, b=1.0, T=1.0, Re=100.0,
               tau=0.5, omega=1.7, epsilon=1e-9, max_it=20000,
               dtype="float64")
    out.update(kw)
    return out


def _bump(shape, rng, scale):
    out = np.zeros(shape)
    out[1:-1, 1:-1] = scale * rng.standard_normal((shape[0] - 2,
                                                   shape[1] - 2))
    return out


def _state(jstate) -> State:
    """The port's State of a JAX state (through numpy)."""
    return State(*(torch.tensor(np.asarray(x), dtype=F64)
                   for x in jstate[:4]), n=int(jstate.n))


def _energy(final):
    return (final.u[1:-1, 1:-1] ** 2).sum() + (final.v[1:-1, 1:-1] ** 2).sum()


def _port_loss(prm, state, n_steps, method="mg", **kw):
    final, _ = diff.solve_n_steps(prm, state, n_steps, pressure_method=method,
                                  **kw)
    return _energy(final)


def _jax_loss(prm, n_steps, method="mg"):
    def loss(state, controls):
        final, _ = jdiff.solve_n_steps(prm, state, n_steps, controls=controls,
                                       pressure_method=method)
        return _energy(final)
    return loss


def _directional(prm, jprm, jstate, direction, n_steps, method="mg"):
    """(JAX's directional derivative w.r.t. the initial u, the port's, and
    the port's central difference at h = 1e-6)."""
    jloss = _jax_loss(jprm, n_steps, method)
    controls = jdiff.default_controls(jprm)
    g = jax.grad(lambda u0: jloss(jstate._replace(u=u0), controls))(jstate.u)
    want = float(jnp.sum(g * direction))
    base = _state(jstate)
    u0 = base.u.clone().requires_grad_(True)
    _port_loss(prm, base._replace(u=u0), n_steps, method).backward()
    d = torch.from_numpy(direction)
    got = float(torch.sum(u0.grad * d))
    h = 1e-6
    with torch.no_grad():
        fd = (float(_port_loss(prm, base._replace(u=base.u + h * d),
                               n_steps, method))
              - float(_port_loss(prm, base._replace(u=base.u - h * d),
                                 n_steps, method))) / (2 * h)
    return want, got, fd


def test_grad_lid_scale_and_gx_match_jax_and_fd():
    """d(loss)/d(lid_scale) and d(loss)/d(g_x) from rest, as
    test_diff.py::test_grad_matches_fd_lid_scale_and_gx (g_x is absorbed
    by the Neumann pressure: ~0)."""
    jprm, prm = JaxParams(**_kw()), Params(**_kw())
    jloss = _jax_loss(jprm, 3)
    jstate = jax_allocate(jprm)

    def jf(ls, gx):
        c = jdiff.default_controls(jprm)._replace(
            lid_scale=jnp.asarray(ls, jnp.float64),
            g_x=jnp.asarray(gx, jnp.float64))
        return jloss(jstate, c)

    want_ls, want_gx = (float(g) for g in jax.grad(jf, argnums=(0, 1))(
        1.0, 0.0))
    state = allocate_state(prm, "cpu")
    ls = torch.tensor(1.0, dtype=F64, requires_grad=True)
    gx = torch.tensor(0.0, dtype=F64, requires_grad=True)
    controls = diff.Controls(lid_scale=ls, g_x=gx,
                             g_y=torch.tensor(0.0, dtype=F64))
    _port_loss(prm, state, 3, controls=controls).backward()
    assert float(ls.grad) == pytest.approx(want_ls, rel=JAX_REL)
    assert abs(float(gx.grad)) < 1e-6 and abs(want_gx) < 1e-6
    h = 1e-5

    def f(x):
        c = controls._replace(lid_scale=torch.tensor(x, dtype=F64))
        with torch.no_grad():
            return float(_port_loss(prm, state, 3, controls=c))

    fd = (f(1.0 + h) - f(1.0 - h)) / (2 * h)
    assert float(ls.grad) == pytest.approx(fd, rel=1e-5)
    assert abs(float(ls.grad)) > 1e-6


def test_grad_initial_state_matches_jax_and_fd():
    jprm, prm = JaxParams(**_kw()), Params(**_kw())
    jstate = jax_allocate(jprm)
    jstate = jstate._replace(u=jstate.u + _bump(
        jprm.shape, np.random.default_rng(42), 0.05))
    direction = _bump(jprm.shape, np.random.default_rng(7), 1.0)
    want, got, fd = _directional(prm, jprm, jstate, direction, 3)
    assert got == pytest.approx(want, rel=JAX_REL)
    assert got == pytest.approx(fd, rel=1e-4)


def test_grad_channel_initial_state_matches_jax_and_fd():
    """Problem 3: the deflated Neumann solve in both directions."""
    kw = dict(Re=10.0, nx=16, ny=8, T=1.0, dtype="float64", epsilon=1e-9)
    jprm, prm = jchannel.plane_channel(**kw), channel.plane_channel(**kw)
    jstate = jchannel.developed_state(jprm)
    rng = np.random.default_rng(5)
    jstate = jstate._replace(v=jstate.v + _bump(jprm.shape, rng, 0.02))
    direction = _bump(jprm.shape, rng, 1.0)
    want, got, fd = _directional(prm, jprm, jstate, direction, 2)
    assert got == pytest.approx(want, rel=JAX_REL)
    assert got == pytest.approx(fd, rel=1e-4)
    assert abs(got) > 1e-3


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_grad_obstacle_initial_state_matches_jax_and_fd(method):
    """The masked adjoint (_ift_bwd_masked) on a small backward-facing
    step, by each masked solver."""
    kw = dict(Re=50.0, nx=16, ny=8, T=1.0, dtype="float64", epsilon=1e-9)
    jprm, prm = jbfs.backward_facing_step(**kw), bfs.backward_facing_step(**kw)
    rng = np.random.default_rng(11)
    bump = _bump(jprm.shape, rng, 0.02)
    jstate = jax_allocate(jprm)
    jstate = jstate._replace(u=jstate.u + bump, v=jstate.v + bump)
    direction = _bump(jprm.shape, rng, 1.0)
    want, got, fd = _directional(prm, jprm, jstate, direction, 2, method)
    assert got == pytest.approx(want, rel=JAX_REL)
    assert got == pytest.approx(fd, rel=1e-4)
    assert abs(got) > 1e-4


def _thermal_setup(variant):
    name, args, kw = {
        "devahl": ("convection_setup", (1e4,), {}),
        "rb": ("rayleigh_benard_setup", (5e3,), {}),
        "rb_freeslip": ("rayleigh_benard_setup", (5e3,),
                        {"sidewalls": "freeslip"}),
        "mixed": ("mixed_convection_setup", (100.0, 1e4), {}),
        "heated_block": ("heated_block_setup", (1e4,), {"block_frac": 0.3}),
    }[variant]
    kw.update(n=10, dtype="float64", epsilon=1e-9)
    jprm, jcfg = getattr(jcv, name)(*args, **kw)
    prm, cfg = getattr(cv, name)(*args, **kw)
    rng = np.random.default_rng(17)
    bu, bv = _bump(jprm.shape, rng, 0.02), _bump(jprm.shape, rng, 0.02)
    jts = jcv.allocate_thermal(jprm, jcfg)
    jts = jts._replace(u=jts.u + bu, v=jts.v + bv)
    ts = cv.thermal_state_from_numpy(*(np.asarray(x) for x in jts[:4]),
                                     device="cpu", dtype=F64)
    return jprm, jcfg, jts, prm, cfg, ts


def _thermal_loss(final):
    return ((final.u[1:-1, 1:-1] ** 2).sum()
            + (final.T[1:-1, 1:-1] ** 2).sum())


@pytest.mark.parametrize("variant", ["devahl", "rb", "rb_freeslip", "mixed",
                                     "heated_block"])
def test_grad_thermal_wall_temperature_all_variants(variant):
    """d(loss)/d(t_left) for every ThermalConfig family member (heating
    orientation, free-slip sidewalls, the moving lid, the isothermal
    block with the masked adjoint), as test_diff.py's variants."""
    jprm, jcfg, jts, prm, cfg, ts = _thermal_setup(variant)

    def jf(t_left):
        final, _ = jdiff.solve_thermal_n_steps(jprm, jts, 2,
                                               jcfg._replace(t_left=t_left))
        return _thermal_loss(final)

    x0 = float(cfg.t_left)
    want = float(jax.grad(jf)(x0))
    x = torch.tensor(x0, dtype=F64, requires_grad=True)

    def f(t_left):
        final, _ = diff.solve_thermal_n_steps(prm, ts, 2,
                                              cfg._replace(t_left=t_left))
        return _thermal_loss(final)

    f(x).backward()
    got = float(x.grad)
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=JAX_REL)
    h = 1e-5
    with torch.no_grad():
        fd = (float(f(x0 + h)) - float(f(x0 - h))) / (2 * h)
    assert got == pytest.approx(fd, rel=1e-4)


def test_grad_thermal_buoyancy_alpha_and_lid_match_jax():
    """d/d(beta_gy), d/d(alpha) (the energy equation's diffusivity, which
    also sets the thermal dt limit through st.div) and, under mixed
    convection, d/d(lid_u): every traced ThermalConfig field the JAX
    package differentiates, held to jax.grad and to the port's central
    differences."""
    jprm, jcfg, jts, prm, cfg, ts = _thermal_setup("mixed")
    fields = ("beta_gy", "alpha", "lid_u")
    x0 = tuple(float(getattr(cfg, f)) for f in fields)

    def jf(*xs):
        final, _ = jdiff.solve_thermal_n_steps(
            jprm, jts, 2, jcfg._replace(**dict(zip(fields, xs))))
        return jnp.sum(final.v[1:-1, 1:-1] ** 2) + _thermal_loss(final)

    want = [float(g) for g in jax.grad(jf, argnums=(0, 1, 2))(*x0)]

    def f(*xs):
        final, _ = diff.solve_thermal_n_steps(
            prm, ts, 2, cfg._replace(**dict(zip(fields, xs))))
        return (final.v[1:-1, 1:-1] ** 2).sum() + _thermal_loss(final)

    xs = [torch.tensor(x, dtype=F64, requires_grad=True) for x in x0]
    f(*xs).backward()
    for k, (name, x) in enumerate(zip(fields, xs)):
        got = float(x.grad)
        assert got == pytest.approx(want[k], rel=JAX_REL), name
        h = 1e-6 * max(1.0, abs(x0[k]))
        plus, minus = list(x0), list(x0)
        plus[k] += h
        minus[k] -= h
        with torch.no_grad():
            fd = (float(f(*plus)) - float(f(*minus))) / (2 * h)
        assert got == pytest.approx(fd, rel=1e-4), name


def test_pressure_solve_ift_vjp_matches_jax():
    """The adjoint of one solve, unmasked (a cavity) and masked (the
    backward-facing step): the cotangents of rhs and p0 for a random
    output cotangent equal JAX's custom_vjp."""
    cases = [(JaxParams(**_kw(i_max=12, j_max=10)),
              Params(**_kw(i_max=12, j_max=10)))]
    kw = dict(Re=50.0, nx=16, ny=8, T=1.0, dtype="float64", epsilon=1e-9)
    cases.append((jbfs.backward_facing_step(**kw),
                  bfs.backward_facing_step(**kw)))
    for jprm, prm in cases:
        rng = np.random.default_rng(3)
        rhs = _bump(jprm.shape, rng, 1.0)
        rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
        p0 = _bump(jprm.shape, rng, 0.1)
        p_bar = rng.standard_normal(jprm.shape)
        _, vjp = jax.vjp(lambda a, b: jdiff.pressure_solve_ift(
            a, b, jprm, "mg"), jnp.asarray(p0), jnp.asarray(rhs))
        want_p0, want_rhs = (np.asarray(x) for x in vjp(jnp.asarray(p_bar)))
        p0_t = torch.tensor(p0, requires_grad=True)
        rhs_t = torch.tensor(rhs, requires_grad=True)
        diff.pressure_solve_ift(p0_t, rhs_t, prm, "mg").backward(
            torch.from_numpy(p_bar))
        scale = np.abs(want_rhs).max()
        assert scale > 0
        np.testing.assert_allclose(rhs_t.grad.numpy(), want_rhs,
                                   rtol=0, atol=JAX_REL * scale)
        np.testing.assert_allclose(p0_t.grad.numpy(), want_p0, rtol=0,
                                   atol=1e-15)


def test_remat_equals_no_remat_and_recompute_is_exact():
    """Checkpointing changes memory, not values: the gradients with and
    without remat are equal bit for bit, because the recomputed forward
    (the pressure solve included) repeats the same operations."""
    prm = Params(**_kw())
    state = allocate_state(prm, "cpu")

    def grad_of(remat):
        ls = torch.tensor(1.0, dtype=F64, requires_grad=True)
        c = diff.default_controls(prm, "cpu")._replace(lid_scale=ls)
        final, _ = diff.solve_n_steps(prm, state, 2, controls=c, remat=remat)
        (final.u[1:-1, 1:-1] ** 2).sum().backward()
        return float(ls.grad)

    assert grad_of(True) == grad_of(False)
    a, _ = diff.diff_step(state, prm)
    b, _ = diff.diff_step(state, prm)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["cavity", "channel", "box", "obstacle"])
def test_diff_step_forward_equals_solver_step(case):
    """The differentiable forward is the production step's arithmetic: one
    step equals solver.step within 1e-12 (f64), from a perturbed state."""
    if case == "channel":
        prm = channel.plane_channel(Re=10.0, nx=16, ny=8, T=1.0,
                                    dtype="float64", epsilon=1e-9)
    elif case == "box":
        prm = Params(**_kw(problem=4))
    elif case == "obstacle":
        prm = bfs.backward_facing_step(Re=50.0, nx=16, ny=8, T=1.0,
                                       dtype="float64", epsilon=1e-9)
    else:
        prm = Params(**_kw())
    state = allocate_state(prm, "cpu")
    bump = torch.from_numpy(_bump(prm.shape, np.random.default_rng(2), 0.05))
    state = state._replace(u=state.u + bump, v=state.v - bump)
    want, _ = solver.step(state, prm, pressure_method="mg")
    got, dt = diff.diff_step(state, prm, pressure_method="mg")
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=0,
                                   atol=1e-12)
    assert float(got.t) == pytest.approx(float(want.t), rel=1e-12)
    assert float(dt) == float(want.t) and got.n == want.n == 1


def test_diff_thermal_step_forward_equals_thermal_step_and_jax():
    """diff_thermal_step's forward equals the primal thermal_step (mixed
    convection and the heated block, 3 steps) and JAX's diff_thermal_step
    within the JAX test's 1e-8."""
    for variant in ("mixed", "heated_block"):
        jprm, jcfg, jts, prm, cfg, ts = _thermal_setup(variant)
        a, b, c = ts, ts, jts
        for _ in range(3):
            a, _ = cv.thermal_step(a, prm, cfg, pressure_method="mg")
            b, _ = diff.diff_thermal_step(b, prm, cfg, pressure_method="mg")
            c, _ = jdiff.diff_thermal_step(c, jprm, jcfg,
                                           pressure_method="mg")
        for name in ("u", "v", "T"):
            x = getattr(b, name).numpy()
            np.testing.assert_allclose(x, getattr(a, name).numpy(), rtol=0,
                                       atol=1e-8)
            np.testing.assert_allclose(x, np.asarray(getattr(c, name)),
                                       rtol=0, atol=1e-8)


def test_mesh_is_refused_and_the_default_controls():
    """A mesh with a trivial axis is JAX's ValueError, for the isothermal
    and the thermal steps (the mesh gradients themselves:
    tests/test_torch_diff_sharded.py)."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from navierstokes_parallel_tpu_torch.parallel import topology

    prm = Params(**_kw(i_max=8, j_max=8, g_x=0.5))
    state = allocate_state(prm, "cpu")
    mesh = topology.Mesh((1, 4), (0, 0), torch.device("cpu"), None)
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("x", "y"))
    jprm = JaxParams(**_kw(i_max=8, j_max=8, g_x=0.5))
    with pytest.raises(ValueError, match="mesh"):
        jdiff.solve_n_steps(jprm, jax_allocate(jprm), 1, mesh=jmesh)
    with pytest.raises(ValueError, match="1x4 mesh"):
        diff.solve_n_steps(prm, state, 1, mesh=mesh)
    tprm, cfg = cv.convection_setup(1e4, n=8, dtype="float64")
    with pytest.raises(ValueError, match="1x4 mesh"):
        diff.solve_thermal_n_steps(tprm, cv.allocate_thermal(tprm, cfg, "cpu"),
                                   1, cfg, mesh=mesh)
    c = diff.default_controls(prm, "cpu")
    want = jdiff.default_controls(JaxParams(**_kw(i_max=8, j_max=8,
                                                  g_x=0.5)))
    for got, ref in zip(c, want):
        assert got.dtype == F64 and float(got) == float(ref)
    final, dts = diff.solve_n_steps(prm, state, 0)
    assert final is not None and dts.shape == (0,)
    # The JAX package's forward of the same steps (the dt sequence).
    jfinal, jdts = jdiff.solve_n_steps(JaxParams(**_kw(i_max=8, j_max=8,
                                                       g_x=0.5)),
                                       jax_allocate(JaxParams(
                                           **_kw(i_max=8, j_max=8, g_x=0.5))),
                                       2)
    final, dts = diff.solve_n_steps(prm, state, 2)
    np.testing.assert_allclose(dts.numpy(), np.asarray(jdts), rtol=1e-12)
    assert final.n == 2


def test_upwind_abs_is_jnp_abs_with_its_derivative_at_zero():
    """The donor-cell |x| under autograd: the value torch.abs', the
    derivative jnp.abs' (1 at +-0, where torch.abs' is 0)."""
    from navierstokes_parallel_tpu_torch.ops import stencils

    x = np.array([-2.5, -1e-300, -0.0, 0.0, 1e-300, 3.0])
    t = torch.tensor(x, requires_grad=True)
    y = stencils.upwind_abs(t)
    y.sum().backward()
    assert torch.equal(y.detach(), torch.abs(t.detach()))
    want = jax.vmap(jax.grad(jnp.abs))(jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
