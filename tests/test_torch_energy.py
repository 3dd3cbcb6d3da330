"""The port's ops/energy.py vs the JAX package's, on the same numpy inputs
(seeded): the advection stencils, the explicit energy step, the buoyancy
(with its skip of a statically zero coefficient), both heating modes' T
BCs, the obstacle T BCs for adiabatic and isothermal blocks, and the
thermal dt bound.  Copies and reflections are bit for bit; arithmetic
within 1e-6 of the field's scale (XLA's CPU backend contracts a*b+c into
FMAs, PyTorch's does not)."""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import energy

TOL = 1e-6  # relative to max |want|
OBSTACLE = ((5, 8, 4, 7),)


def _params(**kw):
    base = dict(problem=1, i_max=12, j_max=10, a=1.0, b=0.8, Re=118.6782,
                T=1.0)
    return Params(**{**base, **kw})


def _jax(prm):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**dataclasses.asdict(prm))


def _fields(prm, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(prm.shape).astype(np.float32)
            for _ in range(3)]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)


@pytest.mark.parametrize("which", ["duT_dx", "dvT_dy"])
def test_advection_stencils_match_jax(which):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params()
    u, v, T = _fields(prm)
    vel, h = (u, prm.dx) if which == "duT_dx" else (v, prm.dy)
    for gamma in (0.0, 0.7):
        got = getattr(energy, which)(torch.from_numpy(vel),
                                     torch.from_numpy(T), h, gamma)
        want = getattr(jenergy, which)(jnp.asarray(vel), jnp.asarray(T), h,
                                       gamma)
        _close(got.numpy(), want)


def test_advance_temperature_matches_jax():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params()
    u, v, T = _fields(prm, 1)
    dt, gamma, alpha = np.float32(0.013), np.float32(0.4), 1.0 / 84.26
    got = energy.advance_temperature(
        torch.from_numpy(T), torch.from_numpy(u), torch.from_numpy(v),
        torch.tensor(dt), torch.tensor(gamma), prm, alpha)
    want = jenergy.advance_temperature(
        jnp.asarray(T), jnp.asarray(u), jnp.asarray(v), jnp.asarray(dt),
        jnp.asarray(gamma), _jax(prm), alpha)
    _close(got.numpy(), want)
    # The ghost ring is untouched, and the input is not modified.
    assert np.array_equal(got.numpy()[0], T[0])
    assert np.array_equal(np.asarray(want)[0], T[0])


@pytest.mark.parametrize("betas", [(0.0, -1.0), (0.3, -1.0), (0.0, 0.0),
                                   (-0.5, 0.0)],
                         ids=["gy", "gx_gy", "zero", "gx"])
def test_buoyant_fg_matches_jax(betas):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params()
    F, G, T = _fields(prm, 2)
    dt = np.float32(0.02)
    got = energy.buoyant_fg(torch.from_numpy(F), torch.from_numpy(G),
                            torch.from_numpy(T), torch.tensor(dt), *betas)
    want = jenergy.buoyant_fg(jnp.asarray(F), jnp.asarray(G),
                              jnp.asarray(T), jnp.asarray(dt), *betas)
    for g, w, orig, beta in zip(got, want, (F, G), betas):
        _close(g.numpy(), w)
        if beta == 0.0:  # a statically zero coefficient adds nothing
            assert np.array_equal(g.numpy(), orig)


@pytest.mark.parametrize("heating", ["side", "below"])
def test_temperature_bcs_match_jax_exactly(heating):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params()
    T = _fields(prm, 3)[2]
    fn = ("apply_temperature_bcs" if heating == "side"
          else "apply_temperature_bcs_rb")
    got = getattr(energy, fn)(torch.from_numpy(T.copy()), prm, 0.5, -0.5)
    want = getattr(jenergy, fn)(jnp.asarray(T), _jax(prm), 0.5, -0.5)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t_obstacle", [None, 0.5, -0.25],
                         ids=["adiabatic", "isothermal", "isothermal_cold"])
def test_obstacle_temperature_bcs_match_jax(t_obstacle):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params(obstacles=OBSTACLE)
    T = _fields(prm, 4)[2]
    got = energy.apply_obstacle_temperature_bcs(torch.from_numpy(T), prm,
                                                t_obstacle)
    want = jenergy.apply_obstacle_temperature_bcs(jnp.asarray(T), _jax(prm),
                                                  t_obstacle)
    _close(got.numpy(), want)
    # Fluid cells keep their T; the block's boundary cells change.
    fluid = np.ones(prm.shape, bool)
    fluid[5:9, 4:8] = False
    assert np.array_equal(got.numpy()[fluid], T[fluid])
    assert not np.array_equal(got.numpy()[~fluid], T[~fluid])
    # Without obstacles T passes through.
    plain = torch.from_numpy(T)
    assert energy.apply_obstacle_temperature_bcs(plain, _params(),
                                                 t_obstacle) is plain


def test_thermal_dt_limit_matches_jax():
    from navierstokes_parallel_tpu.ops import energy as jenergy

    prm = _params()
    for alpha in (1.0 / 84.26, 0.05):
        assert energy.thermal_dt_limit(prm, alpha) == \
            jenergy.thermal_dt_limit(_jax(prm), alpha)
