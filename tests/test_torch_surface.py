"""The port's free-surface operators (ops/surface.py) vs the JAX package's.

The same seeded numpy inputs go through both packages' functions,
mirroring the operator half of tests/test_freesurface.py:

  * ``cell_flags`` from particles (inactive ones left out, obstacle cells
    folded out, the fill fractions) and ``classify``: equal masks and
    fill fractions;
  * ``apply_surface_bcs`` on random fields over geometries with one to
    four free faces per surface cell, with and without gravity: the
    surface cells' divergence zero to 1e-12 (JAX's bound), the book's
    one-face rule, bulk cells untouched, and u/v within 1e-12 of JAX's;
  * ``_traced_weights`` (equal in float64), ``interp_coeffs``,
    ``surface_pressure``, ``mask_pressure``, ``fluid_face_masks`` and
    ``pin_fg``: equal;
  * ``solve_pressure_free`` on a layer and a random blob, plain and
    SUMMAC, with and without an explicit surface value, and on an
    obstacle domain: equal iterations and convergence, p within 1e-4 of
    JAX's (the f32 sweeps: XLA contracts a*b+c into FMAs on the CPU), and
    the bulk residual under the contract's threshold.
"""

import dataclasses

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import particles as P
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import masked
from navierstokes_parallel_tpu_torch.ops import surface as surf

EXACT = 1e-12
CONTRACT = 1e-4


def _params(n=16, **kw):
    base = dict(problem=1, i_max=n, j_max=n, a=1.0, b=1.0, T=0.05,
                Re=100.0, tau=0.4, omega=1.7, epsilon=1e-6, max_it=2000,
                dtype="float64")
    base.update(kw)
    return Params(**base)


def _jax_params(prm):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**dataclasses.asdict(prm))


def _padded(fluid_interior):
    fl = np.zeros((fluid_interior.shape[0] + 2,
                   fluid_interior.shape[1] + 2), bool)
    fl[1:-1, 1:-1] = fluid_interior
    return fl


def _flags_pair(fluid_interior):
    """(port Flags, JAX Flags) of a padded mask through ``classify``."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import surface as jsurf

    fl = _padded(fluid_interior)
    return surf.classify(torch.from_numpy(fl)), jsurf.classify(
        jnp.asarray(fl))


def _assert_flags_equal(flags, jflags, fill_tol=0.0):
    for name in ("fluid", "empty", "surface", "bulk"):
        np.testing.assert_array_equal(getattr(flags, name).numpy(),
                                      np.asarray(getattr(jflags, name)),
                                      err_msg=name)
    assert flags.fill.dtype == {np.float32: torch.float32,
                                np.float64: torch.float64}[
        np.asarray(jflags.fill).dtype.type]
    np.testing.assert_allclose(flags.fill.numpy(), np.asarray(jflags.fill),
                               rtol=0, atol=fill_tol)


def _geometry(kind, n=10):
    fl = np.zeros((n, n), bool)
    if kind == "layer_bump_tower":
        fl[:, 0:4] = True          # a layer
        fl[4, 4] = True            # a bump: three empty neighbours
        fl[7:9, 4:7] = True        # a tower: corners with two
    elif kind == "blob":
        rng = np.random.default_rng(9)
        fl = rng.random((n, n)) < 0.6
        fl[:, 0] = True
    elif kind == "single_east":
        fl[:] = True
        fl[3, 2] = False
    return fl


def test_cell_flags_from_particles_as_jax():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu import particles as JP
    from navierstokes_parallel_tpu.ops import surface as jsurf

    prm = _params(n=8)
    jprm = _jax_params(prm)
    pts = [[1.6 / 8, 2.4 / 8], [0.5, 0.99]]
    for active in ([True, True], [False, True]):
        pset = P.init_particles(pts, dtype=torch.float64, device="cpu")
        pset = pset._replace(active=torch.tensor(active))
        jset = JP.init_particles(pts, dtype=jnp.float64)
        jset = JP.ParticleSet(jset.x, jset.y, jnp.asarray(active))
        flags = surf.cell_flags(pset.x, pset.y, pset.active, prm)
        jflags = jsurf.cell_flags(jset.x, jset.y, jset.active, jprm)
        _assert_flags_equal(flags, jflags)
        assert int(flags.fluid.sum()) == sum(active)
    assert bool(flags.fluid[5, 8])


@pytest.mark.parametrize("ppc,obstacle", [(3, False), (6, True)])
def test_cell_flags_of_a_seeded_region_as_jax(ppc, obstacle):
    """A filled region with a ragged top (ppc^2 lattice, seeded random
    deactivations), with an obstacle block folded out: equal flags and
    fill fractions (exact: the counts are integers)."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.models import freesurface as JF
    from navierstokes_parallel_tpu.ops import surface as jsurf
    from navierstokes_parallel_tpu_torch.models import freesurface as FS

    kw = dict(particles_per_cell=ppc)
    if obstacle:
        kw["obstacles"] = ((6, 9, 1, 4),)
    prm = _params(n=16, **kw)
    jprm = _jax_params(prm)
    pset = FS.fill_region(prm, 0.0, 0.8, 0.0,
                          lambda x: 0.4 + 0.1 * np.sin(6.0 * x),
                          device="cpu")
    jset = JF.fill_region(jprm, 0.0, 0.8, 0.0,
                          lambda x: 0.4 + 0.1 * np.sin(6.0 * x))
    active = np.random.default_rng(4).random(pset.x.shape[0]) < 0.9
    flags = surf.cell_flags(pset.x, pset.y, torch.from_numpy(active), prm)
    jflags = jsurf.cell_flags(jset.x, jset.y, jnp.asarray(active), jprm)
    _assert_flags_equal(flags, jflags)
    assert bool(flags.surface.any()) and bool(flags.bulk.any())


@pytest.mark.parametrize("kind", ["layer_bump_tower", "blob", "single_east"])
@pytest.mark.parametrize("gravity", [False, True], ids=["plain", "dt"])
def test_surface_bcs_zero_divergence_as_jax(kind, gravity):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import surface as jsurf

    n = 6 if kind == "single_east" else 10
    prm = _params(n=n, g_x=0.3, g_y=-1.0)
    rng = np.random.default_rng(3)
    u, v = rng.normal(size=prm.shape), rng.normal(size=prm.shape)
    flags, jflags = _flags_pair(_geometry(kind, n))
    _assert_flags_equal(flags, jflags)
    dt = 0.05 if gravity else None
    u2, v2 = surf.apply_surface_bcs(torch.from_numpy(u.copy()),
                                    torch.from_numpy(v.copy()), flags, prm,
                                    dt=None if dt is None
                                    else torch.tensor(dt, dtype=torch.float64))
    ju2, jv2 = jsurf.apply_surface_bcs(
        jnp.asarray(u), jnp.asarray(v), jflags, _jax_params(prm),
        dt=None if dt is None else jnp.asarray(dt))
    np.testing.assert_allclose(u2.numpy(), np.asarray(ju2), rtol=0,
                               atol=EXACT)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv2), rtol=0,
                               atol=EXACT)
    div = surf._interior_divergence(u2, v2, prm).numpy()
    s = flags.surface[1:-1, 1:-1].numpy()
    assert s.any() and np.max(np.abs(div[s])) < EXACT
    div0 = surf._interior_divergence(torch.from_numpy(u),
                                     torch.from_numpy(v), prm).numpy()
    b = flags.bulk[1:-1, 1:-1].numpy()
    deep = b.copy()
    deep[1:, :] &= b[:-1, :]
    deep[:-1, :] &= b[1:, :]
    deep[:, 1:] &= b[:, :-1]
    deep[:, :-1] &= b[:, 1:]
    np.testing.assert_array_equal(div[deep], div0[deep])
    if kind == "single_east" and not gravity:
        # Griebel eq. 8.10: u_e = u_w - dx (v_n - v_s) / dy.
        want = u[2, 3] - prm.dx / prm.dy * (v[3, 3] - v[3, 2])
        assert abs(float(u2[3, 3]) - want) < EXACT


@pytest.mark.parametrize("kind", ["layer_bump_tower", "blob"])
def test_weights_coeffs_and_masks_as_jax(kind):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import surface as jsurf

    prm = _params(n=10)
    jprm = _jax_params(prm)
    fl = _geometry(kind)
    flags, jflags = _flags_pair(fl)
    # A fill fraction with the sub-cell values SUMMAC reads.
    fill = np.random.default_rng(2).random(prm.shape) * _padded(fl)
    flags = flags._replace(fill=torch.from_numpy(fill))
    jflags = jflags._replace(fill=jnp.asarray(fill))
    w = surf._traced_weights(flags, prm)
    jw = jsurf._traced_weights(jflags, jprm)
    for name in ("w_e", "w_w", "w_n", "w_s", "diag", "fluid"):
        np.testing.assert_array_equal(getattr(w, name).numpy(),
                                      np.asarray(getattr(jw, name)),
                                      err_msg=name)
    assert int(w.n_fluid) == int(jw.n_fluid)
    for got, want in zip(surf.interp_coeffs(flags),
                         jsurf.interp_coeffs(jflags)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(surf.surface_pressure(flags, prm).numpy(),
                               np.asarray(jsurf.surface_pressure(jflags,
                                                                 jprm)),
                               rtol=0, atol=EXACT)
    p = np.random.default_rng(5).normal(size=prm.shape)
    p_s = np.random.default_rng(6).normal(size=prm.shape)
    np.testing.assert_array_equal(
        surf.mask_pressure(torch.from_numpy(p), flags,
                           torch.from_numpy(p_s)).numpy(),
        np.asarray(jsurf.mask_pressure(jnp.asarray(p), jflags,
                                       jnp.asarray(p_s))))
    for got, want in zip(surf.fluid_face_masks(flags),
                         jsurf.fluid_face_masks(jflags)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    F, G, u, v = (np.random.default_rng(k).normal(size=prm.shape)
                  for k in range(4))
    got = surf.pin_fg(*(torch.from_numpy(a) for a in (F, G, u, v)), flags)
    want = jsurf.pin_fg(*(jnp.asarray(a) for a in (F, G, u, v)), jflags)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# (tag, geometry, interpolated, explicit surface value, obstacles).
SOLVE_CASES = [
    ("layer_plain", "layer", False, False, ()),
    ("layer_summac", "layer", True, False, ()),
    ("blob_summac", "blob", True, False, ()),
    ("blob_explicit", "blob", False, True, ()),
    ("layer_obstacle", "layer", True, False, ((6, 9, 1, 4),)),
]


@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: c[0])
def test_solve_pressure_free_as_jax(case):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.ops import surface as jsurf

    tag, kind, interpolated, explicit, obst = case
    n = 16
    prm = _params(n=n, epsilon=1e-8, obstacles=obst)
    jprm = _jax_params(prm)
    if kind == "layer":
        fl = np.zeros((n, n), bool)
        fl[:, 0:8] = True
    else:
        fl = _geometry("blob", n)
    fill = np.clip(np.random.default_rng(1).random(prm.shape) + 0.3, 0, 1)
    flags, jflags = _flags_pair(fl)
    flags = flags._replace(fill=torch.from_numpy(fill))
    jflags = jflags._replace(fill=jnp.asarray(fill))
    rng = np.random.default_rng(7)
    rhs = np.zeros(prm.shape)
    rhs[1:-1, 1:-1] = rng.normal(size=(n, n))
    p0 = rng.normal(size=prm.shape) * 0.1
    p_s = (np.random.default_rng(8).normal(size=prm.shape) * 0.05
           if explicit else None)
    res = surf.solve_pressure_free(
        torch.from_numpy(p0), torch.from_numpy(rhs), flags, prm,
        None if p_s is None else torch.from_numpy(p_s),
        interpolated=interpolated)
    jres = jsurf.solve_pressure_free(
        jnp.asarray(p0), jnp.asarray(rhs), jflags, jprm,
        None if p_s is None else jnp.asarray(p_s),
        interpolated=interpolated)
    assert res.iterations == int(jres.iterations) > 0
    assert res.converged is bool(jres.converged) is True
    np.testing.assert_allclose(res.p.numpy(), np.asarray(jres.p), rtol=0,
                               atol=CONTRACT)
    if obst:
        interior = surf._domain_interior(prm, torch.device("cpu"))
        flags = surf.classify(flags.fluid & interior, interior, flags.fill)
    if not interpolated:
        # The bulk residual meets the contract's threshold (the SUMMAC
        # values move with p, so there the solver's own check stands).
        w = surf._traced_weights(flags, prm)
        r = masked.masked_residual(res.p, torch.from_numpy(rhs)[1:-1, 1:-1],
                                   w)
        p_start = surf.mask_pressure(torch.from_numpy(p0), flags, None if
                                     p_s is None else torch.from_numpy(p_s))
        norm_p0 = float(masked._l2_fluid(torch.where(
            w.fluid, p_start[1:-1, 1:-1], torch.zeros(())), w))
        assert float(masked._l2_fluid(r, w)) <= \
            prm.epsilon * (norm_p0 + 1.5) * (1 + 1e-9)
        bulk = flags.bulk.numpy()
        surface = flags.surface.numpy()
        assert np.all(res.p.numpy()[~bulk & ~surface] == 0.0)
        want_s = 0.0 if p_s is None else p_s[surface]
        np.testing.assert_array_equal(res.p.numpy()[surface], want_s)
