"""The port's marker particles (particles.py) vs the JAX package's.

Each test feeds the same seeded numpy inputs to both packages' functions,
mirroring tests/test_particles.py: the staggered interpolation on a linear
field and at a wall (within 1e-12, float64), Euler and Heun advection
(uniform flow, solid-body rotation; positions within 1e-12 of JAX's and
the integrators' orders as JAX's test holds them), deactivation at the
domain edge and in an obstacle cell (equal masks, frozen positions equal),
the ring-buffer injection, the host loop of ``trace_particles`` against
JAX's device and host loops (equal counts, particles within 1e-12 with a
float64 state, the flow bit for bit with ``solver.solve``), the cavity
run, float32 positions against JAX's within 1e-6, the history that JAX's
``plot_particle_paths`` draws, and the refusals.
"""

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import particles as P
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params

TOL = 1e-12


def _params(**kw):
    base = dict(problem=1, i_max=16, j_max=16, a=1.0, b=1.0, T=0.05,
                Re=100.0, tau=0.5, omega=1.7, epsilon=1e-4, max_it=500,
                dtype="float64")
    base.update(kw)
    return Params(**base)


def _jax_params(prm):
    import dataclasses

    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**dataclasses.asdict(prm))


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _linear_fields(prm, au=(0.3, -0.7, 0.11), av=(0.9, 0.4, -0.2)):
    """u/v whose node values are linear in the node's physical staggered
    position: bilinear interpolation reproduces them exactly."""
    ii, jj = np.meshgrid(np.arange(prm.shape[0]), np.arange(prm.shape[1]),
                         indexing="ij")
    u = au[0] * ii * prm.dx + au[1] * (jj - 0.5) * prm.dy + au[2]
    v = av[0] * (ii - 0.5) * prm.dx + av[1] * jj * prm.dy + av[2]
    return u, v, (au, av)


def _assert_sets(got, jset, tol=TOL):
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jset.x), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(jset.y), rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got.active.numpy(),
                                  np.asarray(jset.active))


def test_interp_exact_on_linear_field_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params()
    u, v, (au, av) = _linear_fields(prm)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0.05, 0.95, 64), rng.uniform(0.05, 0.95, 64)
    up, vp = P.interp_uv(_t(x), _t(y), _t(u), _t(v), prm)
    jup, jvp = JP.interp_uv(_jnp(x), _jnp(y), _jnp(u), _jnp(v),
                            _jax_params(prm))
    np.testing.assert_allclose(up.numpy(), au[0] * x + au[1] * y + au[2],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(vp.numpy(), av[0] * x + av[1] * y + av[2],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), rtol=0, atol=TOL)
    np.testing.assert_allclose(vp.numpy(), np.asarray(jvp), rtol=0, atol=TOL)


def test_interp_wall_uses_ghost_reflection_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params()
    u = np.ones(prm.shape)
    u[:, 0] = -1.0
    u[:, prm.j_max + 1] = -1.0
    v = np.zeros(prm.shape)
    for y, want in ((0.0, 0.0), (0.5, 1.0)):
        got, _ = P.interp_uv(_t([0.5]), _t([y]), _t(u), _t(v), prm)
        jgot, _ = JP.interp_uv(_jnp([0.5]), _jnp([y]), _jnp(u), _jnp(v),
                               _jax_params(prm))
        assert abs(float(got[0]) - want) < TOL
        assert float(got[0]) == float(jgot[0])


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_advect_uniform_flow_as_jax(method):
    from navierstokes_parallel_tpu import particles as JP

    prm = _params()
    u, v = np.full(prm.shape, 0.25), np.full(prm.shape, -0.125)
    pts = [[0.3, 0.6], [0.5, 0.5]]
    out = P.advect(P.init_particles(pts, dtype=torch.float64, device="cpu"),
                   _t(u), _t(v), 0.1, prm, method=method)
    jout = JP.advect(JP.init_particles(pts, dtype=np.float64), _jnp(u),
                     _jnp(v), 0.1, _jax_params(prm), method=method)
    np.testing.assert_allclose(out.x.numpy(), [0.325, 0.525], atol=1e-14)
    np.testing.assert_allclose(out.y.numpy(), [0.5875, 0.4875], atol=1e-14)
    _assert_sets(out, jout)


def test_heun_second_order_on_rotation_as_jax():
    """Solid-body rotation is linear in position, so the radius drift is
    pure time-integration error: Heun's is far below Euler's and falls
    about 8x when dt halves (JAX's test); every position equals JAX's."""
    from navierstokes_parallel_tpu import particles as JP

    prm = _params(i_max=32, j_max=32)
    ii, jj = np.meshgrid(np.arange(prm.shape[0]), np.arange(prm.shape[1]),
                         indexing="ij")
    c, r0 = 0.5, 0.25
    u = -(((jj - 0.5) * prm.dy) - c)
    v = ((ii - 0.5) * prm.dx) - c
    jprm = _jax_params(prm)

    def drift(method, dt, steps):
        pset = P.init_particles([[c + r0, c]], dtype=torch.float64,
                                device="cpu")
        jset = JP.init_particles([[c + r0, c]], dtype=np.float64)
        for _ in range(steps):
            pset = P.advect(pset, _t(u), _t(v), dt, prm, method=method)
            jset = JP.advect(jset, _jnp(u), _jnp(v), dt, jprm, method=method)
        _assert_sets(pset, jset)
        return abs(np.hypot(float(pset.x[0]) - c, float(pset.y[0]) - c) - r0)

    d_euler = drift("euler", 0.02, 100)
    d_heun = drift("heun", 0.02, 100)
    assert d_heun < d_euler / 50
    assert 6.0 < d_heun / drift("heun", 0.01, 200) < 10.0


def test_out_of_domain_deactivates_and_freezes_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params()
    u, v = np.ones(prm.shape), np.zeros(prm.shape)
    pts = [[0.98, 0.5], [0.2, 0.5]]
    out = P.init_particles(pts, dtype=torch.float64, device="cpu")
    jout = JP.init_particles(pts, dtype=np.float64)
    for _ in range(2):
        out = P.advect(out, _t(u), _t(v), 0.1, prm, method="euler")
        jout = JP.advect(jout, _jnp(u), _jnp(v), 0.1, _jax_params(prm),
                         method="euler")
        _assert_sets(out, jout)
    assert out.active.tolist() == [False, True]
    assert float(out.x[0]) == 0.98 and abs(float(out.x[1]) - 0.4) < 1e-14


def test_obstacle_cell_deactivates_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params(obstacles=((8, 10, 1, 16),))
    u, v = np.ones(prm.shape), np.zeros(prm.shape)
    x0 = (8 - 1) * prm.dx - 0.01
    out = P.advect(P.init_particles([[x0, 0.5]], dtype=torch.float64,
                                    device="cpu"),
                   _t(u), _t(v), 0.05, prm, method="euler")
    jout = JP.advect(JP.init_particles([[x0, 0.5]], dtype=np.float64),
                     _jnp(u), _jnp(v), 0.05, _jax_params(prm),
                     method="euler")
    _assert_sets(out, jout, tol=0.0)
    assert not bool(out.active[0]) and float(out.x[0]) == pytest.approx(x0)


def test_inject_ring_buffer_wraps_as_jax():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu import particles as JP

    pset = P.init_particles(np.zeros((0, 2)), capacity=4,
                            dtype=torch.float64, device="cpu")
    jset = JP.init_particles(np.zeros((0, 2)), capacity=4, dtype=np.float64)
    pts = np.array([[0.1, 0.2], [0.3, 0.4]])
    cur, jcur = 0, jnp.zeros((), jnp.int32)
    for k in range(3):
        pset, cur = P.inject(pset, pts + 0.1 * k, cur)
        jset, jcur = JP.inject(jset, pts + 0.1 * k, jcur)
    assert cur == int(jcur) == 6
    np.testing.assert_allclose(pset.x.numpy(), [0.3, 0.5, 0.2, 0.4],
                               atol=1e-12)
    _assert_sets(pset, jset, tol=0.0)


def test_host_loop_matches_jax_device_and_host_loops():
    """``trace_particles`` / ``solve_with_particles`` (one host loop)
    against JAX's on-device loop and its host loop, with streakline
    injection every second step: equal counts, particles within TOL, the
    history's shape and frames, and the port's flow bit for bit with
    ``solver.solve``."""
    from navierstokes_parallel_tpu import particles as JP

    prm = _params(T=0.3, i_max=12, j_max=12)
    jprm = _jax_params(prm)
    seeds = P.grid_of_particles(prm, 3, 3, capacity=12, device="cpu")
    jseeds = JP.grid_of_particles(jprm, 3, 3, capacity=12)
    kw = dict(inject_points=[[0.5, 0.9]], inject_every=2)
    st_h, stats_h, out_h, hist = P.trace_particles(prm, seeds, **kw)
    st_d, stats_d, out_d = P.solve_with_particles(prm, seeds, **kw)
    _, jstats_d, jout_d = JP.solve_with_particles(jprm, jseeds, **kw)
    *_, jout_h, jhist = JP.trace_particles(jprm, jseeds, **kw)
    assert stats_h == stats_d
    assert stats_h.steps == int(jstats_d.steps) and stats_h.steps > 2
    assert stats_h.total_sor_iterations == int(
        jstats_d.total_sor_iterations)
    # JAX's own loops agree bit for bit; the port's within TOL of them
    # (float32 positions: XLA and PyTorch round the f32 casts alike, the
    # f64 interpolation within TOL).
    for jout in (jout_d, jout_h):
        _assert_sets(out_h, jout, tol=1e-6)
    _assert_sets(out_h, out_d, tol=0.0)
    assert hist.shape == jhist.shape == (stats_h.steps + 1, 12, 3)
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=1e-6)
    ref, _ = solver.solve(prm, device="cpu")
    assert torch.equal(st_d.u, ref.u) and torch.equal(st_h.u, ref.u)


def test_cavity_particles_circulate_and_stay_inside_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params(T=0.3, i_max=24, j_max=24, epsilon=1e-3)
    lattice = P.grid_of_particles(prm, 4, 4, device="cpu")
    pts = np.concatenate([np.stack([lattice.x.numpy(), lattice.y.numpy()],
                                   -1), [[0.5, 0.97]]])
    _, stats, out = P.solve_with_particles(
        prm, P.init_particles(pts, dtype=torch.float64, device="cpu"))
    _, jstats, jout = JP.solve_with_particles(
        _jax_params(prm), JP.init_particles(pts, dtype=np.float64))
    assert stats.steps == int(jstats.steps)
    x, y = out.x.numpy(), out.y.numpy()
    assert bool(out.active.all())
    assert np.all((x > 0) & (x < 1) & (y > 0) & (y < 1))
    assert x[-1] > 0.55
    _assert_sets(out, jout, tol=1e-9)


def test_history_plots_with_jax_plotting(tmp_path):
    """The port's history is the array JAX's ``plot_particle_paths``
    reads: its pathline and point pictures are written from it."""
    from navierstokes_parallel_tpu.utils import plotting

    prm = _params(T=0.03, i_max=12, j_max=12)
    *_, hist = P.trace_particles(
        prm, P.grid_of_particles(prm, 2, 2, device="cpu"))
    assert hist.shape[1:] == (4, 3) and hist.dtype == np.float32
    jprm = _jax_params(prm)
    for mode in ("paths", "points"):
        path = plotting.plot_particle_paths(
            hist, jprm, str(tmp_path / f"{mode}.png"), mode=mode)
        assert (tmp_path / f"{mode}.png").stat().st_size > 0 and path


def test_validation_errors_as_jax():
    from navierstokes_parallel_tpu import particles as JP

    prm = _params()
    u = torch.zeros(prm.shape, dtype=torch.float64)
    pset = P.init_particles([[0.5, 0.5]], device="cpu")
    with pytest.raises(ValueError, match="integrator"):
        P.advect(pset, u, u, 0.1, prm, method="rk9")
    with pytest.raises(ValueError, match="capacity"):
        P.init_particles([[0.1, 0.1], [0.2, 0.2]], capacity=1, device="cpu")
    with pytest.raises(ValueError, match="inject_every"):
        P.solve_with_particles(prm, pset, inject_points=[[0.5, 0.5]],
                               inject_every=0)
    with pytest.raises(ValueError, match="inject_every"):
        JP.solve_with_particles(_jax_params(prm), JP.init_particles(
            [[0.5, 0.5]]), inject_points=[[0.5, 0.5]], inject_every=0)
    # No entry point picks a device for the caller.
    with pytest.raises(ValueError, match="device"):
        P.init_particles([[0.5, 0.5]])
