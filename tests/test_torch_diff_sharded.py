"""Gradients on a mesh: the port's ``diff.solve_n_steps(mesh=...)`` and
``diff.solve_thermal_n_steps(mesh=...)`` against the JAX package's mesh
gradients (tests/test_diff_sharded.py's cases) and the port's own
single-device ones.

  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback takes the gradients of GRAD_CASES on a 2x2 mesh: the loss
    of the final velocities w.r.t. the Controls and the initial u, v, p
    at 16^2 from rest, f64 to epsilon 1e-9, 2 steps, by mg and by rb_sor,
    on a ragged 17 x 13 grid (blocks of 9 x 7, padded), on an obstacle
    domain (the masked adjoint, by rb_sor), and through the Boussinesq
    step w.r.t. the buoyancy coefficient.  Every rank must hold the same
    gradient.  The same ranks show that the differentiated forward is
    ``ShardedStepper``'s (``ThermalShardedStepper``'s) bit for bit, that
    remat changes nothing, and gradcheck the collectives' transposes:
    the halo exchange through the global scatter and an all-reduce, and
    the global maxima of the CFL rule with ties on two ranks; with ties
    on three ranks and the corner the maxima's gradient equals
    ``st.max_interior``'s on one device.  Each rank then takes one case's
    single-device gradient.
  * Against JAX's ``diff`` on a 2x2 ``jax.sharding.Mesh`` of the virtual
    CPU devices (its GSPMD recipe), computed in this process while the
    ranks run: within JAX_REL.  Against the port on one device: rb_sor
    (and the masked rb_sor) within 1e-10 relative, as JAX's own mesh test
    holds its mesh gradient; mg within 1e-7 (the sharded V-cycle stops
    its levels at a block of 4 cells, one device at the whole grid's).
  * One rank: the 1x1 mesh against one device, in process; the refusals
    (a mesh with a trivial axis, as JAX's; masked fft; the sharded
    backend's own).

The spawned workers import this module, which imports no jax at its top.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu_torch import diff
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import State, allocate_state
from navierstokes_parallel_tpu_torch.models import convection as cv
from navierstokes_parallel_tpu_torch.ops import stencils as st
from navierstokes_parallel_tpu_torch.parallel import (autograd, halo, sharded,
                                                      sharded_thermal,
                                                      topology)
from navierstokes_parallel_tpu_torch.utils import distributed
from test_torch_sharded import PROBE_SEED, _free_port, probe_fields

WORLD = 4
WORKER_TIMEOUT_S = 240
MESH = (2, 2)
STEPS = 2
PROBE_STEPS = 3
JAX_REL = 1e-6
# Against the port's single-device gradient, by method.
SELF_REL = {"rb_sor": 1e-10, "pallas_sor": 1e-10, "mg": 1e-7}
F64 = torch.float64

# (tag, pressure method, extra Params fields, thermal, remat).  The
# exchange before every half-sweep of rb_sor's f64 solve costs ~2 ms a
# sweep on gloo, so its two cases skip the recomputed forward solves
# (remat gives the same bits: test_mesh_remat_equals_no_remat).
GRAD_CASES = [
    ("mg", "mg", {}, False, True),
    ("rb_sor", "rb_sor", {}, False, False),
    ("ragged", "rb_sor", {"i_max": 17, "j_max": 13}, False, False),
    ("obstacle", "rb_sor", {"obstacles": ((6, 10, 6, 10),)}, False, True),
    ("obstacle_mg", "mg", {"obstacles": ((6, 10, 6, 10),)}, False, True),
    ("thermal", "mg", {"Re": 200.0}, True, True)]
CASE_TAGS = [c[0] for c in GRAD_CASES]
# The cases whose forward is held against the steppers bit for bit (the
# steppers refuse an f64 obstacle domain, as the JAX package's sharded
# backend does).
FORWARD_TAGS = ("mg", "ragged", "thermal")


def _fields(**kw):
    out = dict(problem=1, i_max=16, j_max=16, a=1.0, b=1.0, T=1.0, Re=100.0,
               tau=0.5, omega=1.7, epsilon=1e-9, max_it=20000,
               dtype="float64")
    out.update(kw)
    return out


def _thermal_cfg(prm):
    return cv.ThermalConfig(alpha=1.0 / (prm.Re * 0.71), beta_gx=0.0,
                            beta_gy=-1.0)


def _energy(final, v_only=False):
    v2 = (final.v[1:-1, 1:-1] ** 2).sum()
    return v2 if v_only else (final.u[1:-1, 1:-1] ** 2).sum() + v2


def _port_gradient(case, mesh, remat=None, bump=0.0):
    """(loss, gradients, forward) of the case on `mesh` (None: one
    device), with the case's remat unless `remat` is given, from rest or
    from u + bump N(0, 1) (seed 42): gradients are [lid_scale, g_x, g_y,
    u, v, p] or [beta_gy]; forward the final fields and the dts,
    detached."""
    _, method, kw, thermal, case_remat = case
    remat = case_remat if remat is None else remat
    prm = Params(**_fields(**kw))
    if thermal:
        cfg = _thermal_cfg(prm)
        beta = torch.tensor(cfg.beta_gy, dtype=F64, requires_grad=True)
        final, dts = diff.solve_thermal_n_steps(
            prm, cv.allocate_thermal(prm, cfg, "cpu"), STEPS,
            cfg._replace(beta_gy=beta), pressure_method=method, remat=remat,
            mesh=mesh)
        loss = _energy(final, v_only=True)
        leaves = [beta]
    else:
        state = allocate_state(prm, "cpu")
        noise = np.zeros(prm.shape)
        noise[1:-1, 1:-1] = bump * np.random.default_rng(42).standard_normal(
            (prm.i_max, prm.j_max))
        state = state._replace(u=state.u + torch.from_numpy(noise))
        start = [x.clone().requires_grad_(True) for x in state[:3]]
        controls = [x.clone().requires_grad_(True)
                    for x in diff.default_controls(prm, "cpu")]
        final, dts = diff.solve_n_steps(
            prm, state._replace(u=start[0], v=start[1], p=start[2]), STEPS,
            controls=diff.Controls(*controls), pressure_method=method,
            remat=remat, mesh=mesh)
        loss = _energy(final)
        leaves = controls + start
    loss.backward()
    forward = [x.detach().clone() for x in (*final[:-2], dts)]
    return float(loss.detach()), [x.grad.clone() for x in leaves], forward


def _stepper_forward(case, mesh):
    """The same steps by the sharded backend's stepper: (u, v, p[, T], dts)
    gathered."""
    _, method, kw, thermal, _ = case
    prm = Params(**_fields(**kw))
    if thermal:
        cfg = _thermal_cfg(prm)
        stepper = sharded_thermal.ThermalShardedStepper(
            prm, cfg, cv.allocate_thermal(prm, cfg, "cpu"), mesh, method)
    else:
        stepper = sharded.ShardedStepper(prm, allocate_state(prm, "cpu"), mesh,
                                         method)
    dts = torch.stack([stepper.step().dt for _ in range(STEPS)])
    final = stepper.state()
    return [*final[:4 if thermal else 3], dts]


def _exchange_gradcheck(mesh, rank):
    """gradcheck of x -> sum over ranks of w_r . exchange(block_r(x)) on a
    padded grid (5 x 3 over 2x2: blocks of 3 x 2)."""
    prm = Params(**_fields(i_max=5, j_max=3))
    li, lj = topology.local_block_dims(mesh.shape, prm.i_max, prm.j_max)
    w = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(
        (li + 2, lj + 2)))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        prm.shape)).requires_grad_(True)

    def f(x):
        with autograd.ordered(mesh):
            y = halo.exchange_halo(autograd.scatter(x, prm, mesh), mesh)
            s = sharded._all_reduce(torch.sum(w * y), dist.ReduceOp.SUM, mesh)
            return autograd.publish(s, mesh)

    return torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-9)


def _maxima_field(n_ties, corner):
    """A 7 x 5 interior (blocks of 4 x 3 over 2x2, padded) whose maximum
    2.0 sits on `n_ties` cells of different ranks' blocks, with the corner
    x[0, 0] at 2.0 too when `corner`."""
    prm = Params(**_fields(i_max=7, j_max=5))
    x = np.random.default_rng(4).uniform(-1.0, 1.0, prm.shape)
    for i, j in [(2, 2), (6, 1), (3, 5), (7, 4)][:n_ties]:
        x[i, j] = 2.0
    x[0, 0] = 2.0 if corner else 0.5
    return prm, torch.from_numpy(x)


def _mesh_maxima(x, prm, mesh):
    """(u_max, v_max) of x and -x by ``sharded._global_maxima`` with the
    mesh gradient's seed, the global corner."""
    li, lj = topology.local_block_dims(mesh.shape, prm.i_max, prm.j_max)
    valid = sharded._valid_mask_or_none(prm, li, lj, mesh)[0]
    with autograd.ordered(mesh):
        b = autograd.scatter(x, prm, mesh)
        return sharded._global_maxima(b, -b, valid, mesh, corner=True)


def _maxima_gradcheck(mesh):
    prm, x = _maxima_field(2, corner=False)

    def f(x):
        u_max, v_max = _mesh_maxima(x, prm, mesh)
        return autograd.publish(u_max + 0.5 * v_max, mesh)

    return torch.autograd.gradcheck(f, (x.requires_grad_(True),), eps=1e-6,
                                    atol=1e-9)


def _maxima_ties_gradient(mesh):
    """(mesh, one device) gradients of the max with three interior ties on
    three ranks and the corner tied too."""
    prm, x = _maxima_field(3, corner=True)
    x = x.requires_grad_(True)
    u_max, _ = _mesh_maxima(x, prm, mesh)
    autograd.publish(u_max, mesh).backward()
    y = x.detach().clone().requires_grad_(True)
    st.max_interior(y).backward()
    return x.grad, y.grad


# The probe's starts: v = 0 on the interior (the probe as it stands, every
# donor-cell |v| on its kink, where the gradient is jnp.abs' 1 at 0) and
# v drawn as u is from the next seed (a generic state).
PROBE_STARTS = ("v_zero", "v_drawn")


def _probe_start(start):
    """The CFL-seed probe of tests/test_torch_sharded.py in f64 (24^2, the
    ghost corner u[0, 0] = 5 above the interior u in [0, 0.01)) with the
    interior v of `start` (``PROBE_STARTS``)."""
    u, v, p = probe_fields(np.float64)
    if start == "v_drawn":
        v[1:-1, 1:-1] = np.random.default_rng(PROBE_SEED + 1).uniform(
            0.0, 0.01, (24, 24))
    return u, v, p


def _probe_gradient(mesh, start):
    """The loss of PROBE_STEPS steps by mg from ``_probe_start(start)`` (on
    `mesh`, or one device for None) and its gradients w.r.t. the Controls
    and the start, with the dts."""
    prm = Params(**_fields(i_max=24, j_max=24))
    state = [torch.from_numpy(x).requires_grad_(True)
             for x in _probe_start(start)]
    controls = [x.clone().requires_grad_(True)
                for x in diff.default_controls(prm, "cpu")]
    final, dts = diff.solve_n_steps(
        prm, State(*state, t=torch.zeros((), dtype=F64), n=0), PROBE_STEPS,
        controls=diff.Controls(*controls), pressure_method="mg", mesh=mesh)
    loss = _energy(final)
    loss.backward()
    out = {f"probe_{start}_loss": float(loss.detach()),
           f"probe_{start}_dts": dts.detach().numpy()}
    for k, x in enumerate(controls + state):
        out[f"probe_{start}_grad{k}"] = x.grad.numpy()
    return out


def _gloo_worker(rank, port, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = topology.make_grid_mesh(shape=MESH, device="cpu")
        out = {}
        forwards, remat = {}, None
        for case in GRAD_CASES:
            tag = case[0]
            t0 = time.perf_counter()
            loss, grads, forwards[tag] = _port_gradient(case, mesh)
            remat = grads if tag == "mg" else remat
            out[f"{tag}_seconds"] = time.perf_counter() - t0
            out[f"{tag}_loss"] = loss
            flat = torch.cat([g.reshape(-1) for g in grads])
            every = [torch.empty_like(flat) for _ in range(WORLD)]
            dist.all_gather(every, flat)
            out[f"{tag}_same_on_every_rank"] = all(
                torch.equal(e, flat) for e in every)
            for k, g in enumerate(grads):
                out[f"{tag}_grad{k}"] = g.numpy()
        for tag in FORWARD_TAGS:
            case = GRAD_CASES[CASE_TAGS.index(tag)]
            want = _stepper_forward(case, mesh)
            out[f"{tag}_forward_equal"] = len(want) == len(forwards[tag]) and \
                all(torch.equal(a, b) for a, b in zip(forwards[tag], want))
        _, no_remat, _ = _port_gradient(GRAD_CASES[0], mesh, remat=False)
        out["remat_equal"] = all(torch.equal(a, b)
                                 for a, b in zip(remat, no_remat))
        for start in PROBE_STARTS:
            out.update(_probe_gradient(mesh, start))
        out["gradcheck_exchange"] = _exchange_gradcheck(mesh, rank)
        out["gradcheck_maxima"] = _maxima_gradcheck(mesh)
        got, want = _maxima_ties_gradient(mesh)
        out["ties_mesh"], out["ties_one_device"] = got.numpy(), want.numpy()
        # The single-device references, one case a rank.
        mine = {}
        for case in GRAD_CASES[rank::WORLD]:
            loss, grads, _ = _port_gradient(case, None)
            mine[f"{case[0]}_loss"] = loss
            for k, g in enumerate(grads):
                mine[f"{case[0]}_grad{k}"] = g.numpy()
        np.savez(os.path.join(outdir, f"one_device{rank}.npz"), **mine)
        if rank == 0:
            np.savez(os.path.join(outdir, "mesh.npz"), **out)
    finally:
        dist.destroy_process_group()


def _jax_gradients():
    """JAX's mesh gradients of GRAD_CASES on a 2x2 mesh of CPU devices:
    {tag: (loss, [gradients in the port's order])}, the cases compiled in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from navierstokes_parallel_tpu import diff as jdiff
    from navierstokes_parallel_tpu.config import Params as JaxParams
    from navierstokes_parallel_tpu.grid import allocate_state as jalloc
    from navierstokes_parallel_tpu.models import convection as jcv

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(MESH), ("x", "y"))

    def one(case):
        _, method, kw, thermal, _ = case
        prm = JaxParams(**_fields(**kw))
        if thermal:
            cfg = jcv.ThermalConfig(alpha=1.0 / (prm.Re * 0.71),
                                    beta_gx=0.0, beta_gy=-1.0)
            ts0 = jcv.allocate_thermal(prm, cfg)

            def loss(beta):
                final, _ = jdiff.solve_thermal_n_steps(
                    prm, ts0, STEPS, cfg._replace(beta_gy=beta),
                    pressure_method=method, mesh=mesh)
                return jnp.sum(final.v[1:-1, 1:-1] ** 2)

            val, g = jax.jit(jax.value_and_grad(loss))(jnp.float64(-1.0))
            return float(val), [np.asarray(g)]

        def loss(state, controls):
            final, _ = jdiff.solve_n_steps(prm, state, STEPS,
                                           controls=controls,
                                           pressure_method=method, mesh=mesh)
            return (jnp.sum(final.u[1:-1, 1:-1] ** 2)
                    + jnp.sum(final.v[1:-1, 1:-1] ** 2))

        val, (gs, gc) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), allow_int=True))(
            jalloc(prm), jdiff.default_controls(prm))
        return float(val), [np.asarray(x) for x in (*gc, *gs[:3])]

    def probe(start):
        """jax.grad of the one-device solve from the probe's `start`."""
        from navierstokes_parallel_tpu.grid import State as JState

        prm = JaxParams(**_fields(i_max=24, j_max=24))
        u, v, p = (jnp.asarray(x) for x in _probe_start(start))
        state = JState(u=u, v=v, p=p, t=jnp.zeros((), jnp.float64),
                       n=jnp.zeros((), jnp.int32))

        def loss(state, controls):
            final, dts = jdiff.solve_n_steps(prm, state, PROBE_STEPS,
                                             controls=controls,
                                             pressure_method="mg")
            return (jnp.sum(final.u[1:-1, 1:-1] ** 2)
                    + jnp.sum(final.v[1:-1, 1:-1] ** 2)), dts

        (val, dts), (gs, gc) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True, allow_int=True))(
            state, jdiff.default_controls(prm))
        return float(val), [np.asarray(x) for x in (*gc, *gs[:3])], \
            np.asarray(dts)

    with ThreadPoolExecutor(len(GRAD_CASES) + len(PROBE_STARTS)) as pool:
        probes = {start: pool.submit(probe, start) for start in PROBE_STARTS}
        out = dict(zip(CASE_TAGS, pool.map(one, GRAD_CASES)))
        for start, future in probes.items():
            out[f"probe_{start}"] = future.result()
        return out


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four ranks' results and JAX's, computed while the ranks run."""
    outdir = str(tmp_path_factory.mktemp("diff_gloo4"))
    ctx = mp.start_processes(_gloo_worker, args=(_free_port(), outdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        jax_out = _jax_gradients()
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gloo workers ran past {WORKER_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    one_device = {}
    for rank in range(WORLD):
        with np.load(os.path.join(outdir, f"one_device{rank}.npz")) as data:
            one_device.update(data)
    with np.load(os.path.join(outdir, "mesh.npz")) as data:
        return {"mesh": dict(data), "one": one_device, "jax": jax_out}


def _grads(results, tag):
    n = len(results["jax"][tag][1])
    return [results["mesh"][f"{tag}_grad{k}"] for k in range(n)], [
        results["one"][f"{tag}_grad{k}"] for k in range(n)]


def _assert_grads_close(got, want, rel):
    """Scalars within `rel` of the first (the lid's or the buoyancy's,
    the body force is absorbed: ~0), fields within `rel` of their max."""
    got, want = [np.asarray(g) for g in got], [np.asarray(w) for w in want]
    scale = abs(float(want[0]))
    assert scale > 1e-3
    for k, (g, w) in enumerate(zip(got, want)):
        tol = rel * (scale if np.ndim(w) == 0 else np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=str(k))


@pytest.mark.parametrize("tag", CASE_TAGS)
def test_mesh_gradient_matches_jax_mesh_gradient(gloo4, tag):
    got, _ = _grads(gloo4, tag)
    jloss, want = gloo4["jax"][tag]
    assert gloo4["mesh"][f"{tag}_loss"] == pytest.approx(jloss, rel=1e-12)
    assert bool(gloo4["mesh"][f"{tag}_same_on_every_rank"])
    _assert_grads_close(got, want, JAX_REL)


@pytest.mark.parametrize("tag", CASE_TAGS)
def test_mesh_gradient_matches_one_device(gloo4, tag):
    method = GRAD_CASES[CASE_TAGS.index(tag)][1]
    got, want = _grads(gloo4, tag)
    assert gloo4["mesh"][f"{tag}_loss"] == pytest.approx(
        float(gloo4["one"][f"{tag}_loss"]), rel=SELF_REL[method])
    _assert_grads_close(got, want, SELF_REL[method])


@pytest.mark.parametrize("tag", FORWARD_TAGS)
def test_mesh_forward_equals_the_sharded_stepper(gloo4, tag):
    assert bool(gloo4["mesh"][f"{tag}_forward_equal"])


@pytest.mark.parametrize("start", PROBE_STARTS)
def test_mesh_gradient_from_a_corner_above_the_interior_is_one_devices(
        gloo4, start):
    """The CFL-seed probe (u[0, 0] = 5 above every interior value): the
    mesh gradient seeds the maxima with the corner and carries it through
    every step, so its dts, loss and gradients are jax.grad's of the
    one-device solve (the sharded stepper seeds with 0, and a step's
    exchange zeroes the corner).  From v = 0 every donor-cell |v| sits on
    its kink: the gradient holds there too (``stencils.upwind_abs``)."""
    jloss, want, jdts = gloo4["jax"][f"probe_{start}"]
    mesh = {k[len(f"probe_{start}_"):]: x for k, x in gloo4["mesh"].items()
            if k.startswith(f"probe_{start}_")}
    np.testing.assert_allclose(mesh["dts"], jdts, rtol=1e-12)
    assert float(mesh["loss"]) == pytest.approx(jloss, rel=1e-10)
    _assert_grads_close([mesh[f"grad{k}"] for k in range(len(want))],
                        want, JAX_REL)


def test_mesh_remat_equals_no_remat(gloo4):
    assert bool(gloo4["mesh"]["remat_equal"])


@pytest.mark.parametrize("which", ["exchange", "maxima"])
def test_collective_transposes_pass_gradcheck(gloo4, which):
    assert bool(gloo4["mesh"][f"gradcheck_{which}"])


def test_maxima_spread_ties_as_one_device(gloo4):
    got, want = gloo4["mesh"]["ties_mesh"], gloo4["mesh"]["ties_one_device"]
    assert np.count_nonzero(want) == 4 and want[0, 0] == 0.5
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("method", ["mg", "pallas_sor"])
def test_one_rank_mesh_gradient_matches_one_device(one_rank, method):
    """pallas_sor on a mesh takes the deep-halo inner on an f64 state (the
    sweeps of kernel B6 on the card, its plain twin here), as one device
    takes the SOR kernel route.  The start is symmetry-broken: from rest
    the first step leaves a mirror-symmetric u, whose max is a tie or not
    by the last bit of the solve, and the sharded V-cycle's bits are not
    one device's."""
    case = ("one", method, {"i_max": 12, "j_max": 12}, False, True)
    loss, got, fwd = _port_gradient(case, one_rank, bump=0.05)
    want_loss, want, want_fwd = _port_gradient(case, None, bump=0.05)
    assert loss == pytest.approx(want_loss, rel=SELF_REL[method])
    _assert_grads_close(got, want, SELF_REL[method])
    # p up to its constant mode, which the V-cycles leave apart.
    for k in (0, 1, 3):
        np.testing.assert_allclose(fwd[k].numpy(), want_fwd[k].numpy(),
                                   rtol=0, atol=1e-8)
    dp = (fwd[2] - want_fwd[2])[1:-1, 1:-1]
    assert float((dp - dp.mean()).abs().max()) < 1e-8


def test_trivial_mesh_axis_is_refused_as_in_jax():
    """A 1x4 mesh: JAX's ValueError for its mesh gradient, and the port's
    (before any collective, so no process group is needed)."""
    import jax
    from jax.sharding import Mesh

    from navierstokes_parallel_tpu import diff as jdiff
    from navierstokes_parallel_tpu.config import Params as JaxParams
    from navierstokes_parallel_tpu.grid import allocate_state as jalloc

    jprm = JaxParams(**_fields())
    with pytest.raises(ValueError, match="mesh"):
        jdiff.solve_n_steps(jprm, jalloc(jprm), 1, mesh=Mesh(
            np.asarray(jax.devices()[:4]).reshape(1, 4), ("x", "y")))
    prm = Params(**_fields())
    mesh = topology.Mesh((1, 4), (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError, match="rejects the 1x4 mesh"):
        diff.solve_n_steps(prm, allocate_state(prm, "cpu"), 1, mesh=mesh)
    cfg = _thermal_cfg(prm)
    with pytest.raises(ValueError, match="rejects the 1x4 mesh"):
        diff.solve_thermal_n_steps(prm, cv.allocate_thermal(prm, cfg, "cpu"),
                                   1, cfg, mesh=mesh)


@pytest.mark.parametrize("kw,method,needle", [
    ({"obstacles": ((6, 10, 6, 10),)}, "fft", "masked deep-halo"),
    ({"i_max": 17}, "mg", "evenly-divisible"),
    ({}, "jacobi_typo", "unknown pressure solver method"),
    ({"problem": 6}, "rb_sor", "sharded_free")])
def test_mesh_gradient_refusals(kw, method, needle):
    prm = Params(**_fields(**kw))
    mesh = topology.Mesh((2, 2), (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError, match=needle):
        diff.solve_n_steps(prm, allocate_state(prm, "cpu"), 1, mesh=mesh,
                           pressure_method=method)
