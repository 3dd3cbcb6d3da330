"""The port's batched ensemble (solver.solve_ensemble / stack_states)
against the JAX package's vmapped one and against each member's solo
solve.

Members are the JAX test's (tests/test_ensemble.py): copies of a 16^2
cavity whose u is perturbed by 0.01 k times a standard normal of one
numpy generator (member 0 at rest).  Each member's steps, SOR iterations
and failures equal JAX's ensemble's and its own solo ``solver.solve``'s,
and its fields agree within the 1e-4 contract; the batched route runs
the solo route's formulation (the refinement over the SOR kernel route's
plain twin, the direct solve, jacobi, the DCT, and mg / cg member by
member), so the member equals its solo solve bit for bit, which also
shows that the ``...``-indexed stencils, BCs and sweeps act on one field
as they did.

The data-parallel ensemble (``solve_ensemble(mesh=...)``): one
``torch.multiprocessing.spawn`` of four gloo ranks on loopback solves 8
members on a 1-D batch mesh of 4 (two members a rank), against the
unmeshed batch (equal: each rank runs the batched route on its slice) and
JAX's ensemble on a 4-device ("b",) mesh (counts equal, fields within the
contract), computed in this process while the ranks run.  The spawned
workers import this module, and with it jax, which they do not call.

``solve_ensemble`` is ``run_steps`` over a ``solver.EnsembleStepper``:
the stepper under ``run_steps`` gives, bit for bit, the fields and
per-member stats of a transcription of the closed loop it replaced
(``_closed_loop``), a member held at T from the start beside members
that step.
"""

import datetime
import os
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.grid import allocate_state as jax_allocate
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.ops import sor
from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel, sor_kernel
from navierstokes_parallel_tpu_torch.parallel import topology

from conftest import assert_close_reference_contract


def _fields(**kw):
    out = dict(problem=1, i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
               omega=1.7, epsilon=1e-4, max_it=500, dtype="float64")
    out.update(kw)
    return out


def _perturbations(prm, n):
    rng = np.random.default_rng(5)
    out = []
    for k in range(n):
        du = np.zeros(prm.shape)
        du[1:-1, 1:-1] = 0.01 * k * rng.standard_normal((prm.i_max,
                                                         prm.j_max))
        out.append(du)
    return out


def _members(prm, jprm, n=3):
    port, jax_side = [], []
    for du in _perturbations(prm, n):
        s = allocate_state(prm, "cpu")
        port.append(s._replace(u=s.u + torch.tensor(du, dtype=s.u.dtype)))
        j = jax_allocate(jprm)
        jax_side.append(j._replace(u=j.u + jnp.asarray(du, j.u.dtype)))
    return port, jax_side


def _run(method, n=3, **kw):
    prm, jprm = Params(**_fields(**kw)), JaxParams(**_fields(**kw))
    port, jax_side = _members(prm, jprm, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # jacobi's omega clamp
        out, stats = solver.solve_ensemble(prm, solver.stack_states(port),
                                           pressure_method=method)
        jout, jstats = jsolver.solve_ensemble(
            jprm, jsolver.stack_states(jax_side), pressure_method=method)
        solos = [solver.solve(prm, m, pressure_method=method) for m in port]
    return prm, out, stats, jout, jstats, solos


CASES = [("rb_sor", "float64"), ("jacobi", "float64"), ("rb_sor", "float32"),
         ("jacobi", "float32"), ("fft", "float32"), ("mg", "float32"),
         ("cg", "float32")]


@pytest.mark.parametrize("method,dtype", CASES,
                         ids=[f"{m}_{d}" for m, d in CASES])
def test_ensemble_matches_jax_and_solo_solves(method, dtype):
    """rb_sor and jacobi on an f64 state take the batched direct solve, on
    an f32 state the batched refinement (rb_sor over the SOR kernel
    route's plain twin here, jacobi over the plain inner), as their solo
    solves do; fft the batched DCT; mg and cg member by member."""
    prm, out, stats, jout, jstats, solos = _run(method, dtype=dtype)
    assert out.u.shape == (3, *prm.shape) and out.n.tolist() == [2, 2, 2]
    for name, want in (("steps", jstats.steps),
                       ("total_sor_iterations", jstats.total_sor_iterations),
                       ("sor_failures", jstats.sor_failures)):
        assert getattr(stats, name).tolist() == np.asarray(want).tolist()
    for k, (state, solo) in enumerate(solos):
        assert stats.steps[k] == solo.steps
        assert stats.total_sor_iterations[k] == solo.total_sor_iterations
        assert stats.sor_failures[k] == solo.sor_failures
        assert float(out.t[k]) == pytest.approx(float(state.t), rel=1e-12)
        for name in ("u", "v", "p"):
            got = getattr(out, name)[k]
            assert_close_reference_contract(got.numpy(),
                                            getattr(state, name).numpy())
            assert_close_reference_contract(
                got.numpy(), np.asarray(getattr(jout, name))[k])
            assert torch.equal(got, getattr(state, name))


def test_ensemble_members_actually_differ():
    _, out, *_ = _run("rb_sor")
    u = out.u.numpy()
    assert np.abs(u[0] - u[1]).max() > 1e-6
    assert np.abs(u[1] - u[2]).max() > 1e-6


def test_ensemble_refusals():
    """pallas_sor and the data-parallel mesh's two refusals (a mesh of two
    axes, a batch that is not a multiple of the mesh) are JAX's
    ValueErrors word for word; problems 5 and 6 are refused as by
    solver.step.  The mesh refusals come before any collective, so no
    process group is needed."""
    import jax
    from jax.sharding import Mesh

    prm, jprm = Params(**_fields()), JaxParams(**_fields())
    port, jax_side = _members(prm, jprm, 3)
    batch, jbatch = solver.stack_states(port), jsolver.stack_states(jax_side)
    cpu = torch.device("cpu")
    devices = np.asarray(jax.devices()[:4])
    for kw, mesh, jmesh in (
            ({"pressure_method": "pallas_sor"}, None, None),
            ({}, topology.Mesh((2, 2), (0, 0), cpu, None),
             Mesh(devices.reshape(2, 2), ("x", "y"))),
            ({}, topology.Mesh((4,), (0,), cpu, None, axes=("b",)),
             Mesh(devices, ("b",)))):
        with pytest.raises(ValueError) as got:
            solver.solve_ensemble(prm, batch, mesh=mesh, **kw)
        with pytest.raises(ValueError) as want:
            jsolver.solve_ensemble(jprm, jbatch, mesh=jmesh, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown problem type 5"):
        solver.solve_ensemble(prm.replace(problem=5), batch)


@pytest.mark.parametrize("problem", [2, 3, 4])
def test_ensemble_other_problems(problem):
    """The oscillating lid (a lid speed per member's t), the channel (the
    flux balance per member, the deflation per member) and the free-slip
    box, against JAX's ensemble and the solo solves."""
    kw = dict(problem=problem, dtype="float32", max_it=2000)
    if problem == 2:
        kw.update(f=40.0, T=0.1)
    if problem == 3:
        kw.update(i_max=24, j_max=12, a=2.0, T=0.2)
    prm, out, stats, jout, jstats, solos = _run("rb_sor", **kw)
    assert stats.steps.tolist() == np.asarray(jstats.steps).tolist()
    assert stats.total_sor_iterations.tolist() == \
        np.asarray(jstats.total_sor_iterations).tolist()
    assert min(stats.steps.tolist()) > 1
    for k, (state, solo) in enumerate(solos):
        assert stats.total_sor_iterations[k] == solo.total_sor_iterations
        for name in ("u", "v"):
            got = getattr(out, name)[k].numpy()
            assert_close_reference_contract(got, getattr(state, name).numpy())
            assert_close_reference_contract(
                got, np.asarray(getattr(jout, name))[k])


def test_ensemble_obstacles_step_member_by_member():
    """An obstacle domain steps each member through solver.step: every
    member equals its solo solve bit for bit, and JAX's ensemble within
    the contract."""
    kw = dict(dtype="float32", max_it=2000, obstacles=((6, 9, 6, 9),))
    prm, out, stats, jout, jstats, solos = _run("rb_sor", **kw)
    assert stats.total_sor_iterations.tolist() == \
        np.asarray(jstats.total_sor_iterations).tolist()
    for k, (state, solo) in enumerate(solos):
        assert stats.steps[k] == solo.steps
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(out, name)[k], getattr(state, name))
            assert_close_reference_contract(
                getattr(out, name)[k].numpy(),
                np.asarray(getattr(jout, name))[k])


def test_members_at_t_stop_while_others_step():
    """A member that starts at T takes no step (its state is held), as
    JAX's batched while_loop holds a finished member's carry."""
    prm = Params(**_fields(dtype="float32"))
    a = allocate_state(prm, "cpu")
    done = a._replace(t=torch.tensor(prm.T, dtype=torch.float32), n=7)
    out, stats = solver.solve_ensemble(prm, solver.stack_states([a, done]))
    assert stats.steps.tolist()[1] == 0 and stats.steps.tolist()[0] > 1
    assert out.n.tolist() == [stats.steps.tolist()[0], 7]
    for name in ("u", "v", "p", "t"):
        assert torch.equal(getattr(out, name)[1], getattr(done, name))


def test_member_axis_twins_equal_each_members_call():
    """The plain twins of the SOR sweep kernel (whole-grid, tiled, and the
    route) and of the fused momentum kernel on a member axis equal each
    member's own call bit for bit, each member with its own dt and gamma:
    what the kernels' batched launches are held against on the card."""
    prm = Params(**_fields(i_max=20, j_max=13, dtype="float32"))
    rng = np.random.default_rng(3)
    rhs = np.zeros((3, *prm.shape), np.float32)
    rhs[:, 1:-1, 1:-1] = rng.standard_normal((3, prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs)
    for sweeps in (sor_kernel.inner_sweeps_plain, sor_kernel.inner_sweeps,
                   lambda r, n, p: sor_kernel.inner_sweeps_tiled_plain(
                       r, n, p, tile_rows=8, sweeps_per_chunk=2)):
        got = sweeps(rhs, 5, prm)
        for k in range(3):
            assert torch.equal(got[k], sweeps(rhs[k], 5, prm))
    u, v = (torch.from_numpy(rng.standard_normal((3, *prm.shape))
                             .astype(np.float32)) for _ in range(2))
    dt = torch.tensor([0.01, 0.02, 0.005])
    gamma = torch.tensor([0.5, 0.7, 0.9])
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    for k in range(3):
        want = momentum_kernel.momentum_rhs(u[k], v[k], dt[k], gamma[k], prm)
        for g, w in zip(got, want):
            assert torch.equal(g[k], w)


def test_solve_pressure_batch_refuses_obstacle_domains():
    """Only the solver decides how obstacle ensembles step (member by
    member, solver.solve_ensemble); the batched solve refuses them."""
    prm = Params(**_fields(obstacles=((6, 9, 6, 9),)))
    z = torch.zeros((2, *prm.shape), dtype=torch.float64)
    with pytest.raises(ValueError, match="member by member"):
        sor.solve_pressure_batch(z, z, prm)


# --- the data-parallel ensemble on four gloo ranks --------------------------

WORLD = 4
WORKER_TIMEOUT_S = 240
MESH_MEMBERS = 8


def _mesh_worker(rank, port, outdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        prm = Params(**_fields())
        members = []
        for du in _perturbations(prm, MESH_MEMBERS):
            s = allocate_state(prm, "cpu")
            members.append(s._replace(u=s.u + torch.from_numpy(du)))
        out, stats = solver.solve_ensemble(
            prm, solver.stack_states(members),
            mesh=topology.make_batch_mesh(device="cpu"))
        if rank == 0:
            np.savez(os.path.join(outdir, "ensemble.npz"),
                     **{f: getattr(out, f).numpy() for f in out._fields},
                     **{f: getattr(stats, f).numpy()
                        for f in stats._fields})
    finally:
        dist.destroy_process_group()


def test_data_parallel_ensemble_matches_batch_and_jax(tmp_path):
    """8 members on a batch mesh of 4 gloo ranks: every field and stat
    equals the unmeshed batch's (atol 1e-12, as JAX's test; 0 expected),
    and JAX's data-parallel ensemble's counts and fields (contract)."""
    import jax
    from jax.sharding import Mesh

    from test_torch_sharded import _free_port

    ctx = mp.start_processes(_mesh_worker, args=(_free_port(), str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        prm, jprm = Params(**_fields()), JaxParams(**_fields())
        port, jax_side = _members(prm, jprm, MESH_MEMBERS)
        want, want_stats = solver.solve_ensemble(prm,
                                                 solver.stack_states(port))
        jout, jstats = jsolver.solve_ensemble(
            jprm, jsolver.stack_states(jax_side),
            mesh=Mesh(np.asarray(jax.devices()[:WORLD]), ("b",)))
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gloo workers ran past {WORKER_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    with np.load(tmp_path / "ensemble.npz") as got:
        got = dict(got)
    for name in ("u", "v", "p", "t", "n"):
        np.testing.assert_allclose(got[name], getattr(want, name).numpy(),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in want_stats._fields:
        np.testing.assert_array_equal(got[name],
                                      getattr(want_stats, name).numpy())
    for name in ("steps", "total_sor_iterations", "sor_failures"):
        assert got[name].tolist() == np.asarray(
            getattr(jstats, name)).tolist()
    for name in ("u", "v", "p"):
        assert_close_reference_contract(got[name],
                                        np.asarray(getattr(jout, name)))


# --- the batched loop as a stepper under run_steps --------------------------


def _closed_loop(params, states, method):
    """``solve_ensemble``'s loop as it was before it became ``run_steps``
    over an ``EnsembleStepper``: the members' flags read once a step, the
    holds and the per-member stats on the device."""
    u, v, p, t = (x.clone() for x in states[:4])
    n = torch.as_tensor(states.n).clone()
    T = torch.tensor(params.T, dtype=t.dtype)
    zero = torch.zeros(t.shape[0], dtype=torch.int64)
    steps, iters, failures = zero.clone(), zero.clone(), zero.clone()
    last = torch.zeros_like(t)
    active = t < T
    while True:
        flags = active.tolist()
        if not any(flags):
            break
        u_new, v_new, t_new, _, res = solver._ensemble_step(
            u, v, p, t, flags, params, method)
        a3 = active.view(-1, 1, 1)
        u = torch.where(a3, u_new, u)
        v = torch.where(a3, v_new, v)
        p = torch.where(a3, res.p, p)
        t = torch.where(active, t_new, t)
        n += active
        steps += active
        iters += torch.where(active, res.iterations, 0)
        failures += active & ~res.converged
        last = torch.where(active, res.res_norm, last)
        active = t < T
    return (u, v, p, t, n), (steps, iters, failures, last)


STEPPER_CASES = [("rb_sor", "float32"), ("rb_sor", "float64"),
                 ("fft", "float32"), ("mg", "float32")]


@pytest.mark.parametrize("method,dtype", STEPPER_CASES,
                         ids=[f"{m}_{d}" for m, d in STEPPER_CASES])
def test_ensemble_stepper_gives_the_closed_loops_bits(method, dtype):
    """Three perturbed members and one already at T (held throughout):
    ``EnsembleStepper`` under ``run_steps``, and ``solve_ensemble``, equal
    the closed loop's fields and per-member stats bit for bit; the held
    member keeps its state and counts no step."""
    prm = Params(**_fields(dtype=dtype))
    members = []
    for du in _perturbations(prm, 3):
        s = allocate_state(prm, "cpu")
        members.append(s._replace(u=s.u + torch.tensor(du, dtype=s.u.dtype)))
    done = members[2]._replace(t=torch.tensor(prm.T, dtype=prm.torch_dtype),
                               n=5)
    batch = solver.stack_states(members + [done])
    want, want_stats = _closed_loop(prm, batch, method)

    stepper = solver.EnsembleStepper(prm, batch, method)
    loop = solver.run_steps(stepper, prm)
    out, stats = stepper.state(), stepper.stats()
    api, api_stats = solver.solve_ensemble(prm, batch, pressure_method=method)
    for got, got_stats in ((out, stats), (api, api_stats)):
        for name, x in zip(("u", "v", "p", "t", "n"), want):
            assert torch.equal(getattr(got, name), x), name
        for name, x in zip(solver.SolveStats._fields, want_stats):
            assert torch.equal(getattr(got_stats, name), x), name
    assert loop.steps == int(want_stats[0].max()) > 1
    assert want_stats[0].tolist()[3] == 0 and out.n.tolist()[3] == 5
    for name in ("u", "v", "p", "t"):
        assert torch.equal(getattr(out, name)[3], getattr(done, name))
    # The batch's own inputs are untouched: a second stepper from them
    # gives the same bits.
    again = solver.EnsembleStepper(prm, batch, method)
    solver.run_steps(again, prm)
    assert torch.equal(again.state().p, out.p)
