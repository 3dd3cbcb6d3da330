"""The port's sharded backend vs the JAX package's.

  * One rank (a one-rank gloo group on an in-process store):
    ``solve_sharded`` on a 1x1 mesh against the port's ``solver.solve`` and
    the JAX package's ``solve_sharded`` on a one-device mesh, at 24^2,
    Re=100, max_it=2000: equal steps, sweeps and failures, fields within
    the reference contract (1e-4); the same from a JAX state; the CLI's
    ``--backend sharded --mesh 1x1`` against the JAX CLI's, and its host
    loop with every protocol file against the single-device CLI's.
  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback runs the halo exchange (and the Neumann and masked ghost
    fills) on a 2x2 mesh, the deep-halo inner on 2x2 and 1x4 meshes, full
    solves at 24^2 (divisible) and 17^2 (padded) on 2x2, and full solves
    of every other pressure method (METHOD_CASES: mg, cg, the pencil fft
    and rb_sor_sync on 2x2 and 1x4, cg on a padded grid, jacobi, and
    rb_sor's direct solve for an f64 state, with the refinement off, and
    on blocks one cell thin), and the CLI's host loop over a padded 11^2
    grid on 2x2 with every protocol file, straight and in two pieces
    (--max-steps, --resume), and with a file that rank 0 cannot write
    (every rank exits 1).  Against the JAX package on the same mesh
    shapes (8 virtual CPU devices): the halo fills exactly, the inner's
    cores within 5e-6 of max|delta| (XLA's FMA contraction), the solves
    with equal counts and u/v/p and the centre values within 1e-4; the
    host loop's files against the single-device CLI's (contract), the
    pieces against the straight run byte for byte.
  * Every branch of the JAX sharded backend the port does not run raises
    ``NotImplementedError`` naming its ROADMAP item, and the port refuses
    with ``ValueError`` what the JAX backend refuses.

The spawned workers import this module, which imports no jax at its top:
the JAX side runs in the test process only.
"""

import dataclasses
import datetime
import os
import socket
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import State
from navierstokes_parallel_tpu_torch.parallel import (deep_halo, halo,
                                                      sharded, topology)
from navierstokes_parallel_tpu_torch.utils import distributed

WORLD = 4
WORKER_TIMEOUT_S = 240
INNER_TOL = 5e-6  # of max|delta|
CONTRACT = 1e-4
SOLVE_SIZES = (24, 17)
DEEP_MESHES = ((2, 2), (1, 4))
DEEP_SIZE, DEEP_SWEEPS = (21, 18), 13
# (tag, pressure method, mesh, i_max, j_max, extra Params fields) of the
# four-rank solves of the other pressure methods.
METHOD_CASES = [
    (f"{method}_{px}x{py}", method, (px, py), 16, 16 * py // 2, {})
    for method in ("mg", "cg", "fft", "rb_sor_sync")
    for px, py in DEEP_MESHES] + [
    ("cg_17_padded", "cg", (2, 2), 17, 17, {}),
    ("jacobi_1x4", "jacobi", (1, 4), 16, 32, {}),
    ("float64_2x2", "rb_sor", (2, 2), 16, 16, {"dtype": "float64"}),
    # The two other routes to the exchange per half-sweep: refinement off
    # (the direct solve in f32), and blocks one cell thin (li = 1).
    ("refine_off_2x2", "rb_sor", (2, 2), 16, 16, {"sor_refine_every": 0}),
    ("thin_4x1", "rb_sor", (4, 1), 4, 16, {"T": 0.2}),
    # The compensated outer (two-float master, the hooks on hi and lo):
    # the deep-halo inner, the sharded mg, and the channel's deflation
    # through the all-reduced mean_fn.
    ("compensated_2x2", "rb_sor", (2, 2), 16, 16,
     {"outer_precision": "compensated", "sor_refine_every": 8}),
    ("compensated_mg_1x4", "mg", (1, 4), 16, 32,
     {"outer_precision": "compensated"}),
    ("compensated_channel_2x2", "rb_sor", (2, 2), 24, 12,
     {"outer_precision": "compensated", "problem": 3, "a": 2.0,
      "T": 0.2})]
# (tag, pressure method, mesh, problem, i_max, j_max, time order) of the
# four-rank solves of the plane channel (problem 3, from rest) and the
# free-slip Taylor-Green box (problem 4, from its exact t = 0 fields), by
# Euler and by Adams-Bashforth 2; one channel is padded on both axes.
PHYSICS_CASES = [
    ("channel_2x2", "rb_sor", (2, 2), 3, 24, 12, 1),
    ("channel_ab2_1x4", "rb_sor", (1, 4), 3, 24, 12, 2),
    ("channel_ab2_17x9_padded_2x2", "rb_sor", (2, 2), 3, 17, 9, 2),
    ("channel_mg_ab2_2x2", "mg", (2, 2), 3, 32, 16, 2),
    ("freeslip_2x2", "rb_sor", (2, 2), 4, 16, 16, 1),
    ("freeslip_ab2_1x4", "rb_sor", (1, 4), 4, 16, 16, 2)]


# The host loop's runs on four ranks and on one: (file tag, extra CLI
# arguments): the straight run, then the same run stopped after 2 steps
# (rc 3) and resumed from its checkpoint.
HOST_LOOP_SIZE, HOST_LOOP_T = 11, 0.3
HOST_LOOP_RUNS = [("straight", []), ("pieces", ["--max-steps", "2"]),
                  ("pieces", ["--resume", "{outdir}/pieces.npz"])]


def _host_loop_argv(outdir, tag, extra=()):
    """The protocol's flags, writing under `outdir` with names tagged
    `tag`, and `extra` ("{outdir}" in it stands for `outdir`)."""
    return [a.format(outdir=outdir) for a in (
        "--output-dir", f"{{outdir}}/{tag}", "--history-file",
        f"{{outdir}}/{tag}.csv", "--history-physics", "--checkpoint-every",
        "1", "--checkpoint-path", f"{{outdir}}/{tag}.npz",
        "--final-output-prefix", f"{{outdir}}/{tag}_final", *extra)]


def _write_error_flags(outdir):
    """Protocol flags whose file cannot be written: a frame directory that
    is a file (the frame writer's error, raised a step later), a history
    file and a checkpoint under that file."""
    blocker = os.path.join(outdir, "hostloop.in")
    return [["--output-dir", blocker],
            ["--history-file", os.path.join(blocker, "h.csv")],
            ["--checkpoint-every", "1", "--checkpoint-path",
             os.path.join(blocker, "c.npz")]]


def _assert_same_protocol_files(dir_a, tag_a, dir_b, tag_b, exact=False):
    """Two runs' frames, final output and history: byte for byte when
    `exact`, else frames within the contract (the JAX comparator), steps
    and iterations equal, t and dt within 1e-6 and the monitors within
    tests/test_torch_protocol.py's tolerances."""
    from navierstokes_parallel_tpu.utils import io as jio

    frames = sorted(os.listdir(os.path.join(dir_a, tag_a)))
    assert frames and frames == sorted(os.listdir(os.path.join(dir_b, tag_b)))
    pairs = [(os.path.join(dir_a, tag_a, f), os.path.join(dir_b, tag_b, f))
             for f in frames]
    pairs += [(os.path.join(dir_a, f"{tag_a}_final_{s}.txt"),
               os.path.join(dir_b, f"{tag_b}_final_{s}.txt")) for s in "uvp"]
    pairs.append((os.path.join(dir_a, f"{tag_a}.csv"),
                  os.path.join(dir_b, f"{tag_b}.csv")))
    for a, b in pairs:
        if exact:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), a
        elif not a.endswith(".csv"):
            assert jio.compare_outputs_with_tolerance(a, b), a
    rows_a, rows_b = (np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
                      for path in pairs[-1])
    assert rows_a.shape == rows_b.shape and len(rows_a) == len(frames) // 3
    np.testing.assert_array_equal(rows_a[:, [0, 3]], rows_b[:, [0, 3]])
    np.testing.assert_allclose(rows_a[:, 1:3], rows_b[:, 1:3], rtol=1e-6)
    np.testing.assert_allclose(rows_a[:, [5, 6, 8]], rows_b[:, [5, 6, 8]],
                               rtol=1e-5)
    np.testing.assert_allclose(rows_a[:, 7], rows_b[:, 7], atol=1e-5)


def _fields(**kw):
    base = {"problem": 1, "i_max": 24, "j_max": 24, "T": 0.05, "Re": 100.0,
            "tau": 0.5, "omega": 1.7, "epsilon": 1e-4, "max_it": 2000,
            "dtype": "float32"}
    return {**base, **kw}


def _params(**kw):
    return Params(**_fields(**kw))


def _physics(problem, i_max, j_max):
    """The fields of a PHYSICS_CASES configuration, and its start: None
    (rest) for the channel, the exact t = 0 arrays for Taylor-Green."""
    from navierstokes_parallel_tpu_torch.models import taylorgreen

    if problem == 3:
        return _fields(problem=3, i_max=i_max, j_max=j_max, a=2.0, Re=10.0,
                       T=0.03, max_it=20000), None
    kw = dict(problem=4, i_max=i_max, j_max=j_max, Re=50.0, T=0.05,
              epsilon=1e-6, max_it=20000)
    u, v, _ = taylorgreen.exact_fields(_params(**kw), 0.0)
    return _fields(**kw), tuple(x.astype(np.float32)
                                for x in (u, v, np.zeros_like(u)))


# The CFL-seed probe: 24^2, Re 100, tau 0.5, interior u in [0, 0.01) from a
# numpy seed, the ghost corner u[0, 0] = 5 above every interior value, to
# T = PROBE_T.  One device seeds the maxima with the corner (3 steps);
# the JAX package's sharded backend seeds them with 0 (1 step).
PROBE_T, PROBE_SEED = 0.011, 16


def probe_fields(dtype=np.float32):
    """(u, v, p) of the CFL-seed probe."""
    u = np.zeros((26, 26), dtype)
    u[1:-1, 1:-1] = np.random.default_rng(PROBE_SEED).uniform(0.0, 0.01,
                                                             (24, 24))
    u[0, 0] = 5.0
    return u, np.zeros_like(u), np.zeros_like(u)


def _probe_state():
    return State(*(torch.from_numpy(x) for x in probe_fields()),
                 t=torch.zeros(()), n=0)


def _jax_probe_state():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.grid import State as JState

    u, v, p = (jnp.asarray(x) for x in probe_fields())
    return JState(u=u, v=v, p=p, t=jnp.zeros((), jnp.float32),
                  n=jnp.zeros((), jnp.int32))


def _jax_params(**kw):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**_fields(**kw))


def _halo_grid(n_i, n_j, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_i + 2, n_j + 2)).astype(np.float32)


def _deep_rhs():
    g = np.zeros((DEEP_SIZE[0] + 2, DEEP_SIZE[1] + 2), np.float32)
    g[1:-1, 1:-1] = np.random.default_rng(3).standard_normal(DEEP_SIZE)
    return g


def _assert_contract(a, b, tol=CONTRACT):
    from conftest import assert_close_reference_contract

    assert_close_reference_contract(np.asarray(a, np.float64),
                                    np.asarray(b, np.float64), tol=tol)


# --- four gloo ranks ------------------------------------------------------------

def _my_block(arr, mesh, li, lj):
    px, py = mesh.shape
    ax, ay = mesh.coords
    blocks = sharded._scatter_blocks(arr, px, py, li, lj)
    return torch.from_numpy(np.ascontiguousarray(
        blocks[ax * (li + 2):(ax + 1) * (li + 2),
               ay * (lj + 2):(ay + 1) * (lj + 2)]))


def _concat_blocks(x, mesh):
    """Every rank's block, block-concatenated (the JAX shard_map layout)."""
    px, py = mesh.shape
    parts = [torch.empty_like(x) for _ in range(px * py)]
    dist.all_gather(parts, x.contiguous())
    rows = [torch.cat(parts[ax * py:(ax + 1) * py], dim=1) for ax in range(px)]
    return torch.cat(rows, dim=0).numpy()


def _gloo_worker(rank, port, outdir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        # Halo exchange and ghost fills on 2x2: 10 x 8 (divisible) and
        # 17 x 13 (padded, masked ghost fill).
        mesh = topology.make_grid_mesh(shape=(2, 2), device="cpu")
        local = _my_block(_halo_grid(10, 8, 1), mesh, 5, 4)
        out["exchange"] = _concat_blocks(halo.exchange_halo(local, mesh),
                                         mesh)
        out["neumann"] = _concat_blocks(
            halo.neumann_or_exchange(local, mesh), mesh)
        local = _my_block(_halo_grid(17, 13, 2), mesh, 9, 7)
        ghost = halo.make_masked_ghost_fn(17, 13, mesh)
        out["masked_ghost"] = _concat_blocks(ghost(local), mesh)

        prm = _params(i_max=DEEP_SIZE[0], j_max=DEEP_SIZE[1])
        for shape in DEEP_MESHES:
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            li, lj = topology.local_block_dims(shape, *DEEP_SIZE)
            rhs = _my_block(_deep_rhs(), mesh, li, lj)
            delta = deep_halo.make_deep_inner(prm, li, lj, mesh)(rhs,
                                                                 DEEP_SWEEPS)
            out[f"deep_{shape[0]}x{shape[1]}"] = sharded._gather_blocks(
                _concat_blocks(delta, mesh), *shape, li, lj, prm.shape)

        for n in SOLVE_SIZES:
            prm = _params(i_max=n, j_max=n)
            mesh = topology.make_grid_mesh(shape=(2, 2), device="cpu")
            state, stats = sharded.solve_sharded(
                prm, mesh=mesh, pressure_method="pallas_sor")
            for name in ("u", "v", "p"):
                out[f"solve{n}_{name}"] = getattr(state, name).numpy()
            out[f"solve{n}_t"] = state.t.numpy()
            out[f"solve{n}_stats"] = np.asarray(
                [stats.steps, stats.total_sor_iterations, stats.sor_failures])
        for tag, method, shape, n_i, n_j, kw in METHOD_CASES:
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # jacobi's omega clamp
                state, stats = sharded.solve_sharded(
                    _params(i_max=n_i, j_max=n_j, **kw), mesh=mesh,
                    pressure_method=method)
            for name in ("u", "v", "p"):
                out[f"{tag}_{name}"] = getattr(state, name).numpy()
            out[f"{tag}_stats"] = np.asarray(
                [stats.steps, stats.total_sor_iterations, stats.sor_failures])
        for tag, method, shape, problem, n_i, n_j, order in PHYSICS_CASES:
            fields, start = _physics(problem, n_i, n_j)
            if start is not None:
                start = State(*(torch.from_numpy(x) for x in start),
                              t=torch.zeros(()), n=0)
            state, stats = sharded.solve_sharded(
                Params(**fields), start,
                topology.make_grid_mesh(shape=shape, device="cpu"),
                pressure_method=method, time_order=order)
            for name in ("u", "v", "p"):
                out[f"{tag}_{name}"] = getattr(state, name).numpy()
            out[f"{tag}_stats"] = np.asarray(
                [stats.steps, stats.total_sor_iterations, stats.sor_failures])
        # The CFL-seed probe on 2x2: the sharded stepper seeds with 0.
        state, stats = sharded.solve_sharded(_params(T=PROBE_T),
                                             _probe_state(), mesh=mesh)
        out["probe_steps_t"] = np.asarray([stats.steps, float(state.t)])
        # The CLI's host loop on 2x2 over an odd grid (11^2, padded to
        # 12^2): straight, then in two pieces (--max-steps, --resume); every
        # rank gathers at the same steps, rank 0 writes every file.
        out["hostloop_rcs"] = np.asarray([
            cli.main([os.path.join(outdir, "hostloop.in"), "--device", "cpu",
                      "--backend", "sharded", "--mesh", "2x2",
                      *_host_loop_argv(outdir, tag, extra)])
            for tag, extra in HOST_LOOP_RUNS])
        # Writes that fail on rank 0 alone, the only rank that writes: each
        # must end every rank with rc 1, none left waiting in a collective.
        every = [None] * WORLD
        dist.all_gather_object(every, [
            cli.main([os.path.join(outdir, "hostloop.in"), "--device", "cpu",
                      "--backend", "sharded", "--mesh", "2x2",
                      "--max-steps", "2", *flags])
            for flags in _write_error_flags(outdir)])
        out["write_error_rcs"] = np.asarray(every)
        if rank == 0:
            np.savez(os.path.join(outdir, "gloo.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four-rank run's results (rank 0's npz, and the host loop's files
    under "outdir")."""
    outdir = str(tmp_path_factory.mktemp("gloo4"))
    _write_param_file(os.path.join(outdir, "hostloop.in"),
                      n=HOST_LOOP_SIZE, T=HOST_LOOP_T)
    ctx = mp.start_processes(_gloo_worker, args=(_free_port(), outdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        # join() returns False while some worker runs, and raises if one
        # failed.
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gloo workers ran past {WORKER_TIMEOUT_S} s")
    finally:
        # Reap workers on any failure path: a deadlocked group would
        # otherwise outlive the test holding its port.
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    with np.load(os.path.join(outdir, "gloo.npz")) as data:
        return {**data, "outdir": outdir}


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("x", "y"))


def _jax_blocks(fn, blocks, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        shard_map = jax.shard_map
    except AttributeError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    mapped = jax.jit(shard_map(fn, mesh=_jax_mesh(shape), in_specs=P("x", "y"),
                               out_specs=P("x", "y"), check_vma=False))
    return np.asarray(mapped(jnp.asarray(blocks)))


@pytest.mark.parametrize("which", ["exchange", "neumann", "masked_ghost"])
def test_gloo_halo_fills_match_jax_exactly(gloo4, which):
    from navierstokes_parallel_tpu.parallel import halo as jhalo

    if which == "masked_ghost":
        blocks = sharded._scatter_blocks(_halo_grid(17, 13, 2), 2, 2, 9, 7)
        fn = jhalo.make_masked_ghost_fn(17, 13)
    else:
        blocks = sharded._scatter_blocks(_halo_grid(10, 8, 1), 2, 2, 5, 4)
        fn = (jhalo.exchange_halo if which == "exchange"
              else jhalo.neumann_or_exchange)
    want = _jax_blocks(fn, blocks, (2, 2))
    assert np.array_equal(gloo4[which], want)


@pytest.mark.parametrize("shape", DEEP_MESHES, ids=["2x2", "1x4"])
def test_gloo_deep_inner_matches_jax(gloo4, shape):
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.parallel import deep_halo as jdh

    jprm = _jax_params(i_max=DEEP_SIZE[0], j_max=DEEP_SIZE[1])
    li, lj = topology.local_block_dims(shape, *DEEP_SIZE)

    def local_fn(rhs_block):
        inner = jdh.make_deep_inner(jprm, li, lj, use_pallas=True)
        return inner(rhs_block, jnp.asarray(DEEP_SWEEPS, jnp.int32))

    blocks = sharded._scatter_blocks(_deep_rhs(), *shape, li, lj)
    want = sharded._gather_blocks(_jax_blocks(local_fn, blocks, shape),
                                  *shape, li, lj, jprm.shape)
    got = gloo4[f"deep_{shape[0]}x{shape[1]}"]
    scale = float(np.max(np.abs(want)))
    assert scale > 0 and deep_halo.comm_depth(_params(), li, lj) < DEEP_SWEEPS
    np.testing.assert_allclose(got[1:-1, 1:-1] / scale,
                               want[1:-1, 1:-1] / scale, rtol=0,
                               atol=INNER_TOL)


@pytest.mark.parametrize("n", SOLVE_SIZES, ids=["24_divisible", "17_padded"])
def test_gloo_solve_matches_jax(gloo4, n):
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    jstate, jstats = jsh.solve_sharded(_jax_params(i_max=n, j_max=n),
                                       mesh=_jax_mesh((2, 2)),
                                       pressure_method="pallas_sor")
    want = [int(jstats.steps), int(jstats.total_sor_iterations),
            int(jstats.sor_failures)]
    assert list(gloo4[f"solve{n}_stats"]) == want
    for name in ("u", "v", "p"):
        _assert_contract(gloo4[f"solve{n}_{name}"], getattr(jstate, name))
    c = n // 2
    _assert_contract([gloo4[f"solve{n}_u"][c, c], gloo4[f"solve{n}_v"][c, c]],
                     [jstate.u[c, c], jstate.v[c, c]])
    assert float(gloo4[f"solve{n}_t"]) == pytest.approx(float(jstate.t),
                                                       rel=1e-6)


@pytest.mark.parametrize("case", METHOD_CASES, ids=lambda c: c[0])
def test_gloo_methods_match_jax(gloo4, case, monkeypatch):
    """Every other pressure method on four gloo ranks against the JAX
    sharded backend on the same mesh (its fft on the real-FFT route, the
    port's only one)."""
    from navierstokes_parallel_tpu.ops import fft as jfft
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    monkeypatch.setattr(jfft, "PREFER_RFFT", True)
    tag, method, shape, n_i, n_j, kw = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstate, jstats = jsh.solve_sharded(
            _jax_params(i_max=n_i, j_max=n_j, **kw), mesh=_jax_mesh(shape),
            pressure_method=method)
    stats = list(gloo4[f"{tag}_stats"])
    assert stats == [int(jstats.steps), int(jstats.total_sor_iterations),
                     int(jstats.sor_failures)]
    # Jacobi (omega clamped to 0.8) runs into max_it on every step.
    assert stats[0] > 1 and (stats[2] == 0) == (method != "jacobi")
    for name in ("u", "v", "p"):
        _assert_contract(gloo4[f"{tag}_{name}"], getattr(jstate, name))
    ci, cj = n_i // 2, n_j // 2
    _assert_contract([gloo4[f"{tag}_u"][ci, cj], gloo4[f"{tag}_v"][ci, cj]],
                     [jstate.u[ci, cj], jstate.v[ci, cj]])


@pytest.mark.parametrize("case", PHYSICS_CASES, ids=lambda c: c[0])
def test_gloo_channel_and_freeslip_match_jax(gloo4, case):
    """The channel's BCs (the flux balance all-reduced over owned cells),
    the free-slip box's and the AB2 carry on four gloo ranks against the
    JAX sharded backend on the same mesh: equal counts, fields within the
    contract."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.grid import State as JaxState
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    tag, method, shape, problem, n_i, n_j, order = case
    fields, start = _physics(problem, n_i, n_j)
    if start is not None:
        start = JaxState(*(jnp.asarray(x) for x in start),
                         t=jnp.zeros((), jnp.float32),
                         n=jnp.zeros((), jnp.int32))
    jstate, jstats = jsh.solve_sharded(
        _jax_params(**fields), start, _jax_mesh(shape),
        pressure_method=method, time_order=order)
    stats = list(gloo4[f"{tag}_stats"])
    assert stats == [int(jstats.steps), int(jstats.total_sor_iterations),
                     int(jstats.sor_failures)]
    assert stats[0] > 1 and stats[2] == 0
    for name in ("u", "v", "p"):
        _assert_contract(gloo4[f"{tag}_{name}"], getattr(jstate, name))


def test_gloo_cfl_seed_is_jax_sharded(gloo4):
    """The probe on four ranks takes the JAX sharded backend's one step on
    the same mesh (seed 0), with t bit for bit."""
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    jstate, jstats = jsh.solve_sharded(_jax_params(T=PROBE_T),
                                       _jax_probe_state(),
                                       mesh=_jax_mesh((2, 2)))
    steps, t = gloo4["probe_steps_t"]
    assert int(steps) == int(jstats.steps) == 1
    assert np.float32(t) == np.float32(jstate.t)


# --- one rank -----------------------------------------------------------------------

@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


def test_one_rank_cfl_seed_is_jax_sharded(one_rank):
    """The probe: the sharded stepper seeds the maxima with 0 as the JAX
    package's sharded backend does (1 step, t bit for bit), where one
    device seeds with the ghost corner u[0, 0] = 5 (3 steps)."""
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    prm = _params(T=PROBE_T)
    state, stats = sharded.solve_sharded(prm, _probe_state(), mesh=one_rank)
    jstate, jstats = jsh.solve_sharded(_jax_params(T=PROBE_T),
                                       _jax_probe_state(),
                                       mesh=_jax_mesh((1, 1)))
    assert stats.steps == int(jstats.steps) == 1
    assert float(state.t) == float(jstate.t)
    single, sstats = solver.solve(prm, _probe_state())
    assert sstats.steps == 3


def test_one_rank_solve_matches_solver_and_jax(one_rank):
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    prm = _params()
    state, stats = sharded.solve_sharded(prm, mesh=one_rank,
                                         pressure_method="pallas_sor")
    single, sstats = solver.solve(prm, device="cpu",
                                  pressure_method="pallas_sor")
    jstate, jstats = jsh.solve_sharded(_jax_params(), mesh=_jax_mesh((1, 1)),
                                       pressure_method="pallas_sor")
    counts = (stats.steps, stats.total_sor_iterations, stats.sor_failures)
    assert counts == (sstats.steps, sstats.total_sor_iterations,
                      sstats.sor_failures)
    assert counts == (int(jstats.steps), int(jstats.total_sor_iterations),
                      int(jstats.sor_failures))
    assert state.n == stats.steps == 3
    for name in ("u", "v", "p"):
        _assert_contract(getattr(state, name), getattr(single, name))
        _assert_contract(getattr(state, name), getattr(jstate, name))


def test_one_rank_solve_from_a_jax_state(one_rank):
    """A JAX State goes in as it is (its arrays through numpy)."""
    from navierstokes_parallel_tpu import solver as jsolver
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    jprm = _jax_params()
    jstart, _ = jsolver.solve(jprm.replace(T=0.02))
    state, stats = sharded.solve_sharded(_params(), jstart, one_rank)
    jstate, jstats = jsh.solve_sharded(jprm, jstart, _jax_mesh((1, 1)))
    assert (stats.steps, stats.total_sor_iterations) == \
        (int(jstats.steps), int(jstats.total_sor_iterations))
    assert state.n == int(jstart.n) + stats.steps
    for name in ("u", "v", "p"):
        _assert_contract(getattr(state, name), getattr(jstate, name))


def test_one_rank_max_steps_and_default_mesh(one_rank):
    prm = _params()
    state, stats = sharded.solve_sharded(prm, max_steps=2)
    assert stats.steps == 2 and state.n == 2
    assert float(state.t) < prm.T
    assert topology.make_grid_mesh(i_max=5, j_max=5).shape == (1, 1)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        topology.make_grid_mesh(shape=(2, 2))
    with pytest.raises(ValueError, match="group of that size"):
        topology.make_grid_mesh(4, 8, 8)


def test_mesh_neighbours_and_origin():
    mesh = topology.Mesh((2, 3), (1, 0), torch.device("cpu"), None)
    assert mesh.neighbour("x", -1) == 0 and mesh.neighbour("x", 1) is None
    assert mesh.neighbour("y", 1) == 4 and mesh.neighbour("y", -1) is None
    assert mesh.origin(5, 7) == (5, 0)
    assert halo.edge_masks(mesh) == {"left": False, "right": True,
                                     "bottom": True, "top": False}


@pytest.mark.parametrize("case,needle", [
    ("time_order_2_problem_5", "first-order"), ("obstacles", None),
    ("problem_5", "sharded_thermal"), ("problem_6", "sharded_free"),
    ("compensated", "A9")])
def test_unported_sharded_branches_raise(one_rank, case, needle):
    kw, method, order = {}, "rb_sor", 1
    if case == "time_order_2_problem_5":
        # JAX's refusal: the multi-chip thermal steppers are first-order.
        with pytest.raises(ValueError, match=needle):
            sharded.solve_sharded(_params(problem=5), mesh=one_rank,
                                  time_order=2)
        return
    if case.startswith("problem_"):
        # Ported (A10 items 6 and 7): the isothermal stepper names the
        # module that steps the problem, and two steps of it on one rank
        # give the single-device counts and fields (the contract).
        with pytest.raises(ValueError, match=needle):
            sharded.solve_sharded(_params(problem=int(case[-1])),
                                  mesh=one_rank)
        if case == "problem_5":
            from navierstokes_parallel_tpu_torch.models import convection
            from navierstokes_parallel_tpu_torch.parallel import \
                sharded_thermal

            prm = _params(problem=5, Ra=5000.0, Pr=0.71, max_it=5000)
            cfg = convection.config_from_params(prm)
            state, stats = sharded_thermal.solve_sharded_thermal(
                prm, cfg, mesh=one_rank, max_steps=2)
            single, sstats = convection.thermal_solve(
                prm, cfg, device="cpu", pressure_method="rb_sor",
                max_steps=2)
            fields = ("u", "v", "p", "T")
        else:
            from navierstokes_parallel_tpu_torch.models import freesurface
            from navierstokes_parallel_tpu_torch.parallel import sharded_free

            prm, fs = freesurface.dam_break(n=8, device="cpu")
            state, stats = sharded_free.solve_free_sharded(
                prm, fs, one_rank, max_steps=2)
            single, sstats = freesurface.solve_free(prm, fs, max_steps=2)
            state, single = state.state, single.state
            fields = ("u", "v", "p")
        assert stats == sstats._replace(last_res_norm=stats.last_res_norm)
        assert stats.steps == 2
        for name in fields:
            _assert_contract(getattr(state, name), getattr(single, name))
        return
    if case == "obstacles":
        # Ported (A10 item 8): two steps on one rank give the single-device
        # masked solve's counts, and its u and v within the contract
        # (tests/test_torch_sharded_obstacles.py holds it against JAX).
        prm = _params(obstacles=((8, 10, 12, 14),))
        state, stats = sharded.solve_sharded(prm, mesh=one_rank, max_steps=2)
        single, sstats = solver.solve(prm, device="cpu", max_steps=2)
        assert stats == sstats._replace(last_res_norm=stats.last_res_norm)
        assert stats.steps == 2 and stats.sor_failures == 0
        for name in ("u", "v"):
            _assert_contract(getattr(state, name), getattr(single, name))
        return
    # Ported (A9): the compensated outer on one rank gives the f64 outer's
    # counts on the same sharded inner, and the single-device compensated
    # solve's fields, by each outer-wrapped method (the sharded mg's
    # levels stop at a block of 4, so its count is its own); on an
    # obstacle domain the masked f64 defect hook (residual_fn) is refused
    # with the JAX package's ValueError.
    prm = _params(outer_precision="compensated", sor_refine_every=8)
    for method in ("pallas_sor", "mg", "fft"):
        state, stats = sharded.solve_sharded(prm, mesh=one_rank,
                                             pressure_method=method)
        _, f64_stats = sharded.solve_sharded(
            prm.replace(outer_precision="float64"), mesh=one_rank,
            pressure_method=method)
        single, _ = solver.solve(prm, device="cpu", pressure_method=method)
        assert stats[:3] == f64_stats[:3]
        assert stats.steps > 1 and stats.sor_failures == 0
        # (p is determined up to its constant mode, which the inners fix
        # differently.)
        for name in ("u", "v"):
            _assert_contract(getattr(state, name), getattr(single, name))
    with pytest.raises(ValueError, match="float64 outer only"):
        sharded.solve_sharded(prm.replace(obstacles=((8, 10, 12, 14),)),
                              mesh=one_rank, max_steps=1)


@pytest.mark.parametrize("case", [
    "mg_padded", "fft_padded", "fft_pencils", "pallas_sor_float64",
    "pallas_sor_refine_off"])
def test_check_method_refuses_what_jax_refuses(case):
    """The ValueErrors of JAX's _check_method (and of its pallas_sor
    branch), on the same configuration and mesh shape in both packages."""
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    method, kw, shape = {
        "mg_padded": ("mg", {"i_max": 17, "j_max": 17}, (2, 2)),
        "fft_padded": ("fft", {"i_max": 17, "j_max": 16}, (2, 2)),
        "fft_pencils": ("fft", {"i_max": 12, "j_max": 8}, (2, 4)),
        "pallas_sor_float64": ("pallas_sor", {"dtype": "float64"}, (2, 2)),
        "pallas_sor_refine_off": ("pallas_sor", {"sor_refine_every": 0},
                                  (2, 2)),
    }[case]
    mesh = topology.Mesh(shape, (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError) as got:
        sharded._check_method(_params(**kw), mesh, method)
    with pytest.raises(ValueError) as want:
        jsh.solve_sharded(_jax_params(**kw), mesh=_jax_mesh(shape),
                          pressure_method=method)
    words = {"mg_padded": "evenly-divisible", "fft_padded": "evenly-divisible",
             "fft_pencils": "tile"}.get(case, "mixed-precision")
    assert words in str(got.value) and words in str(want.value)


def test_unknown_sharded_method_is_refused(one_rank):
    with pytest.raises(ValueError, match="unknown"):
        sharded.solve_sharded(_params(), mesh=one_rank,
                              pressure_method="nope")


def test_refined_solver_hooks_refuse_a_parity_without_inner():
    from navierstokes_parallel_tpu_torch.ops import sor

    prm = _params(i_max=8, j_max=8)
    z = torch.zeros(prm.shape)
    with pytest.raises(ValueError, match="parity"):
        sor._solve_pressure_refined(z, z, prm, parity=1)


@pytest.mark.parametrize("hook,needle", [("mean_fn", "A9"),
                                         ("residual_fn", "A9")])
def test_refined_solver_refuses_unported_hooks(hook, needle):
    """The hooks run on the f64 outer: residual_fn's defect replaces the
    Laplacian's (with the masked operator and its inner, the refinement is
    ops/masked.py's solve bit for bit), beside mean_fn on problem 3.  The
    compensated outer (A9) takes mean_fn (it deflates every f32 defect by
    it, as the JAX package's does) and refuses residual_fn with the JAX
    package's ValueError."""
    from navierstokes_parallel_tpu.ops import sor as jsor
    from navierstokes_parallel_tpu_torch.ops import masked, sor

    prm = _params(i_max=16, j_max=8, problem=3 if hook == "mean_fn" else 1,
                  obstacles=((3, 6, 1, 4),))
    z = torch.zeros(prm.shape)
    w32 = masked.device_weights(prm, torch.float32, torch.device("cpu"))
    w64 = masked.device_weights(prm, torch.float64, torch.device("cpu"))
    # A compatible rhs: zero mean over the fluid cells, 0 on solid ones.
    r = np.random.default_rng(7).standard_normal((16, 8))
    r = np.where(w32.fluid.numpy(), r - r[w32.fluid.numpy()].mean(), 0.0)
    rhs = torch.zeros(prm.shape)
    rhs[1:-1, 1:-1] = torch.from_numpy(r.astype(np.float32))
    omega = torch.tensor(prm.omega)

    def fluid_mean(r):
        return torch.sum(r) / w64.n_fluid

    hooks = dict(
        inner_fn=lambda rf, n: masked._smooth_masked(
            torch.zeros(prm.shape), rf[1:-1, 1:-1], w32, n, omega),
        l2_fn=lambda r: masked._l2_fluid(r, w64), valid_mask=w64.fluid,
        residual_fn=lambda q, r: masked.masked_residual(q, r, w64),
        mean_fn=fluid_mean)
    got = sor._solve_pressure_refined(z, rhs, prm, **hooks)
    want = masked.solve_pressure_masked(z, rhs, prm)
    assert got.iterations == want.iterations > 0 and got.converged
    assert torch.equal(got.p[1:-1, 1:-1], want.p[1:-1, 1:-1])
    comp = prm.replace(outer_precision="compensated", obstacles=())
    if hook == "residual_fn":
        with pytest.raises(ValueError) as err:
            sor._solve_pressure_refined(z, rhs, comp, **hooks)
        with pytest.raises(ValueError) as jerr:
            jsor._solve_pressure_refined(
                np.zeros(prm.shape, np.float32), rhs.numpy(),
                _jax_params(i_max=16, j_max=8,
                            outer_precision="compensated"),
                method="rb_sor", residual_fn=lambda q, r: r)
        assert str(err.value) == str(jerr.value)
        return
    # On the channel (problem 3) every compensated defect loses
    # mean_fn(defect): a hook that adds nothing to the default mean gives
    # the default solve bit for bit, and it is called once per defect.
    calls = []

    def counted_mean(r):
        calls.append(r.shape)
        return torch.mean(r)

    plain = sor._solve_pressure_refined(z, rhs, comp)
    hooked = sor._solve_pressure_refined(z, rhs, comp, mean_fn=counted_mean)
    assert hooked.iterations == plain.iterations > 0 and hooked.converged
    assert torch.equal(hooked.p, plain.p)
    assert calls == [(16, 8)] * (1 + hooked.iterations // prm.sor_refine_every
                                 + (hooked.iterations % prm.sor_refine_every
                                    > 0))


# --- the CLI ------------------------------------------------------------------

def _write_param_file(path, n=24, T=0.05, problem=1):
    with open(path, "w") as fh:
        fh.write("\n".join(map(str, [problem, 1, n, n, 1.0, 1.0, T, 100.0,
                                     0.0, 0.0, 0.5, 1.7, 1e-4, 2000, 1]))
                 + "\n")
    return str(path)


def _param_file(tmp_path, n=24, T=0.05, problem=1):
    return _write_param_file(tmp_path / "p.in", n, T, problem)


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_sharded_matches_jax_cli(tmp_path, capsys):
    from navierstokes_parallel_tpu import cli as jcli

    path = _param_file(tmp_path)
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--backend",
                                   "sharded", "--mesh", "1x1", "--stats"],
                        capsys)
    assert not dist.is_initialized()  # the CLI's own group is gone
    jrc, jout, jerr = _run(jcli.main, [path, "--backend", "sharded", "--mesh",
                                       "1x1", "--stats"], capsys)
    assert rc == jrc == 0
    assert out.splitlines() == jout.splitlines()
    stats = err.splitlines()[0].split()[:3]
    assert stats == jerr.splitlines()[0].split()[:3]
    assert stats == ["steps=3", "sor_iterations=832", "sor_failures=0"]


def test_cli_backends_and_max_steps(tmp_path, capsys):
    path = _param_file(tmp_path)
    runs = {b: _run(cli.main, [path, "--device", "cpu", "--backend", b,
                               "--stats"], capsys)
            for b in ("auto", "jnp", "pallas", "sharded")}
    lines = {b: (rc, out, err.splitlines()[0].split()[:3])
             for b, (rc, out, err) in runs.items()}
    assert len(set(map(repr, lines.values()))) == 1, lines
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--backend",
                                   "sharded", "--max-steps", "1", "--stats"],
                        capsys)
    assert rc == 3 and err.startswith("steps=1 ")


@pytest.mark.parametrize("argv,needle", [
    (["--backend", "gspmd", "--method", "pallas_sor"],
     "gspmd backend supports"),
    (["--backend", "sharded", "--mesh", "2x2"], "needs 4 ranks"),
    (["--mesh", "1x1"], "applies to the sharded backend"),
    (["--backend", "sharded", "--mesh", "2y2"], "expects PxQ"),
    (["--backend", "sharded", "--method", "mg"], "A10"),
])
def test_cli_sharded_errors(tmp_path, capsys, argv, needle):
    # The sharded mg runs, on problem 5 too since ROADMAP A10 item 6 (the
    # "A10" case, which refused it before): two steps give the JAX sharded
    # CLI's counts and centre values.
    path = _param_file(tmp_path, problem=5 if needle == "A10" else 1)
    if needle == "A10":
        from navierstokes_parallel_tpu import cli as jcli

        cut = [*argv, "--mesh", "1x1", "--max-steps", "2", "--stats"]
        rc, out, err = _run(cli.main, [path, "--device", "cpu", *cut],
                            capsys)
        jrc, jout, jerr = _run(jcli.main, [path, *cut], capsys)
        assert rc == jrc == 3 and len(out.splitlines()) == 2
        assert err.split()[:3] == jerr.split()[:3]
        _assert_contract([float(x.split()[1]) for x in out.splitlines()],
                         [float(x.split()[1]) for x in jout.splitlines()])
        assert err.startswith("steps=2 ")
    else:
        rc, out, err = _run(cli.main, [path, "--device", "cpu", *argv],
                            capsys)
        assert rc == 1 and needle in err and out == ""
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [
    ["--method", "mg"], ["--method", "fft"], ["--method", "cg"],
    ["--method", "rb_sor_sync"], ["--dtype", "float64"],
    ["--time-order", "2"], ["channel", "--time-order", "2"]],
    ids=["mg", "fft", "cg", "rb_sor_sync", "float64", "ab2", "channel_ab2"])
def test_cli_sharded_methods_match_jax_cli(tmp_path, capsys, argv,
                                           monkeypatch):
    from navierstokes_parallel_tpu import cli as jcli
    from navierstokes_parallel_tpu.ops import fft as jfft

    monkeypatch.setattr(jfft, "PREFER_RFFT", True)
    problem = 1
    if argv[0] == "channel":  # problem 3 in the same 16^2 box
        problem, argv = 3, argv[1:]
    path = _param_file(tmp_path, n=16, problem=problem)
    common = ["--backend", "sharded", "--mesh", "1x1", "--stats", *argv]
    rc, out, err = _run(cli.main, [path, "--device", "cpu", *common], capsys)
    assert not dist.is_initialized()
    jrc, jout, jerr = _run(jcli.main, [path, *common], capsys)
    assert rc == jrc == 0
    _assert_contract([float(x.split()[1]) for x in out.splitlines()],
                     [float(x.split()[1]) for x in jout.splitlines()])
    assert err.splitlines()[0].split()[:3] == \
        jerr.splitlines()[0].split()[:3]


def test_gloo_host_loop_matches_single_device(gloo4, tmp_path):
    """The host loop on four ranks over a padded grid writes the frames,
    final output and history of the single-device host loop (within the
    contract), and a run in two pieces writes the straight run's, byte for
    byte (the gather and the scatter of a resume carry every bit a block's
    step reads)."""
    outdir = gloo4["outdir"]
    assert list(gloo4["hostloop_rcs"]) == [0, 3, 0]
    cfg = os.path.join(outdir, "hostloop.in")
    assert cli.main([cfg, "--device", "cpu",
                     *_host_loop_argv(str(tmp_path), "single")]) == 0
    _assert_same_protocol_files(outdir, "straight", str(tmp_path), "single")
    _assert_same_protocol_files(outdir, "pieces", outdir, "straight",
                                exact=True)


def test_gloo_write_error_ends_every_rank(gloo4):
    """A write that fails on rank 0 (the frame directory is a file, the
    history file or the checkpoint lies under one) ends all four ranks with
    rc 1: every rank learns of the error before the next gather."""
    assert gloo4["write_error_rcs"].tolist() == \
        [[1] * len(_write_error_flags(""))] * WORLD


def test_one_rank_host_loop(one_rank, tmp_path, capsys):
    """--backend sharded --mesh 1x1 with every protocol file: the
    single-device run's files within the contract; stopped after 2 steps
    and resumed, the straight run's byte for byte."""
    cfg = _write_param_file(tmp_path / "h.in", n=HOST_LOOP_SIZE,
                            T=HOST_LOOP_T)
    where = str(tmp_path)
    rcs = [cli.main([cfg, "--device", "cpu", "--backend", "sharded",
                     "--mesh", "1x1", *_host_loop_argv(where, tag, extra)])
           for tag, extra in HOST_LOOP_RUNS]
    assert rcs == [0, 3, 0] and dist.is_initialized()
    assert cli.main([cfg, "--device", "cpu",
                     *_host_loop_argv(where, "single")]) == 0
    _assert_same_protocol_files(where, "straight", where, "single")
    _assert_same_protocol_files(where, "pieces", where, "straight",
                                exact=True)
    stepper = sharded.ShardedStepper(_params(i_max=11, j_max=11), None,
                                     one_rank, "pallas_sor")
    diag = stepper.step()
    assert stepper.n == 1 and stepper.t == float(diag.dt) > 0
    assert stepper.state().u.shape == (13, 13)


def test_params_from_jax_fields():
    """The shared field set of both packages' Params (used above)."""
    from navierstokes_parallel_tpu.config import Params as JaxParams

    ref = JaxParams(**_fields())
    assert Params.from_mapping(dataclasses.asdict(ref)) == _params()
