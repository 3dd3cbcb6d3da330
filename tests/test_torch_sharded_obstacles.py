"""The port's sharded obstacle domains vs the JAX package's.

  * Four ranks: one ``torch.multiprocessing.spawn`` of four gloo ranks on
    loopback runs the masked deep-halo inner (a 32^2 cavity with a block,
    12 sweeps) on 2x2 and 1x4 meshes, and the OBSTACLE_CASES step by step
    (the backward-facing step at 64 x 16 by Euler on 2x2 and by AB2 on 1x4,
    a padded 17^2 cavity with one block on 2x2, the sharp circle with
    ghost-fluid BCs and cut-cell apertures on 2x2, and the staircase knob
    on 1x4).  Against the JAX sharded backend on the same mesh shapes (8
    virtual CPU devices): the inner's cores within 5e-6 of max|delta|
    (XLA's FMA contraction), every step's iterations and convergence
    equal (the staircase knob's later steps run into max_it in both),
    u/v/p within the reference contract (1e-4).
  * One rank: the masked deep inner on a 1x1 mesh equals ops/masked.py's
    sweeps bit for bit; the CLI's ``configs/channel.in --obstacle ...
    --backend sharded --mesh 1x1`` gives the JAX CLI's record; and
    ``_check_method`` refuses what the JAX backend refuses, with its
    messages.

The spawned workers import this module, which imports no jax at its top.
"""

import dataclasses
import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from navierstokes_parallel_tpu_torch import cli
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import karman
from navierstokes_parallel_tpu_torch.models import step as step_model
from navierstokes_parallel_tpu_torch.ops import masked
from navierstokes_parallel_tpu_torch.parallel import (deep_halo, sharded,
                                                      topology)
from navierstokes_parallel_tpu_torch.utils import distributed
from test_torch_sharded import (_assert_contract, _concat_blocks,
                                _free_port, _jax_blocks, _jax_mesh,
                                _my_block)

WORLD = 4
WORKER_TIMEOUT_S = 240
INNER_TOL = 5e-6  # of max|delta|
BASE = dict(problem=1, Re=100.0, T=1.0, tau=0.5, omega=1.7, epsilon=1e-4,
            max_it=2000, dtype="float32")
DEEP_N, DEEP_SWEEPS = 32, 12
DEEP_MESHES = ((2, 2), (1, 4))
BLOCK = ((9, 16, 13, 20),)


def _deep_fields():
    return dict(BASE, i_max=DEEP_N, j_max=DEEP_N, obstacles=BLOCK,
                sor_comm_every=4)


def _circle_fields(n=32, d=0.35):
    rects = karman.circle_rects(0.5, 0.5, d, 1.0 / n, 1.0 / n, n, n)
    return dict(BASE, i_max=n, j_max=n, obstacles=rects,
                obstacle_surfaces=(("circle", 0.5, 0.5, 0.5 * d),))


# (tag, Params fields, mesh, time order, steps).
OBSTACLE_CASES = [
    ("bfs_2x2", dataclasses.asdict(step_model.backward_facing_step(
        Re=100.0, nx=64, ny=16)), (2, 2), 1, 4),
    ("bfs_ab2_1x4", dataclasses.asdict(step_model.backward_facing_step(
        Re=100.0, nx=64, ny=16)), (1, 4), 2, 4),
    ("block_17_padded_2x2", dict(BASE, i_max=17, j_max=17,
                                 obstacles=((6, 10, 8, 12),)), (2, 2), 1, 3),
    ("circle_2x2", _circle_fields(), (2, 2), 1, 3),
    ("staircase_1x4", dict(BASE, i_max=32, j_max=32, obstacles=BLOCK,
                           obstacle_surfaces=(("box", 0.26, 0.5, 0.39,
                                               0.625),),
                           obstacle_pressure="staircase"), (1, 4), 1, 3),
]


def _deep_rhs(prm):
    rng = np.random.default_rng(3)
    fluid = masked._weights(prm).fluid
    g = np.zeros(prm.shape, np.float32)
    g[1:-1, 1:-1] = np.where(fluid, rng.standard_normal(fluid.shape), 0.0)
    return g


def _stepped(prm, mesh, order, steps):
    """(state, per-step iterations, per-step convergence) of `steps` steps
    of the sharded backend from rest."""
    stepper = sharded.ShardedStepper(prm, None, mesh, "rb_sor", order)
    iters, conv = [], []
    for _ in range(steps):
        diag = stepper.step()
        iters.append(int(diag.sor_iterations))
        conv.append(bool(diag.sor_converged))
    return stepper.state(), iters, conv


def _gloo_worker(rank, port, outdir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        prm = Params(**_deep_fields())
        for shape in DEEP_MESHES:
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            li, lj = topology.local_block_dims(shape, DEEP_N, DEEP_N)
            rhs = _my_block(_deep_rhs(prm), mesh, li, lj)
            delta = deep_halo.make_deep_inner(prm, li, lj, mesh)(rhs,
                                                                 DEEP_SWEEPS)
            out[f"deep_{shape[0]}x{shape[1]}"] = sharded._gather_blocks(
                _concat_blocks(delta, mesh), *shape, li, lj, prm.shape)
        for tag, fields, shape, order, steps in OBSTACLE_CASES:
            mesh = topology.make_grid_mesh(shape=shape, device="cpu")
            state, iters, conv = _stepped(Params(**fields), mesh, order,
                                          steps)
            for name in ("u", "v", "p"):
                out[f"{tag}_{name}"] = getattr(state, name).numpy()
            out[f"{tag}_iters"] = np.asarray(iters)
            out[f"{tag}_conv"] = np.asarray(conv)
        if rank == 0:
            np.savez(os.path.join(outdir, "gloo.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The four-rank run's results (rank 0's npz)."""
    outdir = str(tmp_path_factory.mktemp("gloo4_obstacles"))
    ctx = mp.start_processes(_gloo_worker, args=(_free_port(), outdir),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"gloo workers ran past {WORKER_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    with np.load(os.path.join(outdir, "gloo.npz")) as data:
        return dict(data)


def _jax_params(fields):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**fields)


@pytest.mark.parametrize("shape", DEEP_MESHES, ids=["2x2", "1x4"])
def test_gloo_masked_deep_inner_matches_jax(gloo4, shape):
    """The masked deep-halo inner on four gloo ranks against JAX's
    ``_ext_sweeps_masked`` route on the same mesh, and against the port's
    single-device masked sweeps (ops/masked.py), both within INNER_TOL of
    max|delta|."""
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.parallel import deep_halo as jdh

    jprm = _jax_params(_deep_fields())
    prm = Params(**_deep_fields())
    li, lj = topology.local_block_dims(shape, DEEP_N, DEEP_N)

    def local_fn(rhs_block):
        inner = jdh.make_deep_inner(jprm, li, lj)
        return inner(rhs_block, jnp.asarray(DEEP_SWEEPS, jnp.int32))

    rhs = _deep_rhs(prm)
    blocks = sharded._scatter_blocks(rhs, *shape, li, lj)
    want = sharded._gather_blocks(_jax_blocks(local_fn, blocks, shape),
                                  *shape, li, lj, jprm.shape)
    single = _single_masked_sweeps(prm, rhs, DEEP_SWEEPS)
    got = gloo4[f"deep_{shape[0]}x{shape[1]}"]
    scale = float(np.max(np.abs(want)))
    assert scale > 0 and deep_halo.comm_depth(prm, li, lj) < DEEP_SWEEPS
    for ref in (want, single):
        np.testing.assert_allclose(got[1:-1, 1:-1] / scale,
                                   ref[1:-1, 1:-1] / scale, rtol=0,
                                   atol=INNER_TOL)


@pytest.mark.parametrize("case", OBSTACLE_CASES, ids=lambda c: c[0])
def test_gloo_obstacle_steps_match_jax(gloo4, case):
    """Every step of an obstacle run on four gloo ranks against the JAX
    sharded backend on the same mesh: equal iterations and convergence per
    step, u/v/p within the contract."""
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    tag, fields, shape, order, steps = case
    stepper = jsh.ShardedStepper(_jax_params(fields), _jax_zero(fields),
                                 _jax_mesh(shape), "rb_sor", order)
    iters, conv = [], []
    for _ in range(steps):
        diag = stepper.step()
        iters.append(int(diag.sor_iterations))
        conv.append(bool(diag.sor_converged))
    jstate = stepper.state()
    assert list(gloo4[f"{tag}_iters"]) == iters
    # The staircase knob's steps after the first run into max_it in both
    # packages; every other case converges at every step.
    assert list(gloo4[f"{tag}_conv"]) == conv
    assert all(conv) == (tag != "staircase_1x4")
    for name in ("u", "v", "p"):
        _assert_contract(gloo4[f"{tag}_{name}"][1:-1, 1:-1],
                         np.asarray(getattr(jstate, name))[1:-1, 1:-1])
    _assert_contract(gloo4[f"{tag}_u"], jstate.u)
    _assert_contract(gloo4[f"{tag}_v"], jstate.v)


def _jax_zero(fields):
    from navierstokes_parallel_tpu.grid import allocate_state

    return allocate_state(_jax_params(fields))


def _single_masked_sweeps(prm, rhs, n_sweeps):
    """n_sweeps of ops/masked.py's sweeps from 0 on the whole grid."""
    w = masked.device_weights(prm, torch.float32, torch.device("cpu"))
    d = torch.zeros(prm.shape)
    return masked._smooth_masked(d, torch.from_numpy(rhs[1:-1, 1:-1]), w,
                                 n_sweeps, torch.tensor(prm.omega)).numpy()


# --- one rank -------------------------------------------------------------------

@pytest.fixture
def one_rank():
    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")
    assert not dist.is_initialized()


def test_one_rank_masked_deep_inner_equals_masked_sweeps(one_rank):
    """On one rank the masked deep inner is ops/masked.py's sweeps bit for
    bit: the same half-sweeps, weights equal on this grid (1/dx^2 = 1024
    and its multiples are exact in f32, so the f32 diagonal equals the
    rounded f64 one)."""
    prm = Params(**_deep_fields())
    rhs = _deep_rhs(prm)
    got = deep_halo.make_deep_inner(prm, DEEP_N, DEEP_N, one_rank)(
        torch.from_numpy(rhs), DEEP_SWEEPS)
    want = _single_masked_sweeps(prm, rhs, DEEP_SWEEPS)
    assert np.array_equal(got.numpy()[1:-1, 1:-1], want[1:-1, 1:-1])
    assert float(np.max(np.abs(want))) > 0


def test_one_rank_channel_obstacle_cli_matches_jax_cli(one_rank, capsys):
    """configs/channel.in with a block through --backend sharded --mesh
    1x1 against the JAX CLI's same run: the stats line's counts and the
    centre values within the contract."""
    from navierstokes_parallel_tpu import cli as jcli

    argv = [os.path.join(os.path.dirname(__file__), "..", "configs",
                         "channel.in"), "--obstacle", "17:24:27:34",
            "--backend", "sharded", "--mesh", "1x1", "--max-steps", "3",
            "--stats"]
    rc = cli.main([*argv, "--device", "cpu"])
    out, err = capsys.readouterr()
    jrc = jcli.main(argv)
    jout, jerr = capsys.readouterr()
    assert rc == jrc == 3
    assert err.splitlines()[0].split()[:3] == \
        jerr.splitlines()[0].split()[:3]
    _assert_contract([float(x.split()[1]) for x in out.splitlines()],
                     [float(x.split()[1]) for x in jout.splitlines()])


@pytest.mark.parametrize("method,kw", [
    ("mg", {}), ("fft", {}), ("cg", {}), ("rb_sor_sync", {}),
    ("jacobi", {}), ("rb_sor", {"dtype": "float64"}),
    ("rb_sor", {"sor_refine_every": 0})],
    ids=["mg", "fft", "cg", "rb_sor_sync", "jacobi", "float64",
         "refine_off"])
def test_check_method_gates_obstacles_as_jax(method, kw):
    """Obstacles admit rb_sor and pallas_sor only, on an f32 state with the
    refinement on: the JAX backend's ValueError and message otherwise (up
    to its remedy: the port has no gspmd backend to send users to)."""
    from navierstokes_parallel_tpu.parallel import sharded as jsh

    fields = dict(_deep_fields(), **kw)
    mesh = topology.Mesh((2, 2), (0, 0), torch.device("cpu"), None)
    with pytest.raises(ValueError) as got:
        sharded._check_method(Params(**fields), mesh, method)
    with pytest.raises(ValueError) as want:
        jsh._check_method(_jax_params(fields), _jax_mesh((2, 2)), method)
    assert str(got.value).split(" — ")[0] == str(want.value).split(" — ")[0]
    if method not in ("rb_sor", "pallas_sor"):
        assert "drop --backend sharded" in str(got.value)
    for ok in ("rb_sor", "pallas_sor"):
        assert sharded._check_method(Params(**_deep_fields()), mesh,
                                     ok) == (2, 2, 16, 16)
