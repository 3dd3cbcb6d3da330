"""The port's deep-halo pieces vs the JAX package, in one process.

  * ``sor_kernel.ext_sweeps_plain`` (the plain twin of kernel B6) against
    the JAX package's extended-block kernel (``_ext_sweeps_call``, Pallas
    in interpret mode on the CPU) and against its jnp sweeps
    (``_ext_sweeps_jnp``) at a global corner, a padded edge and the middle
    of a grid, on the core of the block, relative to max|delta|: 5e-6.
    They are not bit-equal: XLA's CPU backend contracts a * b + c into
    fused multiply-adds, and the jnp sweeps round omega's coefficient in
    f32 where the kernels take it from doubles.
  * A 2x2 and a 2x4 padded cut of a grid, swept block by block through
    ``ext_sweeps_plain`` in chunks of K with the blocks rebuilt from the
    grid between chunks (the deep exchange), equals the whole-grid twin
    ``inner_sweeps_plain`` bit for bit: the deep-halo exactness argument
    (deep_halo.py).  On a one-rank process group, ``make_deep_inner``
    (which builds the blocks with ``extend_block``) equals it too.
  * ``comm_depth``, the extended-block masks, the mesh shapes and block
    dims, and the block layout (``_scatter_blocks`` / ``_gather_blocks``,
    ghost ring included) equal the JAX package's exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.parallel import deep_halo as jdh
from navierstokes_parallel_tpu.parallel import sharded as jsh
from navierstokes_parallel_tpu.parallel import topology as jtop
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
from navierstokes_parallel_tpu_torch.parallel import deep_halo, sharded
from navierstokes_parallel_tpu_torch.parallel import topology
from navierstokes_parallel_tpu_torch.utils import distributed

TOL = 5e-6  # of max|delta|: FMA contraction on XLA's CPU backend


def _params(i_max, j_max, **kw):
    ref = JaxParams(**{"i_max": i_max, "j_max": j_max, "a": 1.0, "b": 0.8,
                       "omega": 1.7, "dtype": "float32", **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _dx2(prm):
    return 1.0 / (prm.dx * prm.dx), 1.0 / (prm.dy * prm.dy)


def _cut_ext(grid, origin, li, lj, H, prm):
    """The extended block of the shard at `origin` cut from a padded global
    grid, zero outside the global interior: what make_deep_inner's
    clean_extend(extend_block(...)) builds across ranks."""
    ext = deep_halo.cut_ext_block(torch.from_numpy(grid), origin, li, lj,
                                  H).numpy()
    interior = sor_kernel.ext_masks(ext.shape, H, origin, prm.i_max,
                                    prm.j_max, *_dx2(prm))[0].numpy()
    return np.where(interior, ext, np.float32(0))


@pytest.mark.parametrize("origin", [(0, 0), (20, 15), (10, 7), (40, 30)])
@pytest.mark.parametrize("H", [2, 16])
def test_cut_ext_block_indexes_the_grid(origin, H):
    """Extended cell (a, b) is grid cell (ox - H + 1 + a, oy - H + 1 + b),
    0 beyond the grid."""
    grid = np.arange(1, 43 * 33 + 1, dtype=np.float32).reshape(43, 33)
    li, lj = 20, 15
    got = deep_halo.cut_ext_block(torch.from_numpy(grid), origin, li, lj,
                                  H).numpy()
    gi = np.arange(li + 2 * H)[:, None] + origin[0] - H + 1
    gj = np.arange(lj + 2 * H)[None, :] + origin[1] - H + 1
    inside = (gi >= 0) & (gi < 43) & (gj >= 0) & (gj < 33)
    want = np.where(inside, grid[np.clip(gi, 0, 42), np.clip(gj, 0, 32)], 0)
    assert got.shape == (li + 2 * H, lj + 2 * H)
    assert np.array_equal(got, want)


def _grid(prm, seed):
    rng = np.random.default_rng(seed)
    g = np.zeros(prm.shape, np.float32)
    g[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    return g


# 39 x 29 over a 2 x 2 mesh: blocks of 20 x 15, the high-side one padded;
# K = 8, H = 16.
ORIGINS = {"corner": (0, 0), "padded_edge": (20, 15), "middle": (10, 7)}


@pytest.mark.parametrize("ns", [1, 4, 8])
@pytest.mark.parametrize("where", sorted(ORIGINS))
def test_ext_plain_matches_jax_kernel_and_jnp(where, ns):
    prm, _ = _params(39, 29)
    li, lj, H = 20, 15, 16
    origin = ORIGINS[where]
    d0 = _cut_ext(_grid(prm, 1), origin, li, lj, H, prm)
    rhs = _cut_ext(_grid(prm, 2), origin, li, lj, H, prm)
    got = sor_kernel.ext_sweeps_plain(torch.from_numpy(d0),
                                      torch.from_numpy(rhs), ns, origin, H,
                                      prm).numpy()
    dx2, dy2 = _dx2(prm)
    want_kernel = np.asarray(jdh._ext_sweeps_call(
        jnp.asarray([ns], jnp.int32), jnp.asarray(origin, jnp.int32),
        jnp.asarray(d0), jnp.asarray(rhs), ext_shape=d0.shape, H=H,
        i_max=prm.i_max, j_max=prm.j_max, omega=float(prm.omega),
        dx2_inv=dx2, dy2_inv=dy2, interpret=True))
    f32 = jnp.float32
    _, red, black, self_coef = jdh._ext_masks(
        d0.shape, H, origin[0], origin[1], prm.i_max, prm.j_max,
        jnp.asarray(dx2, f32), jnp.asarray(dy2, f32))
    want_jnp = np.asarray(jdh._ext_sweeps_jnp(
        jnp.asarray(d0), jnp.asarray(rhs), ns, red, black, self_coef,
        jnp.asarray(prm.omega, f32), jnp.asarray(dx2, f32),
        jnp.asarray(dy2, f32)))
    core = (slice(H, H + li), slice(H, H + lj))
    for want in (want_kernel, want_jnp):
        scale = float(np.max(np.abs(want[core])))
        assert scale > 0
        np.testing.assert_allclose(got[core] / scale, want[core] / scale,
                                   rtol=0, atol=TOL)
    # The ring the sweeps never reach keeps its input; cells outside the
    # global interior are never updated.
    interior = sor_kernel.ext_masks(d0.shape, H, origin, prm.i_max, prm.j_max,
                                    dx2, dy2)[0].numpy()
    assert np.array_equal(got[~interior], d0[~interior])


def _decomposed_sweeps(prm, rhs, n, mesh_shape):
    """n sweeps from delta = 0 over the blocks of a (px, py) cut, in chunks
    of K: each chunk cuts every block's extended block from the grid of the
    chunk before, sweeps it with ext_sweeps_plain and writes its core."""
    px, py = mesh_shape
    li, lj = topology.local_block_dims(mesh_shape, prm.i_max, prm.j_max)
    K = deep_halo.comm_depth(prm, li, lj)
    H = 2 * K
    delta = np.zeros(prm.shape, np.float32)
    done = 0
    while done < n:
        ns = min(K, n - done)
        nxt = delta.copy()
        for ax in range(px):
            for ay in range(py):
                origin = (ax * li, ay * lj)
                ext = sor_kernel.ext_sweeps_plain(
                    torch.from_numpy(_cut_ext(delta, origin, li, lj, H, prm)),
                    torch.from_numpy(_cut_ext(rhs, origin, li, lj, H, prm)),
                    ns, origin, H, prm).numpy()
                # Core cells past the padded grid are pad: dropped.
                ri = min(li, prm.i_max - origin[0])
                rj = min(lj, prm.j_max - origin[1])
                nxt[1 + origin[0]:1 + origin[0] + ri,
                    1 + origin[1]:1 + origin[1] + rj] = \
                    ext[H:H + ri, H:H + rj]
        delta = nxt
        done += ns
    return delta, K


@pytest.mark.parametrize("n", [1, 5, 13])
@pytest.mark.parametrize("mesh_shape,size", [((2, 2), (17, 13)),
                                             ((2, 4), (21, 30))],
                         ids=["2x2_17x13", "2x4_21x30"])
def test_decomposition_equals_whole_grid_sweeps(mesh_shape, size, n):
    prm, _ = _params(*size)
    rhs = _grid(prm, 5)
    got, K = _decomposed_sweeps(prm, rhs, n, mesh_shape)
    want = sor_kernel.inner_sweeps_plain(torch.from_numpy(rhs), n, prm)
    assert n == 1 or n > K  # n > 1 runs several chunks
    assert np.array_equal(got, want.numpy())


@pytest.fixture(scope="module")
def one_rank_group():
    with distributed.process_group("cpu"):
        yield


@pytest.mark.parametrize("n", [3, 20])
def test_deep_inner_on_one_rank_equals_whole_grid(one_rank_group, n):
    prm, _ = _params(19, 14)
    mesh = topology.make_grid_mesh(i_max=19, j_max=14, device="cpu")
    assert mesh.shape == (1, 1) and mesh.coords == (0, 0)
    rhs = torch.from_numpy(_grid(prm, 9))
    got = deep_halo.make_deep_inner(prm, 19, 14, mesh)(rhs, n)
    want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
    assert torch.equal(got, want)


@pytest.mark.parametrize("li,lj,every", [(32, 32, 8), (5, 40, 8), (40, 3, 8),
                                         (64, 64, 16), (2, 2, 8), (9, 7, 1)])
def test_comm_depth_matches_jax(li, lj, every):
    prm, ref = _params(64, 64, sor_comm_every=every)
    assert deep_halo.comm_depth(prm, li, lj) == jdh.comm_depth(ref, li, lj)


@pytest.mark.parametrize("origin", [(0, 0), (20, 15), (10, 7)])
@pytest.mark.parametrize("H", [2, 16])
def test_ext_masks_match_jax(origin, H):
    prm, _ = _params(40, 30)
    shape = (20 + 2 * H, 15 + 2 * H)
    dx2, dy2 = _dx2(prm)
    got = sor_kernel.ext_masks(shape, H, origin, 40, 30, dx2, dy2)
    want = jdh._ext_masks(shape, H, origin[0], origin[1], 40, 30,
                          jnp.float32(dx2), jnp.float32(dy2))
    for g, w in zip(got, want):
        g = np.broadcast_to(g.numpy(), shape)
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12])
@pytest.mark.parametrize("size", [(32, 32), (17, 17), (257, 257), (99, 63),
                                  (24, 10)])
def test_mesh_shapes_and_blocks_match_jax(n, size):
    assert topology.choose_mesh_shape_padded(n, *size) == \
        jtop.choose_mesh_shape_padded(n, *size)
    assert topology._factor_pairs(n) == jtop._factor_pairs(n)
    shape = topology.choose_mesh_shape_padded(n, *size)
    assert topology.local_block_dims(shape, *size) == \
        jtop.local_block_dims(shape, *size)
    try:
        want = jtop.choose_mesh_shape(n, *size)
    except ValueError:
        with pytest.raises(ValueError):
            topology.choose_mesh_shape(n, *size)
    else:
        assert topology.choose_mesh_shape(n, *size) == want


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (2, 4), (1, 4),
                                        (3, 1)])
@pytest.mark.parametrize("size", [(16, 16), (17, 13)])
def test_block_layout_matches_jax(mesh_shape, size):
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((size[0] + 2, size[1] + 2)).astype(np.float32)
    li, lj = topology.local_block_dims(mesh_shape, *size)
    dims = (*mesh_shape, li, lj)
    got = sharded._scatter_blocks(arr, *dims)
    assert np.array_equal(got, jsh._scatter_blocks(arr, *dims))
    back = sharded._gather_blocks(got, *dims, arr.shape)
    assert np.array_equal(back, jsh._gather_blocks(got, *dims, arr.shape))
    assert np.array_equal(back, arr)  # ghost ring and corners included
