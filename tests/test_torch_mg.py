"""The port's multigrid and CG pressure paths vs the JAX package.

Same inputs, made with numpy from a seed, go through both packages on the
CPU: the JAX package's Pallas warm-start kernel in interpret mode and its
jnp smoother (``mg._smooth(..., allow_kernel=False)``), its mg pieces, its
``solve_pressure(method="mg"/"cg")``, its solver and its CLI.

Tolerances and why:
  * smoother: 1e-6 of max|p|.  Both sides round each f32 operation once in
    the same order; XLA's CPU code rounds some of them differently (the two
    JAX formulations agree with each other exactly, and with the port to
    <= 5e-7 here);
  * _lap and _prolong are exact; _restrict is within 1 f32 ulp of the
    window's mean magnitude (XLA sums the 2x2 window pairwise on power-of-two
    grids, where the port is exact, and in another order elsewhere);
  * one V-cycle: 1e-6 of max|p| (measured <= 3.4e-7); the coarse cycle's
    plain twin (the same functions from a given depth) likewise;
  * solves: the reference contract (1e-4), with equal iteration counts and
    convergence flags.
"""

import dataclasses
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops import mg as jmg
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu.ops.pallas import sor_kernel as jsk
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.ops import mg, sor
from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
from navierstokes_parallel_tpu_torch.utils import timing

from conftest import assert_close_reference_contract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOOTH_TOL = 1e-6   # relative to max|p|
V_CYCLE_TOL = 1e-6  # relative to max|p|


def _params(i_max, j_max, **kw):
    ref = JaxParams(**{"i_max": i_max, "j_max": j_max, "a": 1.0, "b": 0.8,
                       "omega": 1.7, "dtype": "float32", **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _interior_field(shape, rng, scale=1.0, zero_mean=False):
    """A padded f32 field with a random interior and a zero ghost ring."""
    out = np.zeros(shape, np.float32)
    inner = rng.standard_normal((shape[0] - 2, shape[1] - 2)) * scale
    if zero_mean:  # compatible with the Neumann problem
        inner -= inner.mean()
    out[1:-1, 1:-1] = inner
    return out


# --- the smoother (kernel B3's plain twin) ----------------------------------

@pytest.mark.parametrize("ring", ["zero_ring", "ring"])
@pytest.mark.parametrize("omega", [1.0, 1.7])
@pytest.mark.parametrize("shape", [(16, 16), (13, 9), (24, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_warm_sweeps_plain_matches_jax(shape, omega, ring):
    prm, ref = _params(*shape)
    dx2, dy2 = 1.0 / prm.dx ** 2, 1.0 / prm.dy ** 2
    assert dx2 != dy2
    rng = np.random.default_rng(shape[0] * 10 + int(omega * 10))
    p = rng.standard_normal(prm.shape).astype(np.float32)
    if ring == "zero_ring":
        p = np.pad(p[1:-1, 1:-1], 1)
    rhs = _interior_field(prm.shape, rng)
    n = 3
    got = sor_kernel.warm_sweeps_plain(torch.from_numpy(p),
                                       torch.from_numpy(rhs), n, omega,
                                       dx2, dy2).numpy()
    kern = np.asarray(jsk.warm_sweeps(jnp.asarray(p), jnp.asarray(rhs), n,
                                      omega, dx2, dy2))
    lvl = jmg._Level(prm.shape, dx2, dy2)
    smooth = np.asarray(jmg._smooth(jnp.asarray(p), jnp.asarray(rhs), lvl, n,
                                    omega, allow_kernel=False))
    scale = float(np.max(np.abs(kern)))
    for want in (kern, smooth):
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=SMOOTH_TOL)
    # The ghost ring is read as given and never written.
    ring_mask = np.ones(prm.shape, bool)
    ring_mask[1:-1, 1:-1] = False
    np.testing.assert_array_equal(got[ring_mask], p[ring_mask])


def test_warm_sweeps_cpu_dispatches_to_plain():
    prm, _ = _params(10, 7)
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32))
    rhs = torch.from_numpy(_interior_field(prm.shape, rng))
    before_p = p.clone()
    before = timing.counts()
    got = sor_kernel.warm_sweeps(p, rhs, 2, 1.0, 3.0, 5.0)
    assert torch.equal(got, sor_kernel.warm_sweeps_plain(p, rhs, 2, 1.0, 3.0,
                                                         5.0))
    assert timing.counts() == before  # no kernel launched
    assert torch.equal(p, before_p)  # p is not modified
    zero = sor_kernel.warm_sweeps(p, rhs, 0, 1.0, 3.0, 5.0)
    assert torch.equal(zero, p) and zero.data_ptr() != p.data_ptr()


# --- levels and transfers ---------------------------------------------------

_GRIDS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.in")))


@pytest.mark.parametrize("source", [os.path.basename(g) for g in _GRIDS]
                         + ["rect96x36"])
def test_build_levels_matches_jax(source):
    if source == "rect96x36":  # coarsens to 24 x 9, an odd floor
        prm, ref = _params(96, 36, a=2.0, b=1.0)
    else:
        ref = JaxParams.from_file(os.path.join(ROOT, "configs", source))
        prm = Params.from_file(os.path.join(ROOT, "configs", source))
    got, want = mg.build_levels(prm), jmg.build_levels(ref)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        # Exact doubles: the same divisions by 4.0 in the same order.
        assert (g.dx2_inv, g.dy2_inv) == (w.dx2_inv, w.dy2_inv)
    if source == "rect96x36":
        assert [lv.shape for lv in got] == [(98, 38), (50, 20), (26, 11)]


@pytest.mark.parametrize("shape", [(64, 64), (32, 48), (24, 34)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_transfers_and_laplacian_match_jax(shape):
    prm, ref = _params(*shape)
    levels, jlevels = mg.build_levels(prm), jmg.build_levels(ref)
    assert len(levels) >= 2
    rng = np.random.default_rng(sum(shape))
    p = rng.standard_normal(prm.shape).astype(np.float32)
    tp = torch.from_numpy(p)

    for a, b in zip(mg._masks(*levels[0]), jmg._masks(*jlevels[0])):
        np.testing.assert_array_equal(a, b)

    got = mg._lap(tp, levels[0]).numpy()
    want = np.asarray(jmg._lap(jnp.asarray(p), jlevels[0]))
    np.testing.assert_array_equal(got, want)

    np.testing.assert_array_equal(mg.ghost_zero(tp).numpy(),
                                  np.asarray(jmg.ghost_zero(jnp.asarray(p))))

    got = mg._restrict(tp, levels[1].shape).numpy()
    want = np.asarray(jmg._restrict(jnp.asarray(p), jlevels[1].shape))
    x = np.abs(p[1:-1, 1:-1])
    mean_mag = 0.25 * (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                       + x[1::2, 1::2])
    assert np.all(np.abs(got - want)[1:-1, 1:-1]
                  <= np.spacing(mean_mag.astype(np.float32)))
    assert not got[0].any() and not got[:, -1].any()
    if shape[0] == shape[1]:  # power of two: the same order, exact
        np.testing.assert_array_equal(got, want)

    e = rng.standard_normal(levels[1].shape).astype(np.float32)
    got = mg._prolong(torch.from_numpy(e), levels[0].shape).numpy()
    want = np.asarray(jmg._prolong(jnp.asarray(e), jlevels[0].shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 64), (32, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_v_cycle_matches_jax(shape):
    prm, ref = _params(*shape)
    rng = np.random.default_rng(7)
    rhs = _interior_field(prm.shape, rng)
    got = mg.v_cycle(torch.zeros(prm.shape), torch.from_numpy(rhs),
                     mg.build_levels(prm)).numpy()
    want = np.asarray(jmg.v_cycle(jnp.zeros(prm.shape, jnp.float32),
                                  jnp.asarray(rhs), jmg.build_levels(ref),
                                  allow_kernel=False))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=V_CYCLE_TOL)
    assert not got[0].any() and not got[:, 0].any()  # the ring stays 0


def test_v_cycle_smoother_calls(monkeypatch):
    """A cycle over L levels calls the smoother 2 L - 1 times, each at its
    level's shape and constants: the count chip_smoke.py holds the
    kernel's launches to."""
    prm, _ = _params(64, 32)
    levels = mg.build_levels(prm)
    calls = []
    real = sor_kernel.warm_sweeps

    def counting(p, rhs, n, omega, dx2, dy2):
        calls.append((tuple(p.shape), n, omega, dx2, dy2))
        return real(p, rhs, n, omega, dx2, dy2)

    monkeypatch.setattr(sor_kernel, "warm_sweeps", counting)
    rhs = torch.from_numpy(_interior_field(prm.shape,
                                           np.random.default_rng(0)))
    mg.inner_v_cycle(rhs, 2, prm)
    per_cycle = 2 * len(levels) - 1
    assert len(levels) == 3 and len(calls) == 2 * per_cycle
    coarse = levels[-1]
    assert calls[len(levels) - 1] == (coarse.shape, 32, 1.0, coarse.dx2_inv,
                                      coarse.dy2_inv)
    assert calls[0] == (levels[0].shape, 2, 1.0, levels[0].dx2_inv,
                        levels[0].dy2_inv)


# --- the coarse cycle (one launch on the card) and the routes by size --------

@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("shape", [(128, 128), (64, 64), (32, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_coarse_cycle_plain_matches_jax_v_cycle_from_depth(shape, depth):
    """The plain twin of the coarse-cycle kernel is the V-cycle from a
    given depth on the plain smoother: held against the JAX v_cycle from
    the same depth on the same non-zero p and rhs, at
    test_v_cycle_matches_jax's tolerance."""
    prm, ref = _params(*shape)
    levels, jlevels = mg.build_levels(prm), jmg.build_levels(ref)
    assert depth < len(levels)
    rng = np.random.default_rng(depth + shape[0])
    # p of the size of a correction, so that A p is of the size of rhs (a
    # p of order 1 leaves rhs - A p to cancellation, which amplifies the
    # two packages' rounding differences beyond the V-cycle's tolerance).
    p = _interior_field(levels[depth].shape, rng,
                        scale=1.0 / levels[depth].dx2_inv)
    rhs = _interior_field(levels[depth].shape, rng)
    got = sor_kernel.coarse_cycle_plain(torch.from_numpy(p),
                                        torch.from_numpy(rhs),
                                        levels[depth:]).numpy()
    want = np.asarray(jmg.v_cycle(jnp.asarray(p), jnp.asarray(rhs), jlevels,
                                  depth=depth, allow_kernel=False))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=V_CYCLE_TOL)
    assert not got[0].any() and not got[:, -1].any()  # the ring stays 0


@pytest.mark.parametrize("counts", [(2, 2, 32), (0, 1, 0), (3, 0, 5)],
                         ids=lambda c: "nu%d_%d_coarse%d" % c)
def test_coarse_cycle_cpu_dispatches_to_plain(counts):
    """On a CPU tensor the wrapper runs its plain twin (no launch counted),
    which equals v_cycle from that depth bit for bit, ghost ring of p
    included; plain tuples serve as levels."""
    prm, _ = _params(32, 48)
    levels = mg.build_levels(prm)
    rng = np.random.default_rng(3)
    shape = levels[1].shape
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before_p, before = p.clone(), timing.counts()
    got = sor_kernel.coarse_cycle(p, rhs, [tuple(lv) for lv in levels[1:]],
                                  *counts)
    assert timing.counts() == before and torch.equal(p, before_p)
    assert torch.equal(got, mg.v_cycle(p, rhs, levels, 1, *counts))
    assert torch.equal(got, mg.v_cycle_plain(p, rhs, levels[1:], *counts))
    assert torch.equal(got[0], p[0]) and torch.equal(got[:, -1], p[:, -1])


def test_v_cycle_hands_the_tail_to_coarse_cycle(monkeypatch):
    """_cycle with the tail entered at depth t smooths twice and transfers
    down and up once on each of the t levels above it and calls
    coarse_cycle once, with the levels from t on, and gives v_cycle's
    bits; v_cycle on a CPU tensor never calls it."""
    prm, _ = _params(64, 32)
    levels = mg.build_levels(prm)
    rhs = torch.from_numpy(_interior_field(prm.shape,
                                           np.random.default_rng(0)))
    p = torch.zeros(prm.shape)
    smooths, tails, transfers = [], [], []
    real_warm, real_cycle = sor_kernel.warm_sweeps, sor_kernel.coarse_cycle
    monkeypatch.setattr(
        sor_kernel, "warm_sweeps",
        lambda q, *a: smooths.append(tuple(q.shape)) or real_warm(q, *a))
    monkeypatch.setattr(
        sor_kernel, "coarse_cycle",
        lambda q, r, lv, *a: tails.append((tuple(q.shape), len(lv)))
        or real_cycle(q, r, lv, *a))

    def down(q, r, lvl, coarse):
        transfers.append(("down", lvl.shape, coarse.shape))
        return mg._down_plain(q, r, lvl, coarse)

    def up(q, e_c, lvl):
        transfers.append(("up", lvl.shape))
        return mg._up_plain(q, e_c, lvl)

    want = mg.v_cycle(p, rhs, levels)
    assert len(smooths) == 2 * len(levels) - 1 and not tails
    for t in range(len(levels)):
        del smooths[:], transfers[:]
        got = mg._cycle(p, rhs, levels, 0, 2, 2, 32, mg._smooth, down, up, t)
        assert tails == [(levels[t].shape, len(levels) - t)]
        assert smooths == ([lv.shape for lv in levels[:t]]
                           + [lv.shape for lv in levels[:t]][::-1])
        assert transfers == (
            [("down", lv.shape, nxt.shape)
             for lv, nxt in zip(levels[:t], levels[1:t + 1])]
            + [("up", lv.shape) for lv in levels[:t]][::-1])
        assert torch.equal(got, want)
        del tails[:]


@pytest.mark.parametrize("shape", [(64, 64), (32, 48), (24, 34)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_transfer_twins_are_the_inline_composition(shape):
    """The plain transfers the V-cycle calls as hooks (and the card's
    kernels are held to) equal the composition the cycle wrote inline,
    bit for bit with signs, from a p whose ghost ring holds -0.0 and
    random values; and they stay within V_CYCLE_TOL of the JAX package's
    own composition (the prolongation exactly)."""
    prm, ref = _params(*shape)
    levels, jlevels = mg.build_levels(prm), jmg.build_levels(ref)
    lvl, coarse = levels[0], levels[1]
    rng = np.random.default_rng(shape[1])
    p = rng.standard_normal(lvl.shape).astype(np.float32) / lvl.dx2_inv
    p[0], p[:, -1] = -0.0, rng.standard_normal(lvl.shape[0])
    rhs = _interior_field(lvl.shape, rng)
    e = rng.standard_normal(coarse.shape).astype(np.float32)
    tp, trhs, te = map(torch.from_numpy, (p, rhs, e))

    def same_bits(a, b):
        return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                                 torch.signbit(b))

    r_c, e_c = mg._down_plain(tp, trhs, lvl, coarse)
    assert same_bits(r_c, mg._restrict(trhs - mg._lap(tp, lvl), coarse.shape))
    assert same_bits(e_c, torch.zeros(coarse.shape))
    up = mg._up_plain(tp, te, lvl)
    assert same_bits(up, tp + mg._prolong(te, lvl.shape))
    assert not torch.signbit(up[0, :-1]).any()  # -0.0 + 0.0 on the ring

    want = np.asarray(jmg._restrict(
        jnp.asarray(rhs) - jmg._lap(jnp.asarray(p), jlevels[0]),
        jlevels[1].shape))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(r_c.numpy() / scale, want / scale, rtol=0,
                               atol=V_CYCLE_TOL)
    np.testing.assert_array_equal(up.numpy(), np.asarray(
        jnp.asarray(p) + jmg._prolong(jnp.asarray(e), jlevels[0].shape)))


def test_cpu_v_cycle_never_calls_the_transfer_kernels(monkeypatch):
    """On a CPU tensor v_cycle, inner_v_cycle and v_cycle_plain run the
    plain transfers: no kernel wrapper is called, no launch and no fused
    level is counted."""
    def refuse(*_args, **_kw):
        raise AssertionError("a CPU cycle called a transfer kernel")

    for name in ("mg_restrict", "mg_prolong", "mg_restrict_unchecked",
                 "mg_prolong_unchecked"):
        monkeypatch.setattr(sor_kernel, name, refuse)
    prm, _ = _params(64, 32)
    levels = mg.build_levels(prm)
    rhs = torch.from_numpy(_interior_field(prm.shape,
                                           np.random.default_rng(2)))
    before = timing.counts()
    got = mg.v_cycle(torch.zeros(prm.shape), rhs, levels)
    assert torch.equal(got, mg.v_cycle_plain(torch.zeros(prm.shape), rhs,
                                             levels))
    assert torch.equal(mg.inner_v_cycle(rhs, 1, prm), got)
    after = timing.counts()
    assert after.get("mg.cycles", 0) == before.get("mg.cycles", 0) + 1
    assert {k: n for k, n in after.items()
            if k.startswith("launch.") or k == "mg.fused_levels"} == {
        k: n for k, n in before.items()
        if k.startswith("launch.") or k == "mg.fused_levels"}


# (levels, the depth the coarse cycle takes over, the whole-grid tile) of
# every configuration's grid.
CONFIG_ROUTES = {"1.in": (6, 1, (32, 32, 8)), "2.in": (7, 2, (32, 32, 8)),
                 "3.in": (8, 3, (64, 64, 8)), "4.in": (9, 4, (64, 64, 8)),
                 "5.in": (10, 5, (64, 64, 8)),
                 "channel.in": (4, 0, (32, 32, 8)),
                 "convection.in": (4, 0, (32, 32, 8)),
                 "dambreak.in": (4, 0, (32, 32, 8))}


def _compiled_tile_shapes():
    """(ti, tj, halo, rs, m, min_blocks) of every tile with a kernel
    compiled for its shape, read from the tile's source."""
    import re

    text = open(os.path.join(ROOT, "navierstokes_parallel_tpu_torch", "csrc",
                             "nsp_sor_tile.cuh")).read()
    table = text[text.index("constexpr HotShape kHotShapes[] = {"):]
    table = table[:table.index("};")]
    return [tuple(int(x) for x in row)
            for row in re.findall(r"\{(\d+), (\d+), (\d+), (\d+), (\d+), "
                                  r"(\d+)\}", table)]


def test_compiled_tile_shapes_cover_the_routes():
    """Each tile the wrappers pick on a main path has a kernel compiled for
    its shape, each such shape fits a block (rows per thread cover the
    haloed tile, at most 1024 threads) and delta of its haloed tile fits
    the shared memory of one block.  The compressed route runs
    whole_grid_tile's tiles in the colour-compacted layout, which is
    compiled for every row of the table too."""
    shapes = _compiled_tile_shapes()
    csrc = os.path.join(ROOT, "navierstokes_parallel_tpu_torch", "csrc")
    tile_src = open(os.path.join(csrc, "nsp_sor_tile.cuh")).read()
    assert "tile_chunk<kHotShapes[I].m, I, kCompact>)...}" in tile_src
    compressed_src = open(os.path.join(csrc, "sor_compressed.cu")).read()
    assert "tile_chunks_from_zero<true>(" in compressed_src
    assert "tile_report<true>(" in compressed_src
    assert len(shapes) >= 3
    for ti, tj, halo, rs, m, min_blocks in shapes:
        assert tj % 2 == 0 and halo % 2 == 0 and rs % 2 == 0
        assert rs * m >= ti + 2 * halo
        assert (tj // 2 + halo) * rs * min_blocks <= 2048
        assert (tj // 2 + halo) * rs <= 1024
        assert sor_kernel.tiled_shared_bytes(ti, halo // 2, tj) \
            <= sor_kernel.MAX_SHARED_BYTES
    keys = {s[:3] for s in shapes}
    for rows, cols, k in sor_kernel.WHOLE_GRID_TILES:
        assert (rows, cols, 2 * k) in keys
    assert (*sor_kernel.WARM_TILE, 4) in keys  # two sweeps: a 4-deep halo
    assert (sor_kernel.TILE_ROWS, sor_kernel.TILE_COLS,
            2 * sor_kernel.SWEEPS_PER_CHUNK) in keys
    assert (sor_kernel.EXT_TILE_ROWS, sor_kernel.TILE_COLS, 16) in keys


@pytest.mark.parametrize("source", sorted(CONFIG_ROUTES))
def test_routes_by_size_on_every_config(source):
    """On every configuration's grid: the whole-grid kernel's tile, the
    smoother's tile and the depth of the coarse cycle, each within one
    block's 232,448 B of shared memory."""
    prm = Params.from_file(os.path.join(ROOT, "configs", source))
    n_levels, depth, tile = CONFIG_ROUTES[source]
    limit = sor_kernel.MAX_SHARED_BYTES
    assert limit == 232448
    assert sor_kernel.whole_grid_tile(prm.shape) == tile
    assert sor_kernel.tiled_shared_bytes(tile[0], tile[2], tile[1]) <= limit
    big = sor_kernel.tile_blocks(prm.shape, 64, 64)
    assert (tile == (64, 64, 8)) == (big >= sor_kernel.WHOLE_GRID_MIN_BLOCKS)
    levels = mg.build_levels(prm)
    assert len(levels) == n_levels
    assert sor_kernel.tiled_shared_bytes(
        sor_kernel.WARM_TILE[0], sor_kernel.WARM_SWEEPS_PER_LAUNCH,
        sor_kernel.WARM_TILE[1]) <= limit
    assert sor_kernel.coarse_cycle_depth(levels) == depth
    tail = levels[depth:]
    assert sor_kernel.cycle_shared_bytes(tail) <= limit
    assert sor_kernel.cycle_shared_bytes(tail) == sum(
        8 * lv.shape[0] * lv.shape[1] for lv in tail)
    assert len(tail) <= sor_kernel.COARSE_CYCLE_MAX_LEVELS
    # Every level that fits one block alone lies in the coarse cycle: the
    # smoother is called on none of them.
    assert all(sor_kernel.cycle_shared_bytes([lv]) > limit
               for lv in levels[:depth])
    if depth:
        assert sor_kernel.cycle_shared_bytes(levels[depth - 1:]) > limit
    sor_kernel.check_cycle_inputs(torch.zeros(tail[0].shape),
                                  torch.zeros(tail[0].shape), tail, 2, 2, 32)
    if source == "4.in":  # 4 levels by the smoother, 5 in the one launch
        assert [lv.shape[0] for lv in levels[:depth]] == [2050, 1026, 514,
                                                          258]
        assert [lv.shape[0] for lv in tail] == [130, 66, 34, 18, 10]
        assert sor_kernel.cycle_shared_bytes(tail) == 182688


@pytest.mark.parametrize("shape,fits", [((170, 170), True),
                                        ((171, 170), False),
                                        ((10, 10), True),
                                        ((3, 9686), False),
                                        ((258, 258), False)])
def test_coarse_cycle_one_level_boundary(shape, fits):
    """29,056 cells of p and rhs are the most one block holds: a single
    level within that is a coarse cycle of its own, a larger one is left
    to the smoother and refused by the coarse cycle's checks."""
    levels = [(shape, 1.0, 1.0)]
    assert sor_kernel.coarse_cycle_depth(levels) == (0 if fits else 1)
    p = torch.zeros(shape)
    if fits:
        sor_kernel.check_cycle_inputs(p, p, levels, 2, 2, 32)
    else:
        with pytest.raises(ValueError, match="bytes of shared memory"):
            sor_kernel.check_cycle_inputs(p, p, levels, 2, 2, 32)


def test_coarse_cycle_depth_limits(monkeypatch):
    """The depth follows the byte limit and the level limit; no level
    fitting gives len(levels) (the V-cycle then never calls the kernel)."""
    prm = Params.from_file(os.path.join(ROOT, "configs", "4.in"))
    levels = mg.build_levels(prm)
    monkeypatch.setattr(sor_kernel, "MAX_SHARED_BYTES", 47488)
    assert sor_kernel.coarse_cycle_depth(levels) == 5  # from 66^2
    monkeypatch.setattr(sor_kernel, "MAX_SHARED_BYTES", 47487)
    assert sor_kernel.coarse_cycle_depth(levels) == 6
    monkeypatch.setattr(sor_kernel, "MAX_SHARED_BYTES", 0)
    assert sor_kernel.coarse_cycle_depth(levels) == len(levels)
    monkeypatch.setattr(sor_kernel, "MAX_SHARED_BYTES", 1 << 40)
    monkeypatch.setattr(sor_kernel, "COARSE_CYCLE_MAX_LEVELS", 3)
    assert sor_kernel.coarse_cycle_depth(levels) == 6


# --- the pressure solve -----------------------------------------------------

SOLVE_CASES = {
    # name: (JAX Params fields, rhs scale, seed)
    "128": (dict(i_max=128, j_max=128), 100.0, 2),
    "cycles2": (dict(i_max=64, j_max=64, mg_cycles_per_outer=2), 100.0, 5),
    "rect": (dict(i_max=32, j_max=32, a=2.0, b=1.0, max_it=1000), 1.0, 3),
    "max_it": (dict(i_max=64, j_max=64, max_it=3), 100.0, 5),
}


@pytest.mark.parametrize("method", ["mg", "cg"])
@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_pressure_matches_jax(case, method):
    fields, scale, seed = SOLVE_CASES[case]
    prm, ref = _params(**{"b": 1.0, "epsilon": 1e-4, "max_it": 20000,
                          **fields})
    rng = np.random.default_rng(seed)
    rhs = _interior_field(prm.shape, rng, scale, zero_mean=True)
    p0 = np.zeros(prm.shape, np.float32)
    got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs),
                             prm, method=method)
    want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), ref,
                               method=method)
    assert got.p.dtype == torch.float32
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged) == (case != "max_it")
    if method == "mg" and case == "cycles2":
        assert got.iterations % 2 == 0  # two V-cycles per outer pass
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))
    assert got.res_norm == pytest.approx(float(want.res_norm), rel=1e-4)


# --- the solver and the CLI -------------------------------------------------

CAVITIES = {
    "32x32": dict(i_max=32, j_max=32, T=0.05, Re=100.0, tau=0.5),
    "32x24": dict(i_max=32, j_max=24, T=0.05, Re=100.0, tau=0.5),
}


def _cavity(name, **kw):
    ref = JaxParams(dtype="float32", epsilon=1e-4, omega=1.7, max_it=2000,
                    **CAVITIES[name], **kw)
    return Params.from_mapping(dataclasses.asdict(ref)), ref


@pytest.mark.parametrize("name", sorted(CAVITIES))
def test_mg_cavity_matches_jax(name):
    """Step by step: equal V-cycles and convergence in every step, and the
    final fields within the contract."""
    prm, ref = _cavity(name)
    state = allocate_state(prm, "cpu")
    jstate = jsolver.allocate_state(ref)
    jstep = jax.jit(functools.partial(jsolver.step, params=ref,
                                      pressure_method="mg"))
    cycles, jcycles = [], []
    while float(state.t) < float(np.float32(prm.T)):
        state, diag = solver.step(state, prm, pressure_method="mg")
        jstate, jdiag = jstep(jstate)
        cycles.append((diag.sor_iterations, diag.sor_converged))
        jcycles.append((int(jdiag.sor_iterations), bool(jdiag.sor_converged)))
    assert float(jstate.t) >= float(np.float32(ref.T))
    assert cycles == jcycles and len(cycles) > 1
    assert all(converged for _, converged in cycles)
    for field in ("u", "v", "p"):
        assert_close_reference_contract(getattr(state, field).numpy(),
                                        np.asarray(getattr(jstate, field)))
    _, stats = solver.solve(prm, device="cpu", pressure_method="mg")
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        len(cycles), sum(c for c, _ in cycles), 0)


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


@pytest.mark.parametrize("method,max_steps", [("mg", 0), ("mg", 2),
                                              ("cg", 0)])
def test_cli_method_matches_jax_cli(method, max_steps, tmp_path, capsys):
    _, ref = _cavity("32x24")
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    argv = [path, "--method", method, "--stats"]
    if max_steps:
        argv += ["--max-steps", str(max_steps)]
    rc, out, err = _run_cli(cli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout, jerr = _run_cli(jcli.main, argv, capsys)
    # --max-steps stops before T: exit code 3, as the JAX CLI's.
    assert rc == jrc == (3 if max_steps else 0)
    assert [line.split(":")[0] for line in out] == ["U-CENTER", "V-CENTER"]
    assert_close_reference_contract(
        [float(line.split()[1]) for line in out],
        [float(line.split()[1]) for line in jout])
    assert len(err) == len(jerr) == 3 and err[1] == jerr[1] == ""
    float(err[2])
    assert err[0].split()[:3] == jerr[0].split()[:3]
    if max_steps:
        assert err[0].split()[0] == f"steps={max_steps}"


def test_cli_rejects_negative_max_steps(tmp_path, capsys):
    _, ref = _cavity("32x24")
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    rc, out, err = _run_cli(cli.main, [path, "--device", "cpu",
                                       "--max-steps", "-1"], capsys)
    assert rc == 1 and not out and "max-steps" in err[0]


# --- the sharded multigrid and cg pieces, one rank ----------------------------
#
# A one-rank gloo group against the JAX pieces inside a one-device
# shard_map (the four-rank solves are in tests/test_torch_sharded.py).

SHARDED_TOL = 1e-6  # relative to max|p|: the smoother's and V-cycle's
CG_TOL = 1e-5       # ten f32 CG steps, dot products summed in other orders


@pytest.fixture
def one_rank():
    from navierstokes_parallel_tpu_torch.parallel import topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    with distributed.process_group("cpu"):
        yield topology.make_grid_mesh(shape=(1, 1), device="cpu")


def _one_device(fn, *arrays):
    """fn on a one-device ("x", "y") shard_map, numpy in and out."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    try:
        shard_map = jax.shard_map
    except AttributeError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("x", "y"))
    spec = P("x", "y")
    mapped = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                               out_specs=spec, check_vma=False))
    return np.asarray(mapped(*(jnp.asarray(a) for a in arrays)))


def _assert_rel(got, want, tol):
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("blocks", [(64, 64), (32, 24), (12, 10), (6, 6),
                                    (17, 16)], ids=lambda b: f"{b[0]}x{b[1]}")
def test_build_levels_sharded_matches_jax(blocks):
    prm, ref = _params(blocks[0] * 2, blocks[1] * 4)
    got = mg.build_levels_sharded(prm, *blocks)
    want = jmg.build_levels_sharded(ref, *blocks)
    assert [tuple(map(tuple, lv[:2])) + lv[2:] for lv in got] == \
        [tuple(map(tuple, lv[:2])) + tuple(lv[2:]) for lv in want]


@pytest.mark.parametrize("n", [2, 6], ids=["deep", "exchange_per_half"])
def test_smooth_sharded_matches_jax(one_rank, n):
    """The deep-halo smoother (2n <= min(li, lj): one exchange, the extended
    block's sweeps through sor_kernel.ext_sweeps) and the exchange before
    every half-sweep (2n > min(li, lj))."""
    prm, ref = _params(12, 10)
    level = mg.build_levels_sharded(prm, 12, 10)[0]
    assert (2 * n <= 10) == (n == 2)
    rng = np.random.default_rng(n)
    p = rng.standard_normal(prm.shape).astype(np.float32)
    rhs = _interior_field(prm.shape, rng)
    got = mg._smooth_sharded(torch.from_numpy(p), torch.from_numpy(rhs),
                             level, n, one_rank)
    want = _one_device(lambda a, b: jmg._smooth_sharded(a, b, level, n), p,
                       rhs)
    _assert_rel(got.numpy(), want, SHARDED_TOL)


@pytest.mark.parametrize("shape", [(64, 64), (32, 24)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_v_cycle_sharded_matches_jax(one_rank, shape):
    """One sharded V-cycle: deep-halo smoothing on the levels down to the
    local floor of 4 cells, then the replicated coarse solve."""
    prm, ref = _params(*shape)
    levels = mg.build_levels_sharded(prm, *shape)
    assert len(levels) >= 2
    rng = np.random.default_rng(7)
    rhs = _interior_field(prm.shape, rng, scale=1.0 / prm.dx ** 2,
                          zero_mean=True)
    p0 = np.zeros(prm.shape, np.float32)
    got = mg.v_cycle_sharded(torch.from_numpy(p0), torch.from_numpy(rhs),
                             levels, one_rank)
    jlevels = jmg.build_levels_sharded(ref, *shape)
    want = _one_device(lambda a, b: jmg.v_cycle_sharded(a, b, jlevels), p0,
                       rhs)
    _assert_rel(got.numpy(), want, SHARDED_TOL)


@pytest.mark.parametrize("inner", ["mg", "cg", "fft"])
def test_sharded_inners_match_jax(one_rank, inner, monkeypatch):
    """The sharded backend's inner stages, one call each as an outer pass
    makes it: one V-cycle, ten CG steps, one pencil DCT solve."""
    from navierstokes_parallel_tpu.ops import fft as jfft
    from navierstokes_parallel_tpu_torch.ops import fft

    monkeypatch.setattr(jfft, "PREFER_RFFT", True)
    prm, ref = _params(32, 24)
    n = {"mg": 1, "cg": 10, "fft": 1}[inner]
    rhs = _interior_field(prm.shape, np.random.default_rng(8), zero_mean=True)
    make = {"mg": (mg.make_sharded_inner, jmg.make_sharded_inner),
            "cg": (mg.make_sharded_cg_inner, jmg.make_sharded_cg_inner),
            "fft": (fft.make_sharded_inner, jfft.make_sharded_inner)}[inner]
    got = make[0](prm, 32, 24, one_rank)(torch.from_numpy(rhs), n)
    want = _one_device(
        lambda b: make[1](ref, 32, 24)(b, jnp.asarray(n, jnp.int32)), rhs)
    _assert_rel(got.numpy()[1:-1, 1:-1], want[1:-1, 1:-1],
                CG_TOL if inner == "cg" else SHARDED_TOL)
