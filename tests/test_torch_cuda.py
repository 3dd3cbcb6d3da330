"""The CUDA side of the port: the build, the wrappers' checks, and (on a
machine with an NVIDIA GPU) each kernel against its plain PyTorch version
and the GPU solves against the CPU ones.

The tests marked ``gpu`` need the card and skip without one; run them on
the GPU machine with (tests/conftest.py imports jax, which that machine
lacks, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

This file imports no jax.  The other tests run on any machine: they need
neither nvcc nor a GPU.
"""

import os
import shutil
import stat

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state, resolve_device
from navierstokes_parallel_tpu_torch.ops.cuda import (_build, momentum_kernel,
                                                      sor_kernel)

# Kernel vs plain on the card, relative to the plain result's max: both
# round every f32 operation once in the same order (no FMA contraction in
# the kernels), so they agree bit for bit; the bound is a margin, not an
# expected error.
KERNEL_RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _params(i_max, j_max):
    return Params(i_max=i_max, j_max=j_max, a=1.0, b=0.8, Re=400.0,
                  g_x=0.1, g_y=-0.3, omega=1.7)


def _rhs(prm, seed=0):
    rng = np.random.default_rng(seed)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    return torch.from_numpy(rhs)


def _uv(prm, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32))
            for _ in range(2)]


# --- failure paths, any machine ---------------------------------------------

def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        allocate_state(_params(8, 8), "cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _isolate_build(monkeypatch, tmp_path, path_dirs=()):
    """Point the build at an empty build directory and a PATH without
    nvcc (plus `path_dirs`), with no toolkit at the fallback locations."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", os.pathsep.join(map(str, path_dirs)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'sor.cu(1): error: refused' >&2\n"
                    "exit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    _isolate_build(monkeypatch, tmp_path, [bindir])
    with pytest.raises(_build.KernelBuildError,
                       match="(?s)exit 2.*sm_90a.*refused"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_source_contents(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path()
    assert [p.name for p in _build.sources()] == [
        "mg_cycle.cu", "momentum.cu", "sor.cu", "sor_compressed.cu",
        "sor_ext.cu", "sor_tiled.cu"]
    with open(csrc / "nsp_round.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build.library_path() != first
    assert _build.library_path().parent == _build.BUILD_DIR


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "negative"])
def test_sor_checks_before_launch(bad):
    prm = _params(10, 6)
    rhs, n = _rhs(prm), 4
    if bad == "float64":
        rhs = rhs.double()
    elif bad == "shape":
        rhs = rhs[:-1]
    elif bad == "strided":
        rhs = torch.zeros(prm.shape[1], prm.shape[0]).t()
    else:
        n = -1
    with pytest.raises((TypeError, ValueError)):
        sor_kernel.check_inputs(rhs, n, prm)
    sor_kernel.check_inputs(_rhs(prm), 4, prm)  # the good case passes


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "negative",
                                 "1d", "device"])
def test_warm_checks_before_launch(bad):
    prm = _params(10, 6)
    p, rhs, n = _rhs(prm, seed=1), _rhs(prm), 2
    if bad == "float64":
        p = p.double()
    elif bad == "shape":
        rhs = rhs[:, :-1].contiguous()
    elif bad == "strided":
        p = torch.zeros(prm.shape[1], prm.shape[0]).t()
    elif bad == "negative":
        n = -1
    elif bad == "1d":
        p, rhs = p.flatten(), rhs.flatten()
    else:
        p = p.to("meta")
    with pytest.raises((TypeError, ValueError)):
        sor_kernel.check_warm_inputs(p, rhs, n)
    sor_kernel.check_warm_inputs(_rhs(prm, seed=1), _rhs(prm), 2)


@pytest.mark.parametrize("bad", ["float64", "shape", "strided"])
def test_momentum_checks_before_launch(bad):
    prm = _params(10, 6)
    u, v = _uv(prm)
    if bad == "float64":
        v = v.double()
    elif bad == "shape":
        u = u[:, :-1]
    else:
        u = torch.zeros(prm.shape[1], prm.shape[0]).t()
    with pytest.raises((TypeError, ValueError)):
        momentum_kernel.check_inputs(u, v, prm)
    momentum_kernel.check_inputs(*_uv(prm), prm)


@pytest.mark.parametrize("bad", ["zero", "over_4096", "shared", "chunk"])
def test_tiled_checks_before_launch(bad):
    """A tile the tiled kernel cannot take is refused, never clamped; the
    error names the shared-memory size."""
    tile, k, match = {"zero": (0, 8, r"\[1, 4096\]"),
                      "over_4096": (4097, 8, r"\[1, 4096\]"),
                      "shared": (574, 8, "232704 bytes of shared memory"),
                      "chunk": (64, 0, "sweeps_per_chunk")}[bad]
    with pytest.raises(ValueError, match=match):
        sor_kernel.check_tile(tile, k)
    sor_kernel.check_tile(573, 8)  # the largest tile that fits at K = 8
    assert sor_kernel.tiled_shared_bytes(573, 8) <= sor_kernel.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        sor_kernel.inner_sweeps_tiled(_rhs(_params(8, 8)), 2, _params(8, 8),
                                      tile_rows=64, sweeps_per_chunk=64)


@pytest.mark.parametrize("rows,k,cols,want", [
    (64, 8, 64, 4 * 96 * 96),      # the default tile: delta alone, f32
    (573, 8, 64, 4 * 605 * 96),    # the largest at K = 8
    (1, 1, 64, 4 * 5 * 68),
    (13, 3, 8, 4 * 25 * 20)])
def test_tiled_shared_bytes_hold_delta_alone(rows, k, cols, want):
    """The tile keeps rhs out of shared memory: 4 bytes per cell of the
    tile and its 2K-deep halo."""
    assert sor_kernel.tiled_shared_bytes(rows, k, cols) == want


def test_ext_shared_bytes_and_the_largest_ns():
    """B6's tile (EXT_TILE_ROWS x TILE_COLS, halo 2 ns): delta alone; ns =
    44 is the most that fits one block at 64 x 64, 45 is refused."""
    assert sor_kernel.ext_shared_bytes(8) == 4 * 96 * 96
    assert sor_kernel.ext_shared_bytes(0) == 4 * 64 * 64
    assert sor_kernel.ext_shared_bytes(44) <= sor_kernel.MAX_SHARED_BYTES
    assert sor_kernel.ext_shared_bytes(45) > sor_kernel.MAX_SHARED_BYTES
    sor_kernel.check_ext_inputs(torch.zeros(8, 8), torch.zeros(8, 8), 44, 88)
    with pytest.raises(ValueError, match="shared memory"):
        sor_kernel.check_ext_inputs(torch.zeros(8, 8), torch.zeros(8, 8), 45,
                                    90)


@pytest.mark.parametrize("rows,cols,ns,want", [
    (64, 64, 8, 1.54443359375),  # vs 94^2 / 64^2 = 2.157 over the full tile
    (64, 64, 1, 1.03173828125),
    (10, 10, 0, 0.0)])
def test_tile_updates_per_cell(rows, cols, ns, want):
    """The trapezoid: half-sweep h updates the centre widened by
    2 ns - 1 - h, half of it (one colour)."""
    assert sor_kernel.tile_updates_per_cell(rows, cols, ns) == want


def test_compressed_takes_even_widths_only():
    prm = _params(10, 7)  # padded width 9
    with pytest.raises(ValueError, match="even padded width"):
        sor_kernel.inner_sweeps_compressed(_rhs(prm), 2, prm)


def test_wrappers_raise_on_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    is refused, not computed by the plain version."""
    prm = _params(6, 6)
    meta = torch.zeros(prm.shape, device="meta")
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.inner_sweeps(meta, 2, prm)
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.inner_sweeps_tiled(meta, 2, prm)
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.inner_sweeps_compressed(meta, 2, prm)
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.warm_sweeps(meta, meta, 2, 1.0, 4.0, 4.0)
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.coarse_cycle(meta, meta, [(prm.shape, 4.0, 4.0)])
    with pytest.raises(ValueError, match="no momentum kernel"):
        momentum_kernel.momentum_rhs(meta, meta, 0.1, 0.1, prm)


@pytest.mark.parametrize("bad", ["ns_over_half_H", "negative", "shared",
                                 "float64", "shape", "strided", "device"])
def test_ext_checks_before_launch(bad):
    """What the extended-block kernel does not take is refused before a
    launch: ns beyond H / 2 (the core would not be exact), a tile beyond
    one block's shared memory (named), mismatched or strided blocks, and
    tensors neither on the CPU nor on CUDA (no silent fallback)."""
    d, rhs = torch.zeros(40, 36), torch.zeros(40, 36)
    ns, H, match = 4, 8, None
    if bad == "ns_over_half_H":
        ns, match = 5, "H / 2"
    elif bad == "negative":
        ns = -1
    elif bad == "shared":
        ns, H, match = 48, 96, "shared memory"
    elif bad == "float64":
        d = d.double()
    elif bad == "shape":
        rhs = rhs[:, :-1].contiguous()
    elif bad == "strided":
        d = torch.zeros(36, 40).t()
    if bad == "device":
        meta = torch.zeros(40, 36, device="meta")
        with pytest.raises(ValueError, match="no SOR kernel"):
            sor_kernel.ext_sweeps(meta, meta, 2, (0, 0), 4, _params(38, 34))
        return
    with pytest.raises((TypeError, ValueError), match=match):
        sor_kernel.check_ext_inputs(d, rhs, ns, H)
    sor_kernel.check_ext_inputs(torch.zeros(40, 36), torch.zeros(40, 36), 4, 8)
    assert sor_kernel.ext_shared_bytes(44) <= sor_kernel.MAX_SHARED_BYTES


def test_kernel_used_only_for_f32_cuda():
    prm = _params(6, 6)
    assert momentum_kernel.usable(prm, "cuda")
    assert not momentum_kernel.usable(prm, "cpu")
    assert not momentum_kernel.usable(prm.replace(dtype="float64"), "cuda")


# --- on the card -------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 13, 64])
@pytest.mark.parametrize("shape", [(256, 256), (97, 61), (8, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sor_kernel_matches_plain(cuda, shape, n):
    prm = _params(*shape)
    rhs = _rhs(prm, seed=n).to(cuda)
    before = sor_kernel.LAUNCHES
    got = sor_kernel.inner_sweeps(rhs, n, prm)
    want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
    torch.cuda.synchronize()
    assert sor_kernel.LAUNCHES == before + 1
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) / scale <= KERNEL_RTOL
    assert torch.equal(got, sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("n", [1, 8, 20, 64])
@pytest.mark.parametrize("shape", [(256, 256), (2048, 2048), (97, 61),
                                   (8, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tiled_kernel_matches_plain_and_whole_grid(cuda, shape, n, tile):
    """B4 bit for bit against its plain twin (full-width strips) and the
    first whole-grid kernel (one launch per half-sweep, no tile): n = 20
    ends on a short chunk (8 + 8 + 4)."""
    prm = _params(*shape)
    rhs = _rhs(prm, seed=n).to(cuda)
    before = sor_kernel.TILED_LAUNCHES
    got = sor_kernel.inner_sweeps_tiled(rhs, n, prm, tile_rows=tile)
    torch.cuda.synchronize()
    assert sor_kernel.TILED_LAUNCHES == before + 1
    assert torch.equal(got,
                       sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))
    assert torch.equal(got, sor_kernel.inner_sweeps_tiled_plain(
        rhs, n, prm, tile_rows=tile))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 64])
@pytest.mark.parametrize("shape", [(256, 256), (96, 62)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compressed_kernel_matches_plain_and_whole_grid(cuda, shape, n):
    """B5 bit for bit against its plain twin and the first whole-grid
    kernel."""
    prm = _params(*shape)
    rhs = _rhs(prm, seed=n).to(cuda)
    before = sor_kernel.COMPRESSED_LAUNCHES
    got = sor_kernel.inner_sweeps_compressed(rhs, n, prm)
    torch.cuda.synchronize()
    assert sor_kernel.COMPRESSED_LAUNCHES == before + 1
    assert torch.equal(got,
                       sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))
    assert torch.equal(got, sor_kernel.inner_sweeps_compressed_plain(
        rhs, n, prm))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 7, 64])
@pytest.mark.parametrize("shape", [(256, 256), (96, 62), (62, 60), (97, 62)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compressed_tile_equals_twin_and_first_kernels(cuda, shape, n,
                                                       monkeypatch):
    """B5 on the temporal tile over the compacted arrays, bit for bit
    against its plain twin, the first whole-grid kernel and its own first
    kernel (one launch per half-sweep on the compacted arrays), at 258^2,
    98 x 64, 64 x 62 and an odd row count (99 x 64), from buffers the
    kernel must fill itself: n = 0 is one chunk of no sweeps, 7 a short
    one, 64 eight."""
    prm = _params(*shape)
    rhs = _rhs(prm, seed=n).to(cuda)
    _poison_empty(monkeypatch)
    before = sor_kernel.COMPRESSED_LAUNCHES
    got = sor_kernel.inner_sweeps_compressed(rhs, n, prm)
    assert sor_kernel.COMPRESSED_LAUNCHES == before + 1
    assert torch.equal(got, sor_kernel.inner_sweeps_compressed_plain(
        rhs, n, prm))
    assert torch.equal(got, sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))
    assert torch.equal(got, sor_kernel.inner_sweeps_compressed_simple(
        rhs, n, prm))
    ring = torch.ones(prm.shape, dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert not got[ring].any()


@pytest.mark.gpu
def test_compressed_tile_has_a_kernel_compiled_for_it(cuda):
    """The compacted layout has a kernel compiled for every tile
    whole_grid_tile can pick (rhs in registers, no run-time shape), with
    the full layout's geometry."""
    for rows, cols, k in sor_kernel.WHOLE_GRID_TILES:
        report = sor_kernel.tile_report(rows, cols, 2 * k, compact=True)
        full = sor_kernel.tile_report(rows, cols, 2 * k)
        assert report["rows_per_thread"] > 0
        assert report["registers"] <= 80, report
        for key in ("rows", "cols", "rows_per_thread", "threads",
                    "shared_bytes"):
            assert report[key] == full[key]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["budget", "forced_off", "compressed",
                                  "compressed_odd", "forced_on"])
def test_inner_sweeps_routes_on_the_card(cuda, case, monkeypatch):
    shape, counter = {"budget": ((2048, 2048), "TILED_LAUNCHES"),
                      "forced_off": ((2048, 2048), "LAUNCHES"),
                      "compressed": ((64, 62), "COMPRESSED_LAUNCHES"),
                      "compressed_odd": ((64, 61), "LAUNCHES"),
                      "forced_on": ((64, 61), "TILED_LAUNCHES")}[case]
    if case == "forced_off":
        monkeypatch.setattr(sor_kernel, "PREFER_TILED", False)
    if case == "forced_on":
        monkeypatch.setattr(sor_kernel, "PREFER_TILED", True)
    if case.startswith("compressed"):
        monkeypatch.setattr(sor_kernel, "USE_COMPRESSED", True)
    prm = _params(*shape)
    rhs = _rhs(prm).to(cuda)
    counts = {name: getattr(sor_kernel, name) for name in (
        "LAUNCHES", "TILED_LAUNCHES", "COMPRESSED_LAUNCHES")}
    got = sor_kernel.inner_sweeps(rhs, 9, prm)
    for name, before in counts.items():
        assert getattr(sor_kernel, name) == before + (name == counter)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, 9, prm))


@pytest.mark.gpu
def test_tiled_solve_equals_whole_grid_solve(cuda, monkeypatch):
    """A cavity forced onto the tiled route (small tiles, several per axis)
    gives the whole-grid route's fields bit for bit."""
    prm = Params(i_max=48, j_max=40, T=0.02, Re=100.0, tau=0.5, max_it=500)
    monkeypatch.setattr(sor_kernel, "TILE_ROWS", 13)
    runs = {}
    for tiled in (True, False):
        monkeypatch.setattr(sor_kernel, "PREFER_TILED", tiled)
        runs[tiled] = solver.solve(prm, device=cuda,
                                   pressure_method="pallas_sor")
    (ts, tstats), (ws, wstats) = runs[True], runs[False]
    assert tstats == wstats and tstats.steps > 1
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(ts, name), getattr(ws, name))


def _poison_empty(monkeypatch):
    """torch.empty and torch.empty_like hand out NaNs."""
    real_empty = torch.empty

    def poisoned(*args, **kw):
        return real_empty(*args, **kw).fill_(float("nan"))

    monkeypatch.setattr(torch, "empty", poisoned)
    monkeypatch.setattr(torch, "empty_like",
                        lambda x, **kw: poisoned(x.shape, dtype=x.dtype,
                                                 device=x.device))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 7, 32, 64, 2048])
@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (2048, 2048),
                                   (97, 61), (96, 62)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_whole_grid_kernel_equals_plain_and_first_kernel(cuda, shape, n,
                                                         monkeypatch):
    """B1 through the temporal tile, bit for bit against its plain twin and
    against its first kernel (one launch per half-sweep), from buffers the
    kernel must fill itself, the ghost ring's zeros included: n = 0 (one
    chunk of no sweeps), short last chunks (7, 32 = what configs/1.in's
    last outer pass runs), 2048 (one outer pass at K = 2048).  The plain
    twin is left out where it would take minutes."""
    prm = _params(*shape)
    rhs = _rhs(prm, seed=n).to(cuda)
    _poison_empty(monkeypatch)
    got = sor_kernel.whole_grid_sweeps(rhs, n, prm)
    assert torch.equal(got, sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))
    if n * prm.shape[0] * prm.shape[1] <= 64 * 2050 * 2050:
        assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, n, prm))
    ring = torch.ones(prm.shape, dtype=torch.bool, device=cuda)
    ring[1:-1, 1:-1] = False
    assert not got[ring].any()


@pytest.mark.gpu
def test_whole_grid_tile_has_a_kernel_compiled_for_it(cuda):
    """Every tile whole_grid_tile can pick is one of the tile's compiled
    shapes (rhs in registers, no run-time shape)."""
    for rows, cols, k in sor_kernel.WHOLE_GRID_TILES:
        report = sor_kernel.tile_report(rows, cols, 2 * k)
        assert report["rows_per_thread"] > 0
        assert report["registers"] <= 80, report
        assert report["shared_bytes"] == sor_kernel.tiled_shared_bytes(
            rows, k, cols)
    report = sor_kernel.tile_report(*sor_kernel.WARM_TILE, 4)
    assert (report["rows"], report["cols"]) == (40, 72)
    assert report["registers"] <= 80, report


def test_simple_kernels_take_cuda_tensors_only():
    """The yardstick kernels have no plain twin to fall to."""
    prm = _params(6, 6)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.whole_grid_sweeps_simple(_rhs(prm), 2, prm)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.warm_sweeps_simple(_rhs(prm), _rhs(prm), 2, 1.0, 4.0, 4.0)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.inner_sweeps_compressed_simple(_rhs(prm), 2, prm)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.compressed_colour_sweeps(
            sor_kernel._compress_planar(_rhs(prm)), 2, prm)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        momentum_kernel.momentum_rhs_simple(*_uv(prm), 0.1, 0.2, prm)


def _levels(i_max, j_max):
    """Multigrid levels of an i_max x j_max grid whose spacings differ
    between the axes."""
    from navierstokes_parallel_tpu_torch.ops import mg

    return mg.build_levels(Params(i_max=i_max, j_max=j_max, a=1.0, b=0.8))


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "negative",
                                 "no_level", "nine_levels", "first_shape",
                                 "not_halved", "shared", "device"])
def test_coarse_cycle_checks_before_launch(bad):
    """What the coarse-cycle kernel does not take is refused before a
    launch, the shared-memory need by name."""
    levels = list(_levels(32, 16))
    assert [lv.shape for lv in levels] == [(34, 18), (18, 10)]
    p, rhs = torch.zeros(34, 18), torch.zeros(34, 18)
    counts, match = (2, 2, 32), None
    if bad == "float64":
        p = p.double()
    elif bad == "shape":
        rhs = rhs[:, :-1].contiguous()
    elif bad == "strided":
        p = torch.zeros(18, 34).t()
    elif bad == "negative":
        counts = (2, -1, 32)
    elif bad == "no_level":
        levels, match = [], "1 to 8 levels"
    elif bad == "nine_levels":
        levels, match = levels * 5, "1 to 8 levels"
    elif bad == "first_shape":
        levels, match = levels[1:], "first level"
    elif bad == "not_halved":
        levels, match = [levels[0], levels[0]], "halve"
    elif bad == "shared":
        levels = list(_levels(256, 256))[:2]
        p, rhs = torch.zeros(258, 258), torch.zeros(258, 258)
        match = "bytes of shared memory"
    if bad == "device":
        meta = torch.zeros(34, 18, device="meta")
        with pytest.raises(ValueError, match="no SOR kernel"):
            sor_kernel.coarse_cycle(meta, meta, levels)
        return
    with pytest.raises((TypeError, ValueError), match=match):
        sor_kernel.check_cycle_inputs(p, rhs, levels, *counts)
    sor_kernel.check_cycle_inputs(torch.zeros(34, 18), torch.zeros(34, 18),
                                  _levels(32, 16), 2, 2, 32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2, 32])
@pytest.mark.parametrize("omega", [1.0, 1.7])
@pytest.mark.parametrize("shape", [(2050, 2050), (1026, 1026), (514, 514),
                                   (258, 258), (130, 130), (66, 66),
                                   (10, 10), (99, 63), (300, 77)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_warm_kernel_matches_plain(cuda, shape, omega, n, monkeypatch):
    """The smoother on the tile (from 2050^2 down to a level smaller than
    one tile; n = 32 takes four launches between two buffers) bit for bit
    against the plain twin and against the first kernel (one launch per
    half-sweep), from a random p0 whose ghost ring is not 0, into a buffer
    the kernel must fill itself."""
    rng = np.random.default_rng(n)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    p, rhs = p.to(cuda), rhs.to(cuda)
    dx2, dy2 = 0.9 * shape[0] ** 2, 1.3 * shape[1] ** 2
    before = sor_kernel.WARM_LAUNCHES
    _poison_empty(monkeypatch)
    got = sor_kernel.warm_sweeps(p, rhs, n, omega, dx2, dy2)
    want = sor_kernel.warm_sweeps_plain(p, rhs, n, omega, dx2, dy2)
    torch.cuda.synchronize()
    assert sor_kernel.WARM_LAUNCHES == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, sor_kernel.warm_sweeps_simple(p, rhs, n, omega,
                                                          dx2, dy2))
    assert torch.equal(got[0], p[0]) and torch.equal(got[:, -1], p[:, -1])
    assert torch.equal(got[-1], p[-1]) and torch.equal(got[:, 0], p[:, 0])


# Hierarchies the coarse cycle takes whole: (i_max, j_max) of its finest
# level.  128^2 is the tail of configs/4.in; 8^2 is a single level.
CYCLES = [(128, 128), (64, 64), (64, 32), (96, 80), (8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [(2, 2, 32), (0, 1, 0), (3, 0, 5)],
                         ids=lambda c: "nu%d_%d_coarse%d" % c)
@pytest.mark.parametrize("size", CYCLES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_coarse_cycle_matches_plain(cuda, size, counts, monkeypatch):
    """The V-cycle's coarse tail in one launch, bit for bit against its
    plain twin (ops/mg.py's recursion on the plain smoother) and against
    the same recursion on the first smoother kernel, from a random p and
    rhs whose ghost rings are not 0."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(*size)
    assert sor_kernel.coarse_cycle_depth(levels) == 0
    rng = np.random.default_rng(size[0] + counts[0])
    p, rhs = (torch.from_numpy(rng.standard_normal(levels[0].shape).astype(
        np.float32)).to(cuda) for _ in range(2))
    before = sor_kernel.CYCLE_LAUNCHES
    _poison_empty(monkeypatch)
    got = sor_kernel.coarse_cycle(p, rhs, levels, *counts)
    torch.cuda.synchronize()
    assert sor_kernel.CYCLE_LAUNCHES == before + 1
    assert torch.equal(got, sor_kernel.coarse_cycle_plain(p, rhs, levels,
                                                          *counts))

    def simple(q, rhs_l, lvl, n):
        return sor_kernel.warm_sweeps_simple(q, rhs_l, n, 1.0, lvl.dx2_inv,
                                             lvl.dy2_inv)

    assert torch.equal(got, mg._cycle(p, rhs, levels, 0, *counts, simple,
                                      len(levels)))


@pytest.mark.gpu
def test_v_cycle_on_card_calls_smoother_and_coarse_cycle(cuda):
    """At 512^2 (7 levels, the coarse cycle from 130^2: depth 2) a V-cycle
    launches the smoother 2 x 2 times and the coarse cycle once, and equals
    the plain recursion bit for bit."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(512, 512)
    t = sor_kernel.coarse_cycle_depth(levels)
    assert (len(levels), t, levels[t].shape) == (7, 2, (130, 130))
    rng = np.random.default_rng(11)
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((512, 512))
    rhs = torch.from_numpy(rhs).to(cuda)
    p = torch.zeros_like(rhs)
    sor_kernel.WARM_LAUNCHES = sor_kernel.CYCLE_LAUNCHES = 0
    got = mg.v_cycle(p, rhs, levels)
    assert (sor_kernel.WARM_LAUNCHES, sor_kernel.CYCLE_LAUNCHES) == (2 * t, 1)
    assert torch.equal(got, mg.v_cycle_plain(p, rhs, levels))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 256), (97, 61), (8, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_momentum_kernel_matches_plain(cuda, shape):
    prm = _params(*shape)
    u, v = (x.to(cuda) for x in _uv(prm, seed=shape[0]))
    dt = torch.tensor(0.003, device=cuda)
    gamma = torch.tensor(0.8, device=cuda)
    before = momentum_kernel.LAUNCHES
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
    torch.cuda.synchronize()
    assert momentum_kernel.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) / float(w.abs().max()) <= KERNEL_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("scalars", ["tensors", "floats"])
@pytest.mark.parametrize("shape", [(256, 256), (2048, 2048), (97, 61),
                                   (5, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_momentum_equals_plain_and_first_kernel(cuda, shape, scalars,
                                                      monkeypatch):
    """The fused B2 kernel, one launch, bit for bit against its plain twin
    and the first kernel (two launches) at 258^2, 2050^2, 99 x 63 and a
    grid smaller than one tile, random dt and gamma as 0-d device tensors
    or Python floats, into buffers that start as NaN."""
    prm = _params(*shape)
    u, v = (x.to(cuda) for x in _uv(prm, seed=shape[1]))
    rng = np.random.default_rng(shape[0])
    dt, gamma = (float(x) for x in rng.uniform(1e-4, 1e-2, 2))
    if scalars == "tensors":
        dt, gamma = (torch.tensor(x, device=cuda) for x in (dt, gamma))
    _poison_empty(monkeypatch)
    before = momentum_kernel.LAUNCHES
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    assert momentum_kernel.LAUNCHES == before + 1
    for want in (momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm),
                 momentum_kernel.momentum_rhs_simple(u, v, dt, gamma, prm)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernels_raise_on_bad_cuda_input(cuda):
    prm = _params(16, 16)
    with pytest.raises(TypeError):
        sor_kernel.inner_sweeps(_rhs(prm).double().to(cuda), 2, prm)
    for wrapper in (sor_kernel.inner_sweeps_tiled,
                    sor_kernel.inner_sweeps_compressed):
        with pytest.raises(TypeError):
            wrapper(_rhs(prm).double().to(cuda), 2, prm)
        with pytest.raises(ValueError):
            wrapper(_rhs(prm)[:-1].to(cuda), 2, prm)
    with pytest.raises(ValueError, match="shared memory"):
        sor_kernel.inner_sweeps_tiled(_rhs(prm).to(cuda), 2, prm,
                                      tile_rows=600)
    odd = _params(16, 15)
    with pytest.raises(ValueError, match="even padded width"):
        sor_kernel.inner_sweeps_compressed(_rhs(odd).to(cuda), 2, odd)
    u, v = (x.to(cuda) for x in _uv(prm))
    with pytest.raises(ValueError):
        momentum_kernel.momentum_rhs(u, v.cpu(), 0.1, 0.1, prm)


@pytest.mark.gpu
def test_gpu_solve_matches_cpu_solve(cuda):
    """A converging cavity on the card (both kernels) and on the CPU (plain
    versions): equal iteration counts, fields within the 1e-4 contract."""
    prm = Params(i_max=32, j_max=24, T=0.05, Re=100.0, tau=0.5,
                 max_it=2000)
    sor_kernel.LAUNCHES = momentum_kernel.LAUNCHES = 0
    gs, gstats = solver.solve(prm, device=cuda, pressure_method="pallas_sor")
    assert sor_kernel.LAUNCHES > 0 and momentum_kernel.LAUNCHES == gstats.steps
    cs, cstats = solver.solve(prm, device="cpu", pressure_method="pallas_sor")
    assert gstats[:3] == cstats[:3] and gstats.sor_failures == 0
    for name in ("u", "v", "p"):
        g = getattr(gs, name).cpu().numpy()
        c = getattr(cs, name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["mg", "cg"])
def test_gpu_mg_cg_solve_matches_cpu_solve(cuda, method):
    """The multigrid and CG paths on the card and on the CPU: equal counts,
    fields within the 1e-4 contract; a V-cycle whose coarse cycle starts at
    depth t launches the smoother 2 t times and the coarse cycle once (all
    four levels of a 64^2 grid fit the coarse cycle: t = 0), and never the
    SOR kernel."""
    from navierstokes_parallel_tpu_torch.ops import mg

    prm = Params(i_max=64, j_max=64, T=0.06, Re=100.0, tau=0.5,
                 max_it=2000)
    sor_kernel.LAUNCHES = sor_kernel.WARM_LAUNCHES = 0
    sor_kernel.CYCLE_LAUNCHES = 0
    gs, gstats = solver.solve(prm, device=cuda, pressure_method=method)
    if method == "mg":
        t = sor_kernel.coarse_cycle_depth(mg.build_levels(prm))
        assert t == 0
        assert sor_kernel.WARM_LAUNCHES == 2 * t * gstats.total_sor_iterations
        assert sor_kernel.CYCLE_LAUNCHES == gstats.total_sor_iterations
    else:
        assert sor_kernel.WARM_LAUNCHES == sor_kernel.CYCLE_LAUNCHES == 0
    assert sor_kernel.LAUNCHES == 0
    cs, cstats = solver.solve(prm, device="cpu", pressure_method=method)
    assert gstats[:3] == cstats[:3] and gstats.sor_failures == 0
    for name in ("u", "v", "p"):
        g = getattr(gs, name).cpu().numpy()
        c = getattr(cs, name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


def _tile_kinds(prm, tile_rows, k):
    """(tiles that take the path without masks, tiles that do not) of the
    tiled kernel on prm's grid: a tile's first box, its centre widened by
    2K - 1, inside global rows and columns [2, n - 3]."""
    ni, nj = prm.shape
    tc, w = sor_kernel.TILE_COLS, 2 * k - 1
    kinds = [r - w >= 2 and r + tile_rows - 1 + w <= ni - 3 and c - w >= 2
             and c + tc - 1 + w <= nj - 3
             for r in range(0, ni, tile_rows) for c in range(0, nj, tc)]
    return sum(kinds), len(kinds) - sum(kinds)


@pytest.mark.gpu
@pytest.mark.parametrize("tile,k", [(16, 2), (64, 8), (5, 1)])
def test_tiled_interior_and_boundary_tiles_in_one_grid(cuda, tile, k):
    """Tiles without masks and tiles with them in one grid, with a chunk
    size other than the default: B4 equals B1 bit for bit."""
    prm = _params(300, 250)
    inside, edge = _tile_kinds(prm, tile, k)
    assert inside > 0 and edge > 0
    rhs = _rhs(prm, seed=tile).to(cuda)
    for n in (1, 2 * k + 1):
        got = sor_kernel.inner_sweeps_tiled(rhs, n, prm, tile_rows=tile,
                                            sweeps_per_chunk=k)
        assert torch.equal(
            got, sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))


@pytest.mark.gpu
def test_largest_tile_the_footprint_admits(cuda):
    """573 rows x 64 columns with a 16-deep halo (232,320 B of shared
    memory; its rhs no longer fits the threads' registers, so the kernel
    reads it from device memory) equals B1 bit for bit."""
    assert sor_kernel.tiled_shared_bytes(574, 8) > sor_kernel.MAX_SHARED_BYTES
    prm = _params(2048, 2048)
    rhs = _rhs(prm, seed=3).to(cuda)
    got = sor_kernel.inner_sweeps_tiled(rhs, 20, prm, tile_rows=573)
    assert torch.equal(got,
                       sor_kernel.whole_grid_sweeps_simple(rhs, 20, prm))
    report = sor_kernel.tile_report(573, sor_kernel.TILE_COLS, 16)
    assert report["rows_per_thread"] == 0
    assert report["shared_bytes"] == sor_kernel.tiled_shared_bytes(573, 8)


@pytest.mark.gpu
def test_tile_report_of_the_default_tile(cuda):
    """The default tile (the main paths' kernel, compiled for its shape):
    96 x 96 cells of delta in shared memory, rhs of 8 rows per thread in
    registers, 576 threads, two blocks resident per SM."""
    report = sor_kernel.tile_report(64, 64, 16)
    assert (report["rows"], report["cols"]) == (96, 96)
    assert report["shared_bytes"] == sor_kernel.tiled_shared_bytes(64, 8)
    assert (report["rows_per_thread"], report["threads"]) == (8, 576)
    assert report["blocks_per_sm"] >= 2


@pytest.mark.gpu
def test_tiled_kernel_fills_uninitialised_buffers(cuda, monkeypatch):
    """The wrapper hands the kernel torch.empty buffers: every cell of the
    result, the ghost ring's zeros included, comes from the kernel, also
    for n = 0 (one chunk of no sweeps) and n = K (one chunk)."""
    prm = _params(97, 61)
    rhs = _rhs(prm, seed=4).to(cuda)
    _poison_empty(monkeypatch)
    for n in (0, 1, 8, 16):
        got = sor_kernel.inner_sweeps_tiled(rhs, n, prm)
        assert torch.equal(
            got, sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))


# --- the extended-block kernel (B6) and the sharded path on the card ----------

# Cuts of a grid into the blocks of a process mesh: (interior, mesh shape).
EXT_CUTS = {"1x1_64x48": ((64, 48), (1, 1)), "2x2_50x50": ((50, 50), (2, 2)),
            "2x4_99x63": ((99, 63), (2, 4))}


def _cut(cut):
    """(params, li, lj, K, the blocks' global origins) of one cut."""
    from navierstokes_parallel_tpu_torch.parallel import deep_halo, topology

    size, mesh_shape = EXT_CUTS[cut]
    prm = _params(*size)
    li, lj = topology.local_block_dims(mesh_shape, *size)
    origins = [(ax * li, ay * lj) for ax in range(mesh_shape[0])
               for ay in range(mesh_shape[1])]
    return prm, li, lj, deep_halo.comm_depth(prm, li, lj), origins


@pytest.mark.gpu
@pytest.mark.parametrize("ns", [0, 1, 2, 7, 8])
@pytest.mark.parametrize("cut", sorted(EXT_CUTS))
def test_ext_kernel_matches_plain(cuda, cut, ns):
    """B6 bit for bit against its twin on every block of the cut, on every
    cell at least 2 ns from the block's edge (the twin's rolls wrap there,
    the kernel reads zeros); cells outside the global interior keep their
    input."""
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    prm, li, lj, K, origins = _cut(cut)
    H = 2 * K
    d0, rhs = _rhs(prm, seed=1).to(cuda), _rhs(prm, seed=2).to(cuda)
    for origin in origins:
        d_ext = deep_halo.cut_ext_block(d0, origin, li, lj, H)
        r_ext = deep_halo.cut_ext_block(rhs, origin, li, lj, H)
        before = sor_kernel.EXT_LAUNCHES
        got = sor_kernel.ext_sweeps(d_ext, r_ext, ns, origin, H, prm)
        want = sor_kernel.ext_sweeps_plain(d_ext, r_ext, ns, origin, H, prm)
        torch.cuda.synchronize()
        assert sor_kernel.EXT_LAUNCHES == before + 1
        e = 2 * ns
        inner = (slice(e, got.shape[0] - e), slice(e, got.shape[1] - e))
        assert torch.equal(got[inner], want[inner])
        interior = sor_kernel.ext_masks(got.shape, H, origin, prm.i_max,
                                        prm.j_max, 1.0, 1.0, device=cuda)[0]
        assert torch.equal(got[~interior], d_ext[~interior])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 13])
@pytest.mark.parametrize("cut", sorted(EXT_CUTS))
def test_ext_kernel_decomposition_equals_whole_grid(cuda, cut, n):
    """n sweeps from delta = 0 block by block in chunks of K, each chunk's
    blocks cut from the grid the chunk before left (the deep exchange),
    equal the first whole-grid kernel bit for bit."""
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    prm, li, lj, K, origins = _cut(cut)
    H = 2 * K
    rhs = _rhs(prm, seed=n).to(cuda)
    delta, done = torch.zeros_like(rhs), 0
    while done < n:
        ns = min(K, n - done)
        nxt = delta.clone()
        for ox, oy in origins:
            ext = sor_kernel.ext_sweeps(
                deep_halo.cut_ext_block(delta, (ox, oy), li, lj, H),
                deep_halo.cut_ext_block(rhs, (ox, oy), li, lj, H), ns,
                (ox, oy), H, prm)
            ri, rj = min(li, prm.i_max - ox), min(lj, prm.j_max - oy)
            nxt[1 + ox:1 + ox + ri, 1 + oy:1 + oy + rj] = \
                ext[H:H + ri, H:H + rj]
        delta, done = nxt, done + ns
    assert torch.equal(delta,
                       sor_kernel.whole_grid_sweeps_simple(rhs, n, prm))


@pytest.mark.gpu
@pytest.mark.parametrize("omega", [1.0, 1.7])
def test_ext_kernel_warm_start_equals_smoother(cuda, omega):
    """The multigrid use: sweeps from a non-zero delta (its ghost ring too)
    with a level's constants and H = 2 ns; the cores of a 2x2 cut equal the
    smoother B3 on the whole grid, its first kernel and its current one,
    bit for bit."""
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    n, ns, H, li = 130, 2, 4, 65
    rng = np.random.default_rng(7)
    p0, rhs = (torch.from_numpy(rng.standard_normal((n + 2, n + 2)).astype(
        np.float32)).to(cuda) for _ in range(2))
    dx2, dy2 = 0.9 * n ** 2, 1.3 * n ** 2
    out = p0.clone()
    for ox in (0, li):
        for oy in (0, li):
            ext = sor_kernel.ext_sweeps(
                deep_halo.cut_ext_block(p0, (ox, oy), li, li, H),
                deep_halo.cut_ext_block(rhs, (ox, oy), li, li, H), ns,
                (ox, oy), H, (n, n, omega, dx2, dy2))
            out[1 + ox:1 + ox + li, 1 + oy:1 + oy + li] = \
                ext[H:H + li, H:H + li]
    assert torch.equal(out, sor_kernel.warm_sweeps_simple(p0, rhs, ns, omega,
                                                          dx2, dy2))
    assert torch.equal(out, sor_kernel.warm_sweeps(p0, rhs, ns, omega, dx2,
                                                   dy2))


@pytest.mark.gpu
def test_sharded_solve_on_card_matches_cpu(cuda):
    """The sharded backend on a one-rank NCCL group (B6 for every chunk of
    sweeps) and on a one-rank gloo group on the CPU (the twin): equal
    counts, fields within the 1e-4 contract."""
    from navierstokes_parallel_tpu_torch.parallel import sharded, topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    prm = Params(i_max=32, j_max=24, T=0.05, Re=100.0, tau=0.5, max_it=2000)
    runs = {}
    for device in ("cuda", "cpu"):
        sor_kernel.EXT_LAUNCHES = 0
        with distributed.process_group(device) as dev:
            mesh = topology.make_grid_mesh(shape=(1, 1), device=dev)
            runs[device] = (*sharded.solve_sharded(prm, mesh=mesh),
                            sor_kernel.EXT_LAUNCHES)
    (gs, gstats, g_launches), (cs, cstats, c_launches) = (runs["cuda"],
                                                          runs["cpu"])
    assert g_launches > 0 and c_launches == 0
    assert gstats[:3] == cstats[:3] and gstats.sor_failures == 0
    for name in ("u", "v", "p"):
        g = getattr(gs, name).cpu().numpy()
        c = getattr(cs, name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))
