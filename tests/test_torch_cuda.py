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
import warnings

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state, resolve_device
from navierstokes_parallel_tpu_torch.ops.cuda import (_build, momentum_kernel,
                                                      sor_kernel)
from navierstokes_parallel_tpu_torch.utils import timing

# Kernel vs plain on the card, relative to the plain result's max: both
# round every f32 operation once in the same order (no FMA contraction in
# the kernels), so they agree bit for bit; the bound is a margin, not an
# expected error.
KERNEL_RTOL = 1e-6


def launches(kernel: str, since=None) -> int:
    """The launches of `kernel` in utils/timing.py's table (its counter
    "launch.<kernel>"): all so far, or since the snapshot `since`."""
    name = "launch." + kernel
    return timing.counts().get(name, 0) - (since or {}).get(name, 0)


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
        "defect.cu", "masked_cycle.cu", "mg_cycle.cu", "momentum.cu",
        "sor.cu", "sor_compressed.cu", "sor_ext.cu", "sor_tiled.cu"]
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
    before = launches("sor_whole_grid")
    got = sor_kernel.inner_sweeps(rhs, n, prm)
    want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
    torch.cuda.synchronize()
    assert launches("sor_whole_grid") == before + 1
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
    before = launches("sor_tiled")
    got = sor_kernel.inner_sweeps_tiled(rhs, n, prm, tile_rows=tile)
    torch.cuda.synchronize()
    assert launches("sor_tiled") == before + 1
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
    before = launches("sor_compressed")
    got = sor_kernel.inner_sweeps_compressed(rhs, n, prm)
    torch.cuda.synchronize()
    assert launches("sor_compressed") == before + 1
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
    before = launches("sor_compressed")
    got = sor_kernel.inner_sweeps_compressed(rhs, n, prm)
    assert launches("sor_compressed") == before + 1
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
    shape, counter = {"budget": ((2048, 2048), "sor_tiled"),
                      "forced_off": ((2048, 2048), "sor_whole_grid"),
                      "compressed": ((64, 62), "sor_compressed"),
                      "compressed_odd": ((64, 61), "sor_whole_grid"),
                      "forced_on": ((64, 61), "sor_tiled")}[case]
    if case == "forced_off":
        monkeypatch.setattr(sor_kernel, "PREFER_TILED", False)
    if case == "forced_on":
        monkeypatch.setattr(sor_kernel, "PREFER_TILED", True)
    if case.startswith("compressed"):
        monkeypatch.setattr(sor_kernel, "USE_COMPRESSED", True)
    prm = _params(*shape)
    rhs = _rhs(prm).to(cuda)
    start = timing.counts()
    got = sor_kernel.inner_sweeps(rhs, 9, prm)
    for name in ("sor_whole_grid", "sor_tiled", "sor_compressed"):
        assert launches(name, start) == (name == counter)
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


def _transfer_refusals(bad):
    """(check, arguments, message) triples that must raise for `bad`."""
    k = sor_kernel
    levels = _levels(32, 16)
    p, e = torch.zeros(34, 18), torch.zeros(18, 10)
    odd, tiny = torch.zeros(35, 18), torch.zeros(3, 18)
    if bad == "odd_interior":
        return [(k.check_restrict_inputs, (odd, odd), "halve"),
                (k.check_prolong_inputs, (odd, e), "halve"),
                (k.check_transfer_levels,
                 (odd, odd, [((35, 18), 4.0, 4.0), levels[1]]), "halve")]
    if bad == "tiny":
        return [(k.check_restrict_inputs, (tiny, tiny), "halve"),
                (k.check_prolong_inputs, (tiny, e), "halve")]
    if bad == "float64":
        return [(check, (p.double(), other), "float32")
                for check, other in ((k.check_restrict_inputs, p),
                                     (k.check_prolong_inputs, e))] + [
            (k.check_transfer_levels, (p, p.double(), levels), "float32")]
    if bad == "shape":
        narrow = torch.zeros(34, 17)
        return [(k.check_restrict_inputs, (p, narrow), "differ in shape"),
                (k.check_transfer_levels, (p, narrow, levels),
                 "differ in shape")]
    if bad == "strided":
        strided = torch.zeros(18, 34).t()
        return [(k.check_restrict_inputs, (strided, p), "contiguous"),
                (k.check_prolong_inputs, (p, torch.zeros(10, 18).t()),
                 "contiguous"),
                (k.check_transfer_levels, (strided, p, levels),
                 "contiguous")]
    if bad == "coarse_shape":
        return [(k.check_prolong_inputs, (p, torch.zeros(18, 9)),
                 "coarse shape")]
    if bad == "device":
        return [(k.check_restrict_inputs,
                 (p, torch.zeros(34, 18, device="meta")), "on meta"),
                (k.check_prolong_inputs,
                 (p, torch.zeros(18, 10, device="meta")), "on meta")]
    if bad == "not_halved":
        return [(k.check_transfer_levels, (p, p, [levels[0], levels[0]]),
                 "halve")]
    return [(k.check_transfer_levels, (p, p, levels[1:]), "first level")]


@pytest.mark.parametrize("bad", ["odd_interior", "tiny", "float64", "shape",
                                 "strided", "coarse_shape", "device",
                                 "not_halved", "first_shape"])
def test_transfer_checks_before_launch(bad):
    """What the transfer kernels do not take is refused by their checks,
    which run before a launch: an odd or too small interior, a non-f32
    array, mismatched shapes, a strided array, tensors on two devices, a
    correction not of the coarse shape; and for a whole cycle a first
    level other than p's or one that does not halve the next.  A CPU
    tensor never reaches a launch."""
    for check, args, match in _transfer_refusals(bad):
        with pytest.raises((TypeError, ValueError), match=match):
            check(*args)
    p = torch.zeros(34, 18)
    sor_kernel.check_transfer_levels(p, torch.zeros(34, 18), _levels(32, 16))
    sor_kernel.check_restrict_inputs(p, torch.zeros(34, 18))
    sor_kernel.check_prolong_inputs(p, torch.zeros(18, 10))
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.mg_restrict(p, p, 4.0, 4.0)
    with pytest.raises(ValueError, match="CUDA tensor only"):
        sor_kernel.mg_prolong(p, torch.zeros(18, 10))


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
    before = launches("sor_warm")
    _poison_empty(monkeypatch)
    got = sor_kernel.warm_sweeps(p, rhs, n, omega, dx2, dy2)
    want = sor_kernel.warm_sweeps_plain(p, rhs, n, omega, dx2, dy2)
    torch.cuda.synchronize()
    assert launches("sor_warm") == before + 1
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
    before = launches("mg_coarse_cycle")
    _poison_empty(monkeypatch)
    got = sor_kernel.coarse_cycle(p, rhs, levels, *counts)
    torch.cuda.synchronize()
    assert launches("mg_coarse_cycle") == before + 1
    assert torch.equal(got, sor_kernel.coarse_cycle_plain(p, rhs, levels,
                                                          *counts))

    def simple(q, rhs_l, lvl, n):
        return sor_kernel.warm_sweeps_simple(q, rhs_l, n, 1.0, lvl.dx2_inv,
                                             lvl.dy2_inv)

    assert torch.equal(got, mg._cycle(p, rhs, levels, 0, *counts, simple,
                                      mg._down_plain, mg._up_plain,
                                      len(levels)))


@pytest.mark.gpu
def test_v_cycle_on_card_calls_smoother_and_coarse_cycle(cuda):
    """At 512^2 (7 levels, the coarse cycle from 130^2: depth 2) a V-cycle
    launches the smoother 2 x 2 times, each transfer kernel twice (once a
    level, counted in mg.fused_levels) and the coarse cycle once, and
    equals the plain recursion bit for bit."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(512, 512)
    t = sor_kernel.coarse_cycle_depth(levels)
    assert (len(levels), t, levels[t].shape) == (7, 2, (130, 130))
    rng = np.random.default_rng(11)
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((512, 512))
    rhs = torch.from_numpy(rhs).to(cuda)
    p = torch.zeros_like(rhs)
    start = timing.counts()
    got = mg.v_cycle(p, rhs, levels)
    assert (launches("sor_warm", start), launches("mg_restrict", start),
            launches("mg_prolong", start),
            launches("mg_coarse_cycle", start)) == (2 * t, t, t, 1)
    fused = timing.counts().get("mg.fused_levels", 0)
    assert fused - start.get("mg.fused_levels", 0) == t
    assert torch.equal(got, mg.v_cycle_plain(p, rhs, levels))


def _same_bits(a, b):
    return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


# Levels the transfer kernels run on: (i_max, j_max) of the finest level.
# 2048^2 down to 256^2 are configs/4.in's levels above the coarse cycle;
# 2048 x 1024 is a non-square one.
TRANSFER_LEVELS = [(2048, 2048), (1024, 1024), (256, 256), (2048, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("ring", ["zero", "random", "negative_zero"])
@pytest.mark.parametrize("size", TRANSFER_LEVELS,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_transfer_kernels_equal_their_plain_twins(cuda, size, ring,
                                                  monkeypatch):
    """The residual with its restriction and the prolongation with its add,
    one launch each, equal ops/mg.py's plain transfers bit for bit, signs
    included, into buffers they must fill themselves; p's ghost ring 0,
    random or -0.0 (which the add turns into +0.0)."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(*size)
    lvl, coarse = levels[0], levels[1]
    rng = np.random.default_rng(size[0] + size[1] + len(ring))
    p = rng.standard_normal(lvl.shape).astype(np.float32) / lvl.dx2_inv
    if ring != "random":
        fill = -0.0 if ring == "negative_zero" else 0.0
        p[0], p[-1], p[:, 0], p[:, -1] = fill, fill, fill, fill
    rhs = rng.standard_normal(lvl.shape).astype(np.float32)
    e = rng.standard_normal(coarse.shape).astype(np.float32)
    p, rhs, e = (torch.from_numpy(x).to(cuda) for x in (p, rhs, e))
    start = timing.counts()
    _poison_empty(monkeypatch)
    r_c, e_c = sor_kernel.mg_restrict(p, rhs, lvl.dx2_inv, lvl.dy2_inv)
    up = sor_kernel.mg_prolong(p, e)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (launches("mg_restrict", start),
            launches("mg_prolong", start)) == (1, 1)
    want_r, want_e = mg._down_plain(p, rhs, lvl, coarse)
    assert _same_bits(r_c, want_r) and _same_bits(e_c, want_e)
    assert _same_bits(up, mg._up_plain(p, e, lvl))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(2048, 2048), (512, 512)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_v_cycle_on_card_equals_plain_cycle(cuda, size):
    """A whole V-cycle on the card (B3, the transfer kernels, the coarse
    cycle) equals v_cycle_plain bit for bit: at 2048^2 nine levels, four
    above the coarse cycle; inner_v_cycle's two cycles likewise."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(*size)
    t = sor_kernel.coarse_cycle_depth(levels)
    assert (len(levels), t) == {(2048, 2048): (9, 4), (512, 512): (7, 2)}[
        size]
    rng = np.random.default_rng(size[0])
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal(size)
    rhs = torch.from_numpy(rhs).to(cuda)
    p = torch.zeros_like(rhs)
    got = mg.v_cycle(p, rhs, levels)
    want = mg.v_cycle_plain(p, rhs, levels)
    assert torch.equal(got, want)
    prm = Params(i_max=size[0], j_max=size[1], a=1.0, b=0.8)
    assert torch.equal(mg.inner_v_cycle(rhs, 2, prm),
                       mg.v_cycle_plain(want, rhs, levels))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["odd_interior", "float64", "shape",
                                 "strided"])
def test_transfer_kernels_raise_before_a_launch_on_card(cuda, bad):
    """Bad CUDA inputs to the transfer wrappers, and to a V-cycle at 256^2
    (one level above the coarse cycle) whose levels or arrays the kernels
    would not take, raise before any launch."""
    from navierstokes_parallel_tpu_torch.ops import mg

    levels = _levels(256, 256)
    assert sor_kernel.coarse_cycle_depth(levels) == 1
    p = torch.zeros(258, 258, device=cuda)
    rhs = torch.zeros(258, 258, device=cuda)
    e = torch.zeros(130, 130, device=cuda)
    if bad == "odd_interior":
        p, rhs = (torch.zeros(259, 258, device=cuda) for _ in range(2))
        levels = [mg._Level((259, 258), *levels[0][1:])] + levels[1:]
    elif bad == "float64":
        p = p.double()
    elif bad == "shape":
        rhs, e = rhs[:, :-1].contiguous(), e[:, :-1].contiguous()
    elif bad == "strided":
        p = torch.zeros(258, 258, device=cuda).t()
    start = timing.counts()
    with pytest.raises((TypeError, ValueError)):
        sor_kernel.mg_restrict(p, rhs, levels[0].dx2_inv, levels[0].dy2_inv)
    with pytest.raises((TypeError, ValueError)):
        sor_kernel.mg_prolong(p, e)
    with pytest.raises((TypeError, ValueError)):
        mg.v_cycle(p, rhs, levels)
    assert {k: n for k, n in timing.counts().items()
            if k.startswith("launch.")} == {
        k: n for k, n in start.items() if k.startswith("launch.")}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 256), (97, 61), (8, 33)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_momentum_kernel_matches_plain(cuda, shape):
    prm = _params(*shape)
    u, v = (x.to(cuda) for x in _uv(prm, seed=shape[0]))
    dt = torch.tensor(0.003, device=cuda)
    gamma = torch.tensor(0.8, device=cuda)
    before = launches("momentum")
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
    torch.cuda.synchronize()
    assert launches("momentum") == before + 1
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
    before = launches("momentum")
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    assert launches("momentum") == before + 1
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
    start = timing.counts()
    gs, gstats = solver.solve(prm, device=cuda, pressure_method="pallas_sor")
    assert launches("sor_whole_grid", start) > 0
    assert launches("momentum", start) == gstats.steps
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
    start = timing.counts()
    gs, gstats = solver.solve(prm, device=cuda, pressure_method=method)
    if method == "mg":
        t = sor_kernel.coarse_cycle_depth(mg.build_levels(prm))
        assert t == 0
        assert launches("sor_warm", start) == 2 * t * gstats.total_sor_iterations
        assert launches("mg_coarse_cycle", start) == gstats.total_sor_iterations
    else:
        assert launches("sor_warm", start) == 0
        assert launches("mg_coarse_cycle", start) == 0
    assert launches("sor_whole_grid", start) == 0
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
        before = launches("sor_ext")
        got = sor_kernel.ext_sweeps(d_ext, r_ext, ns, origin, H, prm)
        want = sor_kernel.ext_sweeps_plain(d_ext, r_ext, ns, origin, H, prm)
        torch.cuda.synchronize()
        assert launches("sor_ext") == before + 1
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
        start = timing.counts()
        with distributed.process_group(device) as dev:
            mesh = topology.make_grid_mesh(shape=(1, 1), device=dev)
            runs[device] = (*sharded.solve_sharded(prm, mesh=mesh),
                            launches("sor_ext", start))
    (gs, gstats, g_launches), (cs, cstats, c_launches) = (runs["cuda"],
                                                          runs["cpu"])
    assert g_launches > 0 and c_launches == 0
    assert gstats[:3] == cstats[:3] and gstats.sor_failures == 0
    for name in ("u", "v", "p"):
        g = getattr(gs, name).cpu().numpy()
        c = getattr(cs, name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


# --- the other pressure methods on the card ------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 256), (99, 63)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_dct_solve_on_the_card_matches_cpu(cuda, shape):
    """poisson_solve_dct through cuFFT against pocketfft on the CPU, within
    1e-5 of max|p| (two f32 FFT libraries)."""
    from navierstokes_parallel_tpu_torch.ops import fft

    prm = _params(*shape)
    r = _rhs(prm, seed=3)[1:-1, 1:-1]
    r = r - r.mean()
    cpu = fft.poisson_solve_dct(r, prm)
    card = fft.poisson_solve_dct(r.to(cuda), prm).cpu()
    assert float((card - cpu).abs().max()) <= 1e-5 * float(cpu.abs().max())


@pytest.mark.gpu
def test_sharded_mg_smoother_launches_the_ext_kernel(cuda):
    """The sharded multigrid's deep-halo smoother on a 1x1 mesh (no
    message): kernel B6 on the card, bit for bit its plain twin on the
    CPU."""
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.parallel import topology

    prm = _params(64, 48)
    level = mg.build_levels_sharded(prm, 64, 48)[1]
    rng = np.random.default_rng(5)
    p, rhs = (torch.from_numpy(rng.standard_normal(level[0]).astype(
        np.float32)) for _ in range(2))
    runs = {}
    for device in ("cpu", cuda):
        mesh = topology.Mesh((1, 1), (0, 0), torch.device(device), None)
        before = launches("sor_ext")
        runs[str(device)] = mg._smooth_sharded(p.to(device), rhs.to(device),
                                               level, 2, mesh).cpu()
        launched = launches("sor_ext") - before
        assert launched == (0 if device == "cpu" else 1)
    assert torch.equal(runs["cpu"], runs["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("method,dtype", [("rb_sor", "float64"),
                                          ("jacobi", "float32"),
                                          ("fft", "float32")])
def test_other_methods_gpu_match_cpu(cuda, method, dtype):
    """A small converging cavity on the card and on the CPU: equal counts,
    fields within the reference contract (1e-4)."""
    prm = Params(problem=1, i_max=32, j_max=32, T=0.05, Re=100.0, tau=0.5,
                 omega=1.7, epsilon=1e-4, max_it=5000, dtype=dtype)
    runs = [solver.solve(prm, device=d, pressure_method=method)
            for d in (cuda, "cpu")]
    (sg, tg), (sc, tc) = runs
    assert tg[:3] == tc[:3] and tg.sor_failures == 0
    for name in ("u", "v", "p"):
        a = getattr(sg, name).cpu().double()
        b = getattr(sc, name).double()
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_plain_momentum_on_the_card_equals_the_cpu(cuda):
    """compute_fg and compute_rhs (the AB2 step's F, G and rhs, and the
    sharded backend's) on the card equal the CPU's bit for bit, Re = 10 and
    a width whose dx is no power of two: every division by a Python number
    is a true division (ops/stencils.py::div), not CUDA's multiply by the
    reciprocal."""
    from navierstokes_parallel_tpu_torch.ops import momentum

    prm = Params(i_max=36, j_max=20, a=2.1, b=0.9, Re=10.0, g_x=0.1,
                 omega=1.7)
    u, v = _uv(prm, seed=7)
    dt, gamma = torch.tensor(0.0021), torch.tensor(0.37)
    want = momentum.compute_fg(u, v, dt, gamma, prm)
    got = momentum.compute_fg(u.to(cuda), v.to(cuda), dt.to(cuda),
                              gamma.to(cuda), prm)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    rhs = momentum.compute_rhs(*want, dt, prm)
    assert torch.equal(momentum.compute_rhs(got[0], got[1], dt.to(cuda),
                                            prm).cpu(), rhs)


@pytest.mark.gpu
@pytest.mark.parametrize("problem,order", [(3, 1), (3, 2), (4, 2)])
def test_channel_and_taylor_green_on_the_card_match_cpu(cuda, problem,
                                                        order):
    """The channel (Euler: B1 and B2; AB2: B1, no B2) and the Taylor-Green
    box under AB2 with mg (B3 and the coarse cycle) on the card against the
    CPU: equal counts, fields within the 1e-4 contract."""
    from navierstokes_parallel_tpu_torch.models import channel, taylorgreen

    if problem == 3:
        prm = channel.plane_channel(nx=48, ny=24, T=0.05, dtype="float32")
        states = {d: solver.allocate_state(prm, d) for d in (cuda, "cpu")}
        method = "pallas_sor"
    else:
        # 256^2: the smoother runs on the finest level, the coarse cycle
        # from 130^2 down.
        prm, _ = taylorgreen.taylor_green(n=256, device="cpu")
        states = {d: taylorgreen.taylor_green(n=256, device=d)[1]
                  for d in (cuda, "cpu")}
        method = "mg"
    start = timing.counts()
    gs, gstats = solver.solve(prm, states[cuda], pressure_method=method,
                              time_order=order, max_steps=3)
    if problem == 3:
        assert launches("sor_whole_grid", start) > 0
    else:
        assert launches("sor_warm", start) > 0
        assert launches("mg_coarse_cycle", start) > 0
    assert launches("momentum", start) == (gstats.steps if order == 1 else 0)
    cs, cstats = solver.solve(prm, states["cpu"], pressure_method=method,
                              time_order=order, max_steps=3)
    assert gstats[:3] == cstats[:3] and gstats.sor_failures == 0
    for name in ("u", "v", "p"):
        g = getattr(gs, name).cpu().numpy()
        c = getattr(cs, name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


@pytest.mark.gpu
@pytest.mark.parametrize("order", [1, 2])
def test_obstacle_step_on_the_card_launches_no_kernel(cuda, order):
    """An obstacle step on the card takes the plain F/G pinned on the
    obstacle faces and the masked solve: no B2 launch (the fused kernel
    forms rhs before pin_fg) and no sweep kernel, by Euler and AB2; its
    masked V-cycles (one level of 32 x 8) one one-block launch each; the
    fields within the 1e-4 contract of the CPU's."""
    from navierstokes_parallel_tpu_torch.models import step as step_model

    prm = step_model.backward_facing_step(nx=32, ny=8, T=0.3)
    assert not momentum_kernel.usable(prm, cuda)
    states = {}
    for device in (cuda, "cpu"):
        start = timing.counts()
        states[device], stats = solver.solve(
            prm, device=device, pressure_method="mg", time_order=order,
            max_steps=3)
        assert stats.steps == 3 and stats.sor_failures == 0
        assert launches("momentum", start) == 0
        assert launches("sor_whole_grid", start) == launches("sor_warm", start) == 0
        assert launches("sor_tiled", start) == launches("mg_coarse_cycle", start) == 0
        assert launches("sor_compressed", start) == launches("sor_ext", start) == 0
        cycles = timing.counts()["masked.cycles"] - start.get(
            "masked.cycles", 0)
        assert cycles > 0
        assert launches("masked_cycle", start) == (
            cycles if device == cuda else 0)
    for name in ("u", "v", "p"):
        g = getattr(states[cuda], name).cpu().numpy()
        c = getattr(states["cpu"], name).numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


@pytest.mark.gpu
def test_diagnostics_on_the_card_equal_the_cpu(cuda):
    """vorticity, the max_divergence monitor and divergence_norm on the
    card equal the CPU's bit for bit, on a grid whose dx, dy and cell
    count are no powers of two: every division by a Python number is a
    true division (ops/stencils.py::div), not CUDA's multiply by the
    reciprocal.  divergence_norm's sum is order-free here: each field has
    one nonzero edge, so two cells carry the divergence.  (The other
    monitors sum in the card's order.)"""
    from navierstokes_parallel_tpu_torch.utils import checks, diagnostics

    prm = Params(i_max=36, j_max=20, a=2.1, b=0.9, Re=10.0)
    u, v = _uv(prm, seed=11)
    got = diagnostics.vorticity(u.to(cuda), v.to(cuda), prm)
    assert torch.equal(got.cpu(), diagnostics.vorticity(u, v, prm))
    got = diagnostics.physics_monitors(u.to(cuda), v.to(cuda), prm)
    want = diagnostics.physics_monitors(u, v, prm)
    assert torch.equal(got.max_divergence.cpu(), want.max_divergence)
    rng = np.random.default_rng(12)
    for k in range(40):
        u, v = torch.zeros(prm.shape), torch.zeros(prm.shape)
        i, j = rng.integers(1, prm.i_max), rng.integers(1, prm.j_max)
        (u if k % 2 else v)[i, j] = float(rng.standard_normal())
        assert checks.divergence_norm(u.to(cuda), v.to(cuda), prm) == \
            checks.divergence_norm(u, v, prm), (k, i, j)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["pallas_sor", "mg"])
def test_thermal_steps_on_the_card_take_no_momentum_kernel(cuda, method):
    """A thermal step on the card takes the plain F/G (the buoyancy is
    added after them, so B2, which forms rhs first, never runs) and the
    pressure kernels of its method: B1 once per outer pass, or the coarse
    cycle once per V-cycle at 34^2; by Euler and AB2, the fields within the
    1e-4 contract of the CPU's."""
    from navierstokes_parallel_tpu_torch.models import convection

    prm, cfg = convection.convection_setup(1e4, n=32)
    prm = prm.replace(T=0.5)
    for order in (1, 2):
        states = {}
        for device in (cuda, "cpu"):
            start = timing.counts()
            states[device], stats = convection.thermal_solve(
                prm, cfg, device=device, pressure_method=method,
                time_order=order, max_steps=4)
            assert stats.steps == 4 and stats.sor_failures == 0
            assert launches("momentum", start) == 0
            launched = launches("sor_whole_grid" if method == "pallas_sor"
                                else "mg_coarse_cycle", start)
            assert (launched > 0) == (device == cuda)
        for name in ("u", "v", "p", "T"):
            g = getattr(states[cuda], name).cpu().numpy()
            c = getattr(states["cpu"], name).numpy()
            assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0,
                                                       np.max(np.abs(c)))


@pytest.mark.gpu
def test_sharded_obstacle_step_on_the_card_launches_no_kernel(cuda):
    """The sharded obstacle path on a one-rank NCCL group runs the masked
    deep-halo sweeps (no B6, no other kernel); 3 steps of the
    backward-facing step equal the card's one-device masked solve in
    counts and within the contract in u and v."""
    from navierstokes_parallel_tpu_torch.models import step as step_model
    from navierstokes_parallel_tpu_torch.parallel import sharded, topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    prm = step_model.backward_facing_step(nx=32, ny=8, T=0.3)
    start = timing.counts()
    with distributed.process_group(cuda) as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        state, stats = sharded.solve_sharded(prm, mesh=mesh, max_steps=3)
    assert launches("sor_ext", start) == launches("momentum", start) == 0
    single, sstats = solver.solve(prm, device=cuda, max_steps=3)
    assert stats[:3] == sstats[:3] and stats.sor_failures == 0
    for name in ("u", "v"):
        g = getattr(state, name).cpu().numpy()
        c = getattr(single, name).cpu().numpy()
        assert np.max(np.abs(g - c)) <= 1e-4 * max(1.0, np.max(np.abs(c)))


@pytest.mark.gpu
def test_free_surface_on_the_card_launches_no_kernel(cuda):
    """Three dam-break steps (n = 15: dx = 1/15, no power of two) on the
    card and on the CPU: the flag field and the particles' cells equal
    (the binning divides through ops/stencils.py::div), no kernel
    launched, equal sweeps, fields and positions within the contract."""
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.ops import surface

    runs = {}
    for device in (cuda, "cpu"):
        prm, fs = FS.dam_break(n=15, T=0.25, dtype="float32", device=device)
        start = timing.counts()
        out, stats = FS.solve_free(prm, fs, wall="freeslip", max_steps=3)
        assert launches("momentum", start) == 0
        assert launches("sor_whole_grid", start) == launches("sor_warm", start) == 0
        assert launches("sor_tiled", start) == launches("mg_coarse_cycle", start) == 0
        assert launches("sor_compressed", start) == launches("sor_ext", start) == 0
        flags = surface.cell_flags(out.pset.x, out.pset.y, out.pset.active,
                                   prm)
        runs[device] = (out, stats, flags)
    (g, gs, gf), (c, cs, cf) = runs[cuda], runs["cpu"]
    assert gs[:3] == cs[:3] and gs.steps == 3
    for name in ("fluid", "surface", "bulk"):
        assert torch.equal(getattr(gf, name).cpu(), getattr(cf, name))
    assert torch.equal(g.pset.active.cpu(), c.pset.active)
    for a, b in ((g.state.u, c.state.u), (g.state.v, c.state.v),
                 (g.state.p, c.state.p), (g.pset.x, c.pset.x),
                 (g.pset.y, c.pset.y)):
        b = b.numpy()
        assert np.max(np.abs(a.cpu().numpy() - b)) <= 1e-4 * max(
            1.0, np.max(np.abs(b)))


@pytest.mark.gpu
def test_particle_interpolation_on_the_card_equals_the_cpu(cuda):
    """interp_uv and advect on a 36 x 20 grid (a = 2.1, b = 0.9): the card
    equals the CPU bit for bit, every x / dx a true division."""
    from navierstokes_parallel_tpu_torch import particles as P

    prm = Params(i_max=36, j_max=20, a=2.1, b=0.9, dtype="float64")
    rng = np.random.default_rng(8)
    u = torch.from_numpy(rng.standard_normal(prm.shape))
    v = torch.from_numpy(rng.standard_normal(prm.shape))
    pts = np.stack([rng.uniform(0.01, 2.09, 500),
                    rng.uniform(0.01, 0.89, 500)], -1)
    outs = {}
    for device in (cuda, "cpu"):
        pset = P.init_particles(pts, dtype=torch.float64, device=device)
        up, vp = P.interp_uv(pset.x, pset.y, u.to(device), v.to(device), prm)
        moved = P.advect(pset, u.to(device), v.to(device), 0.01, prm)
        outs[device] = [t.cpu() for t in (up, vp, moved.x, moved.y,
                                          moved.active)]
    for a, b in zip(outs[cuda], outs["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_gradient_on_the_card_equals_the_cpu(cuda):
    """diff.solve_n_steps' gradients (a 24^2 cavity, f64, epsilon 1e-9,
    2 steps by mg, symmetry broken) on the card against the CPU's: within
    1e-6 relative (both solves converge to 1e-9); the smoother and coarse
    cycle launch in the forward and in the backward pass; remat changes
    no bit of the gradient, and a recomputed step repeats the first."""
    from navierstokes_parallel_tpu_torch import diff

    prm = Params(i_max=24, j_max=24, Re=100.0, tau=0.5, epsilon=1e-9,
                 max_it=20000, dtype="float64")
    bump = np.zeros(prm.shape)
    bump[1:-1, 1:-1] = 0.05 * np.random.default_rng(4).standard_normal(
        (24, 24))
    grads = {}
    for device in (cuda, "cpu"):
        for remat in (True, False):
            state = allocate_state(prm, device)
            u0 = (state.u + torch.from_numpy(bump).to(device)
                  ).requires_grad_(True)
            lid = torch.tensor(1.0, dtype=torch.float64, device=device,
                               requires_grad=True)
            c = diff.default_controls(prm, device)._replace(lid_scale=lid)
            start = timing.counts()
            final, _ = diff.solve_n_steps(prm, state._replace(u=u0), 2,
                                          controls=c, remat=remat)
            fwd = (launches("sor_warm", start),
                   launches("mg_coarse_cycle", start))
            ((final.u[1:-1, 1:-1] ** 2).sum()
             + (final.v[1:-1, 1:-1] ** 2).sum()).backward()
            bwd = (launches("sor_warm", start) - fwd[0],
                   launches("mg_coarse_cycle", start) - fwd[1])
            if device == cuda:
                assert fwd[1] > 0 and bwd[1] > 0, (fwd, bwd)
            grads[device, remat] = (lid.grad.cpu(), u0.grad.cpu())
    for device in (cuda, "cpu"):
        assert all(torch.equal(a, b) for a, b in zip(grads[device, True],
                                                     grads[device, False]))
    got, want = grads[cuda, True], grads["cpu", True]
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
    scale = float(want[1].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * scale
    state = allocate_state(prm, cuda)
    a, _ = diff.diff_step(state, prm)
    b, _ = diff.diff_step(state, prm)
    assert all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))


@pytest.mark.gpu
def test_compensated_arithmetic_on_the_card_is_exact(cuda):
    """two_sum, two_prod and split on 2^16 random f32 pairs: exact in f64
    on the card and equal to the CPU's bit for bit (each operation one
    elementwise kernel, nothing fused)."""
    from navierstokes_parallel_tpu_torch.ops import compensated as comp

    rng = np.random.default_rng(12)
    a = rng.standard_normal(1 << 16).astype(np.float32)
    b = (rng.standard_normal(1 << 16)
         * 10.0 ** rng.integers(-6, 6, 1 << 16)).astype(np.float32)
    for name, exact in (("two_sum", a.astype(np.float64) + b),
                        ("two_prod", a.astype(np.float64) * b)):
        fn = getattr(comp, name)
        x, e = (t.cpu().numpy() for t in fn(torch.from_numpy(a).to(cuda),
                                            torch.from_numpy(b).to(cuda)))
        np.testing.assert_array_equal(x.astype(np.float64) + e, exact)
        cx, ce = (t.numpy() for t in fn(torch.from_numpy(a),
                                        torch.from_numpy(b)))
        assert np.array_equal(x, cx) and np.array_equal(e, ce)
    hi, lo = (t.cpu().numpy() for t in comp.split(torch.from_numpy(a).to(
        cuda)))
    np.testing.assert_array_equal(hi.astype(np.float64) + lo,
                                  a.astype(np.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["rb_sor", "fft", "mg"])
def test_ensemble_on_the_card_matches_its_solo_runs(cuda, method):
    """Three members of a 32^2 cavity: each member's counts equal its solo
    solve's on the card and the CPU ensemble's; fields within 1e-5."""
    prm = Params(i_max=32, j_max=32, T=0.05, Re=100.0, tau=0.5,
                 epsilon=1e-4, max_it=2000)
    rng = np.random.default_rng(5)
    du = [0.01 * k * rng.standard_normal(prm.shape) for k in range(3)]
    outs = {}
    for device in (cuda, "cpu"):
        members = []
        for d in du:
            s = allocate_state(prm, device)
            members.append(s._replace(u=s.u + torch.tensor(
                d, dtype=s.u.dtype, device=device)))
        out, stats = solver.solve_ensemble(prm, solver.stack_states(members),
                                           pressure_method=method)
        outs[device] = (out, stats, members)
    out, stats, members = outs[cuda]
    cpu_out, cpu_stats, _ = outs["cpu"]
    assert stats.total_sor_iterations.tolist() == \
        cpu_stats.total_sor_iterations.tolist()
    for k, member in enumerate(members):
        _, solo = solver.solve(prm, member, pressure_method=method)
        assert (int(stats.steps[k]), int(stats.total_sor_iterations[k]),
                int(stats.sor_failures[k])) == tuple(solo[:3])
    assert float((out.u.cpu() - cpu_out.u).abs().max()) < 1e-5


def test_member_axis_is_taken_where_a_kernel_batches():
    """A leading member axis passes the checks of the kernels that batch
    (the tiled SOR sweeps, the fused momentum kernel) and no other."""
    prm = _params(10, 6)
    rhs = torch.stack([_rhs(prm, seed=k) for k in range(3)])
    sor_kernel.check_inputs(rhs, 4, prm, batched=True)
    with pytest.raises(ValueError):
        sor_kernel.check_inputs(rhs, 4, prm)
    with pytest.raises(ValueError):
        sor_kernel.check_inputs(rhs[None], 4, prm, batched=True)
    u, v = (torch.stack([x] * 3) for x in _uv(prm))
    momentum_kernel.check_inputs(u, v, prm, batched=True)
    with pytest.raises(ValueError):
        momentum_kernel.check_inputs(u, v, prm)
    with pytest.raises(ValueError):
        momentum_kernel.check_inputs(u, v[:2], prm, batched=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 13, 64])
@pytest.mark.parametrize("shape", [(32, 32), (97, 61)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_batched_sweeps_equal_each_members_launch(cuda, shape, n):
    """Three members in one launch per chunk (whole-grid and tiled
    routes) equal the plain twin on the member axis and each member's own
    launch bit for bit."""
    prm = _params(*shape)
    rhs = torch.stack([_rhs(prm, seed=k) for k in range(3)]).to(cuda)
    for call, counter in (
            (sor_kernel.whole_grid_sweeps, "sor_whole_grid"),
            (lambda r, m, p: sor_kernel.inner_sweeps_tiled(r, m, p,
                                                           tile_rows=16),
             "sor_tiled")):
        before = launches(counter)
        got = call(rhs, n, prm)
        assert launches(counter) == before + 1
        want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        for k in range(3):
            assert torch.equal(got[k], call(rhs[k].contiguous(), n, prm))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 32), (97, 61)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_batched_momentum_equals_each_members_launch(cuda, shape):
    """Three members, each with its own dt and gamma, in one launch equal
    the plain twin on the member axis and each member's own launch."""
    prm = _params(*shape)
    u, v = (torch.stack(x).to(cuda)
            for x in zip(*(_uv(prm, seed=k) for k in range(3))))
    dt = torch.tensor([0.004, 0.002, 0.003], device=cuda)
    gamma = torch.tensor([0.7, 0.5, 0.9], device=cuda)
    before = launches("momentum")
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    assert launches("momentum") == before + 1
    want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in range(3):
        solo = momentum_kernel.momentum_rhs(u[k].contiguous(),
                                            v[k].contiguous(), dt[k],
                                            gamma[k], prm)
        for g, s in zip(got, solo):
            assert torch.equal(g[k], s)


@pytest.mark.gpu
def test_ensemble_on_the_card_launches_the_batched_kernels(cuda):
    """An f32 rb_sor ensemble on the card steps every member through the
    fused momentum kernel and the SOR sweep kernel, one launch per step
    and per chunk for the whole batch, and each member equals its solo
    run bit for bit."""
    prm = Params(i_max=32, j_max=32, T=0.05, Re=100.0, tau=0.5,
                 epsilon=1e-4, max_it=2000)
    rng = np.random.default_rng(5)
    members = []
    for k in range(3):
        s = allocate_state(prm, cuda)
        members.append(s._replace(u=s.u + torch.tensor(
            0.01 * k * rng.standard_normal(prm.shape), dtype=s.u.dtype,
            device=cuda)))
    sweeps, momentum = launches("sor_whole_grid"), launches("momentum")
    start = timing.counts()
    out, stats = solver.solve_ensemble(prm, solver.stack_states(members))
    counted = {name: timing.counts().get(name, 0) - start.get(name, 0)
               for name in ("pressure.passes", "pressure.fused_passes",
                            "launch.pressure_defect")}
    steps = max(stats.steps.tolist())
    assert launches("momentum") - momentum == steps
    assert launches("sor_whole_grid") - sweeps >= steps
    # The f64 outer's pass: one launch of csrc/defect.cu a pass for the
    # whole batch.
    assert (counted["launch.pressure_defect"] == counted["pressure.passes"]
            == counted["pressure.fused_passes"] >= steps)
    for k, member in enumerate(members):
        state, solo = solver.solve(prm, member)
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(out, name)[k], getattr(state, name))
        assert int(stats.total_sor_iterations[k]) == solo.total_sor_iterations
        assert float(stats.last_res_norm[k]) == solo.last_res_norm


# --- the f64 outer's fused pass (csrc/defect.cu) -------------------------------

# The fused pass's norm against its twin's: the kernel sums r^2 in another
# order (per-block partials, then the blocks in order), so the two agree
# to rounding; master and next rhs agree bit for bit.
DEFECT_NORM_RTOL = 1e-13


def _defect_inputs(i_max, j_max, seed):
    """(params, master, delta, rhs interior) of one pass, on the CPU."""
    prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7)
    rng = np.random.default_rng(seed)
    return (prm, torch.from_numpy(rng.standard_normal(prm.shape)),
            torch.from_numpy(rng.standard_normal(prm.shape).astype(
                np.float32)),
            torch.from_numpy(rng.standard_normal((i_max, j_max))))


def _defect_run(prm, p64, delta, rhs, device, case: str, n_passes: int = 2):
    """n_passes of defect_kernel.outer_pass from p64 on `device` (the
    kernel on the card, the twin on the CPU): (master, rhs_full, on,
    iterations, res_norm) after them.  case: "going" (threshold 0),
    "stopped" (the flag already off) or "stops" (the first pass's norm
    meets the threshold)."""
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel

    # Copies: the twin works on its master in place.
    p64, delta, rhs = (x.to(device, copy=True) for x in (p64, delta, rhs))
    rhs_full = torch.zeros(prm.shape, dtype=torch.float32, device=device)
    threshold = torch.tensor(1e300 if case == "stops" else 0.0,
                             dtype=torch.float64, device=device)
    on = torch.tensor(case != "stopped", device=device)
    iterations = torch.zeros((), dtype=torch.int64, device=device)
    res_norm = torch.full((), float("inf"), dtype=torch.float64,
                          device=device)
    pass_fn = defect_kernel.outer_pass(p64, rhs, rhs_full, threshold, prm)
    for _ in range(n_passes):
        p64 = pass_fn(p64, delta, on, iterations, res_norm, 64)
    return p64, rhs_full, on, iterations, res_norm


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["going", "stopped", "stops"])
@pytest.mark.parametrize("interior", [(256, 256), (2048, 2048), (128, 64)],
                         ids=lambda s: f"{s[0] + 2}x{s[1] + 2}")
def test_defect_kernel_matches_plain(cuda, interior, case):
    """Two passes of the kernel (its master ping-pongs between two buffers)
    against two of the twin on the CPU: masters' interiors and the next rhs
    bit for bit, the flag and the count equal, the norm within
    DEFECT_NORM_RTOL; the kernel writes no ghost ring."""
    prm, p64, delta, rhs = _defect_inputs(*interior, seed=interior[1])
    start = timing.counts()
    km, krhs, kon, kit, knorm = _defect_run(prm, p64, delta, rhs, cuda, case)
    torch.cuda.synchronize()
    assert launches("pressure_defect", start) == 2
    pm, prhs, pon, pit, pnorm = _defect_run(prm, p64, delta, rhs, "cpu", case)
    assert torch.equal(km.cpu()[1:-1, 1:-1], pm[1:-1, 1:-1])
    assert torch.equal(krhs.cpu(), prhs)
    assert (bool(kon), int(kit)) == (bool(pon), int(pit))
    assert int(kit) == {"going": 128, "stopped": 0, "stops": 64}[case]
    ring = torch.ones(prm.shape, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.equal(km.cpu()[ring], p64[ring])
    if case == "stopped":
        assert float(knorm) == float(pnorm) == float("inf")
        assert torch.equal(km.cpu(), p64)
    else:
        assert (abs(float(knorm) - float(pnorm))
                <= DEFECT_NORM_RTOL * float(pnorm))


@pytest.mark.gpu
def test_defect_kernel_gives_the_same_bits_twice(cuda):
    """Two runs of three passes from one master at 2050^2: the same
    masters, next rhs and norms bit for bit (the norm's sum has a fixed
    order)."""
    prm, p64, delta, rhs = _defect_inputs(2048, 2048, seed=12)
    runs = [_defect_run(prm, p64, delta, rhs, cuda, "going", n_passes=3)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_defect_kernel_raises_on_what_it_does_not_take(cuda):
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel

    prm, p64, delta, rhs = _defect_inputs(16, 12, seed=13)
    p64, delta, rhs = p64.to(cuda), delta.to(cuda), rhs.to(cuda)
    rhs_full = torch.zeros(prm.shape, device=cuda)
    threshold = torch.zeros((), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        defect_kernel.outer_pass(p64.float(), rhs, rhs_full, threshold, prm)
    pass_fn = defect_kernel.outer_pass(p64, rhs, rhs_full, threshold, prm)
    on = torch.ones((), dtype=torch.bool, device=cuda)
    it = torch.zeros((), dtype=torch.int64, device=cuda)
    norm = torch.zeros((), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="delta"):
        pass_fn(p64, delta.double(), on, it, norm, 4)
    with pytest.raises(ValueError, match="on"):
        pass_fn(p64, delta, on.reshape(1), it, norm, 4)
    out = pass_fn(p64, delta, on, it, norm, 4)
    with pytest.raises(ValueError, match="spare"):
        pass_fn(p64, delta, on, it, norm, 4)  # the spare of the next pass
    pass_fn(out, delta, on, it, norm, 4)


def _defect_members_run(prm, p64, delta, rhs, device, on, threshold,
                        n_passes: int = 2):
    """n_passes of defect_kernel.outer_pass from p64 on `device`, one
    problem (2-D tensors, `on` and `threshold` numbers) or a batch (3-D,
    lists): (master, rhs_full, on, iterations, res_norm) after them."""
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel

    p64, delta, rhs = (x.to(device, copy=True) for x in (p64, delta, rhs))
    rhs_full = torch.zeros(p64.shape, dtype=torch.float32, device=device)
    on = torch.tensor(on, device=device)
    threshold = torch.tensor(threshold, dtype=torch.float64, device=device)
    iterations = torch.zeros(on.shape, dtype=torch.int64, device=device)
    res_norm = torch.full(on.shape, float("inf"), dtype=torch.float64,
                          device=device)
    pass_fn = defect_kernel.outer_pass(p64, rhs, rhs_full, threshold, prm)
    for _ in range(n_passes):
        p64 = pass_fn(p64, delta, on, iterations, res_norm, 64)
    return p64, rhs_full, on, iterations, res_norm


def _defect_batch_inputs(i_max, j_max, n_members, seed):
    """(params, masters, deltas, rhs interiors) of a batch's pass."""
    members = [_defect_inputs(i_max, j_max, seed + k)
               for k in range(n_members)]
    return (members[0][0], *(torch.stack(x) for x in
                             zip(*(m[1:] for m in members))))


# A batch's members: going, stopped before the first pass, and one whose
# first pass's norm meets its threshold; their counts after two passes.
DEFECT_MEMBERS = {"on": [True, False, True], "threshold": [0.0, 0.0, 1e300],
                  "iterations": [128, 0, 64]}


@pytest.mark.gpu
@pytest.mark.parametrize("interior", [(256, 256), (97, 61)],
                         ids=lambda s: f"{s[0] + 2}x{s[1] + 2}")
def test_batched_defect_equals_each_members_launch(cuda, interior):
    """Two passes of one launch each over three members (going, stopped,
    stops) equal two launches on each member alone bit for bit: master
    (ring included), next rhs, norm, count and flag; and against the twin
    on the CPU as test_defect_kernel_matches_plain holds one problem."""
    prm, p64, delta, rhs = _defect_batch_inputs(*interior, 3,
                                                seed=interior[1])
    on, threshold = DEFECT_MEMBERS["on"], DEFECT_MEMBERS["threshold"]
    start = timing.counts()
    batch = _defect_members_run(prm, p64, delta, rhs, cuda, on, threshold)
    torch.cuda.synchronize()
    assert launches("pressure_defect", start) == 2
    assert batch[3].tolist() == DEFECT_MEMBERS["iterations"]
    assert batch[2].tolist() == [True, False, False]
    for k in range(3):
        solo = _defect_members_run(prm, p64[k], delta[k], rhs[k], cuda,
                                   on[k], threshold[k])
        for got, want in zip(batch, solo):
            assert torch.equal(got[k], want)
    assert torch.equal(batch[0][1].cpu(), p64[1])  # stopped: kept
    twin = _defect_members_run(prm, p64, delta, rhs, "cpu", on, threshold)
    assert torch.equal(batch[0].cpu()[:, 1:-1, 1:-1], twin[0][:, 1:-1, 1:-1])
    for got, want in zip(batch[1:4], twin[1:4]):
        assert torch.equal(got.cpu(), want)
    norms, twin_norms = batch[4].cpu().tolist(), twin[4].tolist()
    for got, want, going in zip(norms, twin_norms, on):
        assert (got == want == float("inf") if not going else
                abs(got - want) <= DEFECT_NORM_RTOL * want)


@pytest.mark.gpu
def test_batched_defect_gives_the_same_bits_twice(cuda):
    """Two runs of three batched passes over 8 members of 258^2 (the
    ensemble cell's batch): the same masters, next rhs, flags, counts and
    norms bit for bit."""
    prm, p64, delta, rhs = _defect_batch_inputs(256, 256, 8, seed=40)
    runs = [_defect_members_run(prm, p64, delta, rhs, cuda, [True] * 8,
                                [0.0] * 8, n_passes=3) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# Each batched method's tolerance for test_batched_pressure_solve_equals_
# each_members_solve, and whether its three members stop at different
# passes there (fft's each stop after two direct solves).
BATCH_SOLVES = {"rb_sor": (1e-3, True), "jacobi": (3e-2, True),
                "fft": (1e-5, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("method", sorted(BATCH_SOLVES))
def test_batched_pressure_solve_equals_each_members_solve(cuda, method):
    """solve_pressure_batch by each batched method on three members of a
    ragged 97x61 problem equals each member's solve_pressure bit for bit
    in p, iterations and res_norm, one fused launch a pass for the
    batch."""
    from navierstokes_parallel_tpu_torch.ops import sor

    assert sorted(BATCH_SOLVES) == sorted(sor.BATCHED_METHODS)
    epsilon, stops_differ = BATCH_SOLVES[method]
    prm = _params(97, 61).replace(epsilon=epsilon, max_it=3000)
    rng = np.random.default_rng(30)
    rhs = np.zeros((3, *prm.shape), np.float32)
    rhs[:, 1:-1, 1:-1] = (rng.standard_normal((3, prm.i_max, prm.j_max))
                          * np.array([1.0, 3.0, 0.3])[:, None, None])
    rhs[:, 1:-1, 1:-1] -= rhs[:, 1:-1, 1:-1].mean(axis=(1, 2),
                                                   keepdims=True)
    p0 = (0.1 * rng.standard_normal((3, *prm.shape))).astype(np.float32)
    p0, rhs = torch.from_numpy(p0).to(cuda), torch.from_numpy(rhs).to(cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # jacobi's omega clamp
        start = timing.counts()
        got = sor.solve_pressure_batch(p0, rhs, prm, method=method)
        counts = timing.counts()
        solos = [sor.solve_pressure(p0[k], rhs[k], prm, method=method)
                 for k in range(3)]
    counted = [counts.get(name, 0) - start.get(name, 0)
               for name in ("pressure.passes", "pressure.fused_passes",
                            "launch.pressure_defect")]
    assert counted[0] == counted[1] == counted[2] >= 1
    assert got.converged.all()
    assert (len(set(got.iterations.tolist())) > 1) is stops_differ
    for k, solo in enumerate(solos):
        assert torch.equal(got.p[k], solo.p)
        assert int(got.iterations[k]) == solo.iterations
        assert float(got.res_norm[k]) == solo.res_norm


def _plain_outer(monkeypatch):
    """Send every refined solve to the plain statements (an explicit
    default norm)."""
    from navierstokes_parallel_tpu_torch.ops import sor

    refined = sor._solve_pressure_refined

    def plain(p, rhs, params, **kw):
        return refined(p, rhs, params, **{"l2_fn": sor._default_l2(params),
                                          **kw})

    monkeypatch.setattr(sor, "_solve_pressure_refined", plain)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["1.in pallas_sor", "514 mg"])
def test_fused_outer_on_the_card_equals_the_plain_statements(cuda, case,
                                                             monkeypatch):
    """One step of configs/1.in by pallas_sor (313 passes into max_it) and
    one of a 514^2 cavity by mg, each with the fused pass (one launch a
    pass) and with the plain statements: equal counts, fields within
    1e-12."""
    from pathlib import Path

    configs = Path(__file__).resolve().parents[1] / "configs"
    if case == "514 mg":
        prm = Params.from_file(str(configs / "4.in")).replace(i_max=512,
                                                              j_max=512)
        method = "mg"
    else:
        prm = Params.from_file(str(configs / "1.in"))
        method = "pallas_sor"
    runs = {}
    for name in ("fused", "plain"):
        if name == "plain":
            _plain_outer(monkeypatch)
        stepper = solver.Stepper(prm, allocate_state(prm, cuda), method)
        start = timing.counts()
        stats = solver.run_steps(stepper, prm, max_steps=1)
        passes = timing.counts()["pressure.passes"] - start.get(
            "pressure.passes", 0)
        runs[name] = (stepper.state(), stats, passes,
                      launches("pressure_defect", start))
    (fs, fstats, fpasses, flaunch), (ps, pstats, ppasses, plaunch) = (
        runs["fused"], runs["plain"])
    assert fstats == pstats and fpasses == ppasses >= 1
    assert flaunch == fpasses and plaunch == 0
    if method == "pallas_sor":
        assert fpasses == -(-prm.max_it // prm.sor_refine_every)
    for name in ("u", "v", "p"):
        f = getattr(fs, name).double()
        p = getattr(ps, name).double()
        assert float((f - p).abs().max()) <= 1e-12 * max(
            1.0, float(p.abs().max())), name


# --- the masked V-cycle's kernels (csrc/masked_cycle.cu) ----------------------
#
# ops/masked.py::_v_cycle_masked on the card: a launch a half-sweep, a
# restriction and a prolongation on the levels too large for one block, one
# launch of one block for the rest (ops/cuda/masked_kernel.py).  Every
# comparison is bit for bit (signs of zero too) against the plain cycle,
# which a level without its packed arrays takes on any device.

MASKED_CASES = ["schafer_turek", "square_cylinder", "step"]
MASKED_COUNTERS = ("masked_cycle", "masked_half_sweep", "masked_restrict",
                   "masked_prolong")


def _masked_params(name):
    """Schäfer-Turek 2D-2 at 440 x 82 with face fractions (2 levels, the
    coarse one in one block), the square cylinder at 160 x 64 on the
    staircase (4 levels, 3 in one block), the backward-facing step at
    64 x 16 (2 levels, both in one block)."""
    from navierstokes_parallel_tpu_torch.models import karman
    from navierstokes_parallel_tpu_torch.models import step as step_model

    return {"schafer_turek": lambda: karman.schafer_turek(n_per_d=20),
            "square_cylinder": karman.square_cylinder,
            "step": lambda: step_model.backward_facing_step(nx=64, ny=16),
            }[name]()


def _masked_levels(prm, device="cpu", dtype=torch.float32):
    from navierstokes_parallel_tpu_torch.ops import masked

    return masked.device_levels(prm, dtype, torch.device(device))


def _shapes(levels):
    return tuple(tuple(w.fluid.shape) for w in levels)


def _same_bits(a, b):
    return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


def _masked_inputs(prm, device, seed=0):
    """A random f32 p (padded, ghost ring not 0) and rhs (interior)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(prm.shape).astype(np.float32)
    rhs = rng.standard_normal((prm.i_max, prm.j_max)).astype(np.float32)
    return torch.from_numpy(p).to(device), torch.from_numpy(rhs).to(device)


@pytest.mark.parametrize("name", MASKED_CASES)
def test_masked_levels_pack_for_the_kernels(name):
    """Each level's kernel arrays: the east and north couplings padded
    with a zero ring, their one-cell shift the west and south couplings bit
    for bit (on the cylinder's face fractions too), the f32 diagonal, one
    fluid byte a cell, and the colours the level's own checkerboard (the
    kernels' parity 0)."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    for w in _masked_levels(_masked_params(name)):
        pk = masked_kernel.pack_level(w)
        masked_kernel.check_packed(pk)
        for pad, inner in ((pk.we, w.w_e), (pk.wn, w.w_n)):
            assert _same_bits(pad[1:-1, 1:-1], inner)
            ring = torch.cat([pad[0], pad[-1], pad[:, 0], pad[:, -1]])
            assert _same_bits(ring, torch.zeros_like(ring))
        assert _same_bits(pk.we[:-2, 1:-1], w.w_w)
        assert _same_bits(pk.wn[1:-1, :-2], w.w_s)
        assert _same_bits(pk.diag, w.diag)
        assert pk.fluid.dtype == torch.uint8
        assert torch.equal(pk.fluid.bool(), w.fluid)
        for colour, mask in ((0, w.red), (1, w.black)):
            assert torch.equal(
                mask, masked._checkerboard(w.fluid.shape, colour) & w.fluid)


@pytest.mark.parametrize("bad", ["west", "south", "float64"])
def test_masked_packing_refuses_what_the_kernels_cannot_read(bad):
    """A level whose west or south coupling is not the shifted east or
    north one, or that is not float32, is refused."""
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params("step")
    if bad == "float64":
        w = _masked_levels(prm, dtype=torch.float64)[0]
        with pytest.raises(TypeError, match="float32"):
            masked_kernel.pack_level(w)
        return
    w = _masked_levels(prm)[0]
    field = {"west": "w_w", "south": "w_s"}[bad]
    moved = getattr(w, field).clone()
    moved[3, 3] = moved[3, 3] * 2.0 + 1.0
    with pytest.raises(ValueError, match="one cell over"):
        masked_kernel.pack_level(w._replace(**{field: moved}))


@pytest.mark.parametrize("name,depth,in_block,launches", [
    ("schafer_turek", 1, 1, (1, 8, 1, 1)),
    ("square_cylinder", 1, 3, (1, 8, 1, 1)),
    ("step", 0, 2, (1, 0, 0, 0))])
def test_masked_one_block_level_by_shared_bytes(name, depth, in_block,
                                                launches):
    """The one-block cycle starts at the first level whose tail fits one
    block's 232,448 B: 440 x 82 gives level 1 at 195,732 B (level 0 alone
    770,256 B); the square cylinder's holds 3 levels; a cycle's launches
    per counter follow (11 at 440 x 82)."""
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    shapes = _shapes(_masked_levels(_masked_params(name)))
    t = masked_kernel.one_block_depth(shapes)
    assert (t, len(shapes) - t) == (depth, in_block)
    assert masked_kernel.cycle_shared_bytes(shapes[t:]) <= 232448
    assert masked_kernel.cycle_shared_bytes(shapes[t - 1:]) > 232448 or t == 0
    got = masked_kernel.launches_per_cycle(shapes)
    assert tuple(got[k] for k in MASKED_COUNTERS) == launches
    if name == "schafer_turek":
        assert masked_kernel.level_shared_bytes(220, 41) == 195732
        assert masked_kernel.level_shared_bytes(440, 82) == 770256
        assert sum(got.values()) == 11


def test_masked_hierarchy_with_no_level_in_one_block():
    """Where even the coarsest level exceeds one block, every level takes
    half-sweep launches, the coarse sweeps too, and no one-block launch."""
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    shapes = ((600, 602), (300, 301))
    assert masked_kernel.one_block_depth(shapes) == 2
    assert masked_kernel.launches_per_cycle(shapes) == {
        "masked_cycle": 0, "masked_half_sweep": 8 + 64,
        "masked_restrict": 1, "masked_prolong": 1}
    nine = tuple((2 ** (9 - k), 2 ** (9 - k)) for k in range(9))
    assert masked_kernel.one_block_depth(nine) == 3  # 64^2 down to 2^2


@pytest.mark.parametrize("case", ["cpu", "float64", "requires_grad",
                                  "unpacked"])
def test_masked_cycle_stays_plain_off_the_kernels(case, monkeypatch):
    """Off the card, on float64 levels, under a gradient and on levels
    without their kernel arrays the cycle is the plain one: no wrapper is
    called and no cycle counts as fused."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params("step")
    dtype = torch.float64 if case == "float64" else torch.float32
    levels = _masked_levels(prm, dtype=dtype)
    assert all(w.packed is None for w in levels)
    if case == "unpacked":
        levels = tuple(w._replace(packed=masked_kernel.pack_level(w))
                       for w in levels)
    p, rhs = (x.to(dtype) for x in _masked_inputs(prm, "cpu"))
    if case == "requires_grad":
        rhs.requires_grad_(True)
    assert not masked_kernel.usable(p, rhs, levels[0])
    for name in ("cycle", "half_sweeps", "restrict", "prolong"):
        monkeypatch.setattr(masked_kernel, name, None)
    fused = timing.counts().get("masked.fused_cycles", 0)
    masked._v_cycle_masked(p.detach().clone(), rhs, levels)
    assert timing.counts().get("masked.fused_cycles", 0) == fused


@pytest.mark.parametrize("bad", ["float64", "p_shape", "rhs_shape", "strided",
                                 "negative", "no_level", "nine_levels",
                                 "not_halved", "shared", "fluid_dtype",
                                 "other_device", "device"])
def test_masked_cycle_checks_before_launch(bad):
    """What the masked kernels do not take is refused before a launch, the
    shared-memory need by name."""
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params("step")
    levels = [masked_kernel.pack_level(w) for w in _masked_levels(prm)]
    assert _shapes(levels) == ((64, 16), (32, 8))
    p, rhs = torch.zeros(66, 18), torch.zeros(64, 16)
    counts, match = (2, 2, 32), None
    if bad == "float64":
        p, match = p.double(), "float32"
    elif bad == "p_shape":
        p, match = torch.zeros(66, 17), "shape"
    elif bad == "rhs_shape":
        rhs, match = torch.zeros(66, 18), "shape"
    elif bad == "strided":
        p, match = torch.zeros(18, 66).t(), "contiguous"
    elif bad == "negative":
        counts, match = (2, -1, 32), ">= 0"
    elif bad == "no_level":
        levels, match = [], "1 to 8 levels"
    elif bad == "nine_levels":
        levels, match = levels * 5, "1 to 8 levels"
    elif bad == "not_halved":
        levels, match = [levels[0], levels[0]], "halve"
    elif bad == "shared":
        big = _masked_levels(_masked_params("square_cylinder"))
        levels = [masked_kernel.pack_level(w) for w in big]
        p, rhs = torch.zeros(162, 66), torch.zeros(160, 64)
        match = "bytes of shared memory"
    elif bad == "fluid_dtype":
        levels[1] = levels[1]._replace(fluid=levels[1].fluid.bool())
        match = "uint8"
    elif bad == "other_device":
        p, match = torch.zeros(66, 18, device="meta"), "is on meta"
    if bad == "device":
        for call in (lambda: masked_kernel.cycle(p, rhs, levels),
                     lambda: masked_kernel.half_sweeps(p, rhs, levels[0], 1),
                     lambda: masked_kernel.restrict(p, rhs, *levels),
                     lambda: masked_kernel.prolong(p, torch.zeros(34, 10),
                                                   levels[0])):
            with pytest.raises(ValueError, match="CUDA tensor only"):
                call()
        return
    with pytest.raises((TypeError, ValueError), match=match):
        masked_kernel.check_cycle_inputs(p, rhs, levels, *counts)
    masked_kernel.check_cycle_inputs(torch.zeros(66, 18), torch.zeros(64, 16),
                                     [masked_kernel.pack_level(w) for w in
                                      _masked_levels(prm)], 2, 2, 32)


def _masked_launches(since):
    return tuple(launches(k, since) for k in MASKED_COUNTERS)


def _plain_levels(levels):
    return tuple(w._replace(packed=None) for w in levels)


@pytest.mark.gpu
@pytest.mark.parametrize("name", MASKED_CASES)
def test_masked_cycle_on_the_card_equals_plain(cuda, name, monkeypatch):
    """One masked V-cycle on the card from a random p (ghost ring not 0):
    the kernels' launches per counter, one fused cycle, and the plain
    cycle's bits on the same card, into buffers the kernels must fill."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params(name)
    levels = _masked_levels(prm, cuda)
    assert all(w.packed is not None for w in levels)
    p, rhs = _masked_inputs(prm, cuda, seed=len(name))
    want = masked._v_cycle_masked(p.clone(), rhs, _plain_levels(levels))
    start = timing.counts()
    _poison_empty(monkeypatch)
    got = masked._v_cycle_masked(p.clone(), rhs, levels)
    torch.cuda.synchronize()
    per = masked_kernel.launches_per_cycle(_shapes(levels))
    assert _masked_launches(start) == tuple(per[k] for k in MASKED_COUNTERS)
    assert (timing.counts()["masked.fused_cycles"]
            - start.get("masked.fused_cycles", 0)) == 1
    assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [(2, 2, 32), (0, 1, 0), (3, 0, 5)],
                         ids=lambda c: "nu%d_%d_coarse%d" % c)
@pytest.mark.parametrize("name", MASKED_CASES)
def test_masked_kernels_equal_their_plain_pieces(cuda, name, counts):
    """Each kernel against the plain function it replaces, on every level:
    half-sweeps for n = 0, 1, 3 (_smooth_masked), the restriction
    (masked_residual, _restrict), the prolongation, and the one-block cycle
    from every level whose tail fits one block, with other sweep counts."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params(name)
    levels = _masked_levels(prm, cuda)
    plain = _plain_levels(levels)
    rng = np.random.default_rng(sum(counts))
    for d, w in enumerate(levels):
        ni, nj = w.fluid.shape
        p = torch.from_numpy(rng.standard_normal((ni + 2, nj + 2)).astype(
            np.float32)).to(cuda)
        rhs = torch.from_numpy(rng.standard_normal((ni, nj)).astype(
            np.float32)).to(cuda)
        one = torch.ones((), device=cuda)
        for n in (0, 1, 3):
            want = masked._smooth_masked(p.clone(), rhs, w, n, one)
            got = masked_kernel.half_sweeps(p.clone(), rhs, w.packed, n)
            assert _same_bits(got, want)
        if d + 1 < len(levels):
            coarse = levels[d + 1]
            e_c, r_c = masked_kernel.restrict(p, rhs, w.packed, coarse.packed)
            zero = torch.zeros((), device=cuda)
            want = torch.where(coarse.fluid, masked._restrict(
                -masked.masked_residual(p, rhs, w)), zero)
            assert _same_bits(r_c, want)
            assert _same_bits(e_c, torch.zeros_like(e_c))
            e_c = torch.from_numpy(rng.standard_normal(e_c.shape).astype(
                np.float32)).to(cuda)
            want = p.clone()
            up = e_c[1:-1, 1:-1].repeat_interleave(2, 0).repeat_interleave(
                2, 1)
            want[1:-1, 1:-1] += torch.where(w.fluid, up, zero)
            assert _same_bits(masked_kernel.prolong(p.clone(), e_c, w.packed),
                              want)
        if d >= masked_kernel.one_block_depth(_shapes(levels)):
            before = launches("masked_cycle")
            got = masked_kernel.cycle(p.clone(), rhs,
                                      [lv.packed for lv in levels[d:]],
                                      *counts)
            assert launches("masked_cycle") == before + 1
            want = masked._v_cycle_masked(p.clone(), rhs, plain, d, *counts)
            assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["schafer_turek", "square_cylinder"])
def test_masked_mg_solve_on_the_card_equals_plain(cuda, name, monkeypatch):
    """A whole solve_pressure_masked(..., "mg") on the card: the same
    iterations, residual and p bits as the plain cycle on the card, every
    cycle fused and one one-block launch a cycle."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = _masked_params(name)
    rng = np.random.default_rng(7)
    fluid = masked._weights(prm).fluid
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = np.where(fluid, rng.standard_normal(fluid.shape), 0.0)
    rhs = torch.from_numpy(rhs).to(cuda)
    p0 = torch.zeros_like(rhs)
    start = timing.counts()
    got = masked.solve_pressure_masked(p0, rhs, prm, "mg")
    torch.cuda.synchronize()
    now = timing.counts()
    cycles = now["masked.cycles"] - start.get("masked.cycles", 0)
    assert cycles == got.iterations > 0
    assert (now["masked.fused_cycles"]
            - start.get("masked.fused_cycles", 0)) == cycles
    assert launches("masked_cycle", start) == cycles
    monkeypatch.setattr(masked_kernel, "usable", lambda *a: False)
    want = masked.solve_pressure_masked(p0, rhs, prm, "mg")
    assert (got.iterations, got.res_norm, got.converged) == (
        want.iterations, want.res_norm, want.converged)
    assert _same_bits(got.p, want.p)


@pytest.mark.gpu
def test_masked_cycle_on_the_card_routes_plain_for_f64_and_grad(cuda):
    """On the card, float64 levels and an rhs that needs a gradient take
    the plain cycle: no masked launch."""
    from navierstokes_parallel_tpu_torch.ops import masked

    prm = _masked_params("step")
    p, rhs = _masked_inputs(prm, cuda)
    start = timing.counts()
    masked._v_cycle_masked(p.double(), rhs.double(),
                           _masked_levels(prm, cuda, torch.float64))
    masked._v_cycle_masked(p.clone(), rhs.clone().requires_grad_(True),
                           _masked_levels(prm, cuda))
    assert _masked_launches(start) == (0, 0, 0, 0)


@pytest.mark.gpu
def test_masked_gathered_tail_on_a_1x1_mesh(cuda, monkeypatch):
    """make_sharded_mg_inner at 440 x 82 on a 1x1 mesh: level 0 on the
    block (plain), the gathered tail from level 1 the one-block launch, a
    launch a cycle, with the plain tail's bits."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel
    from navierstokes_parallel_tpu_torch.parallel import topology

    prm = _masked_params("schafer_turek")
    mesh = topology.Mesh((1, 1), (0, 0), cuda, None)
    rng = np.random.default_rng(3)
    rhs = torch.from_numpy(rng.standard_normal(prm.shape)).to(cuda)
    runs = []
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(masked_kernel, "usable", lambda *a: False)
        inner = masked.make_sharded_mg_inner(prm, prm.i_max, prm.j_max, mesh)
        start = timing.counts()
        runs.append(inner(rhs, 2))
        torch.cuda.synchronize()
        assert _masked_launches(start) == ((2, 0, 0, 0) if kernel
                                           else (0, 0, 0, 0))
    assert _same_bits(*runs)


@pytest.mark.gpu
def test_masked_counters_add_up_to_the_launches(cuda):
    """Under the profiler one masked V-cycle at 440 x 82 runs as many
    device kernels as its launch counters add up to: 11."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.ops import masked

    prm = _masked_params("schafer_turek")
    levels = _masked_levels(prm, cuda)
    p, rhs = _masked_inputs(prm, cuda)
    masked._v_cycle_masked(p.clone(), rhs, levels)
    torch.cuda.synchronize()
    start = timing.counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        masked._v_cycle_masked(p, rhs, levels)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    assert sum(_masked_launches(start)) == 11
    assert kernels == 11
