"""The port's tiled and colour-compressed SOR routes vs the JAX package.

The plain twins of the tiled kernel (``inner_sweeps_tiled_plain``, full-width
strips with a 2K-deep halo) and of the colour-compressed kernel
(``inner_sweeps_compressed_plain``) are held:

  * bit for bit (``torch.equal``) against the whole-grid twin
    ``inner_sweeps_plain``: every written cell goes through the same
    expression on the same neighbour values, which is also why the CUDA
    kernels equal each other on the card;
  * against the JAX kernels (Pallas, interpret mode on the CPU) relative to
    max|delta|: 2e-6 for one chunk and 5e-6 for several (the bounds of
    tests/test_vmem_paths.py), 1e-6 for the compressed kernel (as the
    whole-grid twin in test_torch_sor.py).  They are not bit-equal: XLA's
    CPU backend contracts a * b + c into fused multiply-adds inside the
    interpreted kernels, while the port rounds every operation once.

The route boundary is the JAX whole-grid budget; a cavity forced onto the
tiled route in both packages is held to the reference contract (1e-4) with
equal iteration counts.
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu import solver as jsolver
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.ops.pallas import sor_kernel as jsk
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

from conftest import assert_close_reference_contract

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "configs", "*.in")))
K = sor_kernel.SWEEPS_PER_CHUNK


def _params(i_max, j_max, **kw):
    ref = JaxParams(**{"i_max": i_max, "j_max": j_max, "a": 1.0, "b": 0.8,
                       "omega": 1.7, "dtype": "float32", **kw})
    return Params.from_mapping(dataclasses.asdict(ref)), ref


def _rhs(i_max, j_max, seed=0):
    rng = np.random.default_rng(seed)
    rhs = np.zeros((i_max + 2, j_max + 2), np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((i_max, j_max))
    return rhs


@pytest.mark.parametrize("n,tol", [(8, 2e-6), (20, 5e-6)],
                         ids=["one_chunk", "8+8+4"])
@pytest.mark.parametrize("double_buffer", [False, True])
def test_tiled_plain_matches_jax_tiled(double_buffer, n, tol):
    """64^2, strips of 32 rows (3 strips), K = 8."""
    prm, ref = _params(64, 64, b=1.0)
    rhs = _rhs(64, 64, seed=7)
    got = sor_kernel.inner_sweeps_tiled_plain(torch.from_numpy(rhs), n, prm,
                                              tile_rows=32).numpy()
    want = np.asarray(jsk.inner_sweeps_tiled(jnp.asarray(rhs), n, ref,
                                             tile_rows=32,
                                             double_buffer=double_buffer))
    scale = float(np.max(np.abs(want)))
    assert got.shape == want.shape and scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("n", [0, 1, K, 3 * K + 1])
@pytest.mark.parametrize("shape,tile", [((13, 9), 5), ((24, 17), 7),
                                        ((37, 22), 16), ((6, 30), 64)],
                         ids=["13x9", "24x17", "37x22", "6x30"])
def test_tiled_plain_equals_whole_grid_plain(shape, tile, n):
    """Non-square and odd shapes, tiles that do not divide the rows (and
    one taller than the grid), chunks that end short."""
    prm, _ = _params(*shape)
    rhs = torch.from_numpy(_rhs(*shape, seed=n))
    got = sor_kernel.inner_sweeps_tiled_plain(rhs, n, prm, tile_rows=tile)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, n, prm))


def test_tiled_plain_short_chunks_equal_whole_grid_plain():
    """K = 2 (halo 4) over strips of 3 rows: many chunks, many strips."""
    prm, _ = _params(20, 11)
    rhs = torch.from_numpy(_rhs(20, 11, seed=3))
    got = sor_kernel.inner_sweeps_tiled_plain(rhs, 13, prm, tile_rows=3,
                                              sweeps_per_chunk=2)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, 13, prm))


def test_compressed_plain_matches_jax_compressed():
    """16^2, n = 13 (tests/test_sor.py's case)."""
    prm, ref = _params(16, 16, b=1.0)
    rhs = _rhs(16, 16)
    got = sor_kernel.inner_sweeps_compressed_plain(torch.from_numpy(rhs), 13,
                                                   prm)
    want = np.asarray(jsk.inner_sweeps_compressed(jnp.asarray(rhs), 13, ref))
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=1e-6)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(
        torch.from_numpy(rhs), 13, prm))


@pytest.mark.parametrize("n", [1, 13])
@pytest.mark.parametrize("shape", [(13, 10), (24, 18), (7, 30)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_compressed_plain_equals_whole_grid_plain(shape, n):
    prm, _ = _params(*shape)
    rhs = torch.from_numpy(_rhs(*shape, seed=n))
    got = sor_kernel.inner_sweeps_compressed_plain(rhs, n, prm)
    assert torch.equal(got, sor_kernel.inner_sweeps_plain(rhs, n, prm))


def test_colour_compaction_matches_jax():
    full = np.random.default_rng(5).standard_normal((9, 12)).astype(np.float32)
    red, black = sor_kernel._compress_colors(torch.from_numpy(full))
    jred, jblack = jsk._compress_colors(jnp.asarray(full))
    np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
    np.testing.assert_array_equal(black.numpy(), np.asarray(jblack))
    assert torch.equal(sor_kernel._decompress_colors(red, black),
                       torch.from_numpy(full))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_route_boundary_matches_jax_fits_in_vmem(path):
    prm = Params.from_file(path)
    ref = JaxParams.from_file(path)
    assert sor_kernel.whole_grid_fits(prm.shape) == jsk.fits_in_vmem(ref)
    assert sor_kernel.route(prm) == (
        "whole" if jsk.fits_in_vmem(ref) else "tiled")


@pytest.mark.parametrize("i_max,j_max", [(2046, 2046), (2047, 2046),
                                         (2048, 1918), (2048, 1919),
                                         (1024, 1024), (4096, 64)])
def test_route_boundary_either_side(i_max, j_max):
    """Padded 2048 x 2048 and 2050 x 1920 fit the budget; one more row or
    column does not."""
    prm, ref = _params(i_max, j_max)
    assert sor_kernel.whole_grid_fits(prm.shape) == jsk.fits_in_vmem(ref)


def test_route_switches(monkeypatch):
    even, _ = _params(30, 20)
    odd, _ = _params(30, 21)
    big, _ = _params(2048, 2048)
    assert [sor_kernel.route(p) for p in (even, odd, big)] == [
        "whole", "whole", "tiled"]
    monkeypatch.setattr(sor_kernel, "USE_COMPRESSED", True)
    # An odd padded width keeps the whole-grid kernel (the JAX rule).
    assert [sor_kernel.route(p) for p in (even, odd, big)] == [
        "compressed", "whole", "tiled"]
    monkeypatch.setattr(sor_kernel, "PREFER_TILED", False)
    assert sor_kernel.route(big) == "compressed"
    monkeypatch.setattr(sor_kernel, "USE_COMPRESSED", False)
    assert sor_kernel.route(big) == "whole"
    monkeypatch.setattr(sor_kernel, "PREFER_TILED", True)
    assert sor_kernel.route(even) == "tiled"
    rhs = torch.from_numpy(_rhs(30, 20))
    assert torch.equal(sor_kernel.inner_sweeps(rhs, 9, even),
                       sor_kernel.inner_sweeps_plain(rhs, 9, even))


def test_tiled_cavity_matches_jax_tiled_cavity(monkeypatch):
    """A 32^2 cavity on the tiled route in both packages (strips of 16 rows,
    K = 8): equal steps, sweeps and max_it hits, fields within 1e-4."""
    prm, ref = _params(32, 32, b=1.0, T=0.05, Re=100.0, tau=0.5,
                       epsilon=1e-4, max_it=2000, sor_refine_every=64)
    monkeypatch.setattr(jsk, "fits_in_vmem", lambda p, **kw: False)
    monkeypatch.setattr(jsk, "PREFER_TILED_DMA", True)
    monkeypatch.setattr(jsk, "TILE_ROWS", 16)
    monkeypatch.setattr(sor_kernel, "PREFER_TILED", True)
    monkeypatch.setattr(sor_kernel, "TILE_ROWS", 16)
    state, stats = solver.solve(prm, device="cpu",
                                pressure_method="pallas_sor")
    jstate, jstats = jsolver.solve(ref, pressure_method="pallas_sor")
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) == (
        int(jstats.steps), int(jstats.total_sor_iterations),
        int(jstats.sor_failures))
    assert stats.steps > 1
    for name in ("u", "v", "p"):
        assert_close_reference_contract(getattr(state, name).numpy(),
                                        np.asarray(getattr(jstate, name)))


def _run_cli(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


def test_tile_size_positional_parses_as_in_jax(tmp_path):
    path = str(tmp_path / "c.in")
    for argv, want in (([path], None), ([path, "32"], 32),
                       ([path, "7", "--stats"], 7)):
        assert cli.build_parser().parse_args(argv).tile_size == want
        assert jcli.build_parser().parse_args(argv).tile_size == want
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args([path, "wide"])


def test_tile_size_positional_sets_the_tile(tmp_path, capsys, monkeypatch):
    """A run forced onto the tiled route with strips of 5 rows prints the
    whole-grid route's answer."""
    _, ref = _params(16, 16, b=1.0, T=0.05, Re=100.0, tau=0.5, max_it=2000)
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    monkeypatch.setattr(sor_kernel, "TILE_ROWS", sor_kernel.TILE_ROWS)
    rc, out, err = _run_cli([path, "--device", "cpu", "--stats"], capsys)
    monkeypatch.setattr(sor_kernel, "PREFER_TILED", True)
    trc, tout, terr = _run_cli([path, "5", "--device", "cpu", "--stats"],
                               capsys)
    assert rc == trc == 0 and sor_kernel.TILE_ROWS == 5
    assert tout == out and terr[0].split()[:3] == err[0].split()[:3]


@pytest.mark.parametrize("size,needle", [("0", "[1, 4096]"),
                                         ("4097", "[1, 4096]"),
                                         ("574", "shared memory")])
def test_tile_size_positional_errors(size, needle, tmp_path, capsys,
                                     monkeypatch):
    monkeypatch.setattr(sor_kernel, "TILE_ROWS", sor_kernel.TILE_ROWS)
    _, ref = _params(16, 16)
    path = str(tmp_path / "c.in")
    ref.to_file(path)
    before = sor_kernel.TILE_ROWS
    rc, out, err = _run_cli([path, size, "--device", "cpu"], capsys)
    assert rc == 1 and not out
    assert err[0].startswith("error:") and needle in err[0]
    assert sor_kernel.TILE_ROWS == before
