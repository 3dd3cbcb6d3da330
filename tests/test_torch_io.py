"""The port's text grids (utils/io.py) vs the JAX package's.

The native writer (csrc/nsp_io.c, built at first use) is held byte for byte
against the port's Python formatter over adversarial values (near-ties,
exact dyadic ties, negative zeros, NaN of either sign, magnitudes past the
fixed-point range), and that formatter byte for byte against the JAX
package's ``_write_grid_py``; ``output`` against the JAX ``output``;
``read_field`` round trips; the comparator against the JAX comparator; a
failed build raises.
"""

import ctypes

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu.utils import io as jio
from navierstokes_parallel_tpu_torch.utils import io as nsio


def _fields(i_max, j_max, seed=0):
    rng = np.random.default_rng(seed)
    shape = (i_max + 2, j_max + 2)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _adversarial() -> np.ndarray:
    rng = np.random.default_rng(11)
    base = (np.arange(-2000, 2000) + 0.5) / 1e5
    vals = np.concatenate([
        rng.standard_normal(20000) * np.logspace(-8, 9, 20000),
        base, base + 1e-13, base - 1e-13,
        np.arange(1, 200) / 64.0, -np.arange(1, 200) / 64.0,  # exact ties
        rng.uniform(-1e10, 1e10, 5000),
        np.array([0.0, -0.0, -1e-7, 1e-7, np.inf, -np.inf, np.nan,
                  np.copysign(np.nan, -1.0), 1e10, -1e10, 9.999999e9,
                  123456789.123456]),
    ])
    n = int(np.ceil(np.sqrt(vals.size)))
    arr = np.zeros((n, n))
    arr.flat[:vals.size] = vals
    return arr


def test_native_writer_equals_python_formatter(tmp_path):
    arr = _adversarial()
    n = arr.shape[0]
    py_path, c_path = tmp_path / "py.txt", tmp_path / "c.txt"
    nsio._write_grid_py(str(py_path), arr, 0.123456, 1.0, 2.0, n, n - 2)
    nsio._write_grid(str(c_path), arr, 0.123456, 1.0, 2.0, n, n - 2)
    assert py_path.read_bytes() == c_path.read_bytes()
    assert nsio.BUILD_DIR.is_dir() and isinstance(nsio._writer(),
                                                  ctypes.CDLL)


@pytest.mark.parametrize("shape", [(99, 63), (16, 16), (5, 4)],
                         ids=["99x63", "16x16", "5x4"])
def test_python_formatter_equals_jax(tmp_path, shape):
    """The port's Python formatter against JAX's _write_grid_py on the
    u/v/p layouts of one grid, with negative zeros planted."""
    u, v, p = _fields(*shape, seed=sum(shape))
    for arr in (u, v, p):
        arr[::3, ::2] = -0.0
        arr[1, 1] = -4e-6  # rounds to -0.00000
    i_max, j_max = shape
    for arr, nc, nr in ((u, i_max + 1, j_max + 2), (v, i_max + 2, j_max + 1),
                        (p, i_max + 2, j_max + 2)):
        mine, theirs = tmp_path / "mine.txt", tmp_path / "jax.txt"
        nsio._write_grid_py(str(mine), arr, 0.5, 1.0, 2.0, nc, nr)
        jio._write_grid_py(str(theirs), arr, 0.5, 1.0, 2.0, nc, nr)
        assert mine.read_bytes() == theirs.read_bytes()
        assert b"-0.00000" in mine.read_bytes()


def test_output_equals_jax_output(tmp_path):
    """The whole triple from tensors (the port) and from arrays (JAX): the
    same bytes, the reference's layout."""
    u, v, p = _fields(7, 5, seed=3)
    nsio.output(*(torch.from_numpy(x) for x in (u, v, p)), 0.125, 1.0, 2.0,
                str(tmp_path / "port" / "3"), verbose=False)
    jio.output(u, v, p, 0.125, 1.0, 2.0, str(tmp_path / "jax" / "3"),
               verbose=False)
    for suffix in ("u", "v", "p"):
        mine = (tmp_path / "port" / f"3_{suffix}.txt").read_bytes()
        assert mine == (tmp_path / "jax" / f"3_{suffix}.txt").read_bytes()
    lines_v = (tmp_path / "port" / "3_v.txt").read_text().splitlines()
    assert lines_v[:3] == ["0.12500", "1.00000", "2.00000"]
    assert len(lines_v) == 3 + 5 + 2 and lines_v[-1] == ""


def test_read_field_round_trip(tmp_path):
    u, v, p = _fields(6, 3, seed=1)
    prefix = str(tmp_path / "rt")
    nsio.output(u, v, p, t=0.5, a=1.0, b=1.0, prefix=prefix, verbose=False)
    t, a, b, p_read = nsio.read_field(prefix + "_p.txt")
    assert (t, a, b) == (0.5, 1.0, 1.0)
    np.testing.assert_allclose(p_read, p, atol=5e-6)
    _, _, _, u_read = nsio.read_field(prefix + "_u.txt")
    np.testing.assert_allclose(u_read, u[:7, :], atol=5e-6)
    _, _, _, v_read = nsio.read_field(prefix + "_v.txt")
    np.testing.assert_allclose(v_read, v[:, :4], atol=5e-6)
    for name in ("u", "v", "p"):
        got = nsio.read_field(f"{prefix}_{name}.txt")[3]
        np.testing.assert_array_equal(
            got, jio.read_field(f"{prefix}_{name}.txt")[3])


def test_comparator_matches_jax(tmp_path):
    u, v, p = _fields(4, 4, seed=2)
    prefixes = {}
    for tag, du in (("a", 0.0), ("b", 5e-6), ("c", 5e-3)):
        prefixes[tag] = str(tmp_path / tag)
        nsio.output(u + du, v, p, 0.1, 1.0, 1.0, prefixes[tag], verbose=False)
    for tag, want in (("b", True), ("c", False)):
        pair = (prefixes["a"] + "_u.txt", prefixes[tag] + "_u.txt")
        assert nsio.compare_outputs_with_tolerance(*pair) is want
        assert jio.compare_outputs_with_tolerance(*pair) is want
    a = np.array([0.0, 0.5, 2.0, -3.0, 1e-9])
    b = np.array([1e-5, 0.5001, 2.0002, -3.0, 0.0])
    np.testing.assert_array_equal(nsio.tolerance_errors(a, b),
                                  jio.tolerance_errors(a, b))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback to the Python formatter: a compiler that fails (or is
    missing) raises WriterBuildError at the first write."""
    monkeypatch.setattr(nsio, "_lib", None)
    monkeypatch.setattr(nsio, "BUILD_DIR", tmp_path / "build")
    u, v, p = _fields(3, 3)
    for cc in ("false", str(tmp_path / "no-such-cc")):
        monkeypatch.setattr(nsio, "CC", cc)
        with pytest.raises(nsio.WriterBuildError):
            nsio.output(u, v, p, 0.0, 1.0, 1.0, str(tmp_path / "x"),
                        verbose=False)
    assert nsio._lib is None and not list((tmp_path / "build").glob("*.so"))
