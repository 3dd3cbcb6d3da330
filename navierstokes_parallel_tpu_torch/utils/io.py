"""Field text I/O in the reference's format (counterpart of
navierstokes_parallel_tpu/utils/io.py, which this module copies: the JAX
package's module is not imported).

``output`` writes u/v/p text grids in exactly the reference's ``output()``
format (src/serial/io.c:61-120): per field a 3-line header (t, a, b, each
"%.5f"), then rows of "%.5f "-formatted values, outer loop over j (so a
text row is a fixed-j slice), inner over i.  Quirks reproduced: the u file
has i_max+1 columns, the v file has j_max+1 data rows followed by one empty
line, the p file is the full (i_max+2) x (j_max+2) padded grid.  So the
reference's tooling and the JAX package's (plot_ghia.py, the notebook
comparator, ``utils/plotting.py``), which read only these files, read the
port's frames unchanged.

The files are written by a native formatter (``csrc/nsp_io.c``), built at
first use with the host C compiler into ``<checkout>/build/torch_io/``
under a name that carries a hash of the source and the flags.  A failed
build raises ``WriterBuildError``: there is no fallback.  ``_write_grid_py`` is the
Python formatter the tests hold the native one against, byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np

from ..grid import host_array

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "nsp_io.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_io"
CC = "cc"
# No -march=native: a checkout (and its build/) may move between hosts.
CFLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-shared")

_lib = None  # the loaded writer, once built
_lib_lock = threading.Lock()


class WriterBuildError(RuntimeError):
    """The C compiler is missing or refused csrc/nsp_io.c."""


def _build() -> Path:
    """Compile the writer unless the library for the source's current
    contents exists; returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CFLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libnsp_io_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Built under a private name and renamed when done: a concurrent build
    # (another process) never loads a half-written library.
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    cmd = [CC, *CFLAGS, "-o", str(tmp), str(SOURCE), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise WriterBuildError(f"cannot run {CC!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise WriterBuildError(f"{' '.join(cmd)} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _writer() -> ctypes.CDLL:
    """The native writer, built on first use.  The lock matters: output()
    calls this from three threads at once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.nsp_write_grid.restype = ctypes.c_int
            lib.nsp_write_grid.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ]
            _lib = lib
        return _lib


def _write_grid_py(path: str, arr: np.ndarray, t: float, a: float, b: float,
                   n_cols: int, n_rows: int) -> None:
    """The Python formatter: the oracle of the native writer's bytes."""
    with open(path, "w") as fh:
        fh.write(f"{t:.5f}\n{a:.5f}\n{b:.5f}\n")
        total_rows = arr.shape[1]
        for j in range(total_rows):
            if j < n_rows:
                row = arr[:n_cols, j]
                fh.write(" ".join(f"{val:.5f}" for val in row) + " \n")
            else:
                fh.write("\n")


def _write_grid(path: str, arr: np.ndarray, t: float, a: float, b: float,
                n_cols: int, n_rows: int) -> None:
    """arr is indexed [i, j]; file rows are j-slices (io.c:102-112)."""
    arr64 = np.ascontiguousarray(arr, dtype=np.float64)
    rc = _writer().nsp_write_grid(
        path.encode(), arr64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr64.shape[0], arr64.shape[1], n_cols, n_rows,
        float(t), float(a), float(b))
    if rc != 0:
        raise OSError(f"cannot write {path!r} (native writer status {rc})")


def output(u, v, p, t: float, a: float, b: float, prefix: str,
           verbose: bool = True, temperature=None) -> None:
    """Write ``<prefix>_{u,v,p}.txt`` (reference io.c:61-120) from padded
    fields (tensors on any device, or arrays).  The files are written
    concurrently: ctypes releases the GIL, so the formatters overlap.
    `temperature` (problem 5) adds a cell-centred ``<prefix>_temp.txt`` in
    p's grid format."""
    u, v, p = host_array(u), host_array(v), host_array(p)
    i_max = p.shape[0] - 2
    j_max = p.shape[1] - 2

    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)

    jobs = (
        (f"{prefix}_u.txt", u, i_max + 1, j_max + 2),
        (f"{prefix}_v.txt", v, i_max + 2, j_max + 1),
        (f"{prefix}_p.txt", p, i_max + 2, j_max + 2),
    )
    if temperature is not None:
        jobs += ((f"{prefix}_temp.txt", host_array(temperature), i_max + 2,
                  j_max + 2),)
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futs = [pool.submit(_write_grid, path, arr, t, a, b, nc, nr)
                for path, arr, nc, nr in jobs]
        for f in futs:
            f.result()
    if verbose:
        print("Output created!")


def read_field(path: str) -> Tuple[float, float, float, np.ndarray]:
    """Read a field file back; returns (t, a, b, array indexed [i, j])."""
    with open(path, "r") as fh:
        t = float(fh.readline())
        a = float(fh.readline())
        b = float(fh.readline())
        rows = []
        for line in fh:
            if not line.isspace():
                # Raises on a corrupt token (np.fromstring(sep=...) would
                # silently truncate the row).
                rows.append(np.array(line.split(), dtype=np.float64))
    # File rows are j-slices with i varying along the row -> transpose.
    return t, a, b, np.array(rows).T


def tolerance_errors(a, b):
    """The reference notebook's comparator metric on arrays: elementwise
    relative error where |x| > 1, absolute error otherwise
    (colab-runner.ipynb compare_outputs_with_tolerance).  Returns the error
    array; compare its max against the tolerance (1e-4 in the contract)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    big = (np.abs(a) > 1.0) | (np.abs(b) > 1.0)
    denom = np.maximum(np.abs(a), np.abs(b))
    rel = np.abs(a - b) / np.where(denom == 0, 1.0, denom)
    return np.where(big, rel, np.abs(a - b))


def compare_outputs_with_tolerance(path_a: str, path_b: str,
                                   tol: float = 1e-4) -> bool:
    """File-based parity check in the notebook's contract."""
    with open(path_a) as fa, open(path_b) as fb:
        lines_a, lines_b = fa.readlines(), fb.readlines()
    if len(lines_a) != len(lines_b):
        return False
    for la, lb in zip(lines_a, lines_b):
        ta, tb = la.split(), lb.split()
        if len(ta) != len(tb):
            return False
        if ta and np.max(
            tolerance_errors([float(x) for x in ta], [float(x) for x in tb])
        ) > tol:
            return False
    return True
