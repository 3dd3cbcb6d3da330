"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
compiles them in seconds, one process per source, all started together, and
links the objects into one shared library, which is loaded with ``ctypes``.  Pointers and the stream are passed as ``c_void_p``; every entry
point returns ``cudaGetLastError()`` after its launches, and the wrappers
raise on anything but 0.

The library goes to ``<checkout>/build/torch_kernels/`` (``build/`` is
git-ignored) under a name that carries a hash of the sources' contents, so
an edited source forces a rebuild and a stale library is never loaded.  It
is built on first use, never at import: the CPU tests import every module
on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# Where the CUDA toolkit lives when nvcc is neither on PATH nor under
# $CUDA_HOME.
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see the .cu sources).
SIGNATURES = {
    # d, rhs, ni, nj, n_sweeps, one_minus_omega, coef, dx2_inv, dy2_inv,
    # device, stream
    "nsp_sor_sweeps_simple": (_P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # out, scratch, p0, rhs, ni, nj, n_sweeps, tile_rows, tile_cols,
    # sweeps_per_launch, one_minus_omega, coef, dx2_inv, dy2_inv, device,
    # stream
    "nsp_sor_warm_sweeps": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                            _F, _F, _I, _P),
    # d, p0, rhs, ni, nj, n_sweeps, one_minus_omega, coef, dx2_inv, dy2_inv,
    # device, stream
    "nsp_sor_warm_sweeps_simple": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I,
                                   _P),
    # out, p0, rhs, shapes (int[2 n_levels], host), consts (float[5
    # n_levels], host), n_levels, nu1, nu2, coarse_sweeps, device, stream
    "nsp_mg_coarse_cycle": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # d, scratch, rhs, ni, nj, n_sweeps, tile_rows, tile_cols,
    # sweeps_per_chunk, one_minus_omega, coef, dx2_inv, dy2_inv, device,
    # stream
    "nsp_sor_tiled_sweeps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                             _F, _I, _P),
    # out, d0, rhs, rows, cols, n_sweeps, ox, oy, H, i_max, j_max,
    # tile_rows, tile_cols, one_minus_omega, coef, dx2_inv, dy2_inv, device,
    # stream
    "nsp_sor_ext_sweeps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _F, _F, _F, _I, _P),
    # tile_rows, tile_cols, halo, out (int[7]), device
    "nsp_sor_tile_report": (_I, _I, _I, _P, _I),
    # red, black, scratch_red, scratch_black, rhs_red, rhs_black, ni, nj,
    # n_sweeps, tile_rows, tile_cols, sweeps_per_chunk, one_minus_omega,
    # coef, dx2_inv, dy2_inv, device, stream
    "nsp_sor_compressed_sweeps": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _F, _F, _F, _F, _I, _P),
    # tile_rows, tile_cols, halo, out (int[7]), device
    "nsp_sor_compressed_tile_report": (_I, _I, _I, _P, _I),
    # red, black, rhs_red, rhs_black, ni, nj, n_sweeps, one_minus_omega,
    # coef, dx2_inv, dy2_inv, device, stream
    "nsp_sor_compressed_sweeps_simple": (_P, _P, _P, _P, _I, _I, _I, _F, _F,
                                         _F, _F, _I, _P),
    # dt_p, gamma_p (device pointers or null), dt_v, gamma_v, u, v, F, G,
    # rhs, ni, nj, i_max, j_max, inv_dx, inv_dy, inv_re, inv_dx2, inv_dy2,
    # g_x, g_y, device, stream
    "nsp_momentum_rhs": (_P, _P, _F, _F, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _F, _F, _F, _F, _F, _F, _I, _P),
    # scalars(dt, gamma), u, v, F, G, rhs, ni, nj, i_max, j_max, inv_dx,
    # inv_dy, inv_re, inv_dx2, inv_dy2, g_x, g_y, device, stream
    "nsp_momentum_rhs_simple": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                _F, _F, _F, _F, _F, _F, _I, _P),
}

_lib = None  # the loaded library, once built


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def sources() -> list:
    """The translation units; headers (*.cuh) are included by them."""
    return sorted(CSRC_DIR.glob("*.cu"))


def source_digest() -> str:
    """Hash of every source and header, names and contents."""
    h = hashlib.sha256()
    for path in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libnsp_torch_{source_digest()}.so"


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else under DEFAULT_CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME or under "
        f"{DEFAULT_CUDA_HOME}: the CUDA kernels cannot be built")


def _run_all(cmds: list) -> None:
    """Run the commands at once; raise KernelBuildError with the output of
    the first that fails, after all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}"
                      f"\n{out}{err}")
    if failed:
        raise KernelBuildError(failed)


def build() -> Path:
    """Compile the sources for sm_90a unless the library for their current
    contents exists; returns its path.  Raises KernelBuildError with the
    compiler's output when nvcc is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Objects and library under private names, the library renamed when
    # done: a concurrent build never loads a half-written library.
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.nsp_error_string.argtypes = [ctypes.c_int]
        lib.nsp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def device_and_stream(x) -> tuple:
    """The CUDA device index of tensor `x` and PyTorch's current stream on
    that device (as a pointer-sized int): where a kernel on `x` launches."""
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(x.device).cuda_stream


def check_status(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status != 0:
        msg = load().nsp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
