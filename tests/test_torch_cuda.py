"""The CUDA side of the port: the build, the wrappers' checks, and (on a
machine with an NVIDIA GPU) each kernel against its plain PyTorch version.

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
    assert [p.name for p in _build.sources()] == ["momentum.cu", "sor.cu"]
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


def test_wrappers_raise_on_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    is refused, not computed by the plain version."""
    prm = _params(6, 6)
    meta = torch.zeros(prm.shape, device="meta")
    with pytest.raises(ValueError, match="no SOR kernel"):
        sor_kernel.inner_sweeps(meta, 2, prm)
    with pytest.raises(ValueError, match="no momentum kernel"):
        momentum_kernel.momentum_rhs(meta, meta, 0.1, 0.1, prm)


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
def test_kernels_raise_on_bad_cuda_input(cuda):
    prm = _params(16, 16)
    with pytest.raises(TypeError):
        sor_kernel.inner_sweeps(_rhs(prm).double().to(cuda), 2, prm)
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
