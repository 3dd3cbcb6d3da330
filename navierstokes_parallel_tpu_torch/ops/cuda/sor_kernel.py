"""Red-black SOR sweeps: the hand-written CUDA kernels and their plain twins.

Counterpart of ``navierstokes_parallel_tpu/ops/pallas/sor_kernel.py``:

  * ``inner_sweeps`` (``_make_kernel`` through ``inner_sweeps`` there): n
    red-black SOR sweeps on A delta = rhs_neg from delta = 0 over the padded
    grid, the SOR route's refinement inner stage;
  * ``warm_sweeps`` (the same body with ``warm_start=True``, through
    ``warm_sweeps``): n red-black sweeps from a given p0, with omega and
    the level's dx^2 / dy^2 per call, the multigrid smoother (ops/mg.py).

Both fold the Neumann boundary into a per-cell self coefficient.  The
kernels are ``csrc/sor.cu``; its source note says what bounds them on the
card.  Each wrapper dispatches on the tensor's device: a CPU tensor goes to
its ``*_plain`` twin; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...config import Params
from . import _build

# Kernel launches, one per call of the wrapper (each call runs all its
# half-sweep launches in C): inner_sweeps counts in LAUNCHES, warm_sweeps
# in WARM_LAUNCHES.
LAUNCHES = 0
WARM_LAUNCHES = 0


def warm_constants(omega: float, dx2_inv: float, dy2_inv: float):
    """(1 - omega, coef, dx2_inv, dy2_inv) as Python doubles; each is
    rounded to f32 once where it meets the f32 field, as the Pallas kernel
    bakes its Python-float constants."""
    omega, dx2_inv, dy2_inv = float(omega), float(dx2_inv), float(dy2_inv)
    coef = omega / (2.0 * (dx2_inv + dy2_inv))
    return 1.0 - omega, coef, dx2_inv, dy2_inv


def sweep_constants(params: Params):
    """warm_constants of the configuration's omega and grid spacing."""
    return warm_constants(params.omega, 1.0 / (params.dx * params.dx),
                          1.0 / (params.dy * params.dy))


def _sweeps_plain(d: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                  constants) -> torch.Tensor:
    """The kernels' formulation in plain PyTorch, n red-black sweeps from
    the f32 field d: rolls of the whole padded field (the wrap lands only
    in the ghost ring, which the masks exclude; interior cells next to it
    read the ring as given), masks, self coefficient, one Python loop
    iteration per sweep.  With omega = 1 the (1 - omega) * d term is still
    computed, as the Pallas body does."""
    one_minus_omega, coef, dx2_inv, dy2_inv = constants
    ni, nj = d.shape
    f32 = torch.float32
    ii = torch.arange(ni, device=d.device).view(ni, 1)
    jj = torch.arange(nj, device=d.device).view(1, nj)
    interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    par = (ii + jj) & 1  # parity on the padded (= 1-based interior) indices
    red = interior & (par == 0)
    black = interior & (par == 1)
    # Neumann BC folded in: the ghost neighbour contributes 0 (the ring is
    # never written) and self_coef * d adds the mirrored one.
    self_coef = (((ii == 1).to(f32) + (ii == ni - 2).to(f32)) * dx2_inv
                 + ((jj == 1).to(f32) + (jj == nj - 2).to(f32)) * dy2_inv)

    def half_sweep(d, mask):
        nb = ((torch.roll(d, 1, 0) + torch.roll(d, -1, 0)) * dx2_inv
              + (torch.roll(d, 1, 1) + torch.roll(d, -1, 1)) * dy2_inv
              + d * self_coef)
        d_new = one_minus_omega * d + coef * (nb - rhs)
        return torch.where(mask, d_new, d)

    for _ in range(int(n_sweeps)):
        d = half_sweep(d, red)
        d = half_sweep(d, black)
    return d


def inner_sweeps_plain(rhs_neg: torch.Tensor, n_sweeps: int,
                       params: Params) -> torch.Tensor:
    """inner_sweeps in plain PyTorch: sweeps from delta = 0."""
    d = torch.zeros(rhs_neg.shape, dtype=torch.float32, device=rhs_neg.device)
    return _sweeps_plain(d, rhs_neg.to(torch.float32), n_sweeps,
                         sweep_constants(params))


def warm_sweeps_plain(p: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                      omega: float, dx2_inv: float,
                      dy2_inv: float) -> torch.Tensor:
    """warm_sweeps in plain PyTorch: sweeps from p (which is not modified)."""
    return _sweeps_plain(p.to(torch.float32, copy=True),
                         rhs.to(torch.float32), n_sweeps,
                         warm_constants(omega, dx2_inv, dy2_inv))


def check_inputs(rhs_neg: torch.Tensor, n_sweeps: int, params: Params) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if rhs_neg.dtype != torch.float32:
        raise TypeError(f"SOR kernel takes float32, got {rhs_neg.dtype}")
    if tuple(rhs_neg.shape) != params.shape:
        raise ValueError(f"SOR kernel takes the padded shape {params.shape}, "
                         f"got {tuple(rhs_neg.shape)}")
    if not rhs_neg.is_contiguous():
        raise ValueError("SOR kernel takes a contiguous rhs")
    if int(n_sweeps) < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")


def inner_sweeps(rhs_neg: torch.Tensor, n_sweeps: int,
                 params: Params) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A delta = rhs_neg from delta = 0:
    the plain version for a CPU tensor, the CUDA kernel for a CUDA one."""
    global LAUNCHES
    if rhs_neg.device.type == "cpu":
        return inner_sweeps_plain(rhs_neg, n_sweeps, params)
    if rhs_neg.device.type != "cuda":
        raise ValueError(f"no SOR kernel for device {rhs_neg.device}")
    check_inputs(rhs_neg, n_sweeps, params)
    lib = _build.load()
    ni, nj = params.shape
    # The kernel never writes the ghost ring, which must stay 0.
    d = torch.zeros((ni, nj), dtype=torch.float32, device=rhs_neg.device)
    status = lib.nsp_sor_sweeps(
        d.data_ptr(), rhs_neg.data_ptr(), ni, nj, int(n_sweeps),
        *sweep_constants(params), *_build.device_and_stream(rhs_neg))
    _build.check_status(status, "nsp_sor_sweeps")
    LAUNCHES += 1
    return d


def check_warm_inputs(p: torch.Tensor, rhs: torch.Tensor,
                      n_sweeps: int) -> None:
    """Raise on anything the warm-start kernel does not take."""
    for name, x in (("p", p), ("rhs", rhs)):
        if x.dtype != torch.float32:
            raise TypeError(f"SOR kernel takes float32 {name}, got {x.dtype}")
        if x.dim() != 2 or min(x.shape) < 1:
            raise ValueError(f"SOR kernel takes a non-empty 2-D {name}, got "
                             f"shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"SOR kernel takes a contiguous {name}")
    if p.shape != rhs.shape:
        raise ValueError(f"p {tuple(p.shape)} and rhs {tuple(rhs.shape)} "
                         f"differ in shape")
    if p.device != rhs.device:
        raise ValueError(f"p on {p.device} and rhs on {rhs.device}")
    if int(n_sweeps) < 0:
        raise ValueError(f"n_sweeps must be >= 0, got {n_sweeps}")


def warm_sweeps(p: torch.Tensor, rhs: torch.Tensor, n_sweeps: int,
                omega: float, dx2_inv: float, dy2_inv: float) -> torch.Tensor:
    """n_sweeps f32 red-black sweeps on A p = rhs from p, into a new tensor
    whose ghost ring is p's: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA one."""
    global WARM_LAUNCHES
    if p.device.type == "cpu":
        return warm_sweeps_plain(p, rhs, n_sweeps, omega, dx2_inv, dy2_inv)
    if p.device.type != "cuda":
        raise ValueError(f"no SOR kernel for device {p.device}")
    check_warm_inputs(p, rhs, n_sweeps)
    lib = _build.load()
    ni, nj = p.shape
    out = torch.empty_like(p)
    status = lib.nsp_sor_warm_sweeps(
        out.data_ptr(), p.data_ptr(), rhs.data_ptr(), ni, nj, int(n_sweeps),
        *warm_constants(omega, dx2_inv, dy2_inv),
        *_build.device_and_stream(p))
    _build.check_status(status, "nsp_sor_warm_sweeps")
    WARM_LAUNCHES += 1
    return out
