"""Red-black SOR sweeps: the hand-written CUDA kernel and its plain twin.

Counterpart of ``navierstokes_parallel_tpu/ops/pallas/sor_kernel.py``
(``_make_kernel`` through ``inner_sweeps``): n red-black SOR sweeps on
A delta = rhs_neg from delta = 0 over the padded grid, with the Neumann
boundary folded into a per-cell self coefficient.  The kernel is
``csrc/sor.cu``; its source note says what bounds it on the card.

``inner_sweeps`` dispatches on the tensor's device: a CPU tensor goes to
``inner_sweeps_plain``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ...config import Params
from . import _build

# Kernel launches through inner_sweeps (one per call; each call runs all
# 2 n half-sweep launches in C).
LAUNCHES = 0


def sweep_constants(params: Params):
    """(1 - omega, coef, dx2_inv, dy2_inv) as Python doubles; each is
    rounded to f32 once where it meets the f32 field, as the Pallas kernel
    bakes its Python-float constants."""
    omega = float(params.omega)
    dx2_inv = float(1.0 / (params.dx * params.dx))
    dy2_inv = float(1.0 / (params.dy * params.dy))
    coef = omega / (2.0 * (dx2_inv + dy2_inv))
    return 1.0 - omega, coef, dx2_inv, dy2_inv


def inner_sweeps_plain(rhs_neg: torch.Tensor, n_sweeps: int,
                       params: Params) -> torch.Tensor:
    """The kernel's formulation in plain PyTorch: rolls of the whole padded
    field (the wrap lands only in the ghost ring, which the masks exclude),
    masks, self coefficient, one Python loop iteration per sweep."""
    one_minus_omega, coef, dx2_inv, dy2_inv = sweep_constants(params)
    ni, nj = rhs_neg.shape
    f32 = torch.float32
    ii = torch.arange(ni, device=rhs_neg.device).view(ni, 1)
    jj = torch.arange(nj, device=rhs_neg.device).view(1, nj)
    interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    par = (ii + jj) & 1  # parity on the padded (= 1-based interior) indices
    red = interior & (par == 0)
    black = interior & (par == 1)
    # Neumann BC folded in: the ghost neighbour contributes 0 (the ring is
    # never written) and self_coef * d adds the mirrored one.
    self_coef = (((ii == 1).to(f32) + (ii == ni - 2).to(f32)) * dx2_inv
                 + ((jj == 1).to(f32) + (jj == nj - 2).to(f32)) * dy2_inv)
    rhs = rhs_neg.to(f32)

    def half_sweep(d, mask):
        nb = ((torch.roll(d, 1, 0) + torch.roll(d, -1, 0)) * dx2_inv
              + (torch.roll(d, 1, 1) + torch.roll(d, -1, 1)) * dy2_inv
              + d * self_coef)
        d_new = one_minus_omega * d + coef * (nb - rhs)
        return torch.where(mask, d_new, d)

    d = torch.zeros((ni, nj), dtype=f32, device=rhs_neg.device)
    for _ in range(int(n_sweeps)):
        d = half_sweep(d, red)
        d = half_sweep(d, black)
    return d


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
