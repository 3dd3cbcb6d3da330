"""Pressure-Poisson solve: mixed-precision refinement around red-black SOR.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/sor.py`` for the main
path.  Convergence contract (serial reference, integration.c:135,164): stop
when L2(residual) <= eps * (||p_0|| + 1.5), ||p_0|| the L2 norm of p at
entry, or after max_it sweeps.

An f32 state cannot meet that threshold on grids >= ~64^2 by plain f32
sweeps (the Laplacian amplifies p's storage rounding), so the solve is the
JAX package's mixed-precision iterative refinement: an f64 master pressure,
an f64 defect and L2 check every K = ``sor_refine_every`` sweeps, and K f32
red-black sweeps on the correction in between.  The H100 has native FP64, so
the outer is plain PyTorch in float64; the sweeps are the hand-written
kernel (ops/cuda/sor_kernel.py).  ``method="pallas_sor"`` and ``"rb_sor"``
take this same route: in JAX they differ only in how the TPU lowers the
sweeps.

The loop runs on the host: each outer pass reads one scalar (the residual
norm) back to decide whether to go on, i.e. one device sync per K sweeps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import Params
from .cuda import sor_kernel
from .stencils import l2_norm

# The serial reference's convergence-threshold offset (integration.c:164).
NORM_OFFSET = 1.5

# Solvers of the JAX package not ported yet, with the ROADMAP item that
# ports each.
NOT_PORTED = {
    "jacobi": "ROADMAP A5 (jacobi)",
    "cg": "ROADMAP A5 (cg)",
    "mg": "ROADMAP A5 (mg; its smoother is kernel B3)",
    "fft": "ROADMAP A5 (fft)",
}


class SORResult(NamedTuple):
    p: torch.Tensor       # solved pressure field (with ghosts)
    iterations: int       # sweeps performed
    res_norm: float       # final L2 residual norm, rounded to p's dtype
    converged: bool


def ghost_fill(p: torch.Tensor) -> torch.Tensor:
    """Homogeneous Neumann ghost update, IN PLACE (the ghost ring of the
    refinement master is scratch): copy the adjacent interior strip.
    Reference integration.c:138-146; corners are never read."""
    p[0, 1:-1] = p[1, 1:-1]
    p[-1, 1:-1] = p[-2, 1:-1]
    p[1:-1, 0] = p[1:-1, 1]
    p[1:-1, -1] = p[1:-1, -2]
    return p


def residual(p: torch.Tensor, rhs_int: torch.Tensor, dx2_inv,
             dy2_inv) -> torch.Tensor:
    """Pointwise Poisson residual on the interior (integration.c:156-160)."""
    return (
        (p[2:, 1:-1] - 2.0 * p[1:-1, 1:-1] + p[:-2, 1:-1]) * dx2_inv
        + (p[1:-1, 2:] - 2.0 * p[1:-1, 1:-1] + p[1:-1, :-2]) * dy2_inv
        - rhs_int
    )


def default_method(params: Params, device) -> str:
    """The JAX package's auto choice: the kernel route on the accelerator
    (CUDA here), rb_sor elsewhere — both run the same refinement here."""
    return "pallas_sor" if torch.device(device).type == "cuda" else "rb_sor"


def solve_pressure(p: torch.Tensor, rhs: torch.Tensor, params: Params, *,
                   method: str = "rb_sor") -> SORResult:
    """Iterate until L2(res) <= eps*(||p0|| + 1.5) or max_it sweeps."""
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"pressure method {method!r} is not ported yet: "
            f"{NOT_PORTED[method]}")
    if method not in ("rb_sor", "pallas_sor"):
        raise ValueError(f"unknown pressure solver method {method!r}")
    if params.obstacles:
        raise NotImplementedError(
            "obstacle domains (masked solvers) are not ported yet: ROADMAP A7")
    if params.problem == 3:
        raise NotImplementedError(
            "problem 3 (constant-mode deflation) is not ported yet: "
            "ROADMAP A6")
    if params.outer_precision == "compensated":
        raise NotImplementedError(
            "outer_precision='compensated' is not ported (the H100 has "
            "native FP64): ROADMAP A9")
    if method == "pallas_sor":
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.sor_refine_every)))
    if p.dtype == torch.float32 and params.sor_refine_every > 0:
        return _solve_pressure_refined(p, rhs, params)
    raise NotImplementedError(
        f"direct (unrefined) {p.dtype} SOR is not ported yet: ROADMAP A2 "
        f"(_solve_pressure_direct); use float32 with sor_refine_every >= 1")


def _solve_pressure_refined(p: torch.Tensor, rhs: torch.Tensor,
                            params: Params) -> SORResult:
    """Mixed-precision iterative refinement around f32 SOR sweeps.

    Outer loop (f64, once per K sweeps): defect r = A p - RHS, L2 norm,
    convergence test against the reference threshold, p += delta.
    Inner (f32): K red-black sweeps on A delta = -r from delta = 0.
    """
    K = params.sor_refine_every
    f64, f32 = torch.float64, torch.float32
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    i_max, j_max = params.i_max, params.j_max

    p64 = p.to(f64, copy=True)  # the master; updated in place below
    rhs_int64 = rhs[1:-1, 1:-1].to(f64)
    norm_p0 = l2_norm(p64[1:-1, 1:-1], i_max, j_max)
    threshold = float(params.epsilon * (norm_p0 + NORM_OFFSET))

    def defect():
        return residual(ghost_fill(p64), rhs_int64, dx2_inv, dy2_inv)

    rhs_full = torch.zeros(p.shape, dtype=f32, device=p.device)
    r64 = defect()
    it = 0
    res_norm = math.inf
    while it < params.max_it and res_norm > threshold:
        n_inner = min(K, params.max_it - it)
        # rhs_full's ghost ring stays 0; only its interior is rewritten.
        rhs_full[1:-1, 1:-1] = -r64.to(f32)
        delta = sor_kernel.inner_sweeps(rhs_full, n_inner, params)
        p64[1:-1, 1:-1] += delta[1:-1, 1:-1].to(f64)
        r64 = defect()
        res_norm = float(l2_norm(r64, i_max, j_max))  # the one sync per pass
        it += n_inner
    p_out = ghost_fill(p64).to(p.dtype)
    return SORResult(
        p=p_out,
        iterations=it,
        res_norm=float(torch.tensor(res_norm, dtype=p.dtype)),
        converged=res_norm <= threshold,
    )
