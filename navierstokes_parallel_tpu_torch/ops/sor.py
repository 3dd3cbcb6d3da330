"""Pressure-Poisson solve: mixed-precision refinement around an f32 inner.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/sor.py`` for the main
path.  Convergence contract (serial reference, integration.c:135,164): stop
when L2(residual) <= eps * (||p_0|| + 1.5), ||p_0|| the L2 norm of p at
entry, or after max_it sweeps.

An f32 state cannot meet that threshold on grids >= ~64^2 by plain f32
sweeps (the Laplacian amplifies p's storage rounding), so the solve is the
JAX package's mixed-precision iterative refinement: an f64 master pressure,
an f64 defect and L2 check every K = ``sor_refine_every`` sweeps, and K f32
red-black sweeps on the correction in between.  The H100 has native FP64, so
the outer is plain PyTorch in float64; the sweeps are hand-written kernels
(ops/cuda/sor_kernel.py::inner_sweeps), routed as the JAX package routes its
Pallas kernels: the temporal-blocked tiled kernel where the grid exceeds the
JAX whole-grid budget (2048^2 and up), else the whole-grid kernel (or the
colour-compressed one with ``sor_kernel.USE_COMPRESSED``).
``method="pallas_sor"`` and ``"rb_sor"`` take this same route: in JAX they
differ only in how the TPU lowers the sweeps.  The f32 inner is the only
one: ``sor_inner_dtype="bfloat16"``, which JAX's kernel route honours, is
refused on ``pallas_sor`` (ROADMAP "Left out"); ``rb_sor`` ignores it, as
JAX's jnp route does.  ``method="mg"`` and ``"cg"`` run the same outer
around another inner stage, as the JAX package does: ``mg_cycles_per_outer``
multigrid V-cycles (ops/mg.py), or ``sor_refine_every`` conjugate-gradient
steps; the solve's ``iterations`` then count V-cycles or CG steps.

The loop runs on the host: each outer pass reads one scalar (the residual
norm) back to decide whether to go on, i.e. one device sync per K sweeps.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import Params
from . import mg
from .cuda import sor_kernel
from .stencils import l2_norm

# The serial reference's convergence-threshold offset (integration.c:164).
NORM_OFFSET = 1.5

# Solvers of the JAX package not ported yet, with the ROADMAP item that
# ports each.
NOT_PORTED = {
    "jacobi": "ROADMAP A5 (jacobi)",
    "fft": "ROADMAP A5 (fft)",
}

# An inner stage: (rhs_full, n) -> delta, n steps of an approximate solve of
# A delta = rhs_full from delta = 0 on the padded f32 grid (ring of rhs_full
# is 0).
Inner = Callable[[torch.Tensor, int], torch.Tensor]


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
    if method not in ("rb_sor", "pallas_sor", "mg", "cg"):
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
    if method == "mg":
        # mg_cycles_per_outer V-cycles per f64 defect check; iterations
        # count V-cycles.
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.mg_cycles_per_outer)),
            inner_fn=lambda r, n: mg.inner_v_cycle(r, n, params))
    if method == "cg":
        # K = sor_refine_every CG steps per outer pass (a restart each);
        # iterations count CG steps.
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.sor_refine_every)),
            inner_fn=_cg_inner(params))
    if method == "pallas_sor":
        if params.sor_inner_dtype != "float32":
            raise NotImplementedError(
                f"sor_inner_dtype={params.sor_inner_dtype!r} (bf16 sweeps and "
                f"transport) is not ported: ROADMAP A, \"Left out of the "
                f"port\"; the kernels sweep in float32")
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.sor_refine_every)))
    if p.dtype == torch.float32 and params.sor_refine_every > 0:
        return _solve_pressure_refined(p, rhs, params)
    raise NotImplementedError(
        f"direct (unrefined) {p.dtype} SOR is not ported yet: ROADMAP A2 "
        f"(_solve_pressure_direct); use float32 with sor_refine_every >= 1")


def _cg_inner(params: Params) -> Inner:
    """n f32 conjugate-gradient steps on B x = -b, B = -A (symmetric
    positive semi-definite), from x = 0, on mg's level-0 Laplacian.  Plain
    PyTorch: the JAX package has no kernel behind it.  Every scalar stays a
    0-d device tensor, so the steps need no host sync."""
    lvl = mg.build_levels(params)[0]

    def B(x):
        return -mg._lap(mg.ghost_zero(x), lvl)

    def dot(a, c):
        return torch.sum(a[1:-1, 1:-1] * c[1:-1, 1:-1])

    def inner(b: torch.Tensor, n_steps: int) -> torch.Tensor:
        x = torch.zeros_like(b)
        r = -b
        d = r
        rs = dot(r, r)
        zero = torch.zeros_like(rs)
        for _ in range(int(n_steps)):
            Bd = B(d)
            denom = dot(d, Bd)
            alpha = torch.where(denom > 0, rs / denom, zero)
            x = x + alpha * d
            r = r - alpha * Bd
            rs_new = dot(r, r)
            beta = torch.where(rs > 0, rs_new / rs, zero)
            d = r + beta * d
            rs = rs_new
        return x

    return inner


def _solve_pressure_refined(p: torch.Tensor, rhs: torch.Tensor,
                            params: Params, *,
                            ghost_fn: Callable = ghost_fill,
                            l2_fn: Optional[Callable] = None, parity: int = 0,
                            inner_fn: Optional[Inner] = None,
                            valid_mask: Optional[torch.Tensor] = None,
                            mean_fn: Optional[Callable] = None,
                            residual_fn: Optional[Callable] = None
                            ) -> SORResult:
    """Mixed-precision iterative refinement around an f32 inner stage.

    Outer loop (f64, once per K inner steps): defect r = A p - RHS, L2
    norm, convergence test against the reference threshold, p += delta.
    Inner (f32): `inner_fn(-r, K)`, by default K red-black sweeps on
    A delta = -r from delta = 0 (the SOR kernel route).

    The hooks are the JAX package's (``_refined_setup``), for a shard of
    the sharded backend (parallel/sharded.py): `ghost_fn` fills the ring
    before each defect (it may work in place or return a new tensor),
    `l2_fn` is the norm of an interior-shaped array (all-reduced across
    shards), `valid_mask` zeroes the pad cells of a padded block in the
    defect and the norms, and `parity` is the block's colour offset
    (ox + oy) % 2, which the default inner (the whole grid, parity 0)
    cannot take: a shard brings its own `inner_fn`.  The JAX package's
    other two hooks are not ported and raise: `mean_fn` (the constant-mode
    deflation of problem 3) and `residual_fn` (the masked defect of
    obstacle domains).
    """
    if mean_fn is not None:
        raise NotImplementedError(
            "the refinement's mean_fn hook (problem 3's constant-mode "
            "deflation) is not ported yet: ROADMAP A6")
    if residual_fn is not None:
        raise NotImplementedError(
            "the refinement's residual_fn hook (the masked defect of "
            "obstacle domains) is not ported yet: ROADMAP A7, A10 "
            "(obstacles)")
    if inner_fn is None:
        if parity % 2:
            raise ValueError(
                "the SOR kernel route sweeps a whole grid (parity 0); a "
                "block of parity 1 needs its own inner_fn")

        def inner_fn(rhs_full, n):
            return sor_kernel.inner_sweeps(rhs_full, n, params)
    K = params.sor_refine_every
    f64, f32 = torch.float64, torch.float32
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    if l2_fn is None:
        def l2_fn(arr):
            return l2_norm(arr, params.i_max, params.j_max)

    def masked(arr):
        if valid_mask is None:
            return arr
        return torch.where(valid_mask, arr, torch.zeros((), dtype=arr.dtype,
                                                        device=arr.device))

    p64 = p.to(f64, copy=True)  # the master; updated in place below
    rhs_int64 = rhs[1:-1, 1:-1].to(f64)
    norm_p0 = l2_fn(masked(p64[1:-1, 1:-1]))
    threshold = float(params.epsilon * (norm_p0 + NORM_OFFSET))

    def defect():
        return masked(residual(ghost_fn(p64), rhs_int64, dx2_inv, dy2_inv))

    rhs_full = torch.zeros(p.shape, dtype=f32, device=p.device)
    r64 = defect()
    it = 0
    res_norm = math.inf
    while it < params.max_it and res_norm > threshold:
        n_inner = min(K, params.max_it - it)
        # rhs_full's ghost ring stays 0; only its interior is rewritten.
        rhs_full[1:-1, 1:-1] = -r64.to(f32)
        delta = inner_fn(rhs_full, n_inner)
        p64[1:-1, 1:-1] += delta[1:-1, 1:-1].to(f64)
        r64 = defect()
        res_norm = float(l2_fn(r64))  # the one sync per pass
        it += n_inner
    p_out = ghost_fn(p64).to(p.dtype)
    return SORResult(
        p=p_out,
        iterations=it,
        res_norm=float(torch.tensor(res_norm, dtype=p.dtype)),
        converged=res_norm <= threshold,
    )
