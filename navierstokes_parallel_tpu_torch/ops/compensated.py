"""Error-free-transformation (two-float) arithmetic for the refinement outer.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/compensated.py``,
the arithmetic of ``outer_precision="compensated"`` (ops/sor.py::
_solve_pressure_refined_compensated): the master pressure is an f32 pair
(hi, lo) and the defect A p - rhs is evaluated with Knuth's two_sum and
Dekker's split / two_prod, ~48 mantissa bits from f32 operations alone.
The JAX package needs it because a TPU emulates f64; the H100 has FP64 in
hardware, so here it is the same contract by another route, kept for
parity with the JAX package's results and options.

Every ``+``, ``-`` and ``*`` below must round once: each is one PyTorch
elementwise operation (one kernel on the card, one loop on the CPU), and
nothing here may be fused (no ``torch.compile``, ``addcmul`` or
``addmm``): a fused multiply-add inside ``split`` or ``two_prod`` breaks
their exactness.  Multiplications by host scalars (the Dekker constant,
1/dx^2 given as an f32 tensor) are safe; there is no division.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Dekker split constant for f32: 2**ceil(24/2) + 1.
_SPLIT = 4097.0


def two_sum(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """s = fl(a+b) and the EXACT rounding error e, so a + b == s + e."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """two_sum when |a| >= |b| (3 operations)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker split: a == hi + lo with hi, lo holding <= 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p = fl(a*b) and the EXACT error e, so a * b == p + e (Dekker, no
    FMA)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add_f32(hi: torch.Tensor, lo: torch.Tensor, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add an f32 array into a normalized two-float pair; returns the
    renormalized (hi, lo) with |lo| <= ulp(hi)/2, so hi alone is the
    correctly rounded f32 value of the pair."""
    s, e = two_sum(hi, x)
    return quick_two_sum(s, lo + e)


def residual_df(p_hi: torch.Tensor, p_lo: torch.Tensor,
                rhs_int: torch.Tensor, dx2_inv, dy2_inv,
                rhs_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compensated 5-point Poisson defect on the interior, f32 result: to
    ~eps^2 |p|/dx^2 + ulp(result) the value ops/sor.py::residual gives in
    f64 on (p_hi + p_lo),

        r = (pE - 2p + pW)/dx^2 + (pN - 2p + pS)/dy^2 - (rhs + rhs_lo).

    `dx2_inv` / `dy2_inv` are f32 (a Python number is rounded to f32 once
    here, as the JAX package's f32 constants are).  `rhs_lo` carries the low
    f32 word of a float64 rhs, so a float64-state solve certifies
    convergence against the full-precision rhs; None when the rhs is
    f32-native."""
    dx2_inv = torch.as_tensor(dx2_inv, dtype=p_hi.dtype, device=p_hi.device)
    dy2_inv = torch.as_tensor(dy2_inv, dtype=p_hi.dtype, device=p_hi.device)
    c_hi = p_hi[1:-1, 1:-1]
    c_lo = p_lo[1:-1, 1:-1]

    def diff(n_hi, n_lo):
        # A neighbour difference as a two-float: the hi subtraction is not
        # always exact (Sterbenz needs operands within 2x), so two_sum keeps
        # its error; the lo parts are O(ulp(p)), their own error negligible.
        d_hi, e = two_sum(n_hi, -c_hi)
        return d_hi, (n_lo - c_lo) + e

    dE_hi, dE_lo = diff(p_hi[2:, 1:-1], p_lo[2:, 1:-1])
    dW_hi, dW_lo = diff(p_hi[:-2, 1:-1], p_lo[:-2, 1:-1])
    dN_hi, dN_lo = diff(p_hi[1:-1, 2:], p_lo[1:-1, 2:])
    dS_hi, dS_lo = diff(p_hi[1:-1, :-2], p_lo[1:-1, :-2])
    # The second difference per axis cancels from O(dx |grad p|) down to
    # O(dx^2 |lap p|): keep that cancellation exact.
    sx, ex = two_sum(dE_hi, dW_hi)
    lx = ex + (dE_lo + dW_lo)
    sy, ey = two_sum(dN_hi, dS_hi)
    ly = ey + (dN_lo + dS_lo)
    # The 1/dx^2 amplification with exact products.
    tx, etx = two_prod(sx, dx2_inv)
    ltx = etx + lx * dx2_inv
    ty, ety = two_prod(sy, dy2_inv)
    lty = ety + ly * dy2_inv
    # tx + ty - rhs cancels to O(threshold) near convergence: compensated
    # accumulation, one collapse at the end.
    u, eu = two_sum(tx, ty)
    v, ev = two_sum(u, -rhs_int)
    corr = ((eu + ev) + ltx) + lty
    if rhs_lo is not None:
        corr = corr - rhs_lo
    return v + corr
