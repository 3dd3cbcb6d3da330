"""Finite-difference stencils as shifted-slice arithmetic.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/stencils.py``
(reference src/serial/integration.c:7-71).  Every function takes padded
(i_max+2, j_max+2) tensors and returns the (i_max, j_max) interior values;
the operation order follows the JAX module so that both round alike.
"""

from __future__ import annotations

import torch


def shifted(x, di: int, dj: int):
    """Interior view of `x` shifted by (di, dj); offsets in {-1, 0, +1}.

    shifted(x, 0, 0)[i-1, j-1] == x[i, j] for interior (i, j).
    """
    ni, nj = x.shape[-2], x.shape[-1]
    return x[..., 1 + di: ni - 1 + di, 1 + dj: nj - 1 + dj]


# ---------------------------------------------------------------------------
# Donor-cell convective stencils (gamma-weighted upwinding),
# reference integration.c:7-51.
# ---------------------------------------------------------------------------

def du2_dx(u, v, dx, gamma):
    """d(u^2)/dx at u-locations (reference integration.c:7-15)."""
    uc, ue, uw = shifted(u, 0, 0), shifted(u, 1, 0), shifted(u, -1, 0)
    avg_e = 0.5 * (uc + ue)
    avg_w = 0.5 * (uw + uc)
    upw_e = torch.abs(avg_e) * 0.5 * (uc - ue)
    upw_w = torch.abs(avg_w) * 0.5 * (uw - uc)
    return (avg_e * avg_e - avg_w * avg_w) / dx + gamma / dx * (upw_e - upw_w)


def duv_dy(u, v, dy, gamma):
    """d(uv)/dy at u-locations (reference integration.c:17-28)."""
    uc, un, us = shifted(u, 0, 0), shifted(u, 0, 1), shifted(u, 0, -1)
    vc, ve = shifted(v, 0, 0), shifted(v, 1, 0)
    vs, vse = shifted(v, 0, -1), shifted(v, 1, -1)
    v_n = 0.5 * (vc + ve)
    v_s = 0.5 * (vs + vse)
    flux_n = v_n * 0.5 * (uc + un)
    flux_s = v_s * 0.5 * (us + uc)
    upw_n = torch.abs(v_n) * 0.5 * (uc - un)
    upw_s = torch.abs(v_s) * 0.5 * (us - uc)
    return (flux_n - flux_s) / dy + gamma / dy * (upw_n - upw_s)


def dv2_dy(u, v, dy, gamma):
    """d(v^2)/dy at v-locations (reference integration.c:30-38)."""
    vc, vn, vs = shifted(v, 0, 0), shifted(v, 0, 1), shifted(v, 0, -1)
    avg_n = 0.5 * (vc + vn)
    avg_s = 0.5 * (vs + vc)
    upw_n = torch.abs(avg_n) * 0.5 * (vc - vn)
    upw_s = torch.abs(avg_s) * 0.5 * (vs - vc)
    return (avg_n * avg_n - avg_s * avg_s) / dy + gamma / dy * (upw_n - upw_s)


def duv_dx(u, v, dx, gamma):
    """d(uv)/dx at v-locations (reference integration.c:40-51)."""
    vc, ve, vw = shifted(v, 0, 0), shifted(v, 1, 0), shifted(v, -1, 0)
    uc, un = shifted(u, 0, 0), shifted(u, 0, 1)
    uw, unw = shifted(u, -1, 0), shifted(u, -1, 1)
    u_e = 0.5 * (uc + un)
    u_w = 0.5 * (uw + unw)
    flux_e = u_e * 0.5 * (vc + ve)
    flux_w = u_w * 0.5 * (vw + vc)
    upw_e = torch.abs(u_e) * 0.5 * (vc - ve)
    upw_w = torch.abs(u_w) * 0.5 * (vw - vc)
    return (flux_e - flux_w) / dx + gamma / dx * (upw_e - upw_w)


# ---------------------------------------------------------------------------
# Central second derivatives (reference integration.c:57-71).
# ---------------------------------------------------------------------------

def d2_dx2(x, dx):
    """Central second derivative along x of any staggered field."""
    return (shifted(x, 1, 0) - 2.0 * shifted(x, 0, 0) + shifted(x, -1, 0)) / (dx * dx)


def d2_dy2(x, dy):
    """Central second derivative along y of any staggered field."""
    return (shifted(x, 0, 1) - 2.0 * shifted(x, 0, 0) + shifted(x, 0, -1)) / (dy * dy)


def d2u_dx2(u, dx):
    return d2_dx2(u, dx)


def d2u_dy2(u, dy):
    return d2_dy2(u, dy)


def d2v_dx2(v, dx):
    return d2_dx2(v, dx)


def d2v_dy2(v, dy):
    return d2_dy2(v, dy)


# ---------------------------------------------------------------------------
# Pressure gradients — forward differences (reference integration.c:101-110).
# ---------------------------------------------------------------------------

def dp_dx(p, dx):
    """Forward difference (p[i+1,j] - p[i,j]) / dx at interior points."""
    return (shifted(p, 1, 0) - shifted(p, 0, 0)) / dx


def dp_dy(p, dy):
    """Forward difference (p[i,j+1] - p[i,j]) / dy at interior points."""
    return (shifted(p, 0, 1) - shifted(p, 0, 0)) / dy


# ---------------------------------------------------------------------------
# Reductions (reference integration.c:115-124, io.c:122-161).
# ---------------------------------------------------------------------------

def l2_norm(interior_vals, i_max: int, j_max: int):
    """sqrt(sum(m^2) / (i_max * j_max)) over the interior (integration.c:115)."""
    return torch.sqrt(torch.sum(interior_vals * interior_vals) / (i_max * j_max))


def max_interior(x):
    """Signed max over the interior, seeded with the ghost corner x[0, 0].

    Reproduces the reference's max_mat quirk (io.c:122-139): it is a *signed*
    max (not abs) whose initial candidate is x[0][0].
    """
    return torch.maximum(x[0, 0], torch.max(x[1:-1, 1:-1]))
