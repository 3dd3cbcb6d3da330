"""Momentum step: tentative velocities F/G, Poisson RHS, projection, CFL dt.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/momentum.py``
(reference src/serial/integration.c:73-96, main.c:89-136).  These are the
plain tensor formulations; on a CUDA f32 state the solver computes F, G and
the RHS with the hand-written kernel instead (ops/cuda/momentum_kernel.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import Params
from . import stencils as st


def compute_fg(u: torch.Tensor, v: torch.Tensor, dt, gamma,
               params: Params, g_x=None,
               g_y=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tentative velocities (reference integration.c:73-96).

    F lives at u-locations for i in [1, i_max-1], j in [1, j_max]; G at
    v-locations for i in [1, i_max], j in [1, j_max-1].  On the walls F = u
    and G = v (Griebel et al. eq. 3.42); every other cell is 0.  `g_x` and
    `g_y` override the body force of `params` (0-d tensors that may carry
    gradients: diff.py); None keeps the configuration's.  A batch of fields
    (a leading member axis: solver.solve_ensemble) takes `dt` and `gamma`
    shaped to broadcast against it.
    """
    dx, dy, Re = params.dx, params.dy, params.Re
    i_max, j_max = params.i_max, params.j_max
    g_x = params.g_x if g_x is None else g_x
    g_y = params.g_y if g_y is None else g_y

    diff_u = st.div(st.d2_dx2(u, dx) + st.d2_dy2(u, dy), Re)
    conv_u = st.du2_dx(u, v, dx, gamma) + st.duv_dy(u, v, dy, gamma)
    f_int = st.shifted(u, 0, 0) + dt * (diff_u - conv_u + g_x)

    diff_v = st.div(st.d2_dx2(v, dx) + st.d2_dy2(v, dy), Re)
    conv_v = st.duv_dx(u, v, dx, gamma) + st.dv2_dy(u, v, dy, gamma)
    g_int = st.shifted(v, 0, 0) + dt * (diff_v - conv_v + g_y)

    F = torch.zeros_like(u)
    G = torch.zeros_like(v)
    F[..., 1:i_max, 1:-1] = f_int[..., : i_max - 1, :]
    G[..., 1:-1, 1:j_max] = g_int[..., :, : j_max - 1]
    F[..., 0, 1:-1] = u[..., 0, 1:-1]
    F[..., i_max, 1:-1] = u[..., i_max, 1:-1]
    G[..., 1:-1, 0] = v[..., 1:-1, 0]
    G[..., 1:-1, j_max] = v[..., 1:-1, j_max]
    return F, G


def compute_rhs(F: torch.Tensor, G: torch.Tensor, dt,
                params: Params) -> torch.Tensor:
    """Poisson RHS = div(F, G)/dt on the interior (reference main.c:116-120)."""
    dx, dy = params.dx, params.dy
    div = (st.div(st.shifted(F, 0, 0) - st.shifted(F, -1, 0), dx)
           + st.div(st.shifted(G, 0, 0) - st.shifted(G, 0, -1), dy))
    rhs = torch.zeros_like(F)
    rhs[..., 1:-1, 1:-1] = div / dt
    return rhs


def project_velocities(u, v, F, G, p, dt,
                       params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """u = F - dt dp/dx, v = G - dt dp/dy (reference main.c:131-136), IN
    PLACE on ``u`` and ``v`` (the step owns them; no new field per step).

    Only u[1:i_max-1, 1:j_max] and v[1:i_max, 1:j_max-1] are updated; the
    wall-edge values and ghosts carry over unchanged.
    """
    i_max, j_max = params.i_max, params.j_max
    u_new = st.shifted(F, 0, 0) - dt * st.dp_dx(p, params.dx)
    v_new = st.shifted(G, 0, 0) - dt * st.dp_dy(p, params.dy)
    u[..., 1:i_max, 1:-1] = u_new[..., : i_max - 1, :]
    v[..., 1:-1, 1:j_max] = v_new[..., :, : j_max - 1]
    return u, v


def cfl_dt_gamma(u_max, v_max, params: Params, limit: torch.Tensor):
    """(dt, gamma) of the CFL rule from the signed maxima with AD-safe
    velocity terms: tau min(limit, dx / max(|u_max|, tiny), dy /
    max(|v_max|, tiny)).  At rest the production form's dx/0 = inf drops
    out of the min forward, but its backward would give 0 * inf = NaN;
    tiny = sqrt(finfo.tiny) keeps the value (dx/tiny never wins the min)
    and the gradient exact wherever |max| > tiny.  `limit` is a 0-d tensor
    (the viscous bound, with the energy equation's where it applies);
    every division is by a device tensor.  The differentiable step
    (diff.py) and the sharded backend's dt (parallel/sharded.py) share
    it."""
    def const(x):
        return st.scalar(x, u_max.dtype, u_max.device)

    tiny = const(torch.finfo(u_max.dtype).tiny ** 0.5)
    dx_t, dy_t = const(params.dx), const(params.dy)
    dt = params.tau * torch.minimum(
        limit, torch.minimum(dx_t / torch.maximum(torch.abs(u_max), tiny),
                             dy_t / torch.maximum(torch.abs(v_max), tiny)))
    if params.gamma_fixed is not None:
        gamma = const(params.gamma_fixed)
    else:
        gamma = torch.maximum(u_max * dt / dx_t, v_max * dt / dy_t)
    return dt, gamma


def adaptive_dt_gamma(u, v, params: Params):
    """CFL time step and donor-cell weight (reference main.c:89-92), as 0-d
    tensors on the state's device (no host round trip).

    dt = tau * min(Re/2/(1/dx^2+1/dy^2), dx/|u_max|, dy/|v_max|), with u_max,
    v_max the reference's *signed* interior maxima (io.c:122).  gamma =
    max(u_max*dt/dx, v_max*dt/dy).  A batch of fields gives one dt and one
    gamma per member (shape (B,)).  A zero max gives dt = +inf for its term,
    which drops out of the min, as C float semantics and JAX do.
    """
    dx, dy, Re, tau = params.dx, params.dy, params.Re, params.tau
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)

    def const(x):
        # Device tensors, not Python scalars: CUDA divides by a host scalar
        # as a multiply by its reciprocal, which rounds differently.
        return st.scalar(x, u.dtype, u.device)

    dx_t, dy_t = const(dx), const(dy)
    visc = const(Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy)))
    dt = tau * torch.minimum(
        visc, torch.minimum(dx_t / torch.abs(u_max), dy_t / torch.abs(v_max)))
    if params.gamma_fixed is not None:
        gamma = const(params.gamma_fixed)
    else:
        gamma = torch.maximum(u_max * dt / dx_t, v_max * dt / dy_t)
    return dt, gamma
