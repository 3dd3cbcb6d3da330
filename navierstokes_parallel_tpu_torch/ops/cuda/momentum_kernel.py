"""Momentum F, G and Poisson RHS: the hand-written CUDA kernel and its twin.

Counterpart of ``navierstokes_parallel_tpu/ops/pallas/momentum_kernel.py``
(``_make_kernel`` through ``momentum_rhs``): the eight donor-cell/diffusive
stencils on the guarded loop domains, the wall values F = u / G = v, and
rhs = div(F, G)/dt on the interior.  The kernel is ``csrc/momentum.cu``, one
fused launch per call; its source note says what bounds it on the card.

``momentum_rhs`` dispatches on the tensors' device: CPU tensors go to
``momentum_rhs_plain``; CUDA tensors launch the kernel or raise.
``momentum_rhs_simple`` is the first kernel (two launches: F and G, then
rhs), on no path: the yardstick the fused kernel is held against on the
card.
"""

from __future__ import annotations

import torch

from ...config import Params
from . import _build

# Kernel launches through momentum_rhs (one per call).
LAUNCHES = 0


def kernel_constants(params: Params):
    """(inv_dx, inv_dy, inv_re, inv_dx2, inv_dy2, g_x, g_y) as Python doubles,
    formed as the Pallas kernel forms them (inv_dx2 = inv_dx * inv_dx in
    double) and rounded to f32 once where they meet the f32 fields."""
    inv_dx, inv_dy = 1.0 / params.dx, 1.0 / params.dy
    return (inv_dx, inv_dy, 1.0 / params.Re, inv_dx * inv_dx, inv_dy * inv_dy,
            float(params.g_x), float(params.g_y))


def _scalars(dt, gamma, device) -> torch.Tensor:
    """(dt, gamma) as a 2-element f32 tensor on `device`, built on the device
    (no host round trip when they are device tensors)."""
    parts = [torch.as_tensor(x, device=device).to(torch.float32).reshape(())
             for x in (dt, gamma)]
    return torch.stack(parts)


def _scalar_arg(x, device):
    """(pointer, value, tensor to keep alive) of dt or gamma for the fused
    kernel: a 0-d f32 tensor on `device` goes by its pointer, as it is (no
    launch, no host round trip); another CUDA tensor by the pointer of its
    f32 copy on `device`; a Python number or a CPU tensor by value, rounded
    to f32 where it meets the kernel's float argument."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        if x.device != device or x.dtype != torch.float32 or x.dim() != 0:
            x = x.to(device=device, dtype=torch.float32).reshape(())
        return x.data_ptr(), 0.0, x
    return None, float(x), None


def momentum_rhs_plain(u, v, dt, gamma, params: Params):
    """The kernel's formulation in plain PyTorch: rolls of the whole padded
    fields, the guarded-domain masks, one tensor operation per step of the
    kernel's arithmetic."""
    inv_dx, inv_dy, inv_re, inv_dx2, inv_dy2, g_x, g_y = \
        kernel_constants(params)
    i_max, j_max = params.i_max, params.j_max
    scal = _scalars(dt, gamma, u.device)
    dt, gamma = scal[0], scal[1]
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    ni, nj = u.shape
    roll = torch.roll

    ii = torch.arange(ni, device=u.device).view(ni, 1)
    jj = torch.arange(nj, device=u.device).view(1, nj)
    j_int = (jj >= 1) & (jj <= j_max)
    i_int = (ii >= 1) & (ii <= i_max)
    f_compute = (ii >= 1) & (ii <= i_max - 1) & j_int
    f_wall = ((ii == 0) | (ii == i_max)) & j_int
    g_compute = (jj >= 1) & (jj <= j_max - 1) & i_int
    g_wall = ((jj == 0) | (jj == j_max)) & i_int
    interior = i_int & j_int

    u_e, u_w = roll(u, -1, 0), roll(u, 1, 0)
    u_n, u_s = roll(u, -1, 1), roll(u, 1, 1)
    v_e, v_w = roll(v, -1, 0), roll(v, 1, 0)
    v_n, v_s = roll(v, -1, 1), roll(v, 1, 1)
    v_se = roll(v_e, 1, 1)   # v[i+1][j-1]
    u_nw = roll(u_w, -1, 1)  # u[i-1][j+1]

    # --- F (u-momentum), integration.c:73-83 -------------------------------
    ae = 0.5 * (u + u_e)
    aw = 0.5 * (u_w + u)
    du2dx = (ae * ae - aw * aw) * inv_dx + gamma * inv_dx * (
        torch.abs(ae) * 0.5 * (u - u_e) - torch.abs(aw) * 0.5 * (u_w - u))
    vn_ = 0.5 * (v + v_e)
    vs_ = 0.5 * (v_s + v_se)
    duvdy = (vn_ * 0.5 * (u + u_n) - vs_ * 0.5 * (u_s + u)) * inv_dy + (
        gamma * inv_dy) * (torch.abs(vn_) * 0.5 * (u - u_n)
                           - torch.abs(vs_) * 0.5 * (u_s - u))
    lap_u = (u_e - 2.0 * u + u_w) * inv_dx2 + (u_n - 2.0 * u + u_s) * inv_dy2
    f_val = u + dt * (inv_re * lap_u - du2dx - duvdy + g_x)

    # --- G (v-momentum), integration.c:85-91 -------------------------------
    an = 0.5 * (v + v_n)
    as_ = 0.5 * (v_s + v)
    dv2dy = (an * an - as_ * as_) * inv_dy + gamma * inv_dy * (
        torch.abs(an) * 0.5 * (v - v_n) - torch.abs(as_) * 0.5 * (v_s - v))
    ue_ = 0.5 * (u + u_n)
    uw_ = 0.5 * (u_w + u_nw)
    duvdx = (ue_ * 0.5 * (v + v_e) - uw_ * 0.5 * (v_w + v)) * inv_dx + (
        gamma * inv_dx) * (torch.abs(ue_) * 0.5 * (v - v_e)
                           - torch.abs(uw_) * 0.5 * (v_w - v))
    lap_v = (v_e - 2.0 * v + v_w) * inv_dx2 + (v_n - 2.0 * v + v_s) * inv_dy2
    g_val = v + dt * (inv_re * lap_v - duvdx - dv2dy + g_y)

    zero = torch.zeros_like(u)
    F = torch.where(f_compute, f_val, torch.where(f_wall, u, zero))
    G = torch.where(g_compute, g_val, torch.where(g_wall, v, zero))

    # --- RHS = div(F, G) / dt (main.c:116-120) -----------------------------
    F_w = roll(F, 1, 0)
    G_s = roll(G, 1, 1)
    rhs = torch.where(interior,
                      ((F - F_w) * inv_dx + (G - G_s) * inv_dy) / dt, zero)
    return F, G, rhs


def check_inputs(u: torch.Tensor, v: torch.Tensor, params: Params) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, x in (("u", u), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"momentum kernel takes float32 {name}, got "
                            f"{x.dtype}")
        if tuple(x.shape) != params.shape:
            raise ValueError(f"momentum kernel takes {name} of the padded "
                             f"shape {params.shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"momentum kernel takes a contiguous {name}")
    if u.device != v.device:
        raise ValueError(f"u on {u.device} but v on {v.device}")


def momentum_rhs(u, v, dt, gamma, params: Params):
    """(F, G, rhs): the plain version for CPU tensors, the fused CUDA kernel
    (one launch) for CUDA tensors.  dt and gamma are Python floats or 0-d
    tensors.  On the card F, G and rhs are views of one allocation."""
    global LAUNCHES
    if u.device.type == "cpu" and v.device.type == "cpu":
        return momentum_rhs_plain(u, v, dt, gamma, params)
    if u.device.type != "cuda":
        raise ValueError(f"no momentum kernel for device {u.device}")
    check_inputs(u, v, params)
    lib = _build.load()
    # The copies _scalar_arg may make stay referenced until the launch.
    dt_p, dt_v, _dt = _scalar_arg(dt, u.device)
    gamma_p, gamma_v, _gamma = _scalar_arg(gamma, u.device)
    ni, nj = params.shape
    out = torch.empty((3, ni, nj), dtype=torch.float32, device=u.device)
    F, G, rhs = out.unbind(0)
    status = lib.nsp_momentum_rhs(
        dt_p, gamma_p, dt_v, gamma_v, u.data_ptr(), v.data_ptr(),
        F.data_ptr(), G.data_ptr(), rhs.data_ptr(), ni, nj, params.i_max,
        params.j_max, *kernel_constants(params),
        *_build.device_and_stream(u))
    _build.check_status(status, "nsp_momentum_rhs")
    LAUNCHES += 1
    return F, G, rhs


def momentum_rhs_simple(u, v, dt, gamma, params: Params):
    """momentum_rhs by its first kernel, two launches (F and G, then rhs
    from F and G in device memory): the yardstick the fused kernel is held
    against on the card, on no path.  CUDA tensors only."""
    if u.device.type != "cuda":
        raise ValueError(f"momentum_rhs_simple runs on a CUDA tensor only, "
                         f"got {u.device}")
    check_inputs(u, v, params)
    lib = _build.load()
    scal = _scalars(dt, gamma, u.device)
    F, G, rhs = (torch.empty_like(u) for _ in range(3))
    ni, nj = params.shape
    status = lib.nsp_momentum_rhs_simple(
        scal.data_ptr(), u.data_ptr(), v.data_ptr(), F.data_ptr(),
        G.data_ptr(), rhs.data_ptr(), ni, nj, params.i_max, params.j_max,
        *kernel_constants(params), *_build.device_and_stream(u))
    _build.check_status(status, "nsp_momentum_rhs_simple")
    return F, G, rhs


def usable(params: Params, device) -> bool:
    """Whether the kernel applies: an f32 state on a CUDA device, as the
    JAX package takes its Pallas kernel for f32 on the TPU."""
    return torch.device(device).type == "cuda" and params.dtype == "float32"
