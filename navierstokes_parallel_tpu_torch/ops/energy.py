"""Energy (temperature) transport for Boussinesq thermal flows.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/energy.py``
(Griebel et al. 1998 ch. 9): a cell-centred temperature T (ghost ring
included, like p), advected with the gamma-weighted donor-cell scheme of
the momentum stencils and diffused with alpha = 1/(Re Pr), feeding back
into the tentative velocities as a Boussinesq buoyancy on the staggered
faces:

  d(uT)/dx|_ij = [u_ij (T_ij+T_i+1,j)/2 - u_i-1,j (T_i-1,j+T_ij)/2] / dx
       + gamma [|u_ij| (T_ij-T_i+1,j)/2 - |u_i-1,j| (T_i-1,j-T_ij)/2] / dx

(the y-term mirrors it).  The operation order is the JAX module's; every
division by a host scalar goes through ``stencils.div`` (on CUDA a
division by a Python number is a reciprocal multiply).  The obstacle
tables are numpy, built once per ``Params`` and moved to a device once per
(params, dtype, device), as in ops/obstacles.py.  Plain PyTorch on every
device: the JAX module is jnp, with no Pallas kernel behind it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import Params
from . import stencils as st
from .stencils import div


def duT_dx(u, T, dx, gamma):
    """d(uT)/dx at cell centres (interior shape)."""
    T_c = st.shifted(T, 0, 0)
    T_e = st.shifted(T, 1, 0)
    T_w = st.shifted(T, -1, 0)
    u_c = st.shifted(u, 0, 0)
    u_w = st.shifted(u, -1, 0)
    flux = div(u_c * (T_c + T_e), 2.0) - div(u_w * (T_w + T_c), 2.0)
    don = (div(st.upwind_abs(u_c) * (T_c - T_e), 2.0)
           - div(st.upwind_abs(u_w) * (T_w - T_c), 2.0))
    return div(flux + gamma * don, dx)


def dvT_dy(v, T, dy, gamma):
    """d(vT)/dy at cell centres (interior shape)."""
    T_c = st.shifted(T, 0, 0)
    T_n = st.shifted(T, 0, 1)
    T_s = st.shifted(T, 0, -1)
    v_c = st.shifted(v, 0, 0)
    v_s = st.shifted(v, 0, -1)
    flux = div(v_c * (T_c + T_n), 2.0) - div(v_s * (T_s + T_c), 2.0)
    don = (div(st.upwind_abs(v_c) * (T_c - T_n), 2.0)
           - div(st.upwind_abs(v_s) * (T_s - T_c), 2.0))
    return div(flux + gamma * don, dy)


def advance_temperature(T, u, v, dt, gamma, params: Params,
                        alpha: float) -> torch.Tensor:
    """Explicit energy step T + dt (alpha lap(T) - (uT)_x - (vT)_y), a new
    tensor.  `alpha` is the dimensionless diffusivity 1/(Re Pr).  The
    caller applies the T BCs before and after (the stencils read the
    ghosts)."""
    lap = st.d2_dx2(T, params.dx) + st.d2_dy2(T, params.dy)
    adv = duT_dx(u, T, params.dx, gamma) + dvT_dy(v, T, params.dy, gamma)
    out = T.clone()
    out[1:-1, 1:-1] += dt * (alpha * lap - adv)
    return out


def _static_zero(c) -> bool:
    """A coefficient that is a Python zero (a tensor always takes the add,
    as a traced scalar does in the JAX module)."""
    return isinstance(c, (int, float)) and c == 0.0


def buoyant_fg(F, G, T, dt, beta_gx: float, beta_gy: float):
    """(F, G) with the Boussinesq buoyancy of the face-averaged temperature:
    F -= dt beta_gx (T_ij + T_i+1,j)/2 on F's live entries (i in
    [1, i_max-1]), G likewise on j in [1, j_max-1]; a statically zero
    coefficient adds nothing.  New tensors where a term is added.  With
    beta_g = beta g, a negative beta_gy (gravity down) makes hot fluid
    rise."""
    if not _static_zero(beta_gx):
        T_face_x = div(st.shifted(T, 0, 0) + st.shifted(T, 1, 0), 2.0)
        F = F.clone()
        F[1:-2, 1:-1] += -dt * beta_gx * T_face_x[:-1, :]
    if not _static_zero(beta_gy):
        T_face_y = div(st.shifted(T, 0, 0) + st.shifted(T, 0, 1), 2.0)
        G = G.clone()
        G[1:-1, 1:-2] += -dt * beta_gy * T_face_y[:, :-1]
    return F, G


def apply_temperature_bcs(T, params: Params, t_left: float,
                          t_right: float) -> torch.Tensor:
    """Differentially heated cavity T BCs, IN PLACE (returns T): Dirichlet
    left/right walls by ghost reflection (the wall value is the
    ghost/interior mean), adiabatic (homogeneous Neumann) top/bottom."""
    T[0, 1:-1] = 2.0 * t_left - T[1, 1:-1]
    T[-1, 1:-1] = 2.0 * t_right - T[-2, 1:-1]
    T[1:-1, 0] = T[1:-1, 1]
    T[1:-1, -1] = T[1:-1, -2]
    return T


def apply_temperature_bcs_rb(T, params: Params, t_bottom: float,
                             t_top: float) -> torch.Tensor:
    """Rayleigh-Benard T BCs, IN PLACE (returns T): the 90-degree rotation
    of ``apply_temperature_bcs``: conducting bottom/top plates, adiabatic
    sidewalls."""
    T[1:-1, 0] = 2.0 * t_bottom - T[1:-1, 1]
    T[1:-1, -1] = 2.0 * t_top - T[1:-1, -2]
    T[0, 1:-1] = T[1, 1:-1]
    T[-1, 1:-1] = T[-2, 1:-1]
    return T


_NEIGHBOURS = ((1, 0), (-1, 0), (0, 1), (0, -1))


@functools.lru_cache(maxsize=32)
def _obstacle_tables(params: Params):
    """(fluid, neighbour count, boundary solid, deep solid): padded numpy
    tables of the obstacle cells (the JAX module's construction)."""
    from .obstacles import fluid_mask

    fl = fluid_mask(params)
    interior = np.zeros_like(fl)
    interior[1:-1, 1:-1] = True
    solid = interior & ~fl
    nb_cnt = np.zeros(fl.shape, np.int32)
    for di, dj in _NEIGHBOURS:
        nb_cnt[1:-1, 1:-1] += fl[1 + di:fl.shape[0] - 1 + di,
                                 1 + dj:fl.shape[1] - 1 + dj]
    return fl, nb_cnt, solid & (nb_cnt > 0), solid & (nb_cnt == 0)


@functools.lru_cache(maxsize=32)
def _device_obstacle_tables(params: Params, dtype: torch.dtype,
                            device: torch.device):
    """``_obstacle_tables`` on `device`: the fluid mask in `dtype`, the
    divisor max(count, 1) in `dtype`, and the two solid masks."""
    fl, nb_cnt, boundary_solid, deep_solid = _obstacle_tables(params)

    def tensor(a, dt=None):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return (tensor(fl, dtype), tensor(np.maximum(nb_cnt, 1), dtype),
            tensor(boundary_solid), tensor(deep_solid))


def apply_obstacle_temperature_bcs(T, params: Params,
                                   t_obstacle=None) -> torch.Tensor:
    """The temperature of the interior obstacle cells (Griebel ch. 9): a
    solid cell with a fluid 4-neighbour is a T ghost for its neighbours'
    stencils.  `t_obstacle` None: an adiabatic block, the solid cell takes
    the mean of its fluid neighbours' T; a float: an isothermal block, it
    takes 2 t_obstacle minus that mean (the face average is t_obstacle),
    and solid cells without a fluid neighbour hold t_obstacle (a float, or
    a 0-d tensor of T's dtype that may carry a gradient).  Returns a new
    tensor (T itself without obstacles)."""
    if not params.obstacles:
        return T
    flj, count, boundary_solid, deep_solid = _device_obstacle_tables(
        params, T.dtype, T.device)
    masked_T = T * flj
    nb_sum = torch.zeros_like(T)
    for di, dj in _NEIGHBOURS:
        nb_sum = nb_sum + torch.roll(masked_T, (-di, -dj), (0, 1))
    mean_nb = nb_sum / count
    if t_obstacle is None:
        return torch.where(boundary_solid, mean_nb, T)
    T = torch.where(boundary_solid, 2.0 * t_obstacle - mean_nb, T)
    if not isinstance(t_obstacle, torch.Tensor):
        t_obstacle = st.scalar(float(t_obstacle), T.dtype, T.device)
    return torch.where(deep_solid, t_obstacle, T)


def thermal_dt_limit(params: Params, alpha):
    """The explicit-diffusion bound of the energy equation, dt <= 1/(2
    alpha) / (1/dx^2 + 1/dy^2), the thermal twin of the viscous limit of
    ``momentum.adaptive_dt_gamma`` (main.c:89-92); a Python float for a
    float `alpha`, as in the JAX module, and a 0-d tensor of `alpha`'s
    dtype for a tensor (the differentiable path, diff.py), its divisions
    true ones on every device."""
    dx, dy = params.dx, params.dy
    d2 = 1.0 / (dx * dx) + 1.0 / (dy * dy)
    if isinstance(alpha, torch.Tensor):
        return div(torch.ones_like(alpha) / (2.0 * alpha), d2)
    return 1.0 / (2.0 * alpha) / d2
