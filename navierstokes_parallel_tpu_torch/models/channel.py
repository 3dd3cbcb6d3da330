"""Plane Poiseuille channel (problem 3): the port's copy of
navierstokes_parallel_tpu/models/channel.py, with numpy and torch.

Parabolic inflow on the left, flux-balanced zero-gradient outflow on the
right and no-slip walls (ops/boundary.py::apply_channel_bcs).  The developed
steady solution

    u(y) = 4 u_max y (b - y) / b^2,   v = 0,   dp/dx = -8 u_max / (Re b^2)

is a fixed point of the discrete step up to the pressure solve's tolerance
(both donor-cell stencils vanish for v = 0 and u uniform in x, and the
second difference of a quadratic is exact), so a drift from it measures the
solver, not the discretization.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Params
from ..grid import State, allocate_state, host_array


def plane_channel(Re: float = 10.0, nx: int = 64, ny: int = 32,
                  a: float = 2.0, b: float = 1.0, T: float = 1.0,
                  **overrides) -> Params:
    """Problem 3: unit-peak parabolic inflow through an a x b channel."""
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T, Re=Re,
                    tau=0.5, omega=1.7, epsilon=1e-4, max_it=20000)
    defaults.update(overrides)
    return Params(**defaults)


def analytic_u(params: Params, u_max: float = 1.0) -> np.ndarray:
    """Exact developed profile at the u-node heights y_j = (j - 1/2) dy."""
    y = (np.arange(1, params.j_max + 1) - 0.5) * params.dy
    return 4.0 * u_max * y * (params.b - y) / (params.b * params.b)


def analytic_dpdx(params: Params, u_max: float = 1.0) -> float:
    """Exact developed streamwise pressure gradient -8 u_max / (Re b^2)."""
    return -8.0 * u_max / (params.Re * params.b * params.b)


def developed_state(params: Params, device, u_max: float = 1.0) -> State:
    """The state AT the analytic fixed point on `device`: u parabolic
    everywhere, its ghost rows the no-slip wall reflection, v = 0, p = 0
    (the first pressure solve recovers the linear dp/dx field)."""
    state = allocate_state(params, device)
    u = np.zeros(params.shape, np.float64)
    u[:, 1:-1] = analytic_u(params, u_max)[None, :]
    u[:, 0] = -u[:, 1]
    u[:, -1] = -u[:, -2]
    return state._replace(u=torch.tensor(u, dtype=state.u.dtype,
                                         device=state.u.device))


def profile_errors(u_field, params: Params,
                   u_max: float = 1.0) -> Tuple[float, float]:
    """(max abs error at the outflow-adjacent column, max abs error at the
    mid-channel column) of u (a tensor on any device, or an array) against
    the analytic profile."""
    exact = analytic_u(params, u_max)
    u_np = host_array(u_field)
    err_mid = float(np.max(np.abs(u_np[params.i_max // 2, 1:-1] - exact)))
    err_out = float(np.max(np.abs(u_np[params.i_max - 1, 1:-1] - exact)))
    return err_out, err_mid
