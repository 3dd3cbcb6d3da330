"""Taylor-Green vortex in a free-slip box (problem 4): the port's copy of
navierstokes_parallel_tpu/models/taylorgreen.py, with numpy and torch.

An exact time-dependent Navier-Stokes solution, so it measures the
solver's whole space-time discretization error against the truth.  With
the phase chosen so that the free-slip box conditions hold on [0, a]^2,

    u(x, y, t) =  sin(k x) cos(k y) exp(-2 k^2 t / Re)
    v(x, y, t) = -cos(k x) sin(k y) exp(-2 k^2 t / Re)
    p(x, y, t) = +(cos(2 k x) + cos(2 k y)) / 4 * exp(-4 k^2 t / Re)

with k = mode * pi / a; the kinetic energy decays as exp(-4 k^2 t / Re).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Params
from ..grid import State, allocate_state, host_array


def taylor_green(n: int = 64, Re: float = 50.0, T: float = 0.3,
                 mode: int = 1, *, device, **overrides
                 ) -> Tuple[Params, State]:
    """Problem 4: the mode-`mode` Taylor-Green vortex in the unit free-slip
    box, sampled on the staggered grid at t = 0, on `device`."""
    defaults = dict(problem=4, i_max=n, j_max=n, a=1.0, b=1.0, T=T, Re=Re,
                    tau=0.5, omega=1.7, epsilon=1e-6, max_it=20000)
    defaults.update(overrides)
    params = Params(**defaults)
    state = allocate_state(params, device)
    u, v, _ = exact_fields(params, 0.0, mode=mode)

    def field(x):
        return torch.tensor(x, dtype=state.u.dtype, device=state.u.device)

    return params, state._replace(u=field(u), v=field(v))


def exact_fields(params: Params, t: float, mode: int = 1
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The exact solution at the staggered nodes, padded shapes (ghosts
    included; the BCs overwrite them): u node (i, j) at (i dx, (j - 1/2)
    dy), v at ((i - 1/2) dx, j dy), p at the cell centres."""
    k = mode * np.pi / params.a
    nu = 1.0 / params.Re
    decay = np.exp(-2.0 * k * k * nu * t)
    nx, ny = params.shape
    dx, dy = params.dx, params.dy
    xe = np.arange(nx) * dx
    xc = (np.arange(nx) - 0.5) * dx
    ye = np.arange(ny) * dy
    yc = (np.arange(ny) - 0.5) * dy
    u = np.sin(k * xe)[:, None] * np.cos(k * yc)[None, :] * decay
    v = -np.cos(k * xc)[:, None] * np.sin(k * ye)[None, :] * decay
    p = 0.25 * (np.cos(2 * k * xc)[:, None]
                + np.cos(2 * k * yc)[None, :]) * decay * decay
    return u, v, p


def errors(state: State, params: Params, mode: int = 1) -> Dict[str, float]:
    """Max-abs interior errors against the exact solution at state.t; the
    pressure mean-removed (the enclosed Neumann problem fixes p only up to
    a constant)."""
    ue, ve, pe = exact_fields(params, float(state.t), mode=mode)
    i, j = params.i_max, params.j_max
    u, v, p = (host_array(x) for x in state[:3])
    u_err = np.abs(u[1:i, 1:-1] - ue[1:i, 1:-1]).max()
    v_err = np.abs(v[1:-1, 1:j] - ve[1:-1, 1:j]).max()
    p_num = p[1:-1, 1:-1]
    p_exa = pe[1:-1, 1:-1]
    p_err = np.abs((p_num - p_num.mean()) - (p_exa - p_exa.mean())).max()
    return {"u": float(u_err), "v": float(v_err), "p": float(p_err)}


def kinetic_energy(state: State, params: Params) -> float:
    """0.5 * integral(u^2 + v^2) through cell-centred averages."""
    u = host_array(state.u)
    v = host_array(state.v)
    uc = 0.5 * (u[:-2, 1:-1] + u[1:-1, 1:-1])
    vc = 0.5 * (v[1:-1, :-2] + v[1:-1, 1:-1])
    return float(0.5 * np.sum(uc * uc + vc * vc) * params.dx * params.dy)


def exact_energy(params: Params, t: float, mode: int = 1) -> float:
    """Exact kinetic energy a^2/4 * exp(-4 k^2 t / Re) (unit amplitude)."""
    k = mode * np.pi / params.a
    return float(0.25 * params.a * params.b
                 * np.exp(-4.0 * k * k * t / params.Re))
