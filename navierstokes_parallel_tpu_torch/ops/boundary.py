"""Velocity boundary conditions: the cavity (problems 1 and 2), the plane
channel (problem 3) and the free-slip box (problem 4).

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/boundary.py``, with
the serial reference semantics (src/serial/boundaries.c:3-39): the wall-
normal velocity is set on the wall edge, the tangential one is reflected
through the wall by ghost-cell averaging (no-slip), copied (free-slip) or
zero-gradient (outflow).

The writes are IN PLACE on ``u`` and ``v`` (no copy of either field per
wall); the functions also return the two tensors for symmetry with the JAX
module.  Callers that must keep their input pass clones (solver.step does).
Every index leads with ``...``: a batch of fields (a leading member axis,
solver.solve_ensemble) takes the same writes, a wall value of one number
per member shaped (B, 1).
"""

from __future__ import annotations

import enum
import functools
from typing import Tuple

import numpy as np
import torch

from . import stencils as st


class Side(enum.Enum):
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"


def set_inflow(u: torch.Tensor, v: torch.Tensor, side: Side, u_fix,
               v_fix) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fix (u_fix, v_fix) velocity on one wall (reference boundaries.c:7-39),
    in place.  ``u_fix``/``v_fix`` are Python floats or 0-d tensors."""
    if side is Side.TOP:
        # wall at y = b: v on edge j_max, u reflected through ghost j_max+1
        v[..., 1:-1, -2] = v_fix
        u[..., 1:-1, -1] = 2.0 * u_fix - u[..., 1:-1, -2]
    elif side is Side.BOTTOM:
        # wall at y = 0: v on edge 0, u reflected through ghost 0
        v[..., 1:-1, 0] = v_fix
        u[..., 1:-1, 0] = 2.0 * u_fix - u[..., 1:-1, 1]
    elif side is Side.LEFT:
        # wall at x = 0: u on edge 0, v reflected through ghost 0
        u[..., 0, 1:-1] = u_fix
        v[..., 0, 1:-1] = 2.0 * v_fix - v[..., 1, 1:-1]
    elif side is Side.RIGHT:
        # wall at x = a: u on edge i_max, v reflected through ghost i_max+1
        u[..., -2, 1:-1] = u_fix
        v[..., -1, 1:-1] = 2.0 * v_fix - v[..., -2, 1:-1]
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def set_noslip(u: torch.Tensor, v: torch.Tensor,
               side: Side) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-slip wall = inflow with zero velocity (reference boundaries.c:3-5)."""
    return set_inflow(u, v, side, 0.0, 0.0)


def set_freeslip(u: torch.Tensor, v: torch.Tensor,
                 side: Side) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-slip wall (Griebel et al. sect. 3.3), in place: zero normal
    velocity on the wall edge, and the tangential ghost copies the first
    interior node (zero normal gradient) instead of negating it."""
    if side is Side.TOP:
        v[..., 1:-1, -2] = 0.0
        u[..., 1:-1, -1] = u[..., 1:-1, -2]
    elif side is Side.BOTTOM:
        v[..., 1:-1, 0] = 0.0
        u[..., 1:-1, 0] = u[..., 1:-1, 1]
    elif side is Side.LEFT:
        u[..., 0, 1:-1] = 0.0
        v[..., 0, 1:-1] = v[..., 1, 1:-1]
    elif side is Side.RIGHT:
        u[..., -2, 1:-1] = 0.0
        v[..., -1, 1:-1] = v[..., -2, 1:-1]
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def apply_cavity_bcs(u, v, lid_u) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-slip left/right/bottom walls + moving lid on top, in place.

    Side order matches the reference driver (main.c:95-104) and is
    LOAD-BEARING: TOP's ghost update reads u[i_max, j_max], which RIGHT
    writes (to 0), so RIGHT must precede TOP.
    """
    set_noslip(u, v, Side.LEFT)
    set_noslip(u, v, Side.RIGHT)
    set_noslip(u, v, Side.BOTTOM)
    set_inflow(u, v, Side.TOP, lid_u, 0.0)
    return u, v


def lid_velocity(problem: int, f: float, t: torch.Tensor):
    """Lid speed for the given problem type (reference main.c:95-108), a 0-d
    tensor of ``t``'s dtype and device."""
    if problem == 1:
        return torch.ones((), dtype=t.dtype, device=t.device)
    elif problem == 2:
        return torch.sin(f * t)
    raise ValueError(f"unknown problem type {problem}")



def apply_freeslip_box(u: torch.Tensor,
                       v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-slip walls on all four sides (problem 4, the Taylor-Green box),
    in place, in the JAX package's side order; here the writes commute."""
    set_freeslip(u, v, Side.LEFT)
    set_freeslip(u, v, Side.RIGHT)
    set_freeslip(u, v, Side.BOTTOM)
    set_freeslip(u, v, Side.TOP)
    return u, v


def set_outflow(u: torch.Tensor, v: torch.Tensor,
                side: Side) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-gradient outflow (Griebel et al. sect. 3.3), in place: the
    wall-normal edge velocity copies its upstream interior neighbour and the
    tangential ghost copies the first interior node."""
    if side is Side.RIGHT:
        u[..., -2, 1:-1] = u[..., -3, 1:-1]
        v[..., -1, 1:-1] = v[..., -2, 1:-1]
    elif side is Side.LEFT:
        u[..., 0, 1:-1] = u[..., 1, 1:-1]
        v[..., 0, 1:-1] = v[..., 1, 1:-1]
    elif side is Side.TOP:
        v[..., 1:-1, -2] = v[..., 1:-1, -3]
        u[..., 1:-1, -1] = u[..., 1:-1, -2]
    elif side is Side.BOTTOM:
        v[..., 1:-1, 0] = v[..., 1:-1, 1]
        u[..., 1:-1, 0] = u[..., 1:-1, 1]
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def poiseuille_profile(params, u_max: float = 1.0) -> np.ndarray:
    """Parabolic channel inflow u(y) = 4 u_max y (b - y) / b^2 at the u-node
    heights y_j = (j - 1/2) dy, j = 1..j_max, in float64 (the JAX package
    forms it in float64 and rounds it to the state's dtype once)."""
    j = np.arange(1, params.j_max + 1)
    y = (j - 0.5) * params.dy
    return 4.0 * u_max * y * (params.b - y) / (params.b * params.b)


@functools.lru_cache(maxsize=8)
def _inflow(params, dtype: torch.dtype, device: torch.device):
    """(the inflow profile as a tensor of the state's dtype on its device,
    the outflow column's fluid rows as a bool tensor or None, their count),
    made once per configuration.  With obstacles the profile is a parabola
    per contiguous fluid span of the inflow column
    (ops/obstacles.py::inflow_profile), and the flux balance runs over the
    fluid rows of the outflow column only (obstacle faces there stay
    no-slip)."""
    if not params.obstacles:
        return (torch.from_numpy(poiseuille_profile(params)).to(
            dtype=dtype, device=device), None, params.j_max)
    from . import obstacles

    out_fluid = obstacles.masks(params).fluid[-2, 1:-1]
    return (torch.from_numpy(obstacles.inflow_profile(params)).to(
        dtype=dtype, device=device), torch.from_numpy(out_fluid).to(device),
        max(1, int(out_fluid.sum())))


def _column_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a wall column: the whole sum for one field, one per member
    (kept as a trailing axis of 1) for a batch."""
    return torch.sum(x) if x.dim() == 1 else torch.sum(x, dim=-1,
                                                        keepdim=True)


def apply_channel_bcs(u: torch.Tensor, v: torch.Tensor,
                      params) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane-channel BCs (problem 3), in place: parabolic inflow on the
    left, zero-gradient outflow on the right, then a uniform correction of
    the outflow edge that pins its flux to the inflow flux (the Poisson rhs
    is compatible only if they balance), then no-slip bottom and top walls,
    whose ghost writes read the corrected outflow edge.  The side order is
    the JAX package's; every read sees what its ``.at[]`` chain sees there.

    q_in and q_out are sums in the state's dtype: PyTorch and XLA add in
    different orders, so the correction agrees with JAX's to rounding, not
    bit for bit.  With obstacles the inflow and the balance follow the
    fluid spans and rows (``_inflow``)."""
    profile, out_fluid, n_out = _inflow(params, u.dtype, u.device)
    set_inflow(u, v, Side.LEFT, profile, 0.0)
    set_outflow(u, v, Side.RIGHT)
    q_in = _column_sum(u[..., 0, 1:-1])
    if out_fluid is None:
        u[..., -2, 1:-1] += st.div(q_in - _column_sum(u[..., -2, 1:-1]),
                                   n_out)
    else:
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        q_out = _column_sum(torch.where(out_fluid, u[..., -2, 1:-1], zero))
        u[..., -2, 1:-1] += torch.where(out_fluid,
                                        st.div(q_in - q_out, n_out), zero)
    set_noslip(u, v, Side.BOTTOM)
    set_noslip(u, v, Side.TOP)
    return u, v
