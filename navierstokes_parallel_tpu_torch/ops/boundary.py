"""Velocity boundary conditions of the cavity problems (1 and 2).

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/boundary.py``, with
the serial reference semantics (src/serial/boundaries.c:3-39): the wall-
normal velocity is set on the wall edge, the tangential one is reflected
through the wall by ghost-cell averaging.

The writes are IN PLACE on ``u`` and ``v`` (no copy of either field per
wall); the functions also return the two tensors for symmetry with the JAX
module.  Callers that must keep their input pass clones (solver.step does).
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch


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
        v[1:-1, -2] = v_fix
        u[1:-1, -1] = 2.0 * u_fix - u[1:-1, -2]
    elif side is Side.BOTTOM:
        # wall at y = 0: v on edge 0, u reflected through ghost 0
        v[1:-1, 0] = v_fix
        u[1:-1, 0] = 2.0 * u_fix - u[1:-1, 1]
    elif side is Side.LEFT:
        # wall at x = 0: u on edge 0, v reflected through ghost 0
        u[0, 1:-1] = u_fix
        v[0, 1:-1] = 2.0 * v_fix - v[1, 1:-1]
    elif side is Side.RIGHT:
        # wall at x = a: u on edge i_max, v reflected through ghost i_max+1
        u[-2, 1:-1] = u_fix
        v[-1, 1:-1] = 2.0 * v_fix - v[-2, 1:-1]
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def set_noslip(u: torch.Tensor, v: torch.Tensor,
               side: Side) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-slip wall = inflow with zero velocity (reference boundaries.c:3-5)."""
    return set_inflow(u, v, side, 0.0, 0.0)


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

