"""Backward-facing step (problem 3 + flag-field obstacle): the port's copy
of navierstokes_parallel_tpu/models/step.py.  The classic
sudden-expansion benchmark (Griebel et al. 1998 sect. 9.3; Armaly et al.
1983).  No reference analogue: the reference ships only the enclosed
cavity problems.

Geometry: an a x b channel whose lower half is blocked for the first
`step_frac` of its length.  The obstacle-aware channel BCs
(ops/boundary.py + ops/obstacles.py) then give the parabolic inflow over
the OPEN upper half automatically, and the flow expands over the step,
forming the recirculation bubble whose reattachment length grows with Re —
`reattachment_length` extracts it from the bottom-wall shear sign.

The JAX package's tests/test_obstacles.py validates the physics (flux
conservation, the recirculation bubble, x_r growing with Re); the port's
tests hold this module to that one.
"""

from __future__ import annotations

import numpy as np

from ..config import Params
from ..grid import host_array


def backward_facing_step(Re: float = 100.0, nx: int = 64, ny: int = 16,
                         a: float = 4.0, b: float = 1.0,
                         step_frac: float = 0.25, T: float = 8.0,
                         **overrides) -> Params:
    """Expansion-ratio-2 backward-facing step: lower half blocked for
    x < step_frac * a."""
    i_step = max(2, int(round(step_frac * nx)))
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T, Re=Re,
                    tau=0.5, omega=1.7, epsilon=1e-4, max_it=20000,
                    obstacles=((1, i_step, 1, ny // 2),))
    defaults.update(overrides)
    return Params(**defaults)


def reattachment_length(u_field, params: Params) -> float:
    """Distance from the step face to the point where the bottom-wall
    shear turns positive again (u at the first interior row changes sign
    from the recirculating backflow to forward flow), in units of the step
    height h = b/2.  `u_field` is a tensor on any device or an array."""
    (_, i_step, _, j_half) = params.obstacles[0]
    u = host_array(u_field)
    row = u[i_step + 1 : params.i_max, 1]    # first row above the bottom wall
    neg = row < 0.0
    if not neg.any():
        return 0.0
    last_neg = int(np.flatnonzero(neg)[-1])
    h = (j_half * params.dy)                  # step height
    return (last_neg + 1) * params.dx / h
