"""Runtime numerical guards (counterpart of
navierstokes_parallel_tpu/utils/checks.py).

JAX's ``enable_nan_debugging`` turns on ``jax_debug_nans``, which faults at
the first NaN-producing operation.  PyTorch has no forward counterpart
(``torch.autograd.set_detect_anomaly`` covers the backward pass only), so
the port's ``--debug-nans`` checks the state after every step instead
(``check_step``): it names the first step whose state is not finite, not
the operation.
"""

from __future__ import annotations

import torch

from ..grid import State
from ..ops.stencils import div


class NonFiniteStateError(RuntimeError):
    pass


def _fields(state) -> tuple:
    """The checked fields: u, v, p, and T of a thermal state (a
    free-surface view's grid fields are u, v, p; its particles are not
    checked, as in the JAX package)."""
    return ("u", "v", "p") + (("T",) if hasattr(state, "T") else ())


def validate_state(state: State, where: str = "") -> State:
    """Host-side guard: raise if u, v, p (or a thermal state's T) contains
    NaN/Inf."""
    for name in _fields(state):
        finite = torch.isfinite(getattr(state, name))
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise NonFiniteStateError(
                f"{bad} non-finite values in {name}"
                f"{' at ' + where if where else ''} (t={float(state.t):.6f}); "
                f"likely CFL blowup — lower tau or refine the grid"
            )
    return state


def check_step(state: State, step: int) -> State:
    """Raise NonFiniteStateError naming `step` if u, v, p (or T) holds a
    NaN or Inf (one host read for the fields)."""
    finite = torch.stack([torch.isfinite(getattr(state, name)).all()
                          for name in _fields(state)])
    if not bool(finite.all()):
        validate_state(state, where=f"step {step}")
    return state


def divergence_norm(u: torch.Tensor, v: torch.Tensor, params) -> float:
    """L2 norm of the discrete velocity divergence over the interior.

    The projection step drives this to ~0 (incompressibility); its residual
    is bounded by the pressure solve's stopping tolerance times dt."""
    d = (div(u[1:-1, 1:-1] - u[:-2, 1:-1], params.dx)
         + div(v[1:-1, 1:-1] - v[1:-1, :-2], params.dy))
    return float(torch.sqrt(div(torch.sum(d * d),
                                params.i_max * params.j_max)))


def cfl_report(u: torch.Tensor, v: torch.Tensor, params) -> dict:
    """The current CFL numbers: how close the state is to the stability
    limits of the adaptive time step."""
    u_max = float(torch.max(torch.abs(u[1:-1, 1:-1])))
    v_max = float(torch.max(torch.abs(v[1:-1, 1:-1])))
    visc = params.Re / 2.0 / (1.0 / params.dx**2 + 1.0 / params.dy**2)
    return {
        "u_max": u_max,
        "v_max": v_max,
        "dt_viscous_limit": visc,
        "dt_convective_x": params.dx / u_max if u_max else float("inf"),
        "dt_convective_y": params.dy / v_max if v_max else float("inf"),
    }
