"""Runtime numerical guards (counterpart of
navierstokes_parallel_tpu/utils/checks.py)."""

from __future__ import annotations

import torch

from ..grid import State


class NonFiniteStateError(RuntimeError):
    pass


def validate_state(state: State, where: str = "") -> State:
    """Host-side guard: raise if u, v or p contains NaN/Inf."""
    for name in ("u", "v", "p"):
        finite = torch.isfinite(getattr(state, name))
        if not bool(finite.all()):
            bad = int((~finite).sum())
            raise NonFiniteStateError(
                f"{bad} non-finite values in {name}"
                f"{' at ' + where if where else ''} (t={float(state.t):.6f}); "
                f"likely CFL blowup — lower tau or refine the grid"
            )
    return state
