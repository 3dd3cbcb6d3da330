"""The comparison that decides `correct`: the fields the timed solves
produced against the reference's, each number beside its limit.

    steps        |steps - reference steps|                        (exact)
    u_err        max |u - u_ref| / max |u_ref| over u's unknowns
    v_err        the same for v
    p_err        the same for p - mean(p) over the interior: the cavity's
                 pressure is defined up to a constant, whose drift under
                 the rounding of an almost compatible rhs is no error
    window_mismatch  timed solves whose fields or step count differ from
                 the compared one (exact)

u's unknowns are the interior faces i = 1 .. i_max - 1, j = 1 .. j_max;
v's i = 1 .. i_max, j = 1 .. j_max - 1; p's the interior cells.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.to(torch.float64), ref.to(torch.float64)
    scale = float(ref.abs().max())
    return float((x - ref).abs().max()) / scale if scale > 0 else float(
        (x - ref).abs().max())


def field_errors(u, v, p, steps: int, ref, i_max: int,
                 j_max: int) -> Dict[str, float]:
    """The readings of one solve's fields against the reference's."""
    ref_p = ref.p[1:-1, 1:-1].to(torch.float64)
    own_p = p[1:-1, 1:-1].to(device=ref_p.device, dtype=torch.float64)
    dev = ref.u.device
    return {
        "steps": float(abs(steps - ref.steps)),
        "u_err": _rel(u[1:i_max, 1:j_max + 1].to(dev),
                      ref.u[1:i_max, 1:j_max + 1]),
        "v_err": _rel(v[1:i_max + 1, 1:j_max].to(dev),
                      ref.v[1:i_max + 1, 1:j_max]),
        "p_err": _rel(own_p - own_p.mean(), ref_p - ref_p.mean()),
    }


def verdict(readings: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, checks): every limited number at or under its limit; a
    reading that is missing or NaN fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value == value and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
