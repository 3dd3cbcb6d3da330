"""Flow past a cylinder in a channel (problem 3 with a registered circle,
the Schäfer-Turek 2D-2 geometry of ``models/karman.py``) through
``solver.Stepper``, timed from a flow that set-up spins up.

The impulsive start costs the program thousands of V-cycles a step for its
first steps and about ten a step once the flow has developed, so set-up
steps ``karman.initial_state`` (its kick behind the cylinder drawn from the
seed) to the configuration's ``spin_up_T`` by the plain reference, whose
exact pressure solve costs the same at every step; each timed solve then
steps that one state, its t, n and p (a warm start) carried, to T.  The
state both sides start from is thus none of the program's solves.  The
functions are those that ``families/cavity.py`` lists.
"""

from __future__ import annotations

from typing import Dict

import torch

from nsbench import seed as seeding
from nsbench.families import cavity
from nsbench.reference import schaefer_turek as plain

warm_up = cavity.warm_up
stepper = cavity.stepper
guard = cavity.guard
fields = cavity.fields


def kick(cell, seed: int) -> float:
    """The size of the cross-stream kick behind the cylinder, uniform in
    the configuration's [kick_low, kick_high], drawn from the seed."""
    assumed = cell.config["assumed"]
    return float(seeding._rng(seed).uniform(assumed["kick_low"],
                                            assumed["kick_high"]))


def initial_state(cell, seed: int, device: torch.device):
    """The program's State at t >= spin_up_T: the impulsive start with the
    seeded kick, stepped by the plain reference."""
    from navierstokes_parallel_tpu_torch.models import karman

    start = karman.initial_state(cell.params, perturb=kick(cell, seed),
                                 device=device)
    spun = plain.solve(start.u, start.v, float(start.t),
                       {**cell.prm, "T": cell.config["assumed"]["spin_up_T"]})
    return program_state(start, spun)


def program_state(start, result):
    """The reference's `result` as the program's State, in `start`'s dtype
    and on its device."""
    dtype = start.u.dtype
    return start._replace(u=result.u.to(dtype), v=result.v.to(dtype),
                          p=result.p.to(dtype),
                          t=torch.tensor(result.t, dtype=start.t.dtype,
                                         device=start.t.device),
                          n=start.n + result.steps)


def reference(cell, state, store=None):
    """The reference's solve from the program's state to T."""
    return plain.solve(state.u, state.v, float(state.t), cell.prm,
                       store=store)


def _rel(x, ref, mask) -> float:
    x, ref = x[mask].to(torch.float64), ref[mask].to(torch.float64)
    scale = float(ref.abs().max())
    err = float((x - ref).abs().max())
    return err / scale if scale > 0 else err


def readings(fields, steps: int, ref, cell) -> Dict[str, float]:
    """u_err, v_err: max |x - x_ref| / max |x_ref| over the faces between
    two fluid cells; p_err the same over the fluid cells, each p less its
    fluid mean; steps exact."""
    fl = plain.fluid_of(cell.prm, ref.u.device)
    i_max, j_max = cell.prm["i_max"], cell.prm["j_max"]
    u_faces = torch.zeros_like(fl)
    u_faces[1:i_max, 1:-1] = fl[1:i_max, 1:-1] & fl[2:i_max + 1, 1:-1]
    v_faces = torch.zeros_like(fl)
    v_faces[1:-1, 1:j_max] = fl[1:-1, 1:j_max] & fl[1:-1, 2:j_max + 1]
    dev = ref.u.device
    p = fields["p"].to(device=dev, dtype=torch.float64)
    p = p - p[fl].mean()
    ref_p = ref.p - ref.p[fl].mean()
    return {
        "steps": float(abs(steps - ref.steps)),
        "u_err": _rel(fields["u"].to(dev), ref.u, u_faces),
        "v_err": _rel(fields["v"].to(dev), ref.v, v_faces),
        "p_err": _rel(p, ref_p, fl),
    }
