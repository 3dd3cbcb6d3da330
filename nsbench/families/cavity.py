"""The lid-driven cavity (problem 1) through ``solver.Stepper``: the family
of every configuration that names none.

A family is a module ``families/<name>.py`` that a configuration names
under its top-level key ``"family"``.  It holds everything the harness
does in one kind of problem's own terms; ``harness.Cell``, ``Solves``,
``run_cell`` and ``calibrate.py`` call only these functions:

    initial_state(cell, seed, device)   the program's seeded state
    warm_up(cell, device)               builds and warms the stepper's route
    stepper(cell, state)                a host-loop stepper from `state`
                                        (``step()``, ``t``, ``state()``),
                                        driven by ``solver.run_steps``
    guard(prm)                          the most steps a solve may take
    fields(state)                       the fields by which solves are kept
                                        and compared, by name and in order,
                                        of the program's state or of the
                                        reference's result
    reference(cell, state, store=None)  the plain reference's solve from the
                                        program's initial fields: a result
                                        with ``steps`` and the fields;
                                        `store` rounds what it keeps (the
                                        precision control)
    readings(fields, steps, ref, cell)  the numbers that `correct` compares
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from nsbench import compare, seed as seeding
from nsbench.reference import cavity


def initial_state(cell, seed: int, device: torch.device):
    """The program's seeded State (float32 fields, p = 0, t = 0)."""
    from navierstokes_parallel_tpu_torch.grid import State

    assumed = cell.config["assumed"]
    u, v = seeding.initial_velocity(
        cell.prm, seed, assumed["perturbation_amplitude"],
        assumed["perturbation_modes"], device)
    dtype = cell.params.torch_dtype
    u, v = u.to(dtype), v.to(dtype)
    return State(u=u, v=v, p=torch.zeros_like(u),
                 t=torch.zeros((), dtype=dtype, device=device), n=0)


def warm_up(cell, device: torch.device) -> None:
    from navierstokes_parallel_tpu_torch import solver

    solver.warm_up(cell.params, device, cell.method)


def stepper(cell, state):
    from navierstokes_parallel_tpu_torch import solver

    return solver.Stepper(cell.params, state, cell.method)


def guard(prm: Dict) -> int:
    """The most steps a solve may take: four times what it would take at
    the smaller of the viscous bound and a step at twice the lid speed."""
    dx, dy = prm["a"] / prm["i_max"], prm["b"] / prm["j_max"]
    visc = prm["Re"] / 2.0 / (1.0 / dx ** 2 + 1.0 / dy ** 2)
    dt = prm["tau"] * min(visc, min(dx, dy) / 2.0)
    return 4 * math.ceil(prm["T"] / dt) + 16


def fields(state) -> Dict[str, torch.Tensor]:
    return {"u": state.u, "v": state.v, "p": state.p}


def reference(cell, state, store=None):
    """The reference's solve from the program's initial fields."""
    ref = cell.traffic["reference"]
    return cavity.solve(state.u, state.v, cell.prm, ref["pressure"],
                        ref.get("check_every", 1), store=store)


def readings(fields, steps: int, ref, cell) -> Dict[str, float]:
    return compare.field_errors(fields["u"], fields["v"], fields["p"],
                                steps, ref, cell.prm["i_max"],
                                cell.prm["j_max"])
