"""An ensemble of lid-driven cavities (problem 1) solved as one batch
through ``solver.EnsembleStepper``, the loop of ``solver.solve_ensemble``.

Each member is the cavity family's seeded state (``families/cavity.py``),
member k of run seed s drawn from seed members * s + k, and the members are
stacked on a leading axis (``solver.stack_states``).  The fields carry that
axis, and each member's own step count ``n`` beside them.  The reference
is ``reference/cavity.py`` on each member alone, with no batching, on a
card one process a member (``reference/members.py``); the readings are
each member's against its own reference, and for each number the worst
member's.  The functions are those that ``families/cavity.py`` lists.
"""

from __future__ import annotations

import math
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, NamedTuple

import torch

from nsbench import compare
from nsbench.families import cavity
from nsbench.reference import cavity as plain, members as one_member

guard = cavity.guard


class Members(NamedTuple):
    """The reference's solves of every member: the fields stacked on the
    member axis, each member's steps, the batch's steps (the most any
    member took) and each member's own result."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor
    steps: int
    results: List[plain.Result]


def member_seeds(cell, seed: int) -> List[int]:
    members = cell.config["assumed"]["members"]
    return [members * seed + k for k in range(members)]


def initial_state(cell, seed: int, device: torch.device):
    """The program's batched State: the cavity family's seeded state of
    each member, stacked."""
    from navierstokes_parallel_tpu_torch import solver

    return solver.stack_states([cavity.initial_state(cell, s, device)
                                for s in member_seeds(cell, seed)])


def warm_up(cell, device: torch.device) -> None:
    """One throw-away batched step of the configuration's members."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.grid import allocate_state

    rest = allocate_state(cell.params, device)
    batch = solver.stack_states([rest] * cell.config["assumed"]["members"])
    solver.EnsembleStepper(cell.params, batch, cell.method).warm()


def stepper(cell, state):
    from navierstokes_parallel_tpu_torch import solver

    return solver.EnsembleStepper(cell.params, state, cell.method)


def fields(state) -> Dict[str, torch.Tensor]:
    return {"u": state.u, "v": state.v, "p": state.p, "n": state.n}


def solve_members(jobs, processes: int) -> List[plain.Result]:
    """``reference/members.py::solve_on`` of each job (its arguments), in
    that many spawned processes, or in this one when `processes` is 0."""
    if not processes:
        return [one_member.solve_on(*job) for job in jobs]
    with ProcessPoolExecutor(
            max_workers=processes,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(one_member.solve_on, *zip(*jobs)))


def reference(cell, state, store=None) -> Members:
    """The reference's solve of each member alone from the program's
    initial fields, as the cavity family runs it; on a card each member in
    a process of its own (up to one a CPU core), results on the host."""
    ref = cell.traffic["reference"]
    device = state.u.device
    jobs = [(str(device), state.u[k].cpu(), state.v[k].cpu(), cell.prm,
             ref["pressure"], ref.get("check_every", 1), store)
            for k in range(state.u.shape[0])]
    processes = (min(len(jobs), os.cpu_count() or 1)
                 if device.type == "cuda" else 0)
    results = solve_members(jobs, processes)

    def stacked(name):
        return torch.stack([getattr(r, name) for r in results])

    steps = [r.steps for r in results]
    return Members(u=stacked("u"), v=stacked("v"), p=stacked("p"),
                   n=torch.tensor(steps), steps=max(steps), results=results)


def readings(fields, steps: int, ref: Members, cell) -> Dict[str, float]:
    """Each member's ``compare.field_errors`` against its own reference
    (its steps its own ``n`` against the reference's), and for each
    number the worst member's; a NaN in any member is kept."""
    per_member: Dict[str, List[float]] = {}
    for k, result in enumerate(ref.results):
        errors = compare.field_errors(
            fields["u"][k], fields["v"][k], fields["p"][k],
            int(fields["n"][k]), result, cell.prm["i_max"],
            cell.prm["j_max"])
        for name, value in errors.items():
            per_member.setdefault(name, []).append(value)
    return {name: (math.nan if any(x != x for x in values) else max(values))
            for name, values in per_member.items()}
