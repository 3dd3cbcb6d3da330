"""A family for the tests only, copied into a copy of the benchmark as
``families/thermal.py``: Boussinesq convection in the de Vahl Davis cavity
(problem 5) through the port's ``convection.ThermalStepper``, whose state
carries the temperature T beside u, v and p.

It is a plumbing fixture and no benchmark family: its reference is the
port's own float64 run, not a plain reference, so it shows only that the
harness carries a family's own state, fields and readings, never that the
port is right.  It has no precision control (`store` is refused)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from nsbench import compare

# Well above the steps a solve of the fixture's T takes.
GUARD = 64


class Result(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    steps: int


def _convection():
    from navierstokes_parallel_tpu_torch.models import convection

    return convection


def _cfg(params):
    return _convection().config_from_params(params)


def initial_state(cell, seed: int, device: torch.device):
    """The conduction state with the interior temperature perturbed by
    uniform noise drawn from the seed."""
    state = _convection().allocate_thermal(cell.params, _cfg(cell.params),
                                           device)
    gen = torch.Generator().manual_seed(seed % 2 ** 63)
    noise = torch.rand(state.T[1:-1, 1:-1].shape, generator=gen,
                       dtype=torch.float64) - 0.5
    T = state.T.clone()
    T[1:-1, 1:-1] += (cell.config["assumed"]["perturbation_amplitude"]
                      * noise).to(device=device, dtype=T.dtype)
    return state._replace(T=T)


def warm_up(cell, device: torch.device) -> None:
    _convection().warm_up(cell.params, _cfg(cell.params), device,
                          cell.method)


def stepper(cell, state):
    return _convection().ThermalStepper(cell.params, _cfg(cell.params),
                                        state, cell.method)


def guard(prm: Dict) -> int:
    return GUARD


def fields(state) -> Dict[str, torch.Tensor]:
    return {"u": state.u, "v": state.v, "p": state.p, "T": state.T}


def reference(cell, state, store=None):
    """The port's own run in float64 from the same initial fields."""
    from navierstokes_parallel_tpu_torch import solver

    if store is not None:
        raise ValueError("the thermal fixture has no precision control")
    params = cell.params.replace(dtype="float64")
    start = state._replace(**{name: getattr(state, name).to(torch.float64)
                              for name in ("u", "v", "p", "T", "t")})
    run = _convection().ThermalStepper(params, _cfg(params), start,
                                       cell.method)
    steps = solver.run_steps(run, params, max_steps=GUARD).steps
    out = run.state()
    return Result(u=out.u, v=out.v, p=out.p, T=out.T, steps=steps)


def readings(fields, steps: int, ref, cell) -> Dict[str, float]:
    out = compare.field_errors(fields["u"], fields["v"], fields["p"], steps,
                               ref, cell.prm["i_max"], cell.prm["j_max"])
    T, ref_T = fields["T"][1:-1, 1:-1], ref.T[1:-1, 1:-1]
    out["T_err"] = float((T - ref_T).abs().max() / ref_T.abs().max())
    return out
