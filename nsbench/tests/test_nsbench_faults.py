"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU, at 24^2, with the committed cells' limits, and one fault planted in
the program: a step that returns its state unchanged (only t moves on),
half of the grid left out of the pressure update, an answer altered where
it is produced (one velocity of the projection), and the same alteration
in every solve after the first timed one (only the window's check sees
it).  No cell exchanges anything between chips, so that fault has no
place here."""

import pytest

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.grid import State
from navierstokes_parallel_tpu_torch.ops import momentum, sor

from nsbench import harness

CELLS = ["tiny.pallas_sor", "tiny.fft"]


def unchanged_step(state, params, *, pressure_method="rb_sor"):
    u, v, p, t, n = state
    dt, _ = momentum.adaptive_dt_gamma(u, v, params)
    return (State(u=u, v=v, p=p, t=t + dt, n=n + 1),
            solver.StepDiagnostics(dt=dt, sor_iterations=1, sor_res_norm=0.0,
                                   sor_converged=True))


def half_pressure(original):
    def solve(p, rhs, params, **kw):
        result = original(p, rhs, params, **kw)
        out = result.p.clone()
        half = out.shape[0] // 2
        out[half:] = p[half:]
        return result._replace(p=out)
    return solve


def altered_projection(original):
    def project(u, v, F, G, p, dt, params):
        u, v = original(u, v, F, G, p, dt, params)
        u[params.i_max // 2, params.j_max // 2] += 1e-2
        return u, v
    return project


def run(registry, workload):
    result, _ = harness.run_cell(workload, 2 ** 31 + 3, 0.1, False, "cpu",
                                 registry)
    return result


@pytest.mark.parametrize("workload", CELLS)
def test_the_unbroken_run_is_correct(tiny, workload):
    assert run(tiny, workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(tiny, workload,
                                                 monkeypatch):
    monkeypatch.setattr(solver, "step", unchanged_step)
    result = run(tiny, workload)
    assert not result["correct"]
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_grid_left_out_of_the_pressure_update(tiny, workload,
                                                          monkeypatch):
    monkeypatch.setattr(sor, "solve_pressure",
                        half_pressure(sor.solve_pressure))
    assert not run(tiny, workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_it_is_produced(tiny, workload, monkeypatch):
    monkeypatch.setattr(momentum, "project_velocities",
                        altered_projection(momentum.project_velocities))
    assert not run(tiny, workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_solves_after_the_compared_one_that_end_elsewhere(tiny, workload,
                                                          monkeypatch):
    """The untimed solve and the first timed one run as they are; every
    later one is altered: only the window's own check can see it."""
    calls = []
    original_run_steps = solver.run_steps
    original_project = momentum.project_velocities

    def run_steps(*args, **kw):
        calls.append(1)
        if len(calls) > 2:
            momentum.project_velocities = altered_projection(
                original_project)
        try:
            return original_run_steps(*args, **kw)
        finally:
            momentum.project_velocities = original_project

    monkeypatch.setattr(solver, "run_steps", run_steps)
    result = harness.run_cell(workload, 2 ** 31 + 3, 0.3, False, "cpu",
                              tiny)[0]
    assert result["attempted"] >= 2
    checks = result["checks"]
    assert checks["window_mismatch"]["value"] == result["attempted"] - 1
    assert not result["correct"]
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("u_err", "v_err", "p_err", "steps"))
    assert momentum.project_velocities is original_project
