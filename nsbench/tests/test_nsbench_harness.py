"""The harness's pieces on the CPU at 16^2 and 24^2: the seeded state, the
reference, the comparison and the run's result line."""

import json
import subprocess
import sys

import pytest
import torch

from nsbench import compare, harness, run, seed as seeding
from nsbench.reference import cavity

PRM = {"problem": 1, "i_max": 16, "j_max": 16, "a": 1.0, "b": 1.0,
       "T": 0.01, "Re": 1000.0, "g_x": 0.0, "g_y": 0.0, "tau": 1.0,
       "omega": 1.7, "epsilon": 1e-4, "max_it": 200}


def divergence(u, v, prm):
    dx, dy = prm["a"] / prm["i_max"], prm["b"] / prm["j_max"]
    return ((u[1:-1, 1:-1] - u[:-2, 1:-1]) / dx
            + (v[1:-1, 1:-1] - v[1:-1, :-2]) / dy)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 12345678901234, -3])
def test_seeded_state_is_divergence_free_and_reproducible(seed):
    u, v = seeding.initial_velocity(PRM, seed, 0.02, 3, "cpu")
    again_u, again_v = seeding.initial_velocity(PRM, seed, 0.02, 3, "cpu")
    assert torch.equal(u, again_u) and torch.equal(v, again_v)
    assert float(divergence(u, v, PRM).abs().max()) < 1e-13
    assert max(float(u.abs().max()), float(v.abs().max())) == \
        pytest.approx(0.02)
    assert float(u[0, 1:-1].abs().max()) == 0.0       # left wall
    assert float(u[16, 1:-1].abs().max()) < 1e-15     # right wall
    assert float(v[1:-1, 0].abs().max()) == 0.0       # bottom wall
    assert float(v[1:-1, 16].abs().max()) < 1e-15     # lid


def test_seeds_draw_distinct_problems():
    u0, _ = seeding.initial_velocity(PRM, 1, 0.02, 3, "cpu")
    u1, _ = seeding.initial_velocity(PRM, 2, 0.02, 3, "cpu")
    assert float((u0 - u1).abs().max()) > 1e-3


def test_reference_projects_onto_divergence_free_fields():
    u, v = seeding.initial_velocity(PRM, 5, 0.02, 3, "cpu")
    ref = cavity.solve(u, v, PRM, "direct")
    assert ref.steps >= 1 and ref.t >= PRM["T"]
    # The exact pressure solve leaves div(u) at rounding.
    assert float(divergence(ref.u, ref.v, PRM).abs().max()) < 1e-9


def test_reference_sor_converges_to_the_direct_solve():
    prm = dict(PRM, max_it=20000, epsilon=1e-12, T=0.004)
    u, v = seeding.initial_velocity(prm, 5, 0.02, 3, "cpu")
    sor = cavity.solve(u, v, prm, "sor", check_every=50)
    direct = cavity.solve(u, v, prm, "direct")
    errors = compare.field_errors(sor.u, sor.v, sor.p, sor.steps, direct,
                                  16, 16)
    assert errors["steps"] == 0
    assert max(errors["u_err"], errors["v_err"], errors["p_err"]) < 1e-8


def test_reference_sor_stops_at_max_it_checking_every_k():
    prm = dict(PRM, max_it=130, epsilon=1e-14)
    u, v = seeding.initial_velocity(prm, 5, 0.02, 3, "cpu")
    ref = cavity.solve(u, v, prm, "sor", check_every=64)
    assert ref.steps >= 1 and ref.sweeps == ref.steps * 130


def test_comparison_of_equal_fields_reads_zero_and_limits_decide():
    u, v = seeding.initial_velocity(PRM, 5, 0.02, 3, "cpu")
    ref = cavity.solve(u, v, PRM, "direct")
    readings = compare.field_errors(ref.u, ref.v, ref.p + 3.0, ref.steps,
                                    ref, 16, 16)
    assert readings == {"steps": 0.0, "u_err": 0.0, "v_err": 0.0,
                        "p_err": pytest.approx(0.0, abs=1e-13)}
    ok, checks = compare.verdict({"a": 1.0, "b": float("nan")},
                                 {"a": 1.0, "b": 5.0, "c": 1.0})
    assert not ok
    assert checks["a"] == {"value": 1.0, "limit": 1.0}
    assert checks["c"]["value"] is None
    assert compare.verdict({"a": 1.0}, {"a": 1.0})[0]


@pytest.mark.parametrize("traffic", ["pallas_sor", "mg", "fft",
                                     "pallas_sor_k2048"])
def test_program_meets_the_limits_at_24_squared(tiny, traffic):
    result, lines = harness.run_cell(f"tiny.{traffic}", 2 ** 31 + 11, 0.2,
                                     False, "cpu", tiny)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] in (
        0, result["attempted"])
    assert set(result["metrics"]) == {
        m["name"] for m in tiny.metrics_of(f"tiny.{traffic}", "end_to_end")}
    assert ("step_ms_p95" in result["metrics"]) == (
        traffic == "pallas_sor_k2048")
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["count"] == 1
    assert result["checks"]["window_mismatch"]["value"] == 0.0
    assert [line.split()[1] for line in lines] == list(result["checks"])


def test_traced_run_reports_per_layer_metrics_and_breakdown(tiny):
    result, _ = harness.run_cell("tiny.pallas_sor", 5, 0.2, True, "cpu",
                                 tiny)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert result["correct"]
    # The CPU has no device kernels: only the host-span metrics read.
    assert set(result["metrics"]) == {"outer_ms_per_step"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_exits_without_a_card_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", "cavity256.sor", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


def test_run_fails_without_the_program(bench_copy):
    """In a directory with only BENCHMARK.json and the benchmark, a run
    cannot import the program and exits non-zero with no result."""
    code = ("import json, sys; from nsbench.harness import run_cell; "
            "print(json.dumps(run_cell('cavity256.sor', 1, 0.1, False, "
            "'cpu')[0]))")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=bench_copy.parent, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "navierstokes_parallel_tpu_torch" in proc.stderr
    assert not proc.stdout.strip().startswith("{")


def test_step_guard_bounds_the_configured_solves():
    for name, steps in (("cavity256_re1000", 3), ("cavity2048_re1000", 168)):
        config = json.loads(
            (harness.Registry().root / f"configs/{name}.json").read_text())
        assert config["assumed"]["steps_per_solve"] == steps
        assert steps < harness.step_guard(config["params"]) < 20 * steps + 20


@pytest.mark.parametrize("traffic", ["pallas_sor", "fft"])
@pytest.mark.parametrize("seed", [3, 7])
def test_the_cavity_family_is_the_path_it_replaced(tiny, traffic, seed):
    """At 24^2, families/cavity.py's seeded state, reference and readings
    are, bit for bit, those of the calls the harness made before it had
    families."""
    cell = harness.Cell(tiny, f"tiny.{traffic}")
    family = tiny.family("cavity")
    assert cell.family.__file__ == family.__file__
    state = family.initial_state(cell, seed, torch.device("cpu"))
    assumed = cell.config["assumed"]
    u, v = seeding.initial_velocity(cell.prm, seed,
                                    assumed["perturbation_amplitude"],
                                    assumed["perturbation_modes"], "cpu")
    assert state.u.dtype == torch.float32 and state.n == 0
    assert torch.equal(state.u, u.to(torch.float32))
    assert torch.equal(state.v, v.to(torch.float32))
    assert torch.equal(state.p, torch.zeros_like(state.u))
    assert torch.equal(state.t, torch.zeros((), dtype=torch.float32))

    ref = family.reference(cell, state)
    plain = cavity.solve(state.u, state.v, cell.prm,
                         cell.traffic["reference"]["pressure"],
                         cell.traffic["reference"].get("check_every", 1))
    assert (ref.t, ref.steps, ref.sweeps) == (plain.t, plain.steps,
                                              plain.sweeps)
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(ref, name), getattr(plain, name))

    out, steps = harness.Solves(cell, state).run()
    kept = {k: x.to(torch.float64)
            for k, x in family.fields(out).items()}
    assert list(kept) == ["u", "v", "p"]
    assert family.readings(kept, steps, ref, cell) == compare.field_errors(
        out.u, out.v, out.p, steps, plain, 24, 24)
