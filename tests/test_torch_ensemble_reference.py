"""The batched ensemble (solver.EnsembleStepper under solver.run_steps)
against the benchmark's plain reference, member by member, on the CPU.

Three seeded members of a 32^2 cavity at Re 1000, 3 steps each (T 0.35,
max_it 2000), by rb_sor at K = 64, run through the functions of the
benchmark's ``ensemble`` family (``nsbench/families/ensemble.py``) in a copy of the
benchmark holding that configuration and a cell with the committed
``ensemble8.rb_sor`` cell's traffic and limits.  Each member is held to
``nsbench/reference/cavity.py`` solving it alone; the reference with its
float32 fields kept in bfloat16 (the precision control) is refused; and a
fault planted in one member's pressure reads not correct, so the family's
readings take the worst member.  Nothing here imports JAX.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from navierstokes_parallel_tpu_torch.ops import sor

from nsbench import calibrate, compare, harness
from nsbench.reference import cavity as plain
from nsbench.registry import Registry

CHECKOUT = Path(__file__).resolve().parents[1]
CELL = "tiny_ensemble.rb_sor"
SOURCE = "ensemble8.rb_sor"
SEEDS = [2 ** 31 + 27, 9]


@pytest.fixture
def cell(tmp_path) -> harness.Cell:
    """The cell of 3 members at 32^2 in a copy of the benchmark."""
    root = tmp_path / "nsbench"
    shutil.copytree(CHECKOUT / "nsbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    config = json.loads(
        (root / "configs/cavity256_re1000_ensemble8.json").read_text())
    config["name"] = "tiny_ensemble"
    config["params"].update(i_max=32, j_max=32, T=0.35, max_it=2000)
    config["assumed"]["members"] = 3
    (root / "configs/tiny_ensemble.json").write_text(json.dumps(config))
    shutil.copy(root / f"limits/{SOURCE}.json", root / f"limits/{CELL}.json")
    bench["configs"].append({"name": "tiny_ensemble", "source": "a test grid",
                             "file": "nsbench/configs/tiny_ensemble.json",
                             "reduced": ["i_max", "j_max", "T", "max_it"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_ensemble",
                               "traffic": "rb_sor", "chips": 1,
                               "why": "CPU tests"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.Cell(Registry(root), CELL)


def program(cell, seed):
    """(initial state, final state, batch steps) of one solve of the
    timed path."""
    state = cell.initial_state(seed, torch.device("cpu"))
    out, steps = harness.Solves(cell, state).run()
    return state, out, steps


def member_errors(cell, state, out, k):
    """Member k's readings against the reference solving it alone."""
    traffic = cell.traffic["reference"]
    ref = plain.solve(state.u[k], state.v[k], cell.prm, traffic["pressure"],
                      traffic["check_every"])
    return compare.field_errors(out.u[k], out.v[k], out.p[k], int(out.n[k]),
                                ref, cell.prm["i_max"], cell.prm["j_max"])


def field_limits(cell):
    return {k: v for k, v in cell.limits.items() if k != "window_mismatch"}


@pytest.mark.parametrize("seed", SEEDS)
def test_each_member_meets_the_cells_limits(cell, seed):
    assert cell.family.__name__.endswith("ensemble")
    state, out, steps = program(cell, seed)
    assert out.u.shape == (3, 34, 34)
    assert out.n.tolist() == [3, 3, 3] and steps == 3
    worst = {}
    for k in range(3):
        errors = member_errors(cell, state, out, k)
        assert compare.verdict(errors, field_limits(cell))[0], (k, errors)
        for name, value in errors.items():
            worst[name] = max(worst.get(name, 0.0), value)
    readings = cell.family.readings(cell.family.fields(out), steps,
                                    cell.reference(state), cell)
    assert readings == pytest.approx(worst, rel=0, abs=0)


def test_the_bfloat16_control_is_refused(cell):
    readings = calibrate.control_readings(cell, SEEDS[0], torch.device("cpu"))
    correct, checks = compare.verdict(readings, field_limits(cell))
    assert not correct, checks


def test_a_fault_in_one_member_reads_not_correct(cell, monkeypatch):
    """Member 1's pressure raised by 1e-2 at one cell after every batched
    solve: the other members stay within the limits, and the readings,
    the worst member's, are not correct."""
    original = sor.solve_pressure_batch

    def raised(p, rhs, params, **kw):
        result = original(p, rhs, params, **kw)
        out = result.p.clone()
        out[1, 16, 16] += 1e-2
        return result._replace(p=out)

    monkeypatch.setattr(sor, "solve_pressure_batch", raised)
    state, out, steps = program(cell, SEEDS[0])
    for k in (0, 2):
        errors = member_errors(cell, state, out, k)
        assert compare.verdict(errors, field_limits(cell))[0], (k, errors)
    assert not compare.verdict(member_errors(cell, state, out, 1),
                               field_limits(cell))[0]
    readings = cell.family.readings(cell.family.fields(out), steps,
                                    cell.reference(state), cell)
    correct, checks = compare.verdict(readings, field_limits(cell))
    assert not correct
    assert checks["p_err"]["value"] > checks["p_err"]["limit"]
