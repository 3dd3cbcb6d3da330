"""The ``ensemble`` family as new files alone, on the CPU: a copy of the
committed ensemble configuration cut to 3 members of a 32^2 cavity, 3
steps (T 0.35, max_it 2000), with the committed cell's traffic and limits; its readers
on a batched trace; and on the card (``-m gpu``) the committed cell itself,
traced, and its precision control."""

import hashlib
import json
import shutil

import pytest
import torch

from nsbench import calibrate, compare, harness
from nsbench.registry import Registry

CELL = "tiny_ensemble.rb_sor"
SOURCE = "ensemble8.rb_sor"
CONFIG = "cavity256_re1000_ensemble8"
METRICS = {"ensemble_sweep_roofline", "ensemble_outer_ms_per_step",
           "ensemble_kernels_per_member_step"}


def digests(root):
    return {p.relative_to(root.parent): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def add_ensemble(root) -> Registry:
    """Adds, as new files and entries only, the tiny ensemble's
    configuration, its cell and the committed cell's limits."""
    config = json.loads((root / f"configs/{CONFIG}.json").read_text())
    config["name"] = "tiny_ensemble"
    config["params"].update(i_max=32, j_max=32, T=0.35, max_it=2000)
    config["assumed"]["members"] = 3
    (root / "configs/tiny_ensemble.json").write_text(json.dumps(config))
    shutil.copy(root / f"limits/{SOURCE}.json", root / f"limits/{CELL}.json")
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny_ensemble",
                             "source": "a test grid",
                             "file": f"{root.name}/configs/tiny_ensemble.json",
                             "reduced": ["i_max", "j_max", "T", "max_it"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_ensemble",
                               "traffic": "rb_sor", "chips": 1,
                               "why": "CPU tests"})
    for metric in bench["per_layer"]:
        if SOURCE in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    bench_path.write_text(json.dumps(bench))
    return Registry(root)


def test_the_family_is_found_without_an_edit(bench_copy):
    before = digests(bench_copy)
    registry = add_ensemble(bench_copy)
    after = digests(bench_copy)
    assert all(after[path] == digest for path, digest in before.items()
               if path.name != "BENCHMARK.json")

    cell = harness.Cell(registry, CELL)
    assert cell.family.__file__ == str(bench_copy / "families/ensemble.py")
    assert {m["name"] for m in registry.metrics_of(CELL, "per_layer")} == \
        METRICS
    for traced in (False, True):
        result, _ = harness.run_cell(CELL, 2 ** 31 + 21, 0.1, traced, "cpu",
                                     registry)
        assert result["correct"], result["checks"]
        assert result["checks"]["window_mismatch"]["value"] == 0.0
        assert result["checks"]["steps"]["value"] == 0.0
    # The CPU has no device kernels: only the host-span metric reads.
    assert set(result["metrics"]) == {"ensemble_outer_ms_per_step"}
    assert result["metrics"]["ensemble_outer_ms_per_step"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, -4])
def test_the_member_seeds_differ(bench_copy, seed):
    cell = harness.Cell(add_ensemble(bench_copy), CELL)
    seeds = cell.family.member_seeds(cell, seed)
    assert len(set(seeds)) == 3
    assert not set(seeds) & set(cell.family.member_seeds(cell, seed + 1))
    state = cell.initial_state(seed, torch.device("cpu"))
    assert state.u.shape == (3, 34, 34) and state.n.tolist() == [0, 0, 0]
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert float((state.u[a] - state.u[b]).abs().max()) > 1e-3
    assert torch.equal(state.u, cell.initial_state(seed, "cpu").u)


def test_members_solved_in_processes_equal_those_solved_here(bench_copy):
    """The card's route of the reference, one spawned process a member,
    gives this process's results bit for bit, with the precision control's
    rounding passed to the processes as well."""
    cell = harness.Cell(add_ensemble(bench_copy), CELL)
    state = cell.initial_state(11, torch.device("cpu"))
    prm = dict(cell.prm, i_max=32, j_max=32, T=0.05)
    for store in (None, calibrate.bfloat16_store):
        jobs = [("cpu", state.u[k], state.v[k], prm, "sor", 64, store)
                for k in range(2)]
        here = cell.family.solve_members(jobs, 0)
        spawned = cell.family.solve_members(jobs, 2)
        for a, b in zip(here, spawned):
            assert a.steps == b.steps >= 1 and a.sweeps == b.sweeps
            for name in ("u", "v", "p"):
                assert torch.equal(getattr(a, name), getattr(b, name))


def test_the_readers_on_a_batched_trace():
    """Two batch steps of 8 members at 258^2 with one inner call each:
    the readers take the inner calls inside the batched solve, the outer's
    host walls less theirs, and the kernels over the member steps."""
    registry = Registry()
    shape = (8, 258, 258)
    inner = [{"start": 0.2 + k, "end": 0.5 + k, "kernel_s": 1e-3,
              "device_end": None, "n_kernels": 8,
              "within": ("solve", "ensemble_step", "pressure_batch"),
              "args": {"shape": shape, "n": 64}} for k in range(2)]
    outer = [{"start": 0.1 + k, "end": 0.9 + k, "kernel_s": 2e-3,
              "device_end": None, "n_kernels": 36,
              "within": ("solve", "ensemble_step"), "args": {"shape": shape}}
             for k in range(2)]
    step = [{"start": k, "end": 1.0 + k, "kernel_s": 3e-3,
             "device_end": None, "n_kernels": 40, "within": ("solve",),
             "args": {"shape": shape}} for k in range(2)]
    card = {"flops": 67e12, "bytes": 3.35e12}
    summary = {"spans": {"sor_inner": inner, "pressure_batch": outer,
                         "ensemble_step": step},
               "steps": 2, "n_kernels": 80, "layers": registry.layers(),
               "bound": lambda op, args: max(
                   a / b for a, b in zip(registry.work(op).count(args),
                                         (card["flops"], card["bytes"])))}

    def read(name):
        return registry.metric(name).read(summary)

    one = registry.work("sor_sweeps").count({"shape": shape[1:], "n": 64})
    batch = registry.work("sor_sweeps_batch").count({"shape": shape, "n": 64})
    assert batch == (8 * one[0], 8 * one[1])
    assert read("ensemble_sweep_roofline") == pytest.approx(
        100 * 2 * (batch[0] / card["flops"]) / 2e-3)
    assert read("ensemble_outer_ms_per_step") == pytest.approx(
        (1.6 - 0.6) / 2 * 1e3)
    assert read("ensemble_kernels_per_member_step") == pytest.approx(
        80 / 16)
    # A solo cell's trace has no batched spans: nothing to read.
    solo = dict(summary, spans={"sor_inner": [dict(inner[0], within=(
        "solve", "step", "pressure"))]})
    assert all(registry.metric(name).read(solo) is None for name in METRICS)


@pytest.mark.gpu
def test_the_cell_on_the_card():
    """The committed cell, traced, is correct and reads its three metrics;
    the precision control at its size is not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    registry = Registry()
    result, _ = harness.run_cell(SOURCE, 2 ** 31 + 303, 1.0, True, "cuda",
                                 registry)
    assert result["correct"], result["checks"]
    assert METRICS <= set(result["metrics"])
    cell = harness.Cell(registry, SOURCE)
    readings = calibrate.control_readings(cell, 101, torch.device("cuda"))
    assert not compare.verdict(readings, cell.limits)[0], readings
