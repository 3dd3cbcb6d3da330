"""A new configuration, traffic mix, per-layer metric, layer and family
are found as new files alone: no file that was there changes."""

import hashlib
import json
import shutil

import pytest
import torch

from navierstokes_parallel_tpu_torch.models import convection

from nsbench import harness
from nsbench.registry import Registry

from conftest import BENCH_DIR, add_tiny

# A 16^2 de Vahl Davis cavity at Ra 1e4: three steps to its T.
THERMAL = {"problem": 5, "i_max": 16, "j_max": 16, "a": 1.0, "b": 1.0,
           "T": 0.1, "Ra": 1e4, "Pr": 0.71, "tau": 0.5, "omega": 1.7,
           "epsilon": 1e-4, "max_it": 200, "dtype": "float32"}


def digests(root):
    return {p.relative_to(root.parent): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_without_an_edit(bench_copy):
    before = digests(bench_copy)
    add_tiny(bench_copy)
    (bench_copy / "traffic/pallas_sor_k8.json").write_text(json.dumps({
        "method": "pallas_sor", "params": {"sor_refine_every": 8},
        "reference": {"pressure": "sor", "check_every": 8}}))
    (bench_copy / "metrics/steps_per_solve.py").write_text(
        "def read(s):\n    return s['steps'] / s['solves']\n")
    (bench_copy / "layers/plain_inner.json").write_text(json.dumps({
        "layer": "SOR inner", "module":
        "navierstokes_parallel_tpu_torch.ops.cuda.sor_kernel",
        "attr": "whole_grid_sweeps", "record": {"shape": 0, "n": 1}}))
    bench_path = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny.k8", "config": "tiny",
                               "traffic": "pallas_sor_k8", "chips": 1,
                               "why": "a new traffic mix"})
    bench["per_layer"].append({
        "name": "steps_per_solve", "unit": "steps", "better": "lower",
        "source": "program_counter", "layer": "time loop",
        "moves": "solve_s", "workloads": ["tiny.k8"]})
    bench_path.write_text(json.dumps(bench))
    (bench_copy / "limits/tiny.k8.json").write_text(
        (bench_copy / "limits/tiny.pallas_sor.json").read_text())
    after = digests(bench_copy)
    assert all(after[path] == digest for path, digest in before.items()
               if path.name != "BENCHMARK.json")

    registry = Registry(bench_copy)
    assert "plain_inner" in registry.layers()
    cell = harness.Cell(registry, "tiny.k8")
    assert cell.params.sor_refine_every == 8 and cell.params.i_max == 24
    result, _ = harness.run_cell("tiny.k8", 3, 0.1, True, "cpu", registry)
    assert result["correct"], result["checks"]
    assert result["metrics"]["steps_per_solve"] == {"value": 1.0,
                                                    "unit": "steps"}


def test_metrics_of_a_cell_follow_benchmark_json():
    registry = Registry()
    names = {m["name"] for m in registry.metrics_of("cavity2048.mg",
                                                    "per_layer")}
    assert names == {"kernels_per_step", "outer_ms_per_step", "vcycle_ms",
                     "momentum_roofline", "device_idle_pct"}
    assert {m["name"] for m in registry.metrics_of(
        "cavity256.sor", "end_to_end")} == {"setup_s", "solve_s"}
    assert {m["name"] for m in registry.metrics_of(
        "cavity256.sor_k2048", "end_to_end")} == {"setup_s", "solve_s",
                                                  "step_ms_p95"}


def add_thermal(root):
    """Adds, as new files and entries only, the test family
    ``family_thermal.py`` as ``families/thermal.py``, a configuration that
    names it, its traffic and limits, and the cell ``thermal16.mg``."""
    shutil.copy(BENCH_DIR / "tests/family_thermal.py",
                root / "families/thermal.py")
    (root / "configs/thermal16.json").write_text(json.dumps({
        "name": "thermal16", "family": "thermal", "params": THERMAL,
        "assumed": {"perturbation_amplitude": 0.05}}))
    (root / "traffic/thermal_mg.json").write_text(json.dumps({
        "method": "mg", "params": {}}))
    (root / "limits/thermal16.mg.json").write_text(json.dumps({
        "steps": 0, "u_err": 1e-4, "v_err": 1e-4, "p_err": 1e-4,
        "T_err": 1e-4, "window_mismatch": 0}))
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "thermal16", "source": "a test grid",
                             "file": f"{root.name}/configs/thermal16.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "thermal16.mg", "config": "thermal16",
                               "traffic": "thermal_mg", "chips": 1,
                               "why": "a second family"})
    for metric in bench["per_layer"]:
        if metric["name"] == "outer_ms_per_step":
            metric["workloads"].append("thermal16.mg")
    bench_path.write_text(json.dumps(bench))
    return Registry(root)


def temperature_altered(original):
    """`thermal_step` with one temperature altered where it is produced,
    in the program's float32 steps only (the fixture's reference is the
    port's own float64 run)."""
    def step(ts, params, cfg, pressure_method="mg"):
        new, extra = original(ts, params, cfg, pressure_method)
        if new.T.dtype == torch.float32:
            T = new.T.clone()
            T[params.i_max // 2, params.j_max // 2] += 1e-2
            new = new._replace(T=T)
        return new, extra
    return step


def test_a_second_family_is_found_without_an_edit(bench_copy, monkeypatch):
    before = digests(bench_copy)
    registry = add_thermal(bench_copy)
    after = digests(bench_copy)
    assert all(after[path] == digest for path, digest in before.items()
               if path.name != "BENCHMARK.json")

    cell = harness.Cell(registry, "thermal16.mg")
    assert list(cell.family.fields(cell.initial_state(3, "cpu"))) == [
        "u", "v", "p", "T"]
    for traced in (False, True):
        result, _ = harness.run_cell("thermal16.mg", 2 ** 31 + 9, 0.1,
                                     traced, "cpu", registry)
        assert result["correct"], result["checks"]
        assert result["checks"]["T_err"]["value"] < 1e-6
        assert result["checks"]["window_mismatch"]["value"] == 0.0
    assert "outer_ms_per_step" in result["metrics"]

    monkeypatch.setattr(convection, "thermal_step",
                        temperature_altered(convection.thermal_step))
    result, _ = harness.run_cell("thermal16.mg", 2 ** 31 + 9, 0.1, False,
                                 "cpu", registry)
    assert not result["correct"]
    assert result["checks"]["T_err"]["value"] > 1e-3


def test_a_configuration_with_no_family_file_fails_at_the_cell(tiny):
    path = tiny.root / "configs/tiny.json"
    config = json.loads(path.read_text())
    assert "family" not in config
    assert harness.Cell(tiny, "tiny.mg").family.__file__ == str(
        tiny.root / "families/cavity.py")
    path.write_text(json.dumps({**config, "family": "dam_break"}))
    with pytest.raises(KeyError, match="dam_break"):
        harness.Cell(tiny, "tiny.mg")
