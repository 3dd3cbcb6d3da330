"""A new configuration, traffic mix, per-layer metric and layer
are found as new files alone: no file that was there changes."""

import hashlib
import json

from nsbench import harness
from nsbench.registry import Registry

from conftest import add_tiny


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
