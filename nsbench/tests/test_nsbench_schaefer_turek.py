"""The ``schaefer_turek`` family as new files alone, on the CPU: a copy of
the committed configuration cut to a tiny channel (10 cells a diameter, 8
diameters long, 80 x 41), spun up by the reference to t = 0.15 in three
steps and solved to 0.25, with the committed cell's traffic and limits."""

import dataclasses
import hashlib
import json
import shutil

import pytest

from navierstokes_parallel_tpu_torch.models import karman
from navierstokes_parallel_tpu_torch.ops import sor

from nsbench import harness
from nsbench.registry import Registry

CELL = "tiny_cylinder.mg"
SOURCE = "schaefer_turek.mg"


def digests(root):
    return {p.relative_to(root.parent): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def add_cylinder(root) -> Registry:
    """Adds, as new files and entries only, the tiny cylinder's
    configuration, its cell and the committed cell's limits."""
    config = json.loads((root / "configs/schaefer_turek_2d2.json")
                        .read_text())
    prm = dataclasses.asdict(karman.schafer_turek(n_per_d=10, T=0.25)
                             .replace(i_max=80, a=8.0))
    config["name"] = "tiny_cylinder"
    config["params"].update({k: prm[k] for k in ("i_max", "j_max", "a",
                                                 "T", "obstacles")})
    config["assumed"]["spin_up_T"] = 0.15
    (root / "configs/tiny_cylinder.json").write_text(json.dumps(config))
    shutil.copy(root / f"limits/{SOURCE}.json", root / f"limits/{CELL}.json")
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny_cylinder", "source": "a test grid",
                             "file": f"{root.name}/configs/tiny_cylinder.json",
                             "reduced": ["i_max", "j_max", "a", "T"],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_cylinder",
                               "traffic": "masked_mg", "chips": 1,
                               "why": "CPU tests"})
    for metric in bench["per_layer"]:
        if SOURCE in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    bench_path.write_text(json.dumps(bench))
    return Registry(root)


def altered_behind_the_cylinder(original):
    """`solve_pressure` with p raised by 1e-2 one diameter behind the
    cylinder, in the program's float32 solves only."""
    def solve(p, rhs, params, **kw):
        result = original(p, rhs, params, **kw)
        if result.p.dtype.itemsize == 4 and params.obstacles:
            out = result.p.clone()
            out[36, 21] += 1e-2
            result = result._replace(p=out)
        return result
    return solve


def test_the_family_is_found_without_an_edit(bench_copy, monkeypatch):
    before = digests(bench_copy)
    registry = add_cylinder(bench_copy)
    after = digests(bench_copy)
    assert all(after[path] == digest for path, digest in before.items()
               if path.name != "BENCHMARK.json")

    cell = harness.Cell(registry, CELL)
    assert cell.family.__file__ == str(
        bench_copy / "families/schaefer_turek.py")
    for traced in (False, True):
        result, _ = harness.run_cell(CELL, 2 ** 31 + 21, 0.1, traced, "cpu",
                                     registry)
        assert result["correct"], result["checks"]
        assert result["checks"]["window_mismatch"]["value"] == 0.0
    # The CPU has no device kernels: only the host-span metrics read.
    assert set(result["metrics"]) == {"masked_vcycle_ms",
                                      "masked_outer_ms_per_step"}
    assert all(m["value"] > 0 for m in result["metrics"].values())

    monkeypatch.setattr(sor, "solve_pressure",
                        altered_behind_the_cylinder(sor.solve_pressure))
    result, _ = harness.run_cell(CELL, 2 ** 31 + 21, 0.1, False, "cpu",
                                 registry)
    assert not result["correct"]
    assert result["checks"]["p_err"]["value"] > result["checks"]["p_err"][
        "limit"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, -4])
def test_the_kick_is_drawn_from_the_seed(bench_copy, seed):
    cell = harness.Cell(add_cylinder(bench_copy), CELL)
    kick = cell.family.kick(cell, seed)
    assert kick == cell.family.kick(cell, seed)
    assert 0.2 <= kick <= 0.4
    assert kick != cell.family.kick(cell, seed + 1)
