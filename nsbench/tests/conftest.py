"""A small copy of the benchmark for the CPU: the committed files, plus a
24 x 24 cavity and a cell for each traffic mix, each with the limits of the
committed cell of the same traffic."""

import json
import shutil
from pathlib import Path

import pytest

from nsbench.registry import Registry

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent
TINY = {"i_max": 24, "j_max": 24, "max_it": 300}
# The committed cell whose limits each tiny cell takes, by traffic.
LIMITS_OF = {"pallas_sor": "cavity256.sor", "mg": "cavity2048.mg",
             "pallas_sor_k2048": "cavity256.sor_k2048",
             "fft": "cavity2048.fft"}


def add_tiny(root: Path) -> Registry:
    """Adds the tiny configuration and its cells to the copy at `root`
    (the benchmark directory), as new files and entries only."""
    config = json.loads((root / "configs/cavity256_re1000.json").read_text())
    config["name"] = "tiny"
    config["params"].update(TINY)
    (root / "configs/tiny.json").write_text(json.dumps(config))
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny", "source": "a test grid",
                             "file": f"{root.name}/configs/tiny.json",
                             "reduced": ["i_max", "j_max", "max_it"],
                             "why": "CPU tests"})
    for traffic, source in LIMITS_OF.items():
        name = f"tiny.{traffic}"
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
        shutil.copy(root / f"limits/{source}.json",
                    root / f"limits/{name}.json")
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if source in metric.get("workloads", []):
                metric["workloads"].append(name)
    bench_path.write_text(json.dumps(bench))
    return Registry(root)


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """A checkout holding BENCHMARK.json and a copy of the benchmark's
    directory; returns that directory."""
    root = tmp_path / "nsbench"
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny(bench_copy) -> Registry:
    return add_tiny(bench_copy)
