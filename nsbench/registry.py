"""Finds a cell's pieces by name: everything that belongs to one
configuration, kind of problem, traffic mix, layer, per-layer metric or
operation's work count is a file of its own under the benchmark's
directory, so a new one is a new file and no edit.

    BENCHMARK.json            the cells, metrics and bounds (checkout root)
    configs/<name>.json       a configuration (its path is in BENCHMARK.json);
                              its key "family" names its family, "cavity"
                              where it has none
    families/<name>.py        a kind of problem: its seeded state, stepper,
                              step guard, compared fields, plain reference
                              and readings (families/cavity.py lists them)
    traffic/<name>.json       the method, the Params overrides and the
                              reference's pressure solve
    limits/<workload>.json    the limits of the numbers `correct` compares
    layers/<key>.json         a layer's entry point, wrapped in traced runs
    metrics/<name>.py         a per-layer metric's reader, read(summary)
    work/<op>.py              one operation's count(args) -> (flops, bytes)
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent


class Registry:
    """The files of one benchmark directory (`root`, default this one) and
    the BENCHMARK.json beside it, one level up."""

    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else HERE
        self.checkout = self.root.parent
        self.benchmark_path = self.checkout / "BENCHMARK.json"
        self.benchmark = json.loads(self.benchmark_path.read_text())

    def _json(self, *parts) -> Dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def cell(self, workload: str) -> Dict:
        for cell in self.benchmark["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in "
                       f"{self.benchmark_path.name}")

    def config(self, name: str) -> Dict:
        for config in self.benchmark["configs"]:
            if config["name"] == name:
                return json.loads(
                    (self.checkout / config["file"]).read_text())
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> Dict:
        return self._json("limits", f"{workload}.json")

    def layers(self) -> Dict[str, Dict]:
        return {path.stem: json.loads(path.read_text())
                for path in sorted(self.root.joinpath("layers").glob(
                    "*.json"))}

    def _module(self, kind: str, name: str):
        path = self.root / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"nsbench_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def family(self, name: str):
        """The family module `name`; a name with no file raises here,
        before any timing."""
        path = self.root / "families" / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no family {name!r}: {path} does not exist")
        return self._module("families", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def work(self, op: str):
        return self._module("work", op)

    def metrics_of(self, workload: str, kind: str):
        """The `kind` ("end_to_end" or "per_layer") metrics the cell
        reports: those that list it, and those with no list whose moved
        metric (per-layer) or themselves (end-to-end) it reports."""
        metrics = self.benchmark[kind]
        if kind == "end_to_end":
            return [m for m in metrics
                    if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.metrics_of(workload,
                                                       "end_to_end")}
        return [m for m in metrics
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in reported)]
