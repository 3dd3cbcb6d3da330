"""One run of one cell: set-up, the measured window (or the traced solves),
the comparison with the reference, and the result line.

What belongs to one kind of problem (its seeded state, its stepper, its
step guard, the fields a solve is judged by, its plain reference and the
readings) comes from the family that the cell's configuration names,
``families/<name>.py`` (``families/cavity.py`` where it names none; that
module's docstring lists the functions a family gives).

The window drives the program's host loop, ``solver.run_steps`` over the
family's stepper (for the cavity ``solver.Stepper``, what ``solver.solve``
and the CLI run), from the same seeded state for every solve, back to back
until the seconds have passed.  Its ``before`` hook, called where the loop
has read t (a sync), marks each step's boundary with a CUDA event, so step
times come from the device's clock.  Every solve's fields are held against
the first timed solve's on the device (no sync); the first timed solve is
compared with the reference once the window has closed, the peak memory
read and the program's state freed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import compare, peaks, trace
from .families.cavity import guard as step_guard  # noqa: F401
from .registry import Registry

# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "navierstokes_parallel_tpu")
# Seconds of whole solves that a traced run profiles (at least one solve).
TRACE_SECONDS = 0.5
END_TO_END = ("setup_s", "solve_s", "step_ms_p95")


class ForbiddenImport(RuntimeError):
    """JAX, a JAX library or the JAX package was loaded in the run."""


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules, each name
    compared whole (the part before the first dot)."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


class StepClock:
    """Step boundaries of each solve: CUDA events on a card, the host clock
    elsewhere (CPU tests only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.solves: List[List] = []

    def solve(self):
        marks: List = []
        self.solves.append(marks)

        def mark():
            if self.cuda:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                marks.append(event)
            else:
                marks.append(time.perf_counter())

        return mark

    def step_ms(self) -> List[float]:
        out = []
        for marks in self.solves:
            for a, b in zip(marks, marks[1:]):
                out.append(a.elapsed_time(b) if self.cuda
                           else (b - a) * 1e3)
        return out


class Cell:
    """A cell's configuration, traffic, limits, the program's Params and
    the configuration's family (``families/cavity.py`` where it names
    none)."""

    def __init__(self, registry: Registry, workload: str):
        from navierstokes_parallel_tpu_torch.config import Params

        self.workload = workload
        self.entry = registry.cell(workload)
        self.config = registry.config(self.entry["config"])
        self.traffic = registry.traffic(self.entry["traffic"])
        self.limits = registry.limits(workload)
        self.prm = {**self.config["params"], **self.traffic["params"]}
        self.params = Params(**self.prm)
        self.method = self.traffic["method"]
        self.family = registry.family(self.config.get("family", "cavity"))
        self.guard = self.family.guard(self.prm)

    def initial_state(self, seed: int, device: torch.device):
        """The program's seeded state."""
        return self.family.initial_state(self, seed, device)

    def reference(self, state, store=None):
        """The reference's solve from the program's initial fields."""
        return self.family.reference(self, state, store)


class Solves:
    """Runs whole solves of a cell from one state, holds the first one's
    fields, and counts on the device the solves that end elsewhere."""

    def __init__(self, cell: Cell, state):
        from navierstokes_parallel_tpu_torch import solver

        self.solver, self.cell, self.state0 = solver, cell, state
        self.kept = None
        self.kept_steps = 0
        self.count = 0
        self.steps_differ = 0
        self.differ = torch.zeros((), dtype=torch.int64,
                                  device=state.u.device)

    def run(self, before=None):
        """One solve; returns (state, steps)."""
        stepper = self.cell.family.stepper(self.cell, self.state0)
        stats = self.solver.run_steps(stepper, self.cell.params,
                                      max_steps=self.cell.guard,
                                      before=before)
        return stepper.state(), stats.steps

    def timed(self, before=None, done=None) -> int:
        """One counted solve; `before` runs before each step and `done`
        once the loop has ended, ahead of the check against the first."""
        state, steps = self.run(before)
        if done is not None:
            done()
        self.count += 1
        fields = self.cell.family.fields(state)
        if self.kept is None:
            self.kept, self.kept_steps = fields, steps
        else:
            differ = torch.zeros((), dtype=torch.bool, device=state.u.device)
            for name, own in fields.items():
                differ |= (own != self.kept[name]).any()
            self.differ += differ
            self.steps_differ += steps != self.kept_steps
        return steps

    def mismatches(self) -> int:
        return int(self.differ) + self.steps_differ


def power_limit_w(index: int) -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", registry: Optional[Registry] = None,
             start: Optional[float] = None) -> Tuple[Dict, List[str]]:
    """One run; returns the result line (a dict) and the check lines for
    standard error.  `start` is the host clock at the process's start (the
    set-up's origin).  Raises ForbiddenImport when a forbidden module was
    loaded."""
    start = time.perf_counter() if start is None else start
    registry = registry or Registry()
    device = torch.device(device)
    cell = Cell(registry, workload)
    state0 = cell.initial_state(seed, device)
    cell.family.warm_up(cell, device)
    solves = Solves(cell, state0)
    solves.run()  # untimed: every shape of the window, warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - start

    metrics: Dict[str, Dict] = {}
    dev: Dict = {"platform": "gpu" if device.type == "cuda" else "cpu",
                 "kind": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                 "count": 1}
    breakdown = None
    if not traced:
        clock = StepClock(device)
        t0 = time.perf_counter()
        while True:
            mark = clock.solve()
            solves.timed(before=mark, done=mark)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        values = {"setup_s": setup_s, "solve_s": window_s / solves.count,
                  "step_ms_p95": _percentile(clock.step_ms(), 95)}
        for m in registry.metrics_of(workload, "end_to_end"):
            if m["name"] not in END_TO_END:
                raise KeyError(f"the harness does not measure {m['name']!r}")
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        layers = registry.layers()
        fd, path = tempfile.mkstemp(prefix="nsbench_trace_", suffix=".json")
        os.close(fd)
        try:
            with trace.LayerSpans(layers) as spans:
                steps = trace.profile_solves(solves.timed,
                                             min(seconds, TRACE_SECONDS),
                                             path)
            summary = trace.summarize(path, spans.calls)
        finally:
            os.remove(path)
        card = peaks.PEAKS.get(dev["kind"])

        def bound(op, args):
            if card is None or not args:
                return None
            return peaks.bound_seconds(card, *registry.work(op).count(args))

        summary.update(steps=steps, solves=solves.count, layers=layers,
                       bound=bound)
        for m in registry.metrics_of(workload, "per_layer"):
            value = registry.metric(m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        dev["memory_peak_bytes"] = 0
    mismatches = solves.mismatches()
    attempted = solves.count
    kept = {name: x.to(torch.float64) for name, x in solves.kept.items()}
    kept_steps = solves.kept_steps
    del solves
    if device.type == "cuda":
        torch.cuda.empty_cache()
        limit = power_limit_w(device.index or 0)
        if limit is not None:
            dev["power_limit_w"] = limit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = cell.reference(state0)
    readings = cell.family.readings(kept, kept_steps, ref, cell)
    readings["window_mismatch"] = float(mismatches)
    correct, checks = compare.verdict(readings, cell.limits)
    fields_ok = compare.verdict(
        readings, {k: v for k, v in cell.limits.items()
                   if k != "window_mismatch"})[0]

    found = forbidden_modules()
    if found:
        raise ForbiddenImport("loaded in the run: " + ", ".join(found))
    result = {"correct": correct, "attempted": attempted,
              "failed": mismatches if fields_ok else attempted,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}"
             for name, c in checks.items()]
    return result, lines
