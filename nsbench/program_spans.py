"""The program's own spans and counters in a traced run of a cell.

The program marks its host work with profiler ranges named ``nsp.<name>``
(the time loop's read of t, the step's dt and BCs and its projection, the
pressure outer's set-up, passes, inner stage, defect, flag read and
result, each V-cycle level) and counts its outer passes, V-cycles, kernel
launches and host reads of device values in one table
(``utils/timing.py``: ``span``, ``count``, ``counts``).  This module
reduces a traced run's Chrome trace and the counters' increase over it to
four per-layer numbers and to idle gaps named by the innermost span of
either kind, the harness's (``nsbench.<key>``) or the program's.

The harness does not call it yet: ``trace.summarize`` reads only the
harness's spans and ``harness.run_cell`` takes no counters, and a PR that
is not a benchmark PR edits neither (PERF.md §7 names the edits).  Until
then it runs a cell's traced solves itself, as a ``--trace 1`` run does:

    python3 -m nsbench.program_spans --workload <cell> --seed <n> \
        [--seconds <s>]

prints one JSON line (the four numbers, the idle gaps, the counters per
step, the spans per solve, the cost of one span with no profiler, the
host syncs the trace shows per step, and every accepted per-layer metric
read from the trace with and without the program's events).  Against a
program that has no spans or counters it reports none of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from . import peaks, trace

PROGRAM_PREFIX = "nsp."
# Device copies to the host: each is one host read of a device value.
DTOH = "DtoH"
STREAM_SYNC = "cudaStreamSynchronize"
IDLE_ENTRIES = 16


def _load(trace_path: str) -> List[Dict]:
    with open(trace_path) as f:
        return json.load(f).get("traceEvents", [])


def summarize(trace_path: str) -> Dict:
    """The trace's program spans (by full name: start, end, kernel_s,
    device_end and n_kernels as the harness's spans carry them, and
    ``idle_s``, the device-idle time in which that name was the innermost
    open span), the idle gaps by the innermost span of either kind (the
    harness's by key, the program's by full name), and the host reads
    (device-to-host copies) and stream syncs inside the solves, each by
    the innermost span the host was in.  Times in seconds."""
    spans, launches, device, syncs, stream_syncs = [], {}, [], [], []
    for e in _load(trace_path):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and name.startswith(trace.PREFIX):
            spans.append(trace._Span(name[len(trace.PREFIX):], ts, ts + dur,
                                     0))
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            spans.append(trace._Span(name, ts, ts + dur, 0))
        elif cat in trace.LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
            if name in trace.SYNC_CALLS:
                syncs.append((ts, ts + dur))
            if name == STREAM_SYNC:
                stream_syncs.append(ts)
        elif cat in trace.DEVICE_CATEGORIES:
            device.append((ts, ts + dur, name, cat,
                           e.get("args", {}).get("correlation")))
    offset = trace.clock_offset(launches, device, syncs)
    device = [(a + offset, b + offset, *rest) for a, b, *rest in device]
    solves = [s for s in spans if s.key == "solve"]
    if not solves:
        raise RuntimeError(f"no {trace.SOLVE} span in the trace {trace_path}")
    w0, w1 = min(s.start for s in solves), max(s.end for s in solves)

    def in_solve(t: float) -> bool:
        return any(s.start <= t <= s.end for s in solves)

    timed = sorted(((launches.get(d[4]), d) for d in device),
                   key=lambda x: -1.0 if x[0] is None else x[0])
    stacks = trace._stacks(spans, [t if t is not None else -1.0
                                   for t, _ in timed])
    kept, n_kernels = [], 0
    reads: Dict[str, int] = defaultdict(int)
    for (launch, d), stack in zip(timed, stacks):
        if not (in_solve(launch) if launch is not None else w0 <= d[0] <= w1):
            continue
        kept.append(d)
        if d[3] == "gpu_memcpy" and DTOH in d[2]:
            reads[stack[-1].key if stack else "none"] += 1
        if d[3] == "kernel":
            n_kernels += 1
            for s in stack:
                s.kernel_s += d[1] - d[0]
                s.n_kernels += 1
                s.device_end = (d[1] if s.device_end is None
                                else max(s.device_end, d[1]))
    busy = trace._union([(max(d[0], w0), min(d[1], w1)) for d in kept
                         if d[1] > w0 and d[0] < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    idle: Dict[str, float] = defaultdict(float)
    segments = trace._host_segments(spans, w0, w1)
    k = 0
    for start, end in gaps:
        while k < len(segments) and segments[k][1] <= start:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < end:
            lo, hi = max(start, segments[j][0]), min(end, segments[j][1])
            if hi > lo:
                idle[segments[j][2]] += hi - lo
            j += 1
    stream_syncs = sorted(t for t in stream_syncs if in_solve(t))
    waits: Dict[str, int] = defaultdict(int)
    for stack in trace._stacks(spans, stream_syncs):
        waits[stack[-1].key if stack else "none"] += 1
    program: Dict[str, Dict] = {}
    for s in sorted(spans, key=lambda s: s.start):
        if s.key.startswith(PROGRAM_PREFIX) and in_solve(s.start):
            entry = program.setdefault(s.key, {
                "spans": [], "idle_s": idle.get(s.key, 0.0)})
            entry["spans"].append({
                "start": s.start, "end": s.end, "kernel_s": s.kernel_s,
                "device_end": s.device_end, "n_kernels": s.n_kernels})
    return {
        "program": program,
        "idle_gaps": [[name, seconds] for name, seconds in sorted(
            idle.items(), key=lambda kv: -kv[1])[:IDLE_ENTRIES]],
        "n_kernels": n_kernels,
        "host_reads": dict(reads),
        "stream_syncs": dict(waits),
    }


def metrics(found: Dict, counters: Optional[Dict[str, int]],
            steps: int) -> Dict[str, float]:
    """The four per-layer numbers of the traced steps from `found`
    (``summarize``'s) and the counters' increase, each left out where the
    program has nothing for it to read: ``outer_passes_per_step``,
    ``host_syncs_per_step`` (every ``sync.*`` counter), and, where the
    device ran kernels, the idle milliseconds a pass of the outer's own
    work (``pressure.pass``, ``pressure.defect``, ``pressure.flag``: the
    pass less its inner stage) and a V-cycle's (every ``mg.*`` span) over
    the counted cycles."""
    out: Dict[str, float] = {}
    program = found["program"] if found["n_kernels"] else {}
    counters = counters or {}
    passes = counters.get("pressure.passes", 0)
    cycles = counters.get("mg.cycles", 0)
    if steps and passes:
        out["outer_passes_per_step"] = passes / steps
        out["host_syncs_per_step"] = sum(
            n for name, n in counters.items()
            if name.startswith("sync.")) / steps
    outer = [program[PROGRAM_PREFIX + name]["idle_s"] for name in (
        "pressure.pass", "pressure.defect", "pressure.flag")
        if PROGRAM_PREFIX + name in program]
    if passes and outer:
        out["outer_idle_ms_per_pass"] = sum(outer) / passes * 1e3
    levels = [entry["idle_s"] for name, entry in program.items()
              if name.startswith(PROGRAM_PREFIX + "mg.")]
    if cycles and levels:
        out["vcycle_idle_ms"] = sum(levels) / cycles * 1e3
    return out


def without_program(trace_path: str, out_path: str) -> None:
    """A copy of the trace without the program's spans."""
    with open(trace_path) as f:
        data = json.load(f)
    data["traceEvents"] = [
        e for e in data.get("traceEvents", [])
        if not (e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PROGRAM_PREFIX))]
    with open(out_path, "w") as f:
        json.dump(data, f)


def _counts():
    """The program's counters, or None where it has none."""
    from navierstokes_parallel_tpu_torch.utils import timing

    return timing.counts() if hasattr(timing, "counts") else None


def span_cost_us(calls: int = 100_000) -> Optional[float]:
    """Microseconds of one ``timing.span`` with no profiler recording, or
    None where the program has none."""
    from navierstokes_parallel_tpu_torch.utils import timing

    if not hasattr(timing, "span"):
        return None
    span = timing.span
    t0 = time.perf_counter()
    for _ in range(calls):
        with span("pressure.pass"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def traced_run(workload: str, seed: int, seconds: float, device="cuda",
               registry=None) -> Dict:
    """A cell's traced solves as ``harness.run_cell`` runs them with
    tracing on, with the counters read around them; returns this module's
    line (see the module's docstring)."""
    from .harness import Cell, Solves, TRACE_SECONDS
    from .registry import Registry

    registry = registry or Registry()
    device = torch.device(device)
    cell = Cell(registry, workload)
    state0 = cell.initial_state(seed, device)
    cell.family.warm_up(cell, device)
    solves = Solves(cell, state0)
    solves.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cost = span_cost_us()
    layers = registry.layers()
    fd, path = tempfile.mkstemp(prefix="nsbench_program_", suffix=".json")
    os.close(fd)
    bare = path + ".bare.json"
    try:
        before = _counts()
        with trace.LayerSpans(layers) as wrapped:
            steps = trace.profile_solves(solves.timed,
                                         min(seconds, TRACE_SECONDS), path)
        after = _counts()
        counters = (None if before is None else
                    {k: n - before.get(k, 0) for k, n in after.items()
                     if n != before.get(k, 0)})
        found = summarize(path)
        without_program(path, bare)
        summaries = {label: trace.summarize(source, wrapped.calls)
                     for label, source in (("with", path),
                                           ("without", bare))}
    finally:
        for p in (path, bare):
            if os.path.exists(p):
                os.remove(p)
    card = peaks.PEAKS.get(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")

    def bound(op, args):
        if card is None or not args:
            return None
        return peaks.bound_seconds(card, *registry.work(op).count(args))

    accepted = {}
    for label, summary in summaries.items():
        summary.update(steps=steps, solves=solves.count, layers=layers,
                       bound=bound)
        accepted[label] = {
            m["name"]: registry.metric(m["name"]).read(summary)
            for m in registry.metrics_of(workload, "per_layer")}
    n_spans = sum(len(e["spans"]) for e in found["program"].values())
    return {
        "workload": workload, "seed": seed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "steps": steps, "solves": solves.count,
        "traced_s_per_solve": summaries["with"]["window_s"] / solves.count,
        "metrics": metrics(found, counters, steps),
        "idle_gaps": found["idle_gaps"],
        "counters_per_step": (None if counters is None else
                              {k: n / steps for k, n in counters.items()}),
        "spans_per_solve": n_spans / solves.count,
        "span_cost_us": cost,
        "trace_host_reads_per_step": {
            k: n / steps for k, n in found["host_reads"].items()},
        "trace_stream_syncs_per_step": {
            k: n / steps for k, n in found["stream_syncs"].items()},
        "accepted_metrics": accepted,
        "mismatches": solves.mismatches(),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("nsbench.program_spans: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(traced_run(args.workload, args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
