"""Traced runs: spans around each layer's entry point, the profiler over
whole solves, and the reduction of its trace to the summary that the
per-layer readers take.

The harness wraps each layer's entry point (``layers/<key>.json``: module,
attribute, the arguments to record) in ``torch.profiler.record_function``
under the name ``nsbench.<key>``, for the traced solves only.  The profiler
records the CPU and CUDA activity; its Chrome trace ties every device kernel
to the host call that launched it (the runtime event with the same
correlation id), and so to the harness spans open on the host at that call.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

PREFIX = "nsbench."
SOLVE = PREFIX + "solve"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# Host calls that return only once the work queued before them has ended.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
BREAKDOWN_ENTRIES = 10
# A kernel's name in the breakdown: its first characters (templates run long).
NAME_CHARS = 160


class LayerSpans(contextlib.AbstractContextManager):
    """Wraps every layer's entry point while the block runs and records the
    arguments each call was given (``record``: a name for each positional
    index; a tensor gives its shape, anything else its int value)."""

    def __init__(self, layers: Dict[str, Dict]):
        self.layers = layers
        self.calls: Dict[str, List[Dict]] = defaultdict(list)
        self._saved = []

    def _wrap(self, key: str, fn: Callable, record: Dict[str, int]):
        calls, name = self.calls[key], PREFIX + key

        def wrapped(*args, **kwargs):
            calls.append({
                field: (tuple(args[i].shape) if isinstance(args[i],
                                                           torch.Tensor)
                        else int(args[i]))
                for field, i in record.items() if i < len(args)})
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def __enter__(self):
        for key, layer in self.layers.items():
            module = importlib.import_module(layer["module"])
            fn = getattr(module, layer["attr"])
            self._saved.append((module, layer["attr"], fn))
            setattr(module, layer["attr"],
                    self._wrap(key, fn, layer.get("record", {})))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()
        return False


def profile_solves(run_solve: Callable[[], int], min_seconds: float,
                   trace_path: str) -> int:
    """Run whole solves under the profiler, each in a ``nsbench.solve``
    span, until `min_seconds` have passed (at least one); write the Chrome
    trace to `trace_path`.  `run_solve` returns the solve's step count;
    returns the steps of all traced solves."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    steps = 0
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        while steps == 0 or time.perf_counter() - start < min_seconds:
            with torch.profiler.record_function(SOLVE):
                steps += run_solve()
    prof.export_chrome_trace(trace_path)
    return steps


class _Span:
    __slots__ = ("key", "start", "end", "index", "within", "kernel_s",
                 "device_end", "n_kernels")

    def __init__(self, key, start, end, index):
        self.key, self.start, self.end, self.index = key, start, end, index
        self.within = ()
        self.kernel_s, self.device_end, self.n_kernels = 0.0, None, 0


def _stacks(spans: List[_Span], times: List[float]) -> List[tuple]:
    """The spans open at each of `times` (sorted), outermost first; the
    spans nest, as record_function ranges on one thread do."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    stack: List[_Span] = []
    out, k = [], 0
    for t in times:
        while k < len(order) and order[k].start <= t:
            while stack and stack[-1].end < order[k].start:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(tuple(stack))
    return out


def clock_offset(launches: Dict, device: List, syncs: List) -> float:
    """The shift that puts the device's timestamps on the host's clock.

    The profiler's alignment of the two clocks can be off by hundreds of
    microseconds.  Two facts bound the shift: no kernel starts before the
    host call that launched it (a lower bound), and a host sync returns
    only after the work launched before it has ended (an upper bound).
    Returns the middle of the two, or the one bound there is."""
    lo = max((launches[d[4]] - d[0] for d in device if d[4] in launches),
             default=None)
    hi = None
    ends = {d[4]: d[1] for d in device if d[4] is not None}
    order = sorted((t, corr) for corr, t in launches.items() if corr in ends)
    times = [t for t, _ in order]
    for start, end in syncs:
        k = bisect.bisect_left(times, start) - 1
        if k >= 0:
            bound = end - ends[order[k][1]]
            hi = bound if hi is None else min(hi, bound)
    if lo is None or hi is None:
        return lo or hi or 0.0
    return (lo + hi) / 2.0


def _host_segments(spans: List[_Span], w0: float, w1: float):
    """[w0, w1] cut at every span's start and end, each piece named by the
    innermost span open in it ("none" outside every span)."""
    cuts = sorted({w0, w1, *(t for s in spans for t in (s.start, s.end)
                             if w0 < t < w1)})
    mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
    return [(a, b, stack[-1].key if stack else "none")
            for a, b, stack in zip(cuts, cuts[1:], _stacks(spans, mids))]


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(trace_path: str, calls: Dict[str, List[Dict]]) -> Dict:
    """The trace reduced to what the readers take: the traced window, the
    device's busy time in it, the kernels launched in it, and for each
    layer its spans (host start and end, the device time and the end of
    the kernels launched under it, the enclosing layers, the recorded
    arguments); and the breakdown of the run's line.  Times in seconds."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, launches, device, syncs = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and name.startswith(PREFIX):
            spans.append(_Span(name[len(PREFIX):], ts, ts + dur, 0))
        elif cat in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
            if name in SYNC_CALLS:
                syncs.append((ts, ts + dur))
        elif cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, name, cat,
                           e.get("args", {}).get("correlation")))
    del events
    offset = clock_offset(launches, device, syncs)
    device = [(a + offset, b + offset, *rest) for a, b, *rest in device]
    solves = [s for s in spans if s.key == "solve"]
    if not solves:
        raise RuntimeError(f"no {SOLVE} span in the trace {trace_path}")
    w0, w1 = min(s.start for s in solves), max(s.end for s in solves)
    by_key = defaultdict(list)
    for span in sorted(spans, key=lambda s: s.start):
        span.index = len(by_key[span.key])
        by_key[span.key].append(span)
    for span, stack in zip(sorted(spans, key=lambda s: s.start),
                           _stacks(spans, [s.start for s in sorted(
                               spans, key=lambda s: s.start)])):
        outer = stack[:stack.index(span)] if span in stack else stack
        span.within = tuple(s.key for s in outer)

    # Each device event's launch time on the host, then the spans open then.
    timed = sorted(((launches.get(d[4]), d) for d in device),
                   key=lambda x: -1.0 if x[0] is None else x[0])
    stacks = _stacks(spans, [t if t is not None else -1.0
                             for t, _ in timed])
    kept, n_kernels, by_name = [], 0, defaultdict(float)
    for (launch, d), stack in zip(timed, stacks):
        in_window = (any(s.key == "solve" for s in stack) if launch is not None
                     else w0 <= d[0] <= w1)
        if not in_window:
            continue
        kept.append(d)
        by_name[d[2]] += d[1] - d[0]
        if d[3] == "kernel":
            n_kernels += 1
            for s in stack:
                s.kernel_s += d[1] - d[0]
                s.n_kernels += 1
                s.device_end = (d[1] if s.device_end is None
                                else max(s.device_end, d[1]))
    busy = _union([(max(d[0], w0), min(d[1], w1)) for d in kept
                   if d[1] > w0 and d[0] < w1])
    busy_s = sum(end - start for start, end in busy)

    # Idle time, split by the innermost harness span the host was in.
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    idle = defaultdict(float)
    segments = _host_segments(spans, w0, w1)
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

    def top(table):
        return [[name[:NAME_CHARS], seconds] for name, seconds in sorted(
            table.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    layer_spans = {}
    for key, found in by_key.items():
        recorded = calls.get(key, [])
        layer_spans[key] = [{
            "start": s.start, "end": s.end, "kernel_s": s.kernel_s,
            "device_end": s.device_end, "n_kernels": s.n_kernels,
            "within": s.within,
            "args": recorded[s.index] if len(recorded) == len(found) else {},
        } for s in found]
    return {
        "window_s": w1 - w0, "busy_s": busy_s, "n_kernels": n_kernels,
        "spans": layer_spans,
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }
