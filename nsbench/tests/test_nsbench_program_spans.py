"""The program's spans and counters as nsbench/program_spans.py reads them:
idle time by the innermost span of either kind on a hand-made trace, the
four numbers of a CPU traced run of a tiny cell, and every accepted
per-layer metric read alike with and without the program's events."""

import json
import math

import pytest

from nsbench import program_spans, trace


def _span(name, start, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start}


def _kernel(corr, start, end):
    """A kernel launched at `start` (so the clocks need no shift)."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": start, "dur": 0.5, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start,
             "dur": end - start, "args": {"correlation": corr}}]


def _write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_goes_to_the_innermost_span_of_either_kind(tmp_path):
    """Microseconds: a solve of one pass whose inner stage (a harness span
    inside the program's) runs one kernel, then a V-cycle of two levels
    with one kernel on level 0."""
    events = [_span("nsbench.solve", 0, 200),
              _span("nsp.pressure.pass", 10, 50),
              _span("nsp.pressure.inner", 20, 30),
              _span("nsbench.sor_inner", 21, 29),
              _span("nsp.pressure.defect", 30, 45),
              _span("nsp.pressure.flag", 45, 50),
              _span("nsp.pressure.inner", 100, 130),
              _span("nsp.mg.level0", 101, 129),
              _span("nsp.mg.level1", 110, 120),
              *_kernel(1, 22, 28), *_kernel(2, 102, 104),
              # The flag's read: a copy to the host, then the wait.
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "ts": 46, "dur": 1, "args": {"correlation": 3}},
              {"ph": "X", "cat": "gpu_memcpy",
               "name": "Memcpy DtoH (Device -> Pinned)", "ts": 46,
               "dur": 1, "args": {"correlation": 3}},
              {"ph": "X", "cat": "cuda_runtime",
               "name": "cudaStreamSynchronize", "ts": 46.5, "dur": 0.5}]
    found = program_spans.summarize(_write(tmp_path, events))
    idle = {name: round(s * 1e6, 6) for name, s in found["idle_gaps"]}
    assert idle == {"solve": 10 + 50 + 70, "nsp.pressure.pass": 10,
                    "nsp.pressure.inner": 1 + 1 + 1 + 1,
                    "sor_inner": 1 + 1, "nsp.pressure.defect": 15,
                    "nsp.pressure.flag": 5 - 1,
                    "nsp.mg.level0": 1 + 6 + 9, "nsp.mg.level1": 10}
    inner = found["program"]["nsp.pressure.inner"]["spans"][0]
    assert inner["n_kernels"] == 1 and inner["device_end"] == 28e-6
    assert found["n_kernels"] == 2
    assert found["host_reads"] == found["stream_syncs"] == {
        "nsp.pressure.flag": 1}
    got = program_spans.metrics(
        found, {"pressure.passes": 1, "mg.cycles": 1,
                "sync.pressure_flag": 2, "sync.loop_t": 1}, 1)
    assert got == pytest.approx({
        "outer_passes_per_step": 1.0, "host_syncs_per_step": 3.0,
        "outer_idle_ms_per_pass": (10 + 15 + 4) * 1e-3,
        "vcycle_idle_ms": (16 + 10) * 1e-3})
    # A program without counters or spans reports none of the four.
    bare = tmp_path / "bare.json"
    program_spans.without_program(_write(tmp_path, events), str(bare))
    assert program_spans.metrics(program_spans.summarize(str(bare)), None,
                                 1) == {}
    # The harness's own summary reads the same with and without them.
    calls = {"sor_inner": [{}]}
    assert (trace.summarize(_write(tmp_path, events, "again.json"), calls)
            == trace.summarize(str(bare), calls))


@pytest.mark.parametrize("traffic", ["pallas_sor", "mg"])
def test_traced_tiny_cell_reports_the_program_numbers(tiny, traffic):
    line = program_spans.traced_run(f"tiny.{traffic}", 2 ** 31 + 3, 0.2,
                                    "cpu", tiny)
    assert line["mismatches"] == 0 and line["steps"] >= line["solves"] >= 1
    per_step = line["counters_per_step"]
    metrics = line["metrics"]
    # The CPU runs no kernel: only the counters' numbers read.
    assert set(metrics) == {"outer_passes_per_step", "host_syncs_per_step"}
    assert metrics["outer_passes_per_step"] == per_step["pressure.passes"]
    assert metrics["host_syncs_per_step"] == pytest.approx(sum(
        n for name, n in per_step.items() if name.startswith("sync.")))
    solves_per_step = line["solves"] / line["steps"]
    # One read of t a step, and one more that ends each solve.
    assert per_step["sync.loop_t"] == pytest.approx(1 + solves_per_step)
    assert per_step["sync.pressure_result"] == 3
    if traffic == "pallas_sor":
        assert per_step["pressure.passes"] >= 1
        assert per_step["sync.pressure_flag"] >= per_step["pressure.passes"]
    else:
        assert per_step["mg.cycles"] == per_step["pressure.passes"]
        assert line["spans_per_solve"] > 0
        assert any(name.startswith("nsp.mg.level")
                   for name, _ in line["idle_gaps"])
    assert math.isfinite(line["span_cost_us"])
    assert line["accepted_metrics"]["with"] == \
        line["accepted_metrics"]["without"]
    assert line["accepted_metrics"]["with"]["outer_ms_per_step"] > 0
