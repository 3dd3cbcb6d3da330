"""The work counts against the bounds the port's kernel table gives, the
reduction of a profiler trace, and the readers on what it gives."""

import json

import pytest

from nsbench import peaks, trace
from nsbench.registry import Registry

H100 = peaks.PEAKS["NVIDIA H100 80GB HBM3"]


def test_b1_at_258_squared_64_sweeps_is_bound_by_operations():
    flops, n_bytes = Registry().work("sor_sweeps").count(
        {"shape": (258, 258), "n": 64})
    assert flops == 11 * 256 * 256 * 64 and n_bytes == 2 * 4 * 258 * 258
    assert flops / H100["f32_flops"] > n_bytes / H100["bytes_per_s"]
    assert peaks.bound_seconds(H100, flops, n_bytes) * 1e6 == \
        pytest.approx(0.689, abs=5e-4)


def test_b2_at_2050_squared_is_bound_by_bytes():
    flops, n_bytes = Registry().work("momentum_rhs").count(
        {"shape": (2050, 2050)})
    assert flops == 122 * 2048 * 2048 and n_bytes == 5 * 4 * 2050 * 2050
    assert n_bytes / H100["bytes_per_s"] > flops / H100["f32_flops"]
    assert peaks.bound_seconds(H100, flops, n_bytes) * 1e6 == \
        pytest.approx(25.09, abs=5e-3)


def x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def synthetic_trace(tmp_path, skew=0.0):
    """One solve of one step: a momentum call (one kernel), a pressure
    solve with two SOR inner calls (one kernel each) and an outer kernel
    between them; times in microseconds."""
    events = [
        x("nsbench.solve", "user_annotation", 0, 1000),
        x("nsbench.step", "user_annotation", 10, 980),
        x("nsbench.momentum", "user_annotation", 20, 10),
        x("cudaLaunchKernel", "cuda_runtime", 25, 2, correlation=1),
        x("momentum_kernel", "kernel", 40, 50, correlation=1),
        x("nsbench.pressure", "user_annotation", 100, 800),
        x("nsbench.sor_inner", "user_annotation", 110, 10),
        x("cudaLaunchKernel", "cuda_runtime", 115, 2, correlation=2),
        x("tile_chunk", "kernel", 130, 100, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 300, 2, correlation=3),
        x("defect", "kernel", 310, 20, correlation=3),
        x("nsbench.sor_inner", "user_annotation", 400, 10),
        x("cudaLaunchKernel", "cuda_runtime", 405, 2, correlation=4),
        x("tile_chunk", "kernel", 420, 100, correlation=4),
        x("cudaStreamSynchronize", "cuda_runtime", 525, 5, correlation=6),
        # launched outside every solve: not in the window
        x("cudaLaunchKernel", "cuda_runtime", 2000, 2, correlation=5),
        x("late", "kernel", 2010, 5, correlation=5),
    ]
    for e in events:  # the device's clock off the host's by `skew`
        if e["cat"] == "kernel":
            e["ts"] += skew
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


@pytest.mark.parametrize("skew", [0.0, -300.0, 1500.0])
def test_trace_reduction_ties_kernels_to_the_spans_that_launched_them(
        tmp_path, skew):
    calls = {"sor_inner": [{"shape": (258, 258), "n": 64},
                           {"shape": (258, 258), "n": 32}],
             "momentum": [{"shape": (258, 258)}]}
    s = trace.summarize(str(synthetic_trace(tmp_path, skew)), calls)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["n_kernels"] == 4
    assert s["busy_s"] == pytest.approx(270e-6)
    inner = s["spans"]["sor_inner"]
    assert [sp["args"]["n"] for sp in inner] == [64, 32]
    assert [sp["kernel_s"] for sp in inner] == pytest.approx([1e-4, 1e-4])
    assert inner[0]["device_end"] == pytest.approx(230e-6)
    assert inner[0]["within"] == ("solve", "step", "pressure")
    assert s["spans"]["pressure"][0]["kernel_s"] == pytest.approx(220e-6)
    assert s["spans"]["step"][0]["n_kernels"] == 4
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["tile_chunk"] == pytest.approx(200e-6) and "late" not in ops
    idle = dict(s["breakdown"]["idle_gaps"])
    # Each idle stretch goes to the innermost span the host was in then.
    assert idle == pytest.approx({"solve": 20e-6, "step": 120e-6,
                                  "momentum": 10e-6, "pressure": 560e-6,
                                  "sor_inner": 20e-6})


def test_readers_on_the_reduced_trace(tmp_path):
    registry = Registry()
    calls = {"sor_inner": [{"shape": (258, 258), "n": 64},
                           {"shape": (258, 258), "n": 32}],
             "momentum": [{"shape": (258, 258)}]}
    s = trace.summarize(str(synthetic_trace(tmp_path)), calls)
    s.update(steps=1, solves=1, layers=registry.layers(),
             bound=lambda op, args: peaks.bound_seconds(
                 H100, *registry.work(op).count(args)))

    def read(name):
        return registry.metric(name).read(s)

    assert read("kernels_per_step") == 4
    assert read("device_idle_pct") == pytest.approx(73.0)
    # pressure 800 us less the inner walls 120 and 120 us
    assert read("outer_ms_per_step") == pytest.approx(0.56)
    bound = sum(peaks.bound_seconds(H100, *registry.work("sor_sweeps")
                                    .count(c)) for c in calls["sor_inner"])
    assert read("sweep_roofline") == pytest.approx(100 * bound / 200e-6)
    assert read("momentum_roofline") == pytest.approx(
        100 * peaks.bound_seconds(H100, *registry.work("momentum_rhs").count(
            {"shape": (258, 258)})) / 50e-6)
    assert read("vcycle_ms") is None and read("dct_ms") is None
