"""The precision control comes out not correct: the reference in the
program's place with every field the configuration keeps in float32
stored in bfloat16, held to the cell's limits.  On the CPU at 24^2; on the
card at each cell's own size, on three seeds (run there with
``python -m pytest nsbench/tests -m gpu``)."""

import pytest
import torch

from nsbench import calibrate, compare, harness
from nsbench.registry import Registry


@pytest.mark.parametrize("workload", ["tiny.pallas_sor", "tiny.fft",
                                      "tiny.mg"])
def test_the_control_fails_at_24_squared(tiny, workload):
    cell = harness.Cell(tiny, workload)
    readings = calibrate.control_readings(cell, 7, torch.device("cpu"))
    correct, _ = compare.verdict(readings, cell.limits)
    assert not correct, readings


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["cavity256.sor", "cavity2048.mg",
                                      "cavity256.sor_k2048",
                                      "cavity2048.fft"])
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    registry = Registry()
    if workload not in {c["name"] for c in registry.benchmark["workloads"]}:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    cell = harness.Cell(registry, workload)
    for seed in (101, 2 ** 31 + 202, 303):
        readings = calibrate.control_readings(cell, seed,
                                              torch.device("cuda"))
        assert not compare.verdict(readings, cell.limits)[0], readings
