"""Port Params vs JAX Params: the .in parser, validation, derived values."""

import dataclasses
import glob
import os

import pytest
import torch

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu_torch.config import Params

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "configs", "*.in")))


def test_configs_found():
    assert len(CONFIGS) >= 8


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_from_file_matches_jax(path):
    port = Params.from_file(path)
    ref = JaxParams.from_file(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.to_text() == ref.to_text()
    assert (port.dx, port.dy, port.shape) == (ref.dx, ref.dy, ref.shape)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_from_mapping_round_trips(path):
    ref = JaxParams.from_file(path)
    port = Params.from_mapping(dataclasses.asdict(ref))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert Params.from_mapping(dataclasses.asdict(port)) == port


def test_from_mapping_rejects_unknown_field():
    with pytest.raises(TypeError):
        Params.from_mapping({"i_max": 8, "no_such_field": 1})


def test_optional_lines_problem_6():
    lines = JaxParams(problem=6, i_max=8, j_max=8).to_text().splitlines()
    lines = lines[:15] + ["0.1", "0.4", "0.0", "0.3"]
    port = Params.from_lines(lines)
    ref = JaxParams.from_lines(lines)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.fluid_x0, port.fluid_x1) == (0.1, 0.4)


def test_overrides_and_torch_dtype(tmp_path):
    path = tmp_path / "c.in"
    JaxParams(i_max=12, j_max=10).to_file(str(path))
    port = Params.from_file(str(path), dtype="float64", sor_refine_every=7)
    assert port.torch_dtype == torch.float64
    assert port.sor_refine_every == 7
    assert Params().torch_dtype == torch.float32
    assert port.replace(i_max=20).shape == (22, 12)


@pytest.mark.parametrize("bad", [
    {"problem": 9}, {"i_max": 1}, {"omega": 2.0}, {"max_it": 0},
    {"sor_inner_dtype": "float16"}, {"outer_precision": "double"},
    {"obstacles": ((0, 1, 1, 1),)},
], ids=lambda d: next(iter(d)))
def test_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        JaxParams(**bad)
    with pytest.raises(ValueError):
        Params(**bad)


def test_short_file_rejected():
    with pytest.raises(ValueError, match="lines"):
        Params.from_lines(["1", "1", "8"])
