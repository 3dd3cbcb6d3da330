"""navierstokes_parallel_tpu_torch — the PyTorch + CUDA port of
navierstokes_parallel_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference: module names mirror it
(config, grid, ops/stencils, ops/boundary, ops/momentum, ops/sor, solver,
cli), and its Pallas TPU kernels become hand-written CUDA kernels under
ops/cuda/ (sources in csrc/), each with a plain PyTorch twin that the CPU
runs.  This package imports torch and numpy, never jax.

The port covers the lid-driven cavity main path (problems 1-2, f32 state,
f64-refined red-black SOR); ROADMAP.md lists what is still to port.
"""

from .config import Params
from .grid import State, allocate_state, interior, state_from_numpy
from .solver import SolveStats, StepDiagnostics, center_values, solve, step

__version__ = "0.1.0"

__all__ = [
    "Params",
    "State",
    "allocate_state",
    "interior",
    "state_from_numpy",
    "SolveStats",
    "StepDiagnostics",
    "center_values",
    "solve",
    "step",
]
