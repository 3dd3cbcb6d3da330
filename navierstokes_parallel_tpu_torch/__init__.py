"""navierstokes_parallel_tpu_torch — the PyTorch + CUDA port of
navierstokes_parallel_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference: module names mirror it
(config, grid, ops/stencils, ops/boundary, ops/momentum, ops/sor, ops/mg,
solver, cli), and its Pallas TPU kernels become hand-written CUDA kernels
under ops/cuda/ (sources in csrc/), each with a plain PyTorch twin that the
CPU runs.  This package imports torch and numpy, never jax.

The port covers the lid-driven cavity (problems 1-2), the plane channel
(3) and the free-slip Taylor-Green box (4), with or without flag-field
obstacles, by explicit Euler or Adams-Bashforth 2, with every pressure
method of the JAX package; natural convection (5, models/convection.py)
and free surfaces with marker particles (6, models/freesurface.py); on
one device, on the sharded backend (parallel/sharded.py) and on the gspmd
backend (parallel/gspmd.py: one device's program on the same blocks).
Gradients through the flow (diff.py) and ensembles
(solver.solve_ensemble) run on one device and on a mesh.  ROADMAP.md
lists what is left out.
"""

from .config import Params
from .grid import State, allocate_state, interior, state_from_numpy
from .solver import (AB2State, SolveStats, StepDiagnostics, ab2_init,
                     center_values, solve, solve_ab2, step, step_ab2)

__version__ = "0.1.0"

__all__ = [
    "Params",
    "State",
    "allocate_state",
    "interior",
    "state_from_numpy",
    "AB2State",
    "SolveStats",
    "StepDiagnostics",
    "ab2_init",
    "center_values",
    "solve",
    "solve_ab2",
    "step",
    "step_ab2",
]
