"""Timing utilities (counterpart of navierstokes_parallel_tpu/utils/timing.py).

PyTorch returns before the device finishes, so a host clock around device
work must end at a fence.  ``profiler_trace`` is the counterpart of the JAX
package's ``jax.profiler`` capture.  The JAX module's bandwidth and VPU
probes and its roofline helpers are not here: the VPU is a TPU unit, and
a bandwidth probe belongs to the port's bench arm (ROADMAP).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def device_fence(state_or_tensor) -> float:
    """Wait for the device that holds ``state_or_tensor`` (a State or a
    tensor) to finish, then return its middle element as a float."""
    x = getattr(state_or_tensor, "u", state_or_tensor)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    idx = tuple(s // 2 for s in x.shape)
    return float(x[idx])


class Timer:
    """Wall timer; ``stop(fence_on=...)`` waits for the device first."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence_on=None) -> float:
        if fence_on is not None:
            device_fence(fence_on)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def __exit__(self, *exc):
        if self._t0 is not None and self.elapsed == 0.0:
            self.elapsed = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Record a torch.profiler trace of the block (the CPU, and CUDA when
    a card is present) into `log_dir`, one ``*.pt.trace.json`` per block,
    readable by TensorBoard or chrome://tracing; yields `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler):
        yield log_dir


def mlups(total_sweeps: int, i_max: int, j_max: int, seconds: float) -> float:
    """Million lattice-site updates per second of the SOR solve."""
    if seconds <= 0:
        return float("inf")
    return total_sweeps * i_max * j_max / seconds / 1e6
