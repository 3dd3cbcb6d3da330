"""Timing utilities (counterpart of navierstokes_parallel_tpu/utils/timing.py).

PyTorch returns before the device finishes, so a host clock around device
work must end at a fence.  ``profiler_trace`` is the counterpart of the JAX
package's ``jax.profiler`` capture, and the one exporter of the program's
spans.  The JAX module's bandwidth and VPU probes and its roofline helpers
are not here: the VPU is a TPU unit, and a bandwidth probe belongs to the
benchmark (``nsbench/``).

Spans and counters mark the step's host work where it happens (the time
loop, the pressure outer, the V-cycle).  ``span(name)`` is a profiler range
named ``nsp.<name>`` while a profiler records, and a shared null context
otherwise, so that a span costs one flag check when nothing traces.
``count(name, n)`` adds to one table of ever-increasing ints, always on;
``counts()`` is a snapshot of it, and a reader takes the difference of two.
Every kernel launch is counted there (``launch.*``), every outer pass and
V-cycle, and every host read of a device value on the step path
(``sync.*``).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "nsp."
_NULL_SPAN = contextlib.nullcontext()
_COUNTS: Dict[str, int] = defaultdict(int)


def span(name: str):
    """A context manager around one piece of the program's host work: a
    ``torch.profiler.record_function`` range named ``nsp.<name>`` while a
    profiler records, else the same null context every time."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NULL_SPAN


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """A snapshot of every counter (name -> total since the process began)."""
    return dict(_COUNTS)


def device_fence(state_or_tensor) -> float:
    """Wait for the device that holds ``state_or_tensor`` (a State or a
    tensor) to finish, then return its middle element as a float."""
    x = getattr(state_or_tensor, "u", state_or_tensor)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    idx = tuple(s // 2 for s in x.shape)
    return float(x[idx])


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
