"""Timing utilities (counterpart of navierstokes_parallel_tpu/utils/timing.py).

PyTorch returns before the device finishes, so a host clock around device
work must end at a fence.
"""

from __future__ import annotations

import torch


def device_fence(state_or_tensor) -> float:
    """Wait for the device that holds ``state_or_tensor`` (a State or a
    tensor) to finish, then return its middle element as a float."""
    x = getattr(state_or_tensor, "u", state_or_tensor)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    idx = tuple(s // 2 for s in x.shape)
    return float(x[idx])


def mlups(total_sweeps: int, i_max: int, j_max: int, seconds: float) -> float:
    """Million lattice-site updates per second of the SOR solve."""
    if seconds <= 0:
        return float("inf")
    return total_sweeps * i_max * j_max / seconds / 1e6
