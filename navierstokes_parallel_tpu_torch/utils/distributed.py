"""The process group of the sharded backend (parallel/).

The JAX package runs its sharded solve as one SPMD program over a device
mesh; the port runs one process per shard under ``torch.distributed``:
NCCL for CUDA devices, gloo for the CPU.

  * Under ``torchrun`` (``WORLD_SIZE`` in the environment) the group comes
    from the ``env://`` rendezvous, and a CUDA rank computes on
    ``cuda:LOCAL_RANK``.
  * Without ``WORLD_SIZE`` it is a one-rank group on an in-process
    ``dist.HashStore()``: no network, no port.
  * A group that exists already (a caller's, or a test's multi-process
    gloo group) is reused and left alone; a group made here is destroyed
    when the block ends, so one process can run several solves.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The device this rank computes on: an unindexed CUDA device becomes
    ``cuda:LOCAL_RANK`` (0 without torchrun); any other device is kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def default_device() -> torch.device:
    """The device of the initialised group's ranks: the current CUDA device
    under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@contextlib.contextmanager
def process_group(device):
    """Run the block inside a default process group for ``device``; yields
    the device this rank computes on (``rank_device``)."""
    device = rank_device(device)
    if dist.is_initialized():
        yield device
        return
    # NCCL is bound to the rank's card at once (device_id), so collectives
    # and barriers need not guess it.
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    backend = backend_for(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    try:
        yield device
    finally:
        dist.destroy_process_group()
