"""Staggered (MAC) grid state.

PyTorch counterpart of ``navierstokes_parallel_tpu/grid.py``.  Every field
is a uniform (i_max+2, j_max+2) padded tensor with one ghost layer on each
side; axis 0 is x (index i), axis 1 is y (index j):

  - ``p[i, j]``  pressure at cell centers
  - ``u[i, j]``  x-velocity at the *right* edge of cell (i, j)
  - ``v[i, j]``  y-velocity at the *top*  edge of cell (i, j)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import Params


class State(NamedTuple):
    """Solver state.  u, v, p are padded fields on one device; ``t`` is a
    0-d tensor of the state's dtype on that device (so time advances
    without a host round trip); ``n`` counts completed steps."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    n: int


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            f"(pass device='cpu' to run the plain PyTorch path)")
    return device


def allocate_state(params: Params, device, dtype=None) -> State:
    """Zero-initialized state (the reference calloc-zeros all grids)."""
    device = resolve_device(device)
    dtype = dtype or params.torch_dtype

    def zeros():
        return torch.zeros(params.shape, dtype=dtype, device=device)

    return State(u=zeros(), v=zeros(), p=zeros(),
                 t=torch.zeros((), dtype=dtype, device=device), n=0)


def state_from_numpy(u, v, p, t=0.0, n=0, *, device,
                     dtype=torch.float32) -> State:
    """State from host arrays, e.g. a JAX state passed through numpy."""
    device = resolve_device(device)

    def field(x):  # a copy: the state never aliases the caller's array
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return State(u=field(u), v=field(v), p=field(p),
                 t=torch.tensor(float(np.asarray(t)), dtype=dtype,
                                device=device),
                 n=int(n))


def interior(x: torch.Tensor) -> torch.Tensor:
    """The (i_max, j_max) interior view of a padded field."""
    return x[1:-1, 1:-1]
