"""Checkpoint / resume (counterpart of
navierstokes_parallel_tpu/utils/checkpoint.py).

The full solver state -- u, v, p, t, n, T of a thermal (problem 5)
state, and the marker particles of a free-surface (problem 6) view as px,
py and pactive -- goes to an ``.npz`` under the JAX package's keys and dtypes (fields and t in the state's dtype, n as
int32), so a checkpoint written by either package resumes in the other
(``np.load`` reads the JAX package's compressed archives and the port's
plain ones alike).  The port does not compress: zlib took 2.5 s for one
2048^2 state on the host of an H100 machine, to save 6 % of its 50 MB
(chip_smoke.py's protocol phase; PERF.md).  ``load_checkpoint`` checks the grid against the configuration,
so a checkpoint cannot resume onto another resolution.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Params
from ..grid import State, host_array, resolve_device


def save_checkpoint(path: str, state) -> None:
    """Write `state` (a State, a ThermalState or a free-surface view, on
    any device) to `path` (numpy appends .npz when the name lacks it, as
    for the JAX package)."""
    fields = dict(u=host_array(state.u), v=host_array(state.v),
                  p=host_array(state.p), t=host_array(state.t),
                  n=np.asarray(int(state.n), np.int32))
    if hasattr(state, "T"):
        fields["T"] = host_array(state.T)
    if hasattr(state, "pset"):
        fields["px"] = host_array(state.pset.x)
        fields["py"] = host_array(state.pset.y)
        fields["pactive"] = host_array(state.pset.active)
    np.savez(path, **fields)


def load_checkpoint(path: str, params: Params, device):
    """The checkpoint's state on `device`, fields in the configuration's
    dtype: a ThermalState for problem 5 (the checkpoint must carry T), a
    ``FreeSurfaceState`` for problem 6 (it must carry the particles, which
    keep their saved dtype), else a State.  Raises ValueError for a grid
    that is not the configuration's or a checkpoint without the field its
    problem needs, as the JAX package does; a problem 1-4 run resumed from
    a checkpoint with T or particles drops them with a warning."""
    with np.load(path, allow_pickle=False) as data:
        u, v, p = data["u"], data["v"], data["p"]
        t, n = data["t"], data["n"]
        temp = data["T"] if "T" in data.files else None
        pset = ((data["px"], data["py"], data["pactive"])
                if "px" in data.files else None)
    if p.shape != params.shape:
        raise ValueError(
            f"checkpoint grid {p.shape} does not match config grid "
            f"{params.shape}")
    device = resolve_device(device)
    dtype = params.torch_dtype

    def field(x):
        return torch.tensor(x, dtype=dtype, device=device)

    base = State(u=field(u), v=field(v), p=field(p), t=field(t), n=int(n))
    if params.problem == 6:
        if pset is None:
            raise ValueError(
                f"checkpoint {path!r} has no particle set — it was written "
                "by a non-free-surface run and cannot resume problem 6")
        from ..models.freesurface import FreeSurfaceState
        from ..particles import particle_set_from_numpy

        return FreeSurfaceState(state=base, pset=particle_set_from_numpy(
            *pset, device=device))
    if params.problem == 5:
        if temp is None:
            raise ValueError(
                f"checkpoint {path!r} has no temperature field — it was "
                "written by an isothermal run and cannot resume problem 5")
        from ..models.convection import ThermalState

        return ThermalState(u=base.u, v=base.v, p=base.p, T=field(temp),
                            t=base.t, n=base.n)
    dropped = [name for name, extra in (("T", temp), ("particles", pset))
               if extra is not None]
    if dropped:
        print(f"warning: checkpoint {path!r} carries {'/'.join(dropped)} "
              f"that problem {params.problem} will discard — resuming as "
              "an isothermal single-phase run", file=sys.stderr)
    return base
