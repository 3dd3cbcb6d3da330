"""Checkpoint / resume (counterpart of
navierstokes_parallel_tpu/utils/checkpoint.py).

The full solver state -- u, v, p, t, n, and T of a thermal (problem 5)
state -- goes to an ``.npz`` under the JAX package's keys and dtypes (fields and t in the state's dtype, n as
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
    """Write `state` (a State or a ThermalState, fields on any device) to
    `path` (numpy appends .npz when the name lacks it, as for the JAX
    package)."""
    fields = dict(u=host_array(state.u), v=host_array(state.v),
                  p=host_array(state.p), t=host_array(state.t),
                  n=np.asarray(int(state.n), np.int32))
    if hasattr(state, "T"):
        fields["T"] = host_array(state.T)
    np.savez(path, **fields)


def load_checkpoint(path: str, params: Params, device):
    """The checkpoint's state on `device`, in the configuration's dtype: a
    ThermalState for problem 5 (the checkpoint must carry T: a thermal run
    cannot resume from an isothermal checkpoint), else a State.  Raises
    ValueError for a grid that is not the configuration's or an isothermal
    checkpoint of problem 5, and NotImplementedError for a checkpoint or a
    configuration of problem 6 (the marker particles are not ported:
    ROADMAP A8).  A problem 1-4 run resumed from a thermal checkpoint drops
    T with a warning, as in the JAX package."""
    with np.load(path, allow_pickle=False) as data:
        particles = sorted({"px", "py", "pactive"} & set(data.files))
        if particles or params.problem == 6:
            raise NotImplementedError(
                f"checkpoint {path!r} of a problem 6 run (free surfaces, "
                f"the marker particles) is not ported: ROADMAP A8")
        u, v, p = data["u"], data["v"], data["p"]
        t, n = data["t"], data["n"]
        temp = data["T"] if "T" in data.files else None
    if p.shape != params.shape:
        raise ValueError(
            f"checkpoint grid {p.shape} does not match config grid "
            f"{params.shape}")
    device = resolve_device(device)
    dtype = params.torch_dtype

    def field(x):
        return torch.tensor(x, dtype=dtype, device=device)

    base = State(u=field(u), v=field(v), p=field(p), t=field(t), n=int(n))
    if params.problem == 5:
        if temp is None:
            raise ValueError(
                f"checkpoint {path!r} has no temperature field — it was "
                "written by an isothermal run and cannot resume problem 5")
        from ..models.convection import ThermalState

        return ThermalState(u=base.u, v=base.v, p=base.p, T=field(temp),
                            t=base.t, n=base.n)
    if temp is not None:
        print(f"warning: checkpoint {path!r} carries T that problem "
              f"{params.problem} will discard — resuming as an isothermal "
              "single-phase run", file=sys.stderr)
    return base
