"""Checkpoint / resume (counterpart of
navierstokes_parallel_tpu/utils/checkpoint.py).

The full solver state -- u, v, p, t, n -- goes to an ``.npz`` under the
JAX package's keys and dtypes (fields and t in the state's dtype, n as
int32), so a checkpoint written by either package resumes in the other
(``np.load`` reads the JAX package's compressed archives and the port's
plain ones alike).  The port does not compress: zlib took 2.5 s for one
2048^2 state on the host of an H100 machine, to save 6 % of its 50 MB
(chip_smoke.py's protocol phase; PERF.md).  ``load_checkpoint`` checks the grid against the configuration,
so a checkpoint cannot resume onto another resolution.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Params
from ..grid import State, host_array, resolve_device


def save_checkpoint(path: str, state: State) -> None:
    """Write `state` (fields on any device) to `path` (numpy appends .npz
    when the name lacks it, as for the JAX package)."""
    np.savez(path, u=host_array(state.u), v=host_array(state.v),
             p=host_array(state.p), t=host_array(state.t),
             n=np.asarray(int(state.n), np.int32))


def load_checkpoint(path: str, params: Params, device) -> State:
    """The checkpoint's State on `device`, in the configuration's dtype.
    Raises ValueError for a grid that is not the configuration's, and
    NotImplementedError for a checkpoint of problem 5 or 6 (the temperature
    field or the marker particles are not ported: ROADMAP A8)."""
    with np.load(path, allow_pickle=False) as data:
        extra = sorted({"T", "px", "py", "pactive"} & set(data.files))
        if extra:
            raise NotImplementedError(
                f"checkpoint {path!r} carries {', '.join(extra)} (a problem "
                f"5 or 6 run); thermal and free-surface states are not "
                f"ported: ROADMAP A8")
        u, v, p = data["u"], data["v"], data["p"]
        t, n = data["t"], data["n"]
    if p.shape != params.shape:
        raise ValueError(
            f"checkpoint grid {p.shape} does not match config grid "
            f"{params.shape}")
    device = resolve_device(device)
    dtype = params.torch_dtype

    def field(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return State(u=field(u), v=field(v), p=field(p), t=field(t), n=int(n))
