"""One member of an ensemble through the plain cavity reference
(``cavity.solve``, unchanged) on a device, its result brought to the host:
what each process the ensemble family spawns runs.  The reference is bound
by the host's launches (~80 us a half-sweep at 256^2, none of it device
time), so members solved in processes of their own take the time of one."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import cavity


def solve_on(device: str, u0: torch.Tensor, v0: torch.Tensor, prm: Dict,
             pressure: str, check_every: int,
             store: Optional[Callable] = None) -> cavity.Result:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = cavity.solve(u0.to(device), v0.to(device), prm, pressure,
                          check_every, store=store)
    return result._replace(u=result.u.cpu(), v=result.v.cpu(),
                           p=result.p.cpu())
