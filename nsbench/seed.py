"""The seeded initial state that both the program and the reference start
from.

A seed draws the coefficients of a stream function on the lowest
``modes`` x ``modes`` sine modes, zero on the walls; the velocity is its
discrete curl on the MAC faces, so every cell's discrete divergence is zero
and the walls' normal velocities vanish.  It is scaled so that the largest
face speed is ``amplitude``: every seed is a distinct problem of the same
size and the same time steps while the amplitude stays well below the lid
speed (the step is then set by the viscous bound).  p and t start at 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def _rng(seed: int) -> np.random.Generator:
    """A generator for any whole number, negative ones included."""
    entropy = [seed] if seed >= 0 else [-seed, 1]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def initial_velocity(prm: Dict, seed: int, amplitude: float, modes: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v): padded (i_max + 2, j_max + 2) float64 fields on `device`,
    zero on every ghost cell."""
    i_max, j_max = prm["i_max"], prm["j_max"]
    dx, dy = prm["a"] / i_max, prm["b"] / j_max
    coef = torch.tensor(_rng(seed).standard_normal((modes, modes)),
                        dtype=torch.float64, device=device)
    m = torch.arange(1, modes + 1, dtype=torch.float64, device=device)

    def sines(n: int) -> torch.Tensor:  # (modes, n + 1) at the cell corners
        return torch.sin(math.pi * m.view(-1, 1)
                         * torch.arange(n + 1, dtype=torch.float64,
                                        device=device).view(1, -1) / n)

    psi = sines(i_max).T @ coef @ sines(j_max)  # (i_max + 1, j_max + 1)
    u = torch.zeros((i_max + 2, j_max + 2), dtype=torch.float64,
                    device=device)
    v = torch.zeros_like(u)
    u[:i_max + 1, 1:j_max + 1] = (psi[:, 1:] - psi[:, :-1]) / dy
    v[1:i_max + 1, :j_max + 1] = -(psi[1:, :] - psi[:-1, :]) / dx
    scale = amplitude / max(float(u.abs().max()), float(v.abs().max()))
    return u * scale, v * scale
