"""Derived-field diagnostics: stream function, vorticity, physics monitors
and the primary vortex (counterpart of
navierstokes_parallel_tpu/utils/diagnostics.py).

The stream function is the standard lid-driven cavity diagnostic: Ghia et
al. 1982 Table III reports the primary vortex's stream-function value and
centre per Reynolds number.  psi is the y-cumulative flux integral of u, so
its interior extremum tests the whole 2-D field, not just two centrelines.

Staggered-grid conventions (src/serial/memory.c:3-26 layout): u[i][j]
lives at (i*dx, (j-0.5)*dy), v[i][j] at ((i-0.5)*dx, j*dy).  The stream
function and vorticity are therefore defined at cell corners (i*dx, j*dy),
where the discrete u = d(psi)/dy and omega = dv/dx - du/dy differences are
exactly centred.

Everything here runs as PyTorch ops on the fields' device; the monitors
return 0-d tensors, which ``monitor_values`` brings to the host in one
transfer.  Every division by a Python number goes through
``ops/stencils.py::div``, so the card divides as the CPU does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import Params
from ..ops.stencils import div

# Ghia et al. (1982) Table III: primary-vortex stream function (psi at the
# vortex centre) and the centre's (x, y) location, per Re.
GHIA_PSI_MIN: Dict[int, float] = {
    100: -0.103423,
    400: -0.113909,
    1000: -0.117929,
    10000: -0.119731,
}
GHIA_VORTEX_CENTER: Dict[int, Tuple[float, float]] = {
    100: (0.6172, 0.7344),
    400: (0.5547, 0.6055),
    1000: (0.5313, 0.5625),
    10000: (0.5117, 0.5333),
}


def stream_function(u: torch.Tensor, params: Params) -> torch.Tensor:
    """psi on the (i_max+1, j_max+1) corner grid, psi(x, 0) = 0 on the
    floor: psi[i, j] = sum_{k<=j} u[i][k] * dy, the exact discrete
    antiderivative of the staggered u (u[i][j] spans corners (i, j-1) and
    (i, j)).  For a discretely divergence-free field this is
    path-independent up to the projection residual."""
    inner = u[: params.i_max + 1, 1: params.j_max + 1] * params.dy
    return torch.nn.functional.pad(torch.cumsum(inner, dim=1), (1, 0))


def vorticity(u: torch.Tensor, v: torch.Tensor,
              params: Params) -> torch.Tensor:
    """omega = dv/dx - du/dy on the (i_max+1, j_max+1) corner grid: both
    differences of the staggered components are exactly centred at the
    corners (wall-ring corners read one ghost value each, which carry the
    reflected tangential velocities of the boundary conditions)."""
    ni, nj = params.i_max, params.j_max
    dvdx = div(v[1: ni + 2, : nj + 1] - v[: ni + 1, : nj + 1], params.dx)
    dudy = div(u[: ni + 1, 1: nj + 2] - u[: ni + 1, : nj + 1], params.dy)
    return dvdx - dudy


class Monitors(NamedTuple):
    """Scalar physics monitors of one state (0-d tensors on its device)."""
    kinetic_energy: torch.Tensor   # 0.5 * integral of |velocity|^2
    enstrophy: torch.Tensor        # 0.5 * integral of vorticity^2
    max_divergence: torch.Tensor   # worst cell continuity violation
    psi_min: torch.Tensor          # primary-vortex strength


def physics_monitors(u: torch.Tensor, v: torch.Tensor,
                     params: Params) -> Monitors:
    """The history's monitor columns, on the fields' device:

    * kinetic energy  0.5*sum(u_c^2 + v_c^2)*dx*dy over cell centres (face
      velocities averaged to centres): bounded by the lid's scale, it
      plateaus at the steady state;
    * enstrophy       0.5*sum(omega^2)*dx*dy over interior corners: a
      blow-up detector;
    * max_divergence  max |du/dx + dv/dy| over cells: how well this step's
      projection enforced continuity; it jumps when SOR hits max_it;
    * psi_min         the primary-vortex strength (Ghia Table III).
    """
    ni, nj = params.i_max, params.j_max
    dxdy = params.dx * params.dy

    u_c = 0.5 * (u[0: ni, 1: nj + 1] + u[1: ni + 1, 1: nj + 1])
    v_c = 0.5 * (v[1: ni + 1, 0: nj] + v[1: ni + 1, 1: nj + 1])
    ke = 0.5 * torch.sum(u_c * u_c + v_c * v_c) * dxdy

    # Interior corners only: the wall ring's one-sided ghost differences
    # would count the lid's velocity jump as an O(1/dy) vorticity band.
    om = vorticity(u, v, params)[1:-1, 1:-1]
    ens = 0.5 * torch.sum(om * om) * dxdy

    divergence = (div(u[1: ni + 1, 1: nj + 1] - u[0: ni, 1: nj + 1],
                      params.dx)
                  + div(v[1: ni + 1, 1: nj + 1] - v[1: ni + 1, 0: nj],
                        params.dy))
    max_div = torch.max(torch.abs(divergence))

    psi_min = torch.min(stream_function(u, params))
    return Monitors(kinetic_energy=ke, enstrophy=ens,
                    max_divergence=max_div, psi_min=psi_min)


def monitor_values(m: Monitors) -> Tuple[float, float, float, float]:
    """The four monitors as Python floats, in one device-to-host copy."""
    return tuple(torch.stack(tuple(m)).tolist())


class PrimaryVortex(NamedTuple):
    psi: float   # stream-function value at the vortex centre
    x: float     # centre location
    y: float


def primary_vortex(psi, params: Params) -> PrimaryVortex:
    """The cavity's primary (clockwise) vortex: the minimum of psi and its
    corner-grid location (Ghia Table III's quantity)."""
    psi = torch.as_tensor(psi)
    flat = int(torch.argmin(psi))
    i, j = divmod(flat, psi.shape[1])
    return PrimaryVortex(psi=float(psi[i, j]), x=float(i * params.dx),
                         y=float(j * params.dy))


class VortexErrors(NamedTuple):
    psi_rel_err: float    # |psi_min - Ghia| / |Ghia|
    center_dist: float    # Euclidean distance of the centres


def ghia_vortex_errors(u, params: Params, Re: int) -> VortexErrors:
    """Deviation of the computed primary vortex from Ghia Table III."""
    if Re not in GHIA_PSI_MIN:
        raise ValueError(
            f"no Ghia vortex data for Re={Re} (have {list(GHIA_PSI_MIN)})")
    vort = primary_vortex(stream_function(torch.as_tensor(u), params), params)
    ref_psi = GHIA_PSI_MIN[Re]
    rx, ry = GHIA_VORTEX_CENTER[Re]
    return VortexErrors(
        psi_rel_err=abs(vort.psi - ref_psi) / abs(ref_psi),
        center_dist=float(np.hypot(vort.x - rx, vort.y - ry)),
    )
