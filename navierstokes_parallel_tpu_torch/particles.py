"""Marker particles: pathlines, streaklines and the free surface's markers.

PyTorch counterpart of ``navierstokes_parallel_tpu/particles.py`` (Griebel
et al. 1998 sect. 3.4, eq. 4.1-4.3):

  * a particle set is a fixed-capacity ``ParticleSet`` of coordinate
    tensors; injection is a ring buffer over the capacity, and a particle
    that leaves the domain or enters an obstacle cell deactivates and
    freezes at its last position (a mask, shapes never change);
  * staggered bilinear interpolation is four flat gathers per field
    (``torch.take`` on the flattened field, indices clamped first);
  * dx/dt = u(x, t) by explicit Euler or Heun (the default).

Positions default to float32 (``init_particles``); every arithmetic step is
the JAX module's, in its order, and a division by the mesh width goes
through ``ops/stencils.py::div`` (CUDA divides by a host scalar as a
multiply by its reciprocal).  No kernel stands behind this module: the
gathers and updates are plain PyTorch on every device, as they are jnp in
the JAX package.

``solve_with_particles`` steps the flow with ``solver.Stepper`` (so any
pressure method, and on the card the solver's kernels) and advects the
set through the end-of-step field after each step; ``trace_particles`` is
the same loop recording the numpy history that the JAX package's
``utils/plotting.py::plot_particle_paths`` reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import Params
from .grid import State, allocate_state, resolve_device
from .ops import obstacles
from .ops import stencils as st
from .solver import SolveStats, Stepper


class ParticleSet(NamedTuple):
    """Fixed-capacity particle state: (capacity,) tensors on one device."""

    x: torch.Tensor       # x position (frozen once inactive)
    y: torch.Tensor
    active: torch.Tensor  # bool: advected (and plotted) iff True


def init_particles(points, capacity: Optional[int] = None,
                   dtype=torch.float32, *, device=None) -> ParticleSet:
    """Particle set from an (N, 2) array of seed positions on `device`;
    `capacity` (>= N) reserves inactive slots for later ``inject`` calls."""
    if device is None:
        raise ValueError("init_particles needs a device")
    device = resolve_device(device)
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    n = pts.shape[0]
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} seed particles")
    x = np.zeros(cap)
    y = np.zeros(cap)
    active = np.zeros(cap, bool)
    x[:n], y[:n] = pts[:, 0], pts[:, 1]
    active[:n] = True
    return ParticleSet(x=torch.tensor(x, dtype=dtype, device=device),
                       y=torch.tensor(y, dtype=dtype, device=device),
                       active=torch.tensor(active, device=device))


def particle_set_from_numpy(x, y, active, *, device) -> ParticleSet:
    """A ``ParticleSet`` from host arrays (e.g. a JAX set through numpy),
    keeping their dtype."""
    device = resolve_device(device)
    return ParticleSet(x=torch.tensor(np.asarray(x), device=device),
                       y=torch.tensor(np.asarray(y), device=device),
                       active=torch.tensor(np.asarray(active, bool),
                                           device=device))


def grid_of_particles(params: Params, nx: int, ny: int,
                      capacity: Optional[int] = None, *,
                      device=None) -> ParticleSet:
    """An nx x ny uniform seed lattice over the interior (cell-centre
    aligned when nx == i_max)."""
    xs = (np.arange(nx) + 0.5) * (params.a / nx)
    ys = (np.arange(ny) + 0.5) * (params.b / ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return init_particles(np.stack([gx.ravel(), gy.ravel()], -1), capacity,
                          device=device)


def _gather(field: torch.Tensor, i: torch.Tensor,
            j: torch.Tensor) -> torch.Tensor:
    """field[i, j] for index vectors, as one flat gather."""
    return torch.take(field, i * field.shape[1] + j)


def _bilinear(field, gx, gy, i_hi: int, j_hi: int):
    """Bilinear interpolation at grid coordinates (gx, gy) of a node family
    at integer grid coordinates; node indices are clamped to
    [0, i_hi] x [0, j_hi], so evaluation clamps to the covered strip."""
    i = torch.clamp(torch.floor(gx).to(torch.int64), 0, i_hi - 1)
    j = torch.clamp(torch.floor(gy).to(torch.int64), 0, j_hi - 1)
    tx = torch.clamp(gx - i, 0.0, 1.0)
    ty = torch.clamp(gy - j, 0.0, 1.0)
    f00 = _gather(field, i, j)
    f10 = _gather(field, i + 1, j)
    f01 = _gather(field, i, j + 1)
    f11 = _gather(field, i + 1, j + 1)
    return ((1 - tx) * ((1 - ty) * f00 + ty * f01)
            + tx * ((1 - ty) * f10 + ty * f11))


def interp_uv(x: torch.Tensor, y: torch.Tensor, u: torch.Tensor,
              v: torch.Tensor, params: Params
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staggered velocity at arbitrary points (Griebel eq. 4.2/4.3):
    u[i, j] sits at (i dx, (j - 1/2) dy), v[i, j] at ((i - 1/2) dx, j dy),
    ghost rows included (they carry the wall reflections)."""
    up = _bilinear(u, st.div(x, params.dx), st.div(y, params.dy) + 0.5,
                   params.i_max, params.j_max + 1)
    vp = _bilinear(v, st.div(x, params.dx) + 0.5, st.div(y, params.dy),
                   params.i_max + 1, params.j_max)
    return up, vp


def cell_indices(x: torch.Tensor, y: torch.Tensor, params: Params):
    """(ci, cj): the padded index of the cell holding each point, clamped
    to the interior."""
    ci = torch.clamp(torch.floor(st.div(x, params.dx)).to(torch.int64) + 1,
                     1, params.i_max)
    cj = torch.clamp(torch.floor(st.div(y, params.dy)).to(torch.int64) + 1,
                     1, params.j_max)
    return ci, cj


def _in_domain(x, y, params: Params) -> torch.Tensor:
    """True strictly inside the domain and, with obstacles, in a fluid
    cell."""
    ok = (x > 0.0) & (x < params.a) & (y > 0.0) & (y < params.b)
    if params.obstacles:
        fluid = obstacles.device_fluid_mask(params, x.device)
        ok = ok & _gather(fluid, *cell_indices(x, y, params))
    return ok


def advect(pset: ParticleSet, u: torch.Tensor, v: torch.Tensor, dt,
           params: Params, *, method: str = "heun") -> ParticleSet:
    """One advection step of every active particle through (u, v):
    "euler" (Griebel eq. 4.1) or "heun" (one predictor interpolation more,
    second order).  Inactive particles stay frozen; a particle that steps
    out of the domain or into an obstacle cell deactivates at its pre-step
    position.  Returns a new set in the positions' dtype."""
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown particle integrator {method!r}")
    x, y = pset.x, pset.y
    k1u, k1v = interp_uv(x, y, u, v, params)
    if isinstance(dt, torch.Tensor):
        # The JAX package promotes dt with the velocities whatever their
        # ranks; PyTorch would let a 0-d dt take the vector's dtype.
        dt = dt.to(torch.promote_types(dt.dtype, k1u.dtype))
    if method == "euler":
        xn = x + dt * k1u
        yn = y + dt * k1v
    else:
        xm = x + dt * k1u
        ym = y + dt * k1v
        k2u, k2v = interp_uv(xm, ym, u, v, params)
        xn = x + dt * 0.5 * (k1u + k2u)
        yn = y + dt * 0.5 * (k1v + k2v)
    live = pset.active & _in_domain(xn, yn, params)
    xn = torch.where(live, xn, x)
    yn = torch.where(live, yn, y)
    return ParticleSet(x=xn.to(x.dtype), y=yn.to(y.dtype), active=live)


def inject(pset: ParticleSet, points, cursor: int
           ) -> Tuple[ParticleSet, int]:
    """Write len(points) new active particles into the ring buffer at
    `cursor`, overwriting the oldest slots; returns (new set, cursor + K).
    The streakline source (Griebel sect. 3.4.2) with a fixed capacity."""
    pts = torch.as_tensor(np.asarray(points, np.float64).reshape(-1, 2),
                          dtype=pset.x.dtype, device=pset.x.device)
    k = pts.shape[0]
    cap = pset.x.shape[0]
    idx = (cursor + torch.arange(k, device=pset.x.device)) % cap
    x, y, active = pset.x.clone(), pset.y.clone(), pset.active.clone()
    x[idx] = pts[:, 0]
    y[idx] = pts[:, 1]
    active[idx] = True
    return ParticleSet(x=x, y=y, active=active), cursor + k


def _snapshot(pset: ParticleSet) -> np.ndarray:
    """(capacity, 3) numpy frame of (x, y, active)."""
    return np.stack([pset.x.cpu().numpy(), pset.y.cpu().numpy(),
                     pset.active.cpu().numpy().astype(np.float32)], -1)


def trace_particles(params: Params, pset: ParticleSet,
                    state: Optional[State] = None, *,
                    pressure_method: str = "rb_sor", method: str = "heun",
                    inject_points=None, inject_every: int = 0,
                    record_every: int = 1, max_steps: int = 0):
    """Integrate flow and particles to t >= T (or `max_steps` steps when
    > 0) from `state` (zeros on the set's device if None): each step is
    ``solver.Stepper``'s, then the set advects through the end-of-step
    field with the step's dt; `inject_points` (K, 2) are injected every
    `inject_every`-th step.  Returns (state, stats, set, history), history
    a (frames, capacity, 3) numpy array of (x, y, active), frame 0 the
    initial set, then one every `record_every` steps (0: the initial set
    only)."""
    if state is None:
        state = allocate_state(params, pset.x.device)
    if inject_points is not None and inject_every < 1:
        raise ValueError("inject_every must be >= 1 with inject_points")
    stepper = Stepper(params, state, pressure_method)
    T = float(torch.tensor(params.T, dtype=params.torch_dtype))
    cursor = steps = iters = fails = 0
    last = 0.0
    frames = [_snapshot(pset)]
    while not 0 < max_steps <= steps and stepper.t < T:
        diag = stepper.step()
        st_ = stepper.state()
        pset = advect(pset, st_.u, st_.v, diag.dt, params, method=method)
        steps += 1
        if inject_points is not None and steps % inject_every == 0:
            pset, cursor = inject(pset, inject_points, cursor)
        if record_every and steps % record_every == 0:
            frames.append(_snapshot(pset))
        iters += diag.sor_iterations
        fails += 0 if diag.sor_converged else 1
        last = diag.sor_res_norm
    stats = SolveStats(steps=steps, total_sor_iterations=iters,
                       sor_failures=fails, last_res_norm=last)
    return stepper.state(), stats, pset, np.stack(frames)


def solve_with_particles(params: Params, pset: ParticleSet,
                         state: Optional[State] = None, *,
                         pressure_method: str = "rb_sor",
                         method: str = "heun", inject_points=None,
                         inject_every: int = 0, max_steps: int = 0
                         ) -> Tuple[State, SolveStats, ParticleSet]:
    """Co-integrate flow and particles to t >= T: the flow steps as
    ``solver.solve``'s (same kernels, same bits), the set advects after
    each step.  The JAX package's one on-device while_loop is the host
    loop of ``trace_particles`` here; returns (state, stats, set)."""
    state, stats, pset, _ = trace_particles(
        params, pset, state, pressure_method=pressure_method, method=method,
        inject_points=inject_points, inject_every=inject_every,
        record_every=0, max_steps=max_steps)
    return state, stats, pset
