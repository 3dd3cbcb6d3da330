"""Kármán vortex street, flow past a cylinder (problem 3 + flag-field
obstacle): the port's copy of navierstokes_parallel_tpu/models/karman.py.

Geometry: the Schäfer-Turek 2D-2 benchmark (Schäfer & Turek 1996) in
cylinder-diameter units, a 22 x 4.1 channel with a cylinder of diameter 1 at
(2.0, 2.0), 0.05 below the centreline (the asymmetry that seeds shedding);
parabolic inflow of peak 1 and mean 2/3, so Re_D = 100 is params.Re = 150.
The cylinder is rasterized as a union of row rectangles (``circle_rects``),
eroded until it passes the obstacle geometry rules; ``sharp=True`` also
registers the analytic circle, for the second-order immersed-boundary
velocity BCs and the cut-cell pressure operator (ops/obstacles.py).  And the
confined square cylinder (Breuer et al. 2000), exact on any grid.
``schafer_turek(n_per_d=20)`` is the benchmark's cell ``schaefer_turek.mg``.

Measurement: ``shedding_signal`` steps a ``solver.Stepper`` in whole chunks
of steps, recording per-step diagnostics on the device (the wake probe's
cross-stream velocity by default, or the control-volume force balance of
``force_record_fn``, or with it the surface traction of
``surface_force_record_fn``) and reading them once per chunk;
``coefficients`` forms drag, lift and the pressure drop, and ``strouhal``
the shedding frequency from the zero crossings of the saturated cycle.
The geometry, ``coefficients`` and ``strouhal`` are the JAX module's numpy
code, copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Params
from ..grid import State, allocate_state
from .. import solver as _solver
from ..ops import obstacles
from ..ops.stencils import div


def circle_cells(cx: float, cy: float, d: float, dx: float, dy: float,
                 i_max: int, j_max: int) -> np.ndarray:
    """Interior solid mask (i_max, j_max) of the rasterized disk: cell
    centers inside radius d/2, eroded to satisfy the obstacle geometry
    rules (no solid cell with fluid on both opposite sides — ops/
    obstacles.py::_check_geometry's thin-wall rule).  Erosion of an
    offending cell can expose a new one, so iterate to a fixed point;
    for a convex disk this only shaves the 1-cell-thin extreme rows and
    columns (a flat staircase cap, indistinguishable from any other
    staircase error at the same resolution)."""
    xi = (np.arange(1, i_max + 1) - 0.5) * dx
    yj = (np.arange(1, j_max + 1) - 0.5) * dy
    solid = ((xi[:, None] - cx) ** 2 + (yj[None, :] - cy) ** 2
             <= (0.5 * d) ** 2)
    while solid.any():
        pad = np.zeros((i_max + 2, j_max + 2), bool)
        pad[1:-1, 1:-1] = solid
        fl = ~pad
        thin_ew = solid & fl[2:, 1:-1] & fl[:-2, 1:-1]
        thin_ns = solid & fl[1:-1, 2:] & fl[1:-1, :-2]
        thin = thin_ew | thin_ns
        if not thin.any():
            return solid
        solid = solid & ~thin
    # Zero cells inside, or erosion shaved an under-resolved disk away.
    raise ValueError(f"cylinder d={d} rasterizes to zero cells at "
                     f"dx={dx}, dy={dy} — refine the grid")


def circle_rects(cx: float, cy: float, d: float, dx: float, dy: float,
                 i_max: int, j_max: int) -> Tuple[Tuple[int, int, int, int],
                                                  ...]:
    """`Params.obstacles` rectangles (1-based inclusive cell indices) for
    the rasterized disk: one rect per contiguous solid run per row."""
    solid = circle_cells(cx, cy, d, dx, dy, i_max, j_max)
    rects = []
    for j in range(j_max):
        row = solid[:, j]
        i = 0
        while i < i_max:
            if not row[i]:
                i += 1
                continue
            k = i
            while k < i_max and row[k]:
                k += 1
            rects.append((i + 1, k, j + 1, j + 1))
            i = k
    return tuple(rects)


def schafer_turek(n_per_d: int = 10, Re_D: float = 100.0, T: float = 50.0,
                  sharp: bool = True, **overrides) -> Params:
    """Schäfer-Turek 2D-2 in diameter units: 22 x 4.1 channel, unit
    cylinder at (2.0, 2.0).  `n_per_d` cells across the diameter must be
    a multiple of 10 so 4.1 * n_per_d is a whole cell count.

    `sharp=True` (default) registers the analytic circle as a
    `Params.obstacle_surfaces` level set, so the velocity BCs are the
    second-order ghost-fluid interpolation against the TRUE circle
    (ops/obstacles.py::ib_weights) instead of the first-order staircase
    mirror — the round-3 ladder showed the staircase leaves the
    Richardson-extrapolated cd_max/cl_max 2-5% below the published
    Schäfer-Turek bands.  `sharp=False` keeps the staircase for A/Bs."""
    if n_per_d % 10 != 0:
        raise ValueError(f"n_per_d must be a multiple of 10 (4.1 * n "
                         f"cells across the channel), got {n_per_d}")
    a, b, cx, cy, d = 22.0, 4.1, 2.0, 2.0, 1.0
    nx = int(round(a * n_per_d))
    ny = int(round(b * n_per_d))
    dx, dy = a / nx, b / ny
    rects = circle_rects(cx, cy, d, dx, dy, nx, ny)
    surfaces = (("circle", cx, cy, 0.5 * d),) if sharp else ()
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T,
                    Re=1.5 * Re_D, tau=0.5, omega=1.7, epsilon=1e-4,
                    max_it=20000, obstacles=rects,
                    obstacle_surfaces=surfaces)
    defaults.update(overrides)
    return Params(**defaults)


def square_cylinder(n_per_d: int = 8, Re_D: float = 100.0, T: float = 60.0,
                    a_over_d: float = 20.0, blockage: float = 8.0,
                    x_front: float = 5.0, offset_frac: float = 0.05,
                    **overrides) -> Params:
    """Confined square cylinder (Breuer et al. 2000 setup, diameter
    units): channel `a_over_d` x `blockage`, unit square with its front
    face at x = `x_front`, shifted `offset_frac` below the channel
    centerline WHERE THE GRID CAN REPRESENT IT — the shift rounds to
    whole cells, so it is exactly zero below n_per_d = 10 and the
    geometry is then Breuer's symmetric one; shedding onset is seeded by
    the `initial_state` kick either way (a symmetric impulsive start
    with perturb=0 still sheds, from grid-roundoff seeds, just much
    later).  Exactly resolvable at any grid (no staircase), so it is the
    cheap CPU-testable shedding workload; Breuer's blockage-1/8 St(Re_D =
    100) is ~0.135-0.14."""
    d_cells = n_per_d
    nx = int(round(a_over_d * n_per_d))
    ny = int(round(blockage * n_per_d))
    a, b = float(a_over_d), float(blockage)
    dy = b / ny
    i0 = int(round(x_front * n_per_d)) + 1
    cy = 0.5 * b - offset_frac
    j0 = int(round((cy - 0.5) / dy)) + 1
    rect = (i0, i0 + d_cells - 1, j0, j0 + d_cells - 1)
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T,
                    Re=1.5 * Re_D, tau=0.5, omega=1.7, epsilon=1e-4,
                    max_it=20000, obstacles=(rect,))
    defaults.update(overrides)
    return Params(**defaults)


def cylinder_extent(params: Params) -> Tuple[float, float, float, float]:
    """(x0, x1, y0, y1) bounding box of the obstacle cells, physical."""
    rs = np.array(params.obstacles)
    return (float((rs[:, 0].min() - 1) * params.dx),
            float(rs[:, 1].max() * params.dx),
            float((rs[:, 2].min() - 1) * params.dy),
            float(rs[:, 3].max() * params.dy))


def initial_state(params: Params, perturb: float = 0.3, *,
                  device) -> State:
    """Impulsive start on `device`: the parabolic inflow profile filled
    across the whole channel (masked to fluid columns by the first BC
    pass), plus a one-sided cross-stream kick just behind the cylinder to
    cut the onset transient (the saturated cycle is the same; only the
    onset changes).  JAX's u and v bit for bit: the fields are formed in
    float64 on the host and rounded once, and where the kick underflows to
    a subnormal they hold 0, as JAX's do (XLA's CPU adds them to the zero
    state with subnormals flushed to zero)."""
    state = allocate_state(params, device)
    prof = obstacles.inflow_profile(params)
    u = np.zeros(params.shape, np.float64)
    u[:, 1:-1] = prof[None, :]
    v = np.zeros(params.shape, np.float64)
    if perturb and params.obstacles:
        x0, x1, y0, y1 = cylinder_extent(params)
        d = max(x1 - x0, y1 - y0)
        xi = (np.arange(params.i_max + 2) - 0.5) * params.dx
        yj = (np.arange(params.j_max + 2) - 0.5) * params.dy
        blob = (np.exp(-(((xi[:, None] - (x1 + d)) / d) ** 2
                         + ((yj[None, :] - 0.5 * (y0 + y1)) / d) ** 2))
                * perturb)
        v += blob
    host_dtype = torch.empty((), dtype=state.u.dtype).numpy().dtype

    def field(x):
        x = x.astype(host_dtype)
        x[np.abs(x) < np.finfo(host_dtype).tiny] = 0.0
        return torch.from_numpy(x).to(state.u.device)

    return state._replace(u=field(u), v=field(v))


class SheddingTrace(NamedTuple):
    t: np.ndarray        # sample times (end of each step; nonuniform dt)
    v: np.ndarray        # cross-stream velocity at the wake probe
    state: State         # final state
    stats: _solver.SolveStats
    rec: dict            # extra per-step records ({} unless record_fn)


def probe_node(params: Params, probe: Optional[Tuple[float, float]] = None
               ) -> Tuple[int, int]:
    """Padded v-node indices nearest the probe point (default: one
    diameter behind the cylinder's rear face, on its horizontal
    midline).  v node (i, j) lives at ((i - 1/2) dx, j dy)."""
    if probe is None:
        x0, x1, y0, y1 = cylinder_extent(params)
        probe = (x1 + max(x1 - x0, y1 - y0), 0.5 * (y0 + y1))
    pi = int(np.clip(round(probe[0] / params.dx + 0.5), 1, params.i_max))
    pj = int(np.clip(round(probe[1] / params.dy), 1, params.j_max - 1))
    return pi, pj


@functools.lru_cache(maxsize=16)
def _probe_record_fn(params: Params, pi: int, pj: int):
    """Default per-step record: v at the wake probe node."""
    def rec(state: State):
        return {"v": state.v[pi, pj]}
    return rec


def shedding_signal(params: Params, state: Optional[State] = None, *,
                    device=None, method: str = "rb_sor",
                    probe: Optional[Tuple[float, float]] = None,
                    perturb: float = 0.3, chunk: int = 64, record_fn=None,
                    time_order: int = 1) -> SheddingTrace:
    """Integrate past params.T recording per-step wake diagnostics.

    The default record is v at the probe, one diameter behind the
    cylinder's rear face on its horizontal midline; pass `record_fn(state)
    -> dict of 0-d tensors` (e.g. ``force_record_fn``) for more (a "v" key
    also fills trace.v).  The state stays on its device (`state`, or
    ``initial_state`` on `device`); the steps run in whole chunks of
    `chunk`, whose records and counts are read once per chunk, so, as in
    the JAX package, the step count is a multiple of `chunk` and the final
    state may overshoot T by up to chunk - 1 steps (the trace keeps its
    exact times).  `time_order=2` steps with Adams-Bashforth 2 from the
    Euler bootstrap, the tendency carried across chunks."""
    if state is None:
        if device is None:
            raise ValueError("shedding_signal needs a state or a device")
        state = initial_state(params, perturb=perturb, device=device)
    if record_fn is None:
        record_fn = _probe_record_fn(params, *probe_node(params, probe))
    t_end = float(torch.tensor(params.T, dtype=state.t.dtype))
    if float(state.t) >= t_end:
        # Chunked stepping overshoots T, so a completed trace's state is
        # past T: fail loudly instead of returning an empty trace.
        raise ValueError(
            f"state.t = {float(state.t):g} already >= T = {t_end:g} — "
            f"raise params.T to continue this run")
    stepper = _solver.Stepper(params, state, method, time_order)
    ts, recs = [], []
    steps = iters = fails = 0
    last = 0.0
    while stepper.t < t_end:
        times, records = [], []
        for _ in range(chunk):
            diag = stepper.step()
            s = stepper.state()
            times.append(s.t)
            records.append(record_fn(s))
            iters += diag.sor_iterations
            fails += 0 if diag.sor_converged else 1
            last = diag.sor_res_norm
        steps += chunk
        # One read per chunk: the times and every record key stacked.
        keys = list(records[0])
        block = torch.stack([torch.stack(times)] + [
            torch.stack([r[k] for r in records]) for k in keys]).cpu().numpy()
        ts.append(block[0])
        recs.append(dict(zip(keys, block[1:])))
    stats = _solver.SolveStats(steps=steps, total_sor_iterations=iters,
                               sor_failures=fails, last_res_norm=last)
    rec = {k: np.concatenate([r[k] for r in recs]) for k in recs[0]}
    v = rec.get("v", np.zeros(0))
    return SheddingTrace(t=np.concatenate(ts), v=v, state=stepper.state(),
                         stats=stats, rec=rec)


def control_volume(params: Params, margin: int = 5
                   ) -> Tuple[int, int, int, int]:
    """(I0, I1, J0, J1) interior cell indices of a rectangular control
    volume: the obstacle bounding box padded by `margin` cells, clamped
    so every CV boundary face (and the stencils evaluated on it) stays
    strictly inside the domain."""
    rs = np.array(params.obstacles)
    I0 = max(int(rs[:, 0].min()) - margin, 2)
    I1 = min(int(rs[:, 1].max()) + margin, params.i_max - 1)
    J0 = max(int(rs[:, 2].min()) - margin, 2)
    J1 = min(int(rs[:, 3].max()) + margin, params.j_max - 2)
    return I0, I1, J0, J1


@functools.lru_cache(maxsize=16)
def force_record_fn(params: Params, margin: int = 5,
                    pi: int = 0, pj: int = 0):
    """Per-step record for force coefficients: the control-volume
    momentum balance

        F_body(t) = oint_dCV [ -u (u.n) - p n + nu (grad u + grad u^T) n ] dS
                    - d/dt int_CV u dV

    as staggered-grid slice reductions on the state's device: the surface
    integral S = (sx, sy) and the CV fluid momentum M = (mx, my), from
    which ``coefficients`` forms F = S - dM/dt on the host.  Exact for ANY
    control volume around the body, so it never integrates over the
    staircase boundary.  Also records the Schäfer-Turek front/back pressure
    difference `dp` (cylinder midline poles) and the wake probe `v` (node
    (pi, pj), 0 = skip).  The record's values are 0-d tensors in the
    state's dtype, in the JAX package's order of operations (its sums add
    in another order)."""
    I0, I1, J0, J1 = control_volume(params, margin)
    dx, dy, nu = params.dx, params.dy, 1.0 / params.Re
    fluid = obstacles.fluid_mask(params)[I0:I1 + 1, J0:J1 + 1]
    # Schäfer-Turek pressure poles: cell just west of the obstacle bbox
    # front face / just east of its rear face, midline cells straddling
    # the obstacle's vertical center.
    rs = np.array(params.obstacles)
    i_f, i_b = int(rs[:, 0].min()) - 1, int(rs[:, 1].max()) + 1
    jc = int(round(0.5 * (rs[:, 2].min() - 1 + rs[:, 3].max())))

    @functools.lru_cache(maxsize=4)
    def fluid_on(device):
        return torch.from_numpy(fluid).to(device)

    def rec(state: State):
        u, v, p = state.u, state.v, state.p
        fl = fluid_on(u.device)
        js = slice(J0, J1 + 1)          # cell rows J0..J1
        ii = slice(I0, I1 + 1)          # cell cols I0..I1
        # --- x-momentum, east/west faces (u-edges I1 / I0-1) ---
        def fx_vert(I, sign):
            uf = u[I, js]
            pf = 0.5 * (p[I, js] + p[I + 1, js])
            dudx = div(u[I + 1, js] - u[I - 1, js], 2 * dx)
            return sign * torch.sum(-uf * uf - pf + 2 * nu * dudx) * dy
        # --- x-momentum, north/south faces (v-edges J1 / J0-1) ---
        def fx_horiz(J, sign):
            vf = v[ii, J]
            uc = 0.25 * (u[I0 - 1:I1, J] + u[ii, J]
                         + u[I0 - 1:I1, J + 1] + u[ii, J + 1])
            dudy = div(0.5 * (u[I0 - 1:I1, J + 1] + u[ii, J + 1])
                       - 0.5 * (u[I0 - 1:I1, J] + u[ii, J]), dy)
            dvdx = div(v[I0 + 1:I1 + 2, J] - v[I0 - 1:I1, J], 2 * dx)
            return sign * torch.sum(-uc * vf + nu * (dudy + dvdx)) * dx
        # --- y-momentum, east/west faces ---
        def fy_vert(I, sign):
            uf = u[I, js]
            vc = 0.25 * (v[I, J0 - 1:J1] + v[I, js]
                         + v[I + 1, J0 - 1:J1] + v[I + 1, js])
            dvdx = div(0.5 * (v[I + 1, js] + v[I + 1, J0 - 1:J1])
                       - 0.5 * (v[I, js] + v[I, J0 - 1:J1]), dx)
            dudy = div(u[I, J0 + 1:J1 + 2] - u[I, J0 - 1:J1], 2 * dy)
            return sign * torch.sum(-uf * vc + nu * (dvdx + dudy)) * dy
        # --- y-momentum, north/south faces ---
        def fy_horiz(J, sign):
            vf = v[ii, J]
            pf = 0.5 * (p[ii, J] + p[ii, J + 1])
            dvdy = div(v[ii, J + 1] - v[ii, J - 1], 2 * dy)
            return sign * torch.sum(-vf * vf - pf + 2 * nu * dvdy) * dx
        sx = (fx_vert(I1, +1.0) + fx_vert(I0 - 1, -1.0)
              + fx_horiz(J1, +1.0) + fx_horiz(J0 - 1, -1.0))
        sy = (fy_vert(I1, +1.0) + fy_vert(I0 - 1, -1.0)
              + fy_horiz(J1, +1.0) + fy_horiz(J0 - 1, -1.0))
        # CV fluid momentum (cell-centered averages; solid cells hold
        # reflection ghosts, so mask them out).
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        uc = 0.5 * (u[I0 - 1:I1, js] + u[ii, js])
        vc = 0.5 * (v[ii, J0 - 1:J1] + v[ii, js])
        mx = torch.sum(torch.where(fl, uc, zero)) * dx * dy
        my = torch.sum(torch.where(fl, vc, zero)) * dx * dy
        dp = (0.5 * (p[i_f, jc] + p[i_f, jc + 1])
              - 0.5 * (p[i_b, jc] + p[i_b, jc + 1]))
        out = {"sx": sx, "sy": sy, "mx": mx, "my": my, "dp": dp}
        if pi:
            out["v"] = v[pi, pj]
        return out
    return rec


@functools.lru_cache(maxsize=16)
def surface_force_record_fn(params: Params, margin: int = 5,
                            pi: int = 0, pj: int = 0):
    """``force_record_fn`` plus the direct surface-traction force (fsx,
    fsy) on the analytic cylinder (ops/obstacles.py::surface_force): two
    independent estimators of one body force in one trace.  Needs
    ``params.obstacle_surfaces`` with a single circle."""
    obstacles.surface_quadrature(params)   # raises on any other geometry
    base = force_record_fn(params, margin, pi, pj)

    def rec(state: State):
        out = dict(base(state))
        out["fsx"], out["fsy"] = obstacles.surface_force(
            state.u, state.v, state.p, params)
        return out
    return rec


def coefficients(trace: SheddingTrace, params: Params, *,
                 d: float = 1.0, u_mean: float = 2.0 / 3.0,
                 skip_frac: float = 0.5) -> dict:
    """Force coefficients of the saturated cycle from a force trace:
    cD(t), cL(t) = 2 (S - dM/dt) / (u_mean^2 d), with dM/dt a centered
    finite difference on the nonuniform sample times.  Returns mean/max
    statistics over the tail plus the Schäfer-Turek normalized pressure
    difference dp / u_mean^2.  Published 2D-2 targets: cD_max 3.22-3.24,
    cL_max 0.99-1.01, dp 2.46-2.50."""
    t = trace.t
    scale = 2.0 / (u_mean * u_mean * d)
    out = {}
    for comp, name in (("x", "cd"), ("y", "cl")):
        S = trace.rec["s" + comp]
        M = trace.rec["m" + comp]
        dMdt = np.gradient(M, t)
        c = scale * (S - dMdt)
        cc = c[int(len(c) * skip_frac):]
        out[name + "_mean"] = float(np.mean(cc))
        out[name + "_max"] = float(np.max(cc))
        out[name + "_amp"] = float(0.5 * (np.max(cc) - np.min(cc)))
    if "fsx" in trace.rec:
        # Surface-traction estimator (surface_force_record_fn): direct
        # coefficients, no dM/dt term.
        for comp, name in (("x", "cd_s"), ("y", "cl_s")):
            c = scale * trace.rec["fs" + comp]
            cc = c[int(len(c) * skip_frac):]
            out[name + "_mean"] = float(np.mean(cc))
            out[name + "_max"] = float(np.max(cc))
            out[name + "_amp"] = float(0.5 * (np.max(cc) - np.min(cc)))
    dp = trace.rec["dp"][int(len(t) * skip_frac):] / (u_mean * u_mean)
    out["dp_mean"] = float(np.mean(dp))
    out["dp_max"] = float(np.max(dp))
    return out


def strouhal(t: np.ndarray, signal: np.ndarray, *, d: float = 1.0,
             u_mean: float = 2.0 / 3.0, skip_frac: float = 0.5,
             min_crossings: int = 5) -> Tuple[float, float]:
    """(St, amplitude) of the saturated limit cycle.

    Uses the tail `1 - skip_frac` of the record: mean-removed zero
    crossings, linearly interpolated in time (exact under nonuniform
    adaptive-dt sampling, unlike an FFT), averaged over all full periods
    = (n_crossings - 1) half-periods.  Amplitude is half the tail's
    peak-to-peak — 0 for a dead (non-shedding) wake."""
    i0 = int(len(t) * skip_frac)
    tt, ss = np.asarray(t[i0:], float), np.asarray(signal[i0:], float)
    if len(tt) < 4:
        raise ValueError("signal too short")
    ss = ss - np.mean(ss)
    amp = 0.5 * (np.max(ss) - np.min(ss))
    idx = np.flatnonzero(np.diff(np.sign(ss)) != 0)
    if len(idx) < min_crossings:
        return 0.0, amp
    cross = tt[idx] - ss[idx] * (tt[idx + 1] - tt[idx]) / (ss[idx + 1]
                                                           - ss[idx])
    period = 2.0 * (cross[-1] - cross[0]) / (len(cross) - 1)
    return d / (u_mean * period), amp
