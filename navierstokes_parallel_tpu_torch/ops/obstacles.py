"""Flag-field obstacle domains (Griebel et al. 1998, sect. 5.1).

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/obstacles.py``.  The
reference has obstacle-free rectangles only; this module adds interior solid
cells, the NaSt2D capability behind the backward-facing step and the flow
past a cylinder:

  * The geometry is static per ``Params.obstacles`` (a hashable tuple of
    cell rectangles): every mask, immersed-boundary weight, face aperture
    and quadrature table is built once on the host in numpy float64 (the
    JAX module's own code, copied, so the tables are equal bit for bit) and
    cached per ``Params``; its tensors are moved to a device once per
    (params, dtype, device), never once per step.
  * The velocity BCs on obstacle faces are ``torch.where`` passes over
    those masks, IN PLACE on u and v like the outer walls'
    (ops/boundary.py); each builds its BC values from the fields as they
    were before it writes.
  * The pressure operator drops solid neighbours per cell through neighbour
    weights and a per-cell self-coefficient (ops/masked.py).

Geometry rules (checked in ``masks``): an obstacle is at least 2 cells thick
wherever it has fluid on both sides, and the fluid region is connected.

No kernel stands behind any of this, as none stands behind it in the JAX
package: an obstacle step runs plain PyTorch on every device, but for the
masked V-cycle's kernels on the card (ops/masked.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import Params
from ..utils import timing
from . import momentum
from . import stencils as st


class ObstacleMasks(NamedTuple):
    """Static numpy masks, all padded-shaped (i_max+2, j_max+2) bool."""

    fluid: np.ndarray      # True on fluid interior cells (ghost ring False)
    # u-edge masks: edge (i, j) sits between cells (i, j) and (i+1, j)
    u_solid: np.ndarray    # edge touches a solid cell -> BC-controlled
    u_refl_n: np.ndarray   # solid-interior edge with fluid row above
    u_refl_s: np.ndarray   # solid-interior edge with fluid row below
    # v-edge masks: edge (i, j) sits between cells (i, j) and (i, j+1)
    v_solid: np.ndarray
    v_refl_e: np.ndarray
    v_refl_w: np.ndarray


def fluid_mask(params: Params) -> np.ndarray:
    """Padded bool mask, True on fluid interior cells."""
    m = np.zeros((params.i_max + 2, params.j_max + 2), bool)
    m[1:-1, 1:-1] = True
    for (i0, i1, j0, j1) in params.obstacles:
        m[i0 : i1 + 1, j0 : j1 + 1] = False
    return m


def _check_geometry(fluid: np.ndarray, params: Params) -> None:
    interior = fluid[1:-1, 1:-1]
    solid = ~interior
    if not solid.any():
        return
    # Thin-wall rule: no solid cell with fluid on both opposite sides.
    fl = fluid
    s = ~fl[1:-1, 1:-1]
    ew = s & fl[2:, 1:-1] & fl[:-2, 1:-1]
    ns = s & fl[1:-1, 2:] & fl[1:-1, :-2]
    if ew.any() or ns.any():
        i, j = np.argwhere(ew | ns)[0] + 1
        raise ValueError(
            f"obstacle wall at cell ({i}, {j}) is 1 cell thin with fluid on "
            f"both sides — obstacles must be >= 2 cells thick (Griebel "
            f"sect. 5.1 geometry rule)")
    # Isolated fluid cells (no fluid neighbor at all) can never be solved.
    nfl = (fl[2:, 1:-1].astype(int) + fl[:-2, 1:-1] + fl[1:-1, 2:]
           + fl[1:-1, :-2])
    if (interior & (nfl == 0)).any():
        i, j = np.argwhere(interior & (nfl == 0))[0] + 1
        raise ValueError(f"fluid cell ({i}, {j}) is fully enclosed by "
                         f"obstacles")
    # Connectivity (the pressure null space is per component).  Vectorized
    # frontier flood fill: O(domain diameter) sweeps; skip on huge grids
    # where the trace-time cost would bite (obstacle workloads are small).
    if params.i_max * params.j_max <= 1 << 18:
        reach = np.zeros_like(interior)
        seed = np.argwhere(interior)[0]
        reach[seed[0], seed[1]] = True
        while True:
            grown = reach.copy()
            grown[1:, :] |= reach[:-1, :]
            grown[:-1, :] |= reach[1:, :]
            grown[:, 1:] |= reach[:, :-1]
            grown[:, :-1] |= reach[:, 1:]
            grown &= interior
            if (grown == reach).all():
                break
            reach = grown
        if not (reach == interior).all():
            raise ValueError(
                "fluid region is disconnected by the obstacles — the "
                "pressure system would be singular per component")


@functools.lru_cache(maxsize=32)
def masks(params: Params) -> ObstacleMasks:
    """Build (and validate) every static mask for `params.obstacles`."""
    fl = fluid_mask(params)
    _check_geometry(fl, params)
    shape = fl.shape
    z = np.zeros(shape, bool)

    # u edge (i, j) between cells (i, j) and (i+1, j); physical edges are
    # i = 0..i_max — domain-wall edges (i = 0, i_max) stay with the outer
    # BCs, obstacle masks cover i = 1..i_max-1 (and solid-interior edges).
    u_solid = z.copy()
    u_solid[1:-2, 1:-1] = ~(fl[1:-2, 1:-1] & fl[2:-1, 1:-1])
    both_solid_u = z.copy()
    both_solid_u[1:-2, 1:-1] = ~fl[1:-2, 1:-1] & ~fl[2:-1, 1:-1]
    fluid_above = z.copy()
    fluid_above[1:-2, 1:-2] = fl[1:-2, 2:-1] & fl[2:-1, 2:-1]
    fluid_below = z.copy()
    fluid_below[1:-2, 2:-1] = fl[1:-2, 1:-2] & fl[2:-1, 1:-2]
    u_refl_n = both_solid_u & fluid_above
    u_refl_s = both_solid_u & fluid_below & ~u_refl_n

    # v edge (i, j) between cells (i, j) and (i, j+1).
    v_solid = z.copy()
    v_solid[1:-1, 1:-2] = ~(fl[1:-1, 1:-2] & fl[1:-1, 2:-1])
    both_solid_v = z.copy()
    both_solid_v[1:-1, 1:-2] = ~fl[1:-1, 1:-2] & ~fl[1:-1, 2:-1]
    fluid_east = z.copy()
    fluid_east[1:-2, 1:-2] = fl[2:-1, 1:-2] & fl[2:-1, 2:-1]
    fluid_west = z.copy()
    fluid_west[2:-1, 1:-2] = fl[1:-2, 1:-2] & fl[1:-2, 2:-1]
    v_refl_e = both_solid_v & fluid_east
    v_refl_w = both_solid_v & fluid_west & ~v_refl_e

    return ObstacleMasks(fluid=fl, u_solid=u_solid, u_refl_n=u_refl_n,
                         u_refl_s=u_refl_s, v_solid=v_solid,
                         v_refl_e=v_refl_e, v_refl_w=v_refl_w)


def _tensors(arrays, device, dtype=None):
    return type(arrays)(*(torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype) for a in arrays))


@functools.lru_cache(maxsize=32)
def device_fluid_mask(params: Params, device: torch.device) -> torch.Tensor:
    """``fluid_mask(params)`` as a bool tensor on `device`, made once; no
    geometry check (the particles and the free-surface flags read it, as
    the JAX package's do)."""
    return torch.from_numpy(fluid_mask(params)).to(device)


@functools.lru_cache(maxsize=32)
def device_masks(params: Params, device: torch.device) -> ObstacleMasks:
    """``masks(params)`` as bool tensors on `device`, made once."""
    return _tensors(masks(params), device)


def apply_obstacle_bcs(u: torch.Tensor, v: torch.Tensor, params: Params):
    """No-slip on every obstacle face, IN PLACE: the BC-controlled edges
    take 0, except the solid-interior edges next to a fluid face, which take
    the tangential reflection (u below/above a horizontal face, v left/right
    of a vertical one) -- the flag-field analogue of boundary.set_noslip.
    With ``params.obstacle_surfaces`` the same edges take the second-order
    ghost-fluid values against the analytic wall (``ib_weights``).  Every
    value is built from the fields as they were on entry (JAX's rolls of
    its input) before either field is written.  It runs in the span
    ``obstacle.bcs``."""
    with timing.span("obstacle.bcs"):
        m = device_masks(params, u.device)
        if params.obstacle_surfaces:
            u_bc, v_bc = _ib_values(u, v, params)
        else:
            zero = torch.zeros((), dtype=u.dtype, device=u.device)
            u_bc = torch.where(m.u_refl_n, -torch.roll(u, -1, 1),
                               torch.where(m.u_refl_s, -torch.roll(u, 1, 1),
                                           zero))
            v_bc = torch.where(m.v_refl_e, -torch.roll(v, -1, 0),
                               torch.where(m.v_refl_w, -torch.roll(v, 1, 0),
                                           zero))
        u.copy_(torch.where(m.u_solid, u_bc, u))
        v.copy_(torch.where(m.v_solid, v_bc, v))
        return u, v


def _ib_values(u, v, params: Params):
    """The ghost-fluid BC values of every edge: a static weight times ONE
    fluid neighbour, summed over the four disjoint weight categories in the
    JAX package's order (zero off their masks)."""
    w = device_ib_weights(params, u.dtype, u.device)
    u_bc = (w.u_wn * torch.roll(u, -1, 1) + w.u_ws * torch.roll(u, 1, 1)
            + w.u_we * torch.roll(u, -1, 0) + w.u_ww * torch.roll(u, 1, 0))
    v_bc = (w.v_we * torch.roll(v, -1, 0) + w.v_ww * torch.roll(v, 1, 0)
            + w.v_wn * torch.roll(v, -1, 1) + w.v_ws * torch.roll(v, 1, 1))
    return u_bc, v_bc


# ---------------------------------------------------------------------------
# Second-order (ghost-fluid) boundary weights against analytic surfaces: each
# BC-controlled velocity edge takes the value a linear profile vanishing on
# the true wall would have, through one in-line fluid neighbour,
#
#     u(node) = u(nbr) * (xi_node - xi_wall) / (xi_nbr - xi_wall),
#
# xi_wall located by bisection on the level set (Tseng & Ferziger 2003).
# Degenerate geometry falls back to the mirror/zero value; |w| <= 3.


class IBWeights(NamedTuple):
    """Static per-edge BC coefficients, padded-shaped float64, ZERO off
    their mask (so a masked sum-of-products needs no extra selects).
    u_wn/u_ws live on u_refl_n/u_refl_s (tangential ghosts, mirror = -1);
    u_we/u_ww on the normal fluid-solid u-edges reading u[i+1,j]/u[i-1,j]
    (mirror = 0); v_* symmetric."""

    u_wn: np.ndarray
    u_ws: np.ndarray
    u_we: np.ndarray
    u_ww: np.ndarray
    v_we: np.ndarray
    v_ww: np.ndarray
    v_wn: np.ndarray
    v_ws: np.ndarray


def _surface_phi(surfaces):
    """Level-set callable phi(x, y) for the union of solids: positive in
    fluid, negative inside any solid, zero on the wall."""

    def phi(x, y):
        vals = []
        for s in surfaces:
            kind = s[0]
            if kind == "circle":
                _, cx, cy, r = s
                vals.append(np.hypot(x - cx, y - cy) - r)
            elif kind == "box":
                _, x0, x1, y0, y1 = s
                ddx = np.maximum(x0 - x, x - x1)
                ddy = np.maximum(y0 - y, y - y1)
                outside = np.hypot(np.maximum(ddx, 0.0),
                                   np.maximum(ddy, 0.0))
                inside = np.minimum(np.maximum(ddx, ddy), 0.0)
                vals.append(outside + inside)
            elif kind == "plane":
                _, nx_, ny_, c = s
                vals.append((nx_ * x + ny_ * y - c) / np.hypot(nx_, ny_))
            else:  # pragma: no cover — Params validates kinds
                raise ValueError(f"unknown surface kind {kind!r}")
        return vals[0] if len(vals) == 1 else np.minimum.reduce(vals)

    return phi


def _bisect_crossing(phi, p0, p1, iters: int = 60) -> np.ndarray:
    """Crossing fraction t in [0, 1] of phi's sign change on each segment
    p0 -> p1 ((N, 2) endpoint arrays; phi(p0) and phi(p1) must straddle
    zero, phi(p0) on the negative side)."""
    a = np.zeros(len(p0))
    b = np.ones(len(p0))
    for _ in range(iters):
        t = 0.5 * (a + b)
        pm = p0 + (p1 - p0) * t[:, None]
        neg = phi(pm[:, 0], pm[:, 1]) < 0.0
        a = np.where(neg, t, a)
        b = np.where(neg, b, t)
    return 0.5 * (a + b)


def _interp_weights(phi, nodes, sources, mirror_w: float) -> np.ndarray:
    """Per-edge coefficient w with u(node) = w * u(source): linear profile
    through the wall crossing on the node->source line (xi_node = 0,
    xi_source = 1, searched over xi in [-1, 1]); `mirror_w` where the
    level set and the cell flags disagree."""
    w = np.full(len(nodes), float(mirror_w))
    if len(nodes) == 0:
        return w
    fP = phi(nodes[:, 0], nodes[:, 1])
    fQ = phi(sources[:, 0], sources[:, 1])
    ok = fQ > 0.0  # the fluid neighbor must be genuinely in fluid
    c1 = ok & (fP < 0.0)  # node inside solid: wall in [node, source]
    if c1.any():
        t = _bisect_crossing(phi, nodes[c1], sources[c1])
        w[c1] = -t / np.maximum(1.0 - t, 1e-12)
    ext = 2.0 * nodes - sources  # node - (source - node)
    fE = phi(ext[:, 0], ext[:, 1])
    # Node on the fluid side of the true wall (staircase juts past the
    # surface): wall in [ext, node], xi_wall in [-1, 0], weight in [0, 1).
    c2 = ok & (fP >= 0.0) & (fE < 0.0)
    if c2.any():
        t = _bisect_crossing(phi, ext[c2], nodes[c2])
        xi = t - 1.0
        w[c2] = -xi / (1.0 - xi)
    # Snap weights within bisection roundoff of the mirror constants so a
    # level set that coincides with the staircase (e.g. an aligned box)
    # reduces BIT-identically to the mirror path.  1e-9 is ~1e9 x the
    # 60-iteration bisection error and far below any physical weight
    # difference (weights vary O(1) across one cell).
    w[np.abs(w + 1.0) < 1e-9] = -1.0
    w[np.abs(w) < 1e-9] = 0.0
    return np.clip(w, -3.0, 3.0)


@functools.lru_cache(maxsize=32)
def ib_weights(params: Params) -> IBWeights:
    """Build the static second-order BC weight arrays (see IBWeights)."""
    m = masks(params)
    fl = m.fluid
    dx, dy = params.dx, params.dy
    phi = _surface_phi(params.obstacle_surfaces)
    shape = fl.shape

    def u_xy(idx):
        return np.stack([idx[:, 0] * dx, (idx[:, 1] - 0.5) * dy], axis=1)

    def v_xy(idx):
        return np.stack([(idx[:, 0] - 0.5) * dx, idx[:, 1] * dy], axis=1)

    def weights_on(mask, xy_fn, axis, step, mirror):
        out = np.zeros(shape)
        idx = np.argwhere(mask)
        if len(idx):
            src = idx.copy()
            src[:, axis] += step
            out[mask] = _interp_weights(phi, xy_fn(idx), xy_fn(src), mirror)
        return out

    # Normal-edge masks: one adjacent cell fluid, and the next in-line
    # edge on the fluid side is itself a fluid edge (else the zero
    # fallback stands — e.g. 1-cell fluid gaps).
    u_norm_e = np.zeros(shape, bool)  # cell (i,j) solid, (i+1,j)+(i+2,j) fluid
    u_norm_e[1:-2, 1:-1] = (~fl[1:-2, 1:-1] & fl[2:-1, 1:-1] & fl[3:, 1:-1])
    u_norm_w = np.zeros(shape, bool)  # cell (i+1,j) solid, (i,j)+(i-1,j) fluid
    u_norm_w[1:-2, 1:-1] = (fl[1:-2, 1:-1] & ~fl[2:-1, 1:-1]
                            & fl[:-3, 1:-1])
    v_norm_n = np.zeros(shape, bool)
    v_norm_n[1:-1, 1:-2] = (~fl[1:-1, 1:-2] & fl[1:-1, 2:-1] & fl[1:-1, 3:])
    v_norm_s = np.zeros(shape, bool)
    v_norm_s[1:-1, 1:-2] = (fl[1:-1, 1:-2] & ~fl[1:-1, 2:-1]
                            & fl[1:-1, :-3])
    # The tangential reflections own their edges; a normal read must not
    # double-write them (disjoint by construction for u_refl vs u_norm —
    # both-solid vs one-fluid — but assert the invariant cheaply).
    assert not (m.u_refl_n & u_norm_e).any() and not (m.u_refl_s & u_norm_w).any()
    assert not (m.v_refl_e & v_norm_n).any() and not (m.v_refl_w & v_norm_s).any()

    return IBWeights(
        u_wn=weights_on(m.u_refl_n, u_xy, 1, +1, -1.0),
        u_ws=weights_on(m.u_refl_s, u_xy, 1, -1, -1.0),
        u_we=weights_on(u_norm_e, u_xy, 0, +1, 0.0),
        u_ww=weights_on(u_norm_w, u_xy, 0, -1, 0.0),
        v_we=weights_on(m.v_refl_e, v_xy, 0, +1, -1.0),
        v_ww=weights_on(m.v_refl_w, v_xy, 0, -1, -1.0),
        v_wn=weights_on(v_norm_n, v_xy, 1, +1, 0.0),
        v_ws=weights_on(v_norm_s, v_xy, 1, -1, 0.0),
    )

@functools.lru_cache(maxsize=32)
def device_ib_weights(params: Params, dtype: torch.dtype,
                      device: torch.device) -> IBWeights:
    """``ib_weights(params)`` rounded to `dtype` on `device`, made once."""
    return _tensors(ib_weights(params), device, dtype)


# ---------------------------------------------------------------------------
# Cut-cell face apertures, the second-order PRESSURE closure: the flux
# balance of each cell weights each face by its open fraction A_d in [0, 1]
# (Johansen & Colella 1998),
#
#     sum_d (A_d / h^2) (p_d - p_P) = (1/dt) div_A(F, G),
#     div_A = (A_e F_e - A_w F_w)/dx + (A_n G_n - A_s G_s)/dy;
#
# on geometry aligned with the staircase every fraction is 0 or 1 and the
# operator is the masked one bit for bit.
# ---------------------------------------------------------------------------

#: Faces between two flag-fluid cells never close completely: a zero (or
#: near-zero) aperture from a tangent level set would disconnect DOFs the
#: geometry check (flags) believes are connected and can zero a fluid
#: cell's diagonal.  The floor only triggers on degenerate tangencies
#: (wall-resolved grids keep fluid-fluid fractions O(1)).
APERTURE_FLOOR = 0.05


def aperture_active(params: Params) -> bool:
    """Whether the cut-cell pressure closure applies (config.py
    `obstacle_pressure`: explicit, or 'auto' iff surfaces are present)."""
    if not params.obstacles:
        return False
    if params.obstacle_pressure == "aperture":
        return True
    if params.obstacle_pressure == "staircase":
        return False
    return bool(params.obstacle_surfaces)


class Apertures(NamedTuple):
    """Static float64 face-fraction arrays, padded-shaped like F/G:
    `au[i, j]` = open fraction of the vertical face between cells (i, j)
    and (i+1, j) (the face u/F edge (i, j) lives on), `av[i, j]` the
    horizontal face between (i, j) and (i, j+1).  Faces touching an
    interior SOLID cell are closed (0); faces to ghost cells keep their
    level-set fraction (~1 away from obstacles) so the outer-wall fluxes
    stay in the RHS.  `theta` is the interior-shaped fluid volume fraction
    (subsampled on cut cells) — used by truncation tests, not the solver."""

    au: np.ndarray
    av: np.ndarray
    theta: np.ndarray


def _face_fractions(phi, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Fluid fraction of each segment p0 -> p1 ((N, 2) endpoints): 1/0 when
    the level set does not change sign, else located by bisection."""
    f0 = phi(p0[:, 0], p0[:, 1])
    f1 = phi(p1[:, 0], p1[:, 1])
    frac = np.where((f0 >= 0.0) & (f1 >= 0.0), 1.0, 0.0)
    mixed = (f0 < 0.0) != (f1 < 0.0)
    if mixed.any():
        a = np.where(f0[mixed, None] < 0.0, p0[mixed], p1[mixed])
        b = np.where(f0[mixed, None] < 0.0, p1[mixed], p0[mixed])
        t = _bisect_crossing(phi, a, b)   # solid end -> fluid end
        frac[mixed] = 1.0 - t
    return frac


@functools.lru_cache(maxsize=32)
def apertures(params: Params) -> Apertures:
    """Build the static cut-cell face fractions (see Apertures)."""
    fl = masks(params).fluid
    ni, nj = params.i_max, params.j_max
    dx, dy = params.dx, params.dy
    phi = _surface_phi(params.obstacle_surfaces)
    shape = fl.shape
    solid_int = np.zeros(shape, bool)
    solid_int[1:-1, 1:-1] = ~fl[1:-1, 1:-1]

    # Level set at cell corners (i*dx, j*dy), i = 0..ni, j = 0..nj.
    ci = np.arange(ni + 1) * dx
    cj = np.arange(nj + 1) * dy
    phi_c = phi(ci[:, None], cj[None, :])

    def fractions(pos0, pos1, sign0, sign1):
        """Vectorized face fractions from corner signs; bisect only the
        cut faces."""
        frac = np.where(sign0 & sign1, 1.0, 0.0)
        mixed = sign0 != sign1
        if mixed.any():
            idx = np.argwhere(mixed)
            p0 = pos0(idx)
            p1 = pos1(idx)
            frac[mixed] = _face_fractions(phi, p0, p1)
        return frac

    flu_c = phi_c >= 0.0
    # u-faces: au[i, j], i = 0..ni, j = 1..nj, segment corner (i, j-1) ->
    # corner (i, j).
    au = np.zeros(shape)
    au[: ni + 1, 1 : nj + 1] = fractions(
        lambda idx: np.stack([idx[:, 0] * dx, idx[:, 1] * dy], axis=1),
        lambda idx: np.stack([idx[:, 0] * dx, (idx[:, 1] + 1) * dy], axis=1),
        flu_c[:, :-1], flu_c[:, 1:])
    # v-faces: av[i, j], i = 1..ni, j = 0..nj, corner (i-1, j) -> (i, j).
    av = np.zeros(shape)
    av[1 : ni + 1, : nj + 1] = fractions(
        lambda idx: np.stack([idx[:, 0] * dx, idx[:, 1] * dy], axis=1),
        lambda idx: np.stack([(idx[:, 0] + 1) * dx, idx[:, 1] * dy], axis=1),
        flu_c[:-1, :], flu_c[1:, :])

    # Close faces touching an interior solid cell (their fluxes are not
    # DOF-corrected; the discrete domain boundary follows the staircase
    # there, clipped by the true wall elsewhere).
    au[:-1, :][solid_int[:-1, :] | solid_int[1:, :]] = 0.0
    av[:, :-1][solid_int[:, :-1] | solid_int[:, 1:]] = 0.0
    # Floor fluid-fluid faces (see APERTURE_FLOOR).
    ff_u = np.zeros(shape, bool)
    ff_u[:-1, :] = fl[:-1, :] & fl[1:, :]
    ff_v = np.zeros(shape, bool)
    ff_v[:, :-1] = fl[:, :-1] & fl[:, 1:]
    au[ff_u] = np.maximum(au[ff_u], APERTURE_FLOOR)
    av[ff_v] = np.maximum(av[ff_v], APERTURE_FLOOR)

    # Volume fractions: 1 on uncut fluid, 0 on solid, subsampled (64x64
    # midpoint rule) on flag-fluid cells whose corners straddle the wall.
    theta = fl[1:-1, 1:-1].astype(float)
    corner_solid = ~flu_c
    cut = np.zeros((ni, nj), bool)
    cut |= corner_solid[:-1, :-1] | corner_solid[1:, :-1]
    cut |= corner_solid[:-1, 1:] | corner_solid[1:, 1:]
    cut &= fl[1:-1, 1:-1]
    if cut.any():
        s = 64
        off = (np.arange(s) + 0.5) / s
        idx = np.argwhere(cut)
        xs = (idx[:, 0:1] + off[None, :]) * dx      # (N, s)
        ys = (idx[:, 1:2] + off[None, :]) * dy
        vals = phi(xs[:, :, None], ys[:, None, :]) >= 0.0
        theta[cut] = vals.mean(axis=(1, 2))
    return Apertures(au=au, av=av, theta=theta)


@functools.lru_cache(maxsize=32)
def _device_apertures(params: Params, dtype: torch.dtype,
                      device: torch.device):
    ap = apertures(params)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (ap.au, ap.av))


def poisson_rhs(F: torch.Tensor, G: torch.Tensor, dt,
                params: Params) -> torch.Tensor:
    """Poisson rhs of an obstacle domain: the aperture-weighted divergence
    when the cut-cell closure is active (``apertures``), else the plain
    divergence; 0 on solid cells either way.  Takes F/G already pinned
    (``pin_fg``)."""
    if not aperture_active(params):
        return mask_rhs(momentum.compute_rhs(F, G, dt, params), params)
    au, av = _device_apertures(params, F.dtype, F.device)
    Fa = F * au
    Ga = G * av
    div = (st.div(Fa[1:-1, 1:-1] - Fa[:-2, 1:-1], params.dx)
           + st.div(Ga[1:-1, 1:-1] - Ga[1:-1, :-2], params.dy))
    rhs = torch.zeros_like(F)
    rhs[1:-1, 1:-1] = div / dt
    return mask_rhs(rhs, params)


def pin_fg(F: torch.Tensor, G: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           params: Params):
    """(F, G) with F = u and G = v on every BC-controlled edge (Griebel eq.
    3.42 on the obstacle faces, as momentum.compute_fg pins the outer
    walls); new tensors."""
    m = device_masks(params, F.device)
    return torch.where(m.u_solid, u, F), torch.where(m.v_solid, v, G)


def mask_rhs(rhs: torch.Tensor, params: Params) -> torch.Tensor:
    """The Poisson rhs with 0 on solid cells (they carry no equation)."""
    m = device_masks(params, rhs.device)
    return torch.where(m.fluid, rhs,
                       torch.zeros((), dtype=rhs.dtype, device=rhs.device))


# ---------------------------------------------------------------------------
# Surface-traction quadrature on the TRUE wall,
#
#     F = oint_S ( -p n + mu (du_t/dn) t ) ds,
#
# p and u_t sampled on two probe rings off the wall (pushed outward until
# every bilinear stencil reads genuine fluid nodes) and extrapolated to it:
# p linearly, du_t/dn by the quadratic through u_t(0) = 0.  The tables are
# static numpy, built once per Params.
# ---------------------------------------------------------------------------


class SurfaceQuad(NamedTuple):
    """Static quadrature tables for `surface_force` (all numpy float64 /
    int32).  Gather tables are (N, 4) [ii, jj] padded indices + weights."""

    nx: np.ndarray
    ny: np.ndarray
    tx: np.ndarray
    ty: np.ndarray
    ds: np.ndarray
    d1: np.ndarray
    d2: np.ndarray
    p1: tuple     # (ii, jj, w) for pressure ring 1
    p2: tuple
    u1: tuple
    u2: tuple
    v1: tuple
    v2: tuple


def _bilinear_table(X, Y, dx, dy, ox, oy, shape):
    """Bilinear gather table for probes (X, Y) on the staggered grid whose
    node (i, j) sits at ((i - ox) dx, (j - oy) dy) in padded indexing."""
    fi = X / dx + ox
    fj = Y / dy + oy
    i0 = np.clip(np.floor(fi).astype(np.int32), 0, shape[0] - 2)
    j0 = np.clip(np.floor(fj).astype(np.int32), 0, shape[1] - 2)
    a = fi - i0
    b = fj - j0
    ii = np.stack([i0, i0 + 1, i0, i0 + 1], axis=1)
    jj = np.stack([j0, j0, j0 + 1, j0 + 1], axis=1)
    w = np.stack([(1 - a) * (1 - b), a * (1 - b), (1 - a) * b, a * b],
                 axis=1)
    return ii, jj, w


@functools.lru_cache(maxsize=16)
def surface_quadrature(params: Params, n_theta: int = 0) -> SurfaceQuad:
    """Build the static traction quadrature for params' analytic surface.
    Currently supports exactly one 'circle' level set (the Schäfer-Turek
    configuration); box/plane obstacles are grid-aligned, where the CV
    balance is already exact-normal.  `n_theta` = 0 picks ~3 samples per
    wall-adjacent cell."""
    surfs = [s for s in params.obstacle_surfaces if s[0] == "circle"]
    if len(surfs) != 1 or len(surfs) != len(params.obstacle_surfaces):
        raise ValueError("surface_quadrature needs exactly one 'circle' "
                         "obstacle surface")
    _, cx, cy, r = surfs[0]
    dx, dy = params.dx, params.dy
    h = max(dx, dy)
    if not n_theta:
        n_theta = max(64, int(np.ceil(3.0 * 2.0 * np.pi * r / h)))
    th = (np.arange(n_theta) + 0.5) * (2.0 * np.pi / n_theta)
    nx, ny = np.cos(th), np.sin(th)
    tx, ty = -np.sin(th), np.cos(th)
    ds = np.full(n_theta, 2.0 * np.pi * r / n_theta)
    n_hat = np.stack([nx, ny], axis=1)

    m = masks(params)
    shape = m.fluid.shape
    # Valid interpolation sources: genuine fluid cells for p; velocity
    # edges NOT controlled by obstacle BCs (domain-wall edges are fine —
    # they hold physical values — but the cylinder sits mid-channel).
    p_valid = m.fluid
    u_valid = ~m.u_solid
    v_valid = ~m.v_solid

    # Probe centers are surface points; distances measured along n_hat
    # from the surface.  Build per-field d1/d2 then take the max across
    # fields so ONE ring geometry serves p, u and v (keeps the quadratic
    # fit consistent across the traction terms).
    surf = np.stack([cx + r * nx, cy + r * ny], axis=1)

    def push(valid, ox, oy, d0):
        d = np.full(n_theta, float(d0))
        for _ in range(25):            # checks d0 .. d0 + 6h inclusive
            X = surf[:, 0] + d * n_hat[:, 0]
            Y = surf[:, 1] + d * n_hat[:, 1]
            ii, jj, _ = _bilinear_table(X, Y, dx, dy, ox, oy, shape)
            ok = valid[ii, jj].all(axis=1)
            if ok.all():
                return d
            d = np.where(ok, d, d + 0.25 * h)
        raise ValueError(
            f"surface probe found no all-fluid bilinear stencil within "
            f"{d0 + 6 * h:.3g} of the wall — obstacle too close to other "
            f"geometry for surface-traction quadrature")

    d1 = np.maximum.reduce([push(p_valid, 0.5, 0.5, 1.2 * h),
                            push(u_valid, 0.0, 0.5, 1.2 * h),
                            push(v_valid, 0.5, 0.0, 1.2 * h)])
    d2 = np.maximum.reduce([push(p_valid, 0.5, 0.5, 2.2 * h),
                            push(u_valid, 0.0, 0.5, 2.2 * h),
                            push(v_valid, 0.5, 0.0, 2.2 * h),
                            d1 + 0.8 * h])

    def table(d, ox, oy):
        X = surf[:, 0] + d * n_hat[:, 0]
        Y = surf[:, 1] + d * n_hat[:, 1]
        return _bilinear_table(X, Y, dx, dy, ox, oy, shape)

    return SurfaceQuad(
        nx=nx, ny=ny, tx=tx, ty=ty, ds=ds, d1=d1, d2=d2,
        p1=table(d1, 0.5, 0.5), p2=table(d2, 0.5, 0.5),
        u1=table(d1, 0.0, 0.5), u2=table(d2, 0.0, 0.5),
        v1=table(d1, 0.5, 0.0), v2=table(d2, 0.5, 0.0))


class DeviceQuad(NamedTuple):
    """A ``SurfaceQuad`` on a device: the per-sample arrays in the fields'
    dtype, the gather tables as (N, 4) index tensors and weights."""

    nx: torch.Tensor
    ny: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    ds: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    p1: tuple
    p2: tuple
    u1: tuple
    u2: tuple
    v1: tuple
    v2: tuple


@functools.lru_cache(maxsize=16)
def device_quadrature(params: Params, dtype: torch.dtype,
                      device: torch.device, n_theta: int = 0) -> DeviceQuad:
    """``surface_quadrature(params, n_theta)`` on `device`, made once."""
    q = surface_quadrature(params, n_theta)

    def arr(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def table(t):
        ii, jj, w = t
        return (torch.from_numpy(ii.astype(np.int64)).to(device),
                torch.from_numpy(jj.astype(np.int64)).to(device), arr(w))

    return DeviceQuad(*(arr(a) for a in q[:7]), *(table(t) for t in q[7:]))


def surface_force(u, v, p, params: Params, quad: DeviceQuad = None,
                  return_samples: bool = False):
    """(F_x, F_y), 0-d tensors, by traction quadrature on the analytic
    surface: a handful of static gathers, no control-volume fluxes and no
    dM/dt term.  `quad` defaults to ``device_quadrature`` of `params` in
    p's dtype on its device.  `return_samples` also returns the per-sample
    wall pressure and wall-normal slope of the tangential velocity."""
    q = quad if quad is not None else device_quadrature(params, p.dtype,
                                                        p.device)

    def gather(field, tbl):
        ii, jj, w = tbl
        g = field[ii, jj] * w
        return g[:, 0] + g[:, 1] + g[:, 2] + g[:, 3]

    d1, d2 = q.d1, q.d2
    p1 = gather(p, q.p1)
    p2 = gather(p, q.p2)
    ps = p1 + (p1 - p2) * d1 / (d2 - d1)        # linear extrapolation
    ut1 = gather(u, q.u1) * q.tx + gather(v, q.v1) * q.ty
    ut2 = gather(u, q.u2) * q.tx + gather(v, q.v2) * q.ty
    # Quadratic u_t(n) through (0, 0), (d1, ut1), (d2, ut2): slope at wall.
    dutdn = (ut1 * d2 * d2 - ut2 * d1 * d1) / (d1 * d2 * (d2 - d1))
    nu = 1.0 / params.Re
    fx = torch.sum((-ps * q.nx + nu * dutdn * q.tx) * q.ds)
    fy = torch.sum((-ps * q.ny + nu * dutdn * q.ty) * q.ds)
    if return_samples:
        return fx, fy, ps, dutdn
    return fx, fy


def n_fluid_cells(params: Params) -> int:
    """Static fluid-cell count (the masked solvers' norm denominator)."""
    if not params.obstacles:
        return params.i_max * params.j_max
    return int(fluid_mask(params)[1:-1, 1:-1].sum())


def inflow_profile(params: Params) -> np.ndarray:
    """Channel inflow u(y) at column i = 1, obstacle-aware: a unit-peak
    parabola over EACH contiguous fluid span of the inflow column (reduces
    to the plain Poiseuille profile without obstacles; gives the
    backward-facing step its upper-half inflow for free)."""
    fl = fluid_mask(params)[1, 1:-1] if params.obstacles else \
        np.ones(params.j_max, bool)
    prof = np.zeros(params.j_max)
    j = 0
    while j < params.j_max:
        if not fl[j]:
            j += 1
            continue
        k = j
        while k < params.j_max and fl[k]:
            k += 1
        span = (k - j) * params.dy          # fluid span height
        y = (np.arange(j, k) - j + 0.5) * params.dy
        prof[j:k] = 4.0 * y * (span - y) / (span * span)
        j = k
    return prof

