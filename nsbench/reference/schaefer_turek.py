"""A plain MAC solver of flow past a cylinder in a channel (Schäfer and
Turek 1996, DFG benchmark 2D-2): the benchmark's reference for the
``schaefer_turek`` family.

Written from Griebel, Dornseifer and Neunhoeffer (1998), chapters 3 and 5
(the channel and flag-field obstacles), with the second-order wall closure
that the program documents for a registered circle: ghost-fluid velocities
against the true circle (Tseng and Ferziger 2003) and the cut-cell pressure
operator (Johansen and Colella 1998).  Float64 PyTorch, no kernel and no
batching; it imports nothing of the program under test.  One time step:

    dt, gamma      the CFL rule of ``cavity.time_step``, before the BCs
    channel BCs    parabolic inflow of peak 1 over each fluid span of the
                   left column, zero-gradient outflow whose u is shifted on
                   its fluid rows so that its flux equals the inflow's,
                   no-slip bottom and top
    obstacle BCs   every velocity edge that touches a solid cell takes 0,
                   or, next to the fluid, the ghost-fluid value w x (its one
                   in-line fluid neighbour), w from a linear profile that
                   vanishes where the line meets the circle
    F, G           the donor-cell F and G of ``cavity.tentative``, then F = u
                   and G = v on every edge that touches a solid cell
    rhs            the aperture-weighted divergence / dt on fluid cells,
                   each face weighted by its open fraction A in [0, 1]
    pressure       sum_d (A_d / h^2) (p_d - p) = rhs - mean(rhs) over the
                   fluid cells, solved exactly (``ExactPoisson``), p less
                   its fluid mean
    projection     u = F - dt dp/dx, v = G - dt dp/dy on the interior faces,
                   then the obstacle BCs again

Geometry, in closed form where the program bisects: the solid cells are
those whose centre lies in the circle, less any cell that has fluid on two
opposite sides, repeated until none has; a face's open fraction is 1 or 0
when its two corners lie on one side of the circle, else the fraction of
the face outside it, from the circle's intersection with the face; a
ghost-fluid weight is the line's intersection with the circle, where the
program bisects 60 times.  The rules the program documents are kept: a
weight within 1e-9 of the mirror constants -1 or 0 is snapped to them and
is clipped to [-3, 3]; faces that touch a solid cell are closed; faces
between two fluid cells are opened to at least 0.05.

Departures from the published case: the run is in diameter units (the
channel 22 x 4.1, the cylinder of diameter 1 at (2, 2), the inflow's peak
1, so Re_D = 100 on the mean velocity is Re = 150), on a uniform MAC grid
with the circle rasterised to whole cells, from the state it is given up to
the configuration's T, not to the periodic regime.  Departures from the
program: the geometry in closed form (above); the pressure solved exactly,
where the program stops its f64-refined multigrid at its stopping rule;
every sum in float64 and in PyTorch's order.

Fields are padded (i_max + 2, j_max + 2) arrays, axis 0 along x: u[i, j]
on the right face of cell (i, j), v[i, j] on its top face, p at its centre.
``store`` rounds every field a stage writes (u, v, F, G, rhs, p) to the
precision the fields are kept in; the identity keeps float64.  The
benchmark's precision control passes a rounding to bfloat16.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import cavity

F64 = torch.float64
# Snapping and clipping of the ghost-fluid weights, and the least open
# fraction of a face between two fluid cells: the program's documented
# closure.
SNAP = 1e-9
WEIGHT_CLIP = 3.0
APERTURE_FLOOR = 0.05
# The exact solve's relative residual over the fluid cells, and the passes
# of iterative refinement it may take to reach it.
SOLVE_TOL = 1e-12
REFINE_PASSES = 4


class Result(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    t: float
    steps: int


class Geometry(NamedTuple):
    """Padded float64 or bool arrays on one device."""

    fluid: torch.Tensor       # fluid interior cells
    u_solid: torch.Tensor     # u edges that touch a solid cell
    v_solid: torch.Tensor
    u_weights: Tuple[Tuple[torch.Tensor, int, int], ...]  # (w, di, dj)
    v_weights: Tuple[Tuple[torch.Tensor, int, int], ...]
    au: torch.Tensor          # open fraction of the face of u[i, j]
    av: torch.Tensor          # of the face of v[i, j]
    inflow: torch.Tensor      # u at the inflow, rows 1 .. j_max
    outflow_fluid: torch.Tensor  # fluid rows of the outflow column


def circle(prm: Dict) -> Tuple[float, float, float]:
    """(cx, cy, r) of the configuration's one registered circle."""
    surfaces = [tuple(s) for s in prm.get("obstacle_surfaces", ())]
    if len(surfaces) != 1 or surfaces[0][0] != "circle":
        raise ValueError("the reference runs one registered circle, got "
                         f"{surfaces!r}")
    _, cx, cy, r = surfaces[0]
    return float(cx), float(cy), float(r)


def phi(x, y, c: Tuple[float, float, float]):
    """Signed distance to the circle: > 0 in the fluid, < 0 inside."""
    return torch.hypot(x - c[0], y - c[1]) - c[2]


def circle_cells(c: Tuple[float, float, float], dx: float, dy: float,
                 i_max: int, j_max: int, device="cpu") -> torch.Tensor:
    """(i_max, j_max) bool: the cells whose centre lies in the circle, less
    those with fluid on two opposite sides, to a fixed point."""
    x = (torch.arange(1, i_max + 1, dtype=F64, device=device) - 0.5) * dx
    y = (torch.arange(1, j_max + 1, dtype=F64, device=device) - 0.5) * dy
    ddx, ddy = x.view(-1, 1) - c[0], y.view(1, -1) - c[1]
    solid = ddx * ddx + ddy * ddy <= c[2] * c[2]
    while bool(solid.any()):
        fl = torch.ones((i_max + 2, j_max + 2), dtype=torch.bool,
                        device=device)
        fl[1:-1, 1:-1] = ~solid
        thin = solid & ((fl[2:, 1:-1] & fl[:-2, 1:-1])
                        | (fl[1:-1, 2:] & fl[1:-1, :-2]))
        if not bool(thin.any()):
            return solid
        solid = solid & ~thin
    raise ValueError("the circle rasterises to no cell")


def fluid_of(prm: Dict, device="cpu") -> torch.Tensor:
    """Padded bool, True on the fluid interior cells: the circle's cells
    taken out, which must be the configuration's obstacle rectangles."""
    i_max, j_max = prm["i_max"], prm["j_max"]
    dx, dy = prm["a"] / i_max, prm["b"] / j_max
    solid = circle_cells(circle(prm), dx, dy, i_max, j_max, device)
    rects = torch.zeros_like(solid)
    for i0, i1, j0, j1 in prm["obstacles"]:
        rects[i0 - 1:i1, j0 - 1:j1] = True
    if not torch.equal(rects, solid):
        raise ValueError("the configuration's obstacle rectangles are not "
                         "the circle's cells")
    fluid = torch.zeros((i_max + 2, j_max + 2), dtype=torch.bool,
                        device=device)
    fluid[1:-1, 1:-1] = ~solid
    return fluid


def crossing(x0, y0, x1, y1, c: Tuple[float, float, float]):
    """Where the segment from (x0, y0), inside the circle, to (x1, y1)
    meets it, as a fraction of the segment: the positive root of
    |P0 + t (P1 - P0) - C|^2 = r^2, in the form that loses no digits."""
    ex, ey = x1 - x0, y1 - y0
    fx, fy = x0 - c[0], y0 - c[1]
    a = ex * ex + ey * ey
    b = 2.0 * (fx * ex + fy * ey)
    k = fx * fx + fy * fy - c[2] * c[2]
    root = torch.sqrt(torch.clamp(b * b - 4.0 * a * k, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, root, -root))
    safe_q = torch.where(q == 0.0, torch.ones_like(q), q)
    return torch.where(b >= 0.0, k / safe_q, q / a)


def _ghost_weight(px, py, qx, qy, c, mirror: float):
    """The ghost-fluid weight w of u(node) = w u(source) at nodes (px, py)
    with the in-line fluid source (qx, qy): the linear profile through the
    circle on the line, xi = 0 at the node and 1 at the source; `mirror`
    where the source is not in the fluid or the line misses the circle
    within a cell of the node."""
    f_node, f_src = phi(px, py, c), phi(qx, qy, c)
    ex, ey = 2.0 * px - qx, 2.0 * py - qy   # one cell behind the node
    ok = f_src > 0.0
    inside = ok & (f_node < 0.0)            # the wall between node, source
    t_in = crossing(px, py, qx, qy, c)
    w_in = -t_in / torch.clamp(1.0 - t_in, min=1e-12)
    behind = ok & (f_node >= 0.0) & (phi(ex, ey, c) < 0.0)
    xi = crossing(ex, ey, px, py, c) - 1.0  # the wall behind the node
    w_behind = -xi / (1.0 - xi)
    w = torch.where(inside, w_in, torch.where(behind, w_behind, mirror))
    w = torch.where((w + 1.0).abs() < SNAP, torch.full_like(w, -1.0), w)
    w = torch.where(w.abs() < SNAP, torch.zeros_like(w), w)
    return torch.clamp(w, -WEIGHT_CLIP, WEIGHT_CLIP)


def _shift(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """x[i + di, j + dj] at every (i, j), False or 0 off the array."""
    out = torch.zeros_like(x)
    ni, nj = x.shape
    out[max(0, -di):ni - max(0, di), max(0, -dj):nj - max(0, dj)] = \
        x[max(0, di):ni + min(0, di), max(0, dj):nj + min(0, dj)]
    return out


def _face_fraction(x0, y0, x1, y1, c):
    """The open fraction of the face from corner (x0, y0) to (x1, y1): 1 or
    0 when both corners lie on one side of the circle, else the part of the
    face outside it."""
    f0, f1 = phi(x0, y0, c), phi(x1, y1, c)
    out0 = f0 >= 0.0
    frac = (out0 & (f1 >= 0.0)).to(F64)
    first_in = torch.where(out0, crossing(x1, y1, x0, y0, c),
                           crossing(x0, y0, x1, y1, c))
    return torch.where(out0 != (f1 >= 0.0), 1.0 - first_in, frac)


def geometry(prm: Dict, device="cpu") -> Geometry:
    i_max, j_max = prm["i_max"], prm["j_max"]
    dx, dy = prm["a"] / i_max, prm["b"] / j_max
    c = circle(prm)
    fl = fluid_of(prm, device)
    shape = fl.shape
    ii = torch.arange(shape[0], dtype=F64, device=device).view(-1, 1)
    jj = torch.arange(shape[1], dtype=F64, device=device).view(1, -1)
    inner_u = torch.zeros(shape, dtype=torch.bool, device=device)
    inner_u[1:i_max, 1:-1] = True           # u edges between two cells
    inner_v = torch.zeros_like(inner_u)
    inner_v[1:-1, 1:j_max] = True
    # u edge (i, j) lies between cells (i, j) and (i + 1, j).
    e = _shift(fl, 1, 0)
    u_solid = inner_u & ~(fl & e)
    u_both = inner_u & ~fl & ~e
    n_fluid = _shift(fl, 0, 1) & _shift(fl, 1, 1)
    s_fluid = _shift(fl, 0, -1) & _shift(fl, 1, -1)
    u_tan_n = u_both & n_fluid
    u_tan_s = u_both & s_fluid & ~u_tan_n
    u_norm_e = inner_u & ~fl & e & _shift(fl, 2, 0)
    u_norm_w = inner_u & fl & ~e & _shift(fl, -1, 0)
    # v edge (i, j) lies between cells (i, j) and (i, j + 1).
    n = _shift(fl, 0, 1)
    v_solid = inner_v & ~(fl & n)
    v_both = inner_v & ~fl & ~n
    v_tan_e = v_both & _shift(fl, 1, 0) & _shift(fl, 1, 1)
    v_tan_w = v_both & _shift(fl, -1, 0) & _shift(fl, -1, 1) & ~v_tan_e
    v_norm_n = inner_v & ~fl & n & _shift(fl, 0, 2)
    v_norm_s = inner_v & fl & ~n & _shift(fl, 0, -1)

    # Coordinates as a column of x and a row of y, broadcast together.
    def u_at(di, dj):        # u node (i, j) lies at (i dx, (j - 1/2) dy)
        return (ii + di) * dx, (jj + dj - 0.5) * dy

    def v_at(di, dj):        # v node (i, j) lies at ((i - 1/2) dx, j dy)
        return (ii + di - 0.5) * dx, (jj + dj) * dy

    def weights(mask, at, di, dj, mirror):
        w = _ghost_weight(*at(0, 0), *at(di, dj), c, mirror)
        return torch.where(mask, w, torch.zeros_like(w)), di, dj

    u_weights = (weights(u_tan_n, u_at, 0, 1, -1.0),
                 weights(u_tan_s, u_at, 0, -1, -1.0),
                 weights(u_norm_e, u_at, 1, 0, 0.0),
                 weights(u_norm_w, u_at, -1, 0, 0.0))
    v_weights = (weights(v_tan_e, v_at, 1, 0, -1.0),
                 weights(v_tan_w, v_at, -1, 0, -1.0),
                 weights(v_norm_n, v_at, 0, 1, 0.0),
                 weights(v_norm_s, v_at, 0, -1, 0.0))

    # Open fractions: u's face (i, j) runs from corner (i, j - 1) to (i, j),
    # v's from (i - 1, j) to (i, j); corners at (i dx, j dy).
    au = _face_fraction(ii * dx, (jj - 1.0) * dy, ii * dx, jj * dy, c)
    av = _face_fraction((ii - 1.0) * dx, jj * dy, ii * dx, jj * dy, c)
    au_on = torch.zeros_like(inner_u)
    au_on[:i_max + 1, 1:-1] = True
    av_on = torch.zeros_like(inner_u)
    av_on[1:-1, :j_max + 1] = True
    solid = torch.zeros_like(inner_u)
    solid[1:-1, 1:-1] = ~fl[1:-1, 1:-1]
    zero = torch.zeros((), dtype=F64, device=device)
    au = torch.where(au_on & ~(solid | _shift(solid, 1, 0)), au, zero)
    av = torch.where(av_on & ~(solid | _shift(solid, 0, 1)), av, zero)
    au = torch.where(fl & e, torch.clamp(au, min=APERTURE_FLOOR), au)
    av = torch.where(fl & n, torch.clamp(av, min=APERTURE_FLOOR), av)

    col = fl[1, 1:-1].tolist()
    inflow = torch.zeros(j_max, dtype=F64)
    j = 0
    while j < j_max:               # a parabola over each fluid span
        if not col[j]:
            j += 1
            continue
        k = j
        while k < j_max and col[k]:
            k += 1
        span = (k - j) * dy
        y = (torch.arange(j, k, dtype=F64) - j + 0.5) * dy
        inflow[j:k] = 4.0 * y * (span - y) / (span * span)
        j = k
    return Geometry(fluid=fl, u_solid=u_solid, v_solid=v_solid,
                    u_weights=u_weights, v_weights=v_weights, au=au, av=av,
                    inflow=inflow.to(device), outflow_fluid=fl[-2, 1:-1])


def channel_bcs(u, v, geo: Geometry) -> None:
    """Inflow on the left, outflow on the right with its flux made the
    inflow's over its fluid rows, no-slip bottom and top; in place, in
    this order (the walls' ghosts read the corrected outflow edge)."""
    u[0, 1:-1] = geo.inflow
    v[0, 1:-1] = -v[1, 1:-1]
    u[-2, 1:-1] = u[-3, 1:-1]
    v[-1, 1:-1] = v[-2, 1:-1]
    out = geo.outflow_fluid
    q_in = u[0, 1:-1].sum()
    q_out = u[-2, 1:-1][out].sum()
    u[-2, 1:-1][out] += (q_in - q_out) / int(out.sum())
    v[1:-1, 0] = 0.0
    u[1:-1, 0] = -u[1:-1, 1]
    v[1:-1, -2] = 0.0
    u[1:-1, -1] = -u[1:-1, -2]


def obstacle_bcs(u, v, geo: Geometry) -> None:
    """Every edge that touches a solid cell takes its ghost-fluid value (0
    where it has no weight), all from the fields as they were; in place."""
    u_bc = sum(w * _shift(u, di, dj) for w, di, dj in geo.u_weights)
    v_bc = sum(w * _shift(v, di, dj) for w, di, dj in geo.v_weights)
    u.copy_(torch.where(geo.u_solid, u_bc, u))
    v.copy_(torch.where(geo.v_solid, v_bc, v))


def aperture_rhs(F, G, dt: float, prm: Dict, geo: Geometry):
    """(1/dt) sum of the faces' open fraction x flux, on fluid cells."""
    dx, dy = prm["a"] / prm["i_max"], prm["b"] / prm["j_max"]
    Fa, Ga = F * geo.au, G * geo.av
    rhs = torch.zeros_like(F)
    rhs[1:-1, 1:-1] = ((Fa[1:-1, 1:-1] - Fa[:-2, 1:-1]) / dx
                       + (Ga[1:-1, 1:-1] - Ga[1:-1, :-2]) / dy) / dt
    return torch.where(geo.fluid, rhs, torch.zeros_like(rhs))


class ExactPoisson:
    """sum_d (A_d / h^2) (p_d - p) = rhs over the fluid cells, solved
    exactly: the operator, negated (K, symmetric positive semi-definite),
    with one fluid cell held at 0 (then definite: the fluid is connected)
    and the solid cells as identity rows, is factored once by block
    Gaussian elimination over the columns of the grid (block tridiagonal,
    dense j_max x j_max blocks); each solve is the two substitutions, with
    iterative refinement until the relative residual of the whole
    operator over the fluid cells is at most SOLVE_TOL."""

    def __init__(self, prm: Dict, geo: Geometry):
        i_max, j_max = prm["i_max"], prm["j_max"]
        dx, dy = prm["a"] / i_max, prm["b"] / j_max
        fl = geo.fluid
        inner = fl[1:-1, 1:-1]
        zero = torch.zeros((), dtype=F64, device=fl.device)
        # Coupling of cell (i, j) to (i + 1, j) and to (i, j + 1).
        self.w_e = torch.where(inner & fl[2:, 1:-1],
                               (1.0 / (dx * dx)) * geo.au[1:-1, 1:-1], zero)
        self.w_n = torch.where(inner & fl[1:-1, 2:],
                               (1.0 / (dy * dy)) * geo.av[1:-1, 1:-1], zero)
        self.fluid = inner
        self.diag = self._sum(self.w_e, self.w_n)
        self.pin = tuple(int(k) for k in torch.nonzero(inner)[0])
        w_e, w_n = self.w_e.clone(), self.w_n.clone()
        i, j = self.pin
        w_e[i, j] = w_n[i, j] = 0.0
        if i > 0:
            w_e[i - 1, j] = 0.0
        if j > 0:
            w_n[i, j - 1] = 0.0
        diag = torch.where(inner, self.diag, torch.ones_like(self.diag))
        diag[i, j] = 1.0
        self._factor(w_e, w_n, diag)

    @staticmethod
    def _sum(w_e, w_n):
        w_w = torch.zeros_like(w_e)
        w_w[1:] = w_e[:-1]
        w_s = torch.zeros_like(w_n)
        w_s[:, 1:] = w_n[:, :-1]
        return w_e + w_w + w_n + w_s

    def _factor(self, w_e, w_n, diag):
        ni, nj = diag.shape
        self.coupling = w_e
        self.inverse: List[torch.Tensor] = []
        self.carry: List[torch.Tensor] = []
        eye = torch.arange(nj, device=diag.device)
        previous = None
        for i in range(ni):
            block = torch.zeros((nj, nj), dtype=F64, device=diag.device)
            block[eye, eye] = diag[i]
            block[eye[:-1], eye[1:]] = -w_n[i, :-1]
            block[eye[1:], eye[:-1]] = -w_n[i, :-1]
            if previous is not None:
                e = w_e[i - 1]
                block -= e.view(-1, 1) * previous * e.view(1, -1)
            inverse = torch.linalg.inv(block)
            self.inverse.append(inverse)
            # x_i = inverse (g_i) - carry_i x_{i+1}: carry = inverse E_i.
            self.carry.append(inverse * (-w_e[i]).view(1, -1))
            previous = inverse

    def _substitute(self, b: torch.Tensor) -> torch.Tensor:
        b = b.clone()
        b[self.pin] = 0.0
        h = []
        for i, inverse in enumerate(self.inverse):
            g = b[i] if i == 0 else b[i] + self.coupling[i - 1] * h[-1]
            h.append(inverse @ g)
        x = torch.empty_like(b)
        x[-1] = h[-1]
        for i in range(len(h) - 2, -1, -1):
            x[i] = h[i] - self.carry[i] @ x[i + 1]
        return x

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """A p on the fluid cells, 0 on the solid ones (interior arrays)."""
        out = -self.diag * p
        out[:-1] += self.w_e[:-1] * p[1:]
        out[1:] += self.w_e[:-1] * p[:-1]
        out[:, :-1] += self.w_n[:, :-1] * p[:, 1:]
        out[:, 1:] += self.w_n[:, :-1] * p[:, :-1]
        return torch.where(self.fluid, out, torch.zeros_like(out))

    def __call__(self, rhs: torch.Tensor) -> torch.Tensor:
        """p (padded, ghosts 0) with A p = rhs - mean(rhs) on the fluid
        cells and p's fluid mean 0."""
        zero = torch.zeros((), dtype=F64, device=rhs.device)
        r = torch.where(self.fluid, rhs[1:-1, 1:-1], zero)
        r = torch.where(self.fluid, r - r.sum() / int(self.fluid.sum()),
                        zero)
        scale = float(torch.linalg.vector_norm(r))
        x = torch.zeros_like(r)
        for _ in range(REFINE_PASSES + 1):
            res = self.apply(x) - r
            if float(torch.linalg.vector_norm(res)) <= SOLVE_TOL * scale:
                break
            x = x + self._substitute(res)
        else:
            raise RuntimeError("the exact pressure solve did not reach its "
                               "residual")
        x = torch.where(self.fluid, x - x[self.fluid].mean(), zero)
        p = torch.zeros_like(rhs)
        p[1:-1, 1:-1] = x
        return p


def solve(u0, v0, t0: float, prm: Dict, store: Optional[Callable] = None,
          max_steps: int = 0) -> Result:
    """Integrate from (u0, v0) at time t0 to t >= T, or `max_steps` steps
    when it is > 0."""
    if prm["problem"] != 3:
        raise ValueError("the reference runs the channel (problem 3)")
    store = store or cavity._identity
    g = cavity.grid(prm)
    geo = geometry(prm, u0.device)
    pressure = ExactPoisson(prm, geo)
    u, v = store(u0.to(F64)), store(v0.to(F64))
    p = torch.zeros_like(u)
    t, steps = float(t0), 0
    while t < prm["T"] and not 0 < max_steps <= steps:
        u, v = u.clone(), v.clone()
        dt, gamma = cavity.time_step(u, v, prm, g)
        channel_bcs(u, v, geo)
        obstacle_bcs(u, v, geo)
        F, G = cavity.tentative(u, v, dt, gamma, prm, g)
        F = store(torch.where(geo.u_solid, u, F))
        G = store(torch.where(geo.v_solid, v, G))
        rhs = store(aperture_rhs(F, G, dt, prm, geo))
        p = store(pressure(rhs))
        u[1:g.i_max, 1:-1] = (F[1:g.i_max, 1:-1] - dt * (
            p[2:g.i_max + 1, 1:-1] - p[1:g.i_max, 1:-1]) / g.dx)
        v[1:-1, 1:g.j_max] = (G[1:-1, 1:g.j_max] - dt * (
            p[1:-1, 2:g.j_max + 1] - p[1:-1, 1:g.j_max]) / g.dy)
        obstacle_bcs(u, v, geo)
        u, v = store(u), store(v)
        t += dt
        steps += 1
    return Result(u=u, v=v, p=p, t=t, steps=steps)
