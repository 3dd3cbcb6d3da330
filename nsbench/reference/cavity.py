"""A plain MAC solver of the lid-driven cavity: the benchmark's reference.

Written from the serial algorithm of Griebel, Dornseifer and Neunhoeffer
(1998), chapter 3, as the reference C code (NavierStokes-parallel,
src/serial) runs it, in float64 PyTorch with no kernel and no batching.  It
imports nothing of the program under test.  One time step:

    dt = tau * min(Re / 2 / (1/dx^2 + 1/dy^2), dx / |u_max|, dy / |v_max|)
    gamma = max(u_max dt / dx, v_max dt / dy)
        (u_max, v_max: the signed maxima over the interior faces, seeded
        with the ghost corner [0, 0], as the reference's max_mat does)
    cavity BCs: no-slip left, right and bottom, the lid on top
    F, G: donor-cell convection weighted by gamma, central diffusion
    rhs = div(F, G) / dt
    pressure: red-black SOR with Neumann ghosts (``sor``), or the exact
        solve by the discrete cosine transform (``direct``)
    u = F - dt dp/dx, v = G - dt dp/dy

Fields are padded (i_max + 2, j_max + 2) arrays, axis 0 along x: u[i, j]
on the right face of cell (i, j), v[i, j] on its top face, p at its
centre.

``store`` rounds every field a stage writes (u, v, F, G, rhs, p) to the
precision the fields are kept in; the identity keeps float64.  The
benchmark's precision control passes a rounding to bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

F64 = torch.float64

# The offset of the stopping rule: ||res|| <= eps (||p_0|| + 1.5).
NORM_OFFSET = 1.5


class Grid(NamedTuple):
    i_max: int
    j_max: int
    dx: float
    dy: float


class Result(NamedTuple):
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    t: float
    steps: int
    sweeps: int


def grid(prm: Dict) -> Grid:
    return Grid(prm["i_max"], prm["j_max"], prm["a"] / prm["i_max"],
                prm["b"] / prm["j_max"])


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _signed_max(x: torch.Tensor) -> float:
    return max(float(x[0, 0]), float(x[1:-1, 1:-1].max()))


def time_step(u, v, prm: Dict, g: Grid):
    """(dt, gamma) of the CFL rule, as Python floats."""
    u_max, v_max = _signed_max(u), _signed_max(v)
    visc = prm["Re"] / 2.0 / (1.0 / g.dx ** 2 + 1.0 / g.dy ** 2)
    bounds = [visc]
    if u_max != 0.0:
        bounds.append(g.dx / abs(u_max))
    if v_max != 0.0:
        bounds.append(g.dy / abs(v_max))
    dt = prm["tau"] * min(bounds)
    gamma = max(u_max * dt / g.dx, v_max * dt / g.dy)
    return dt, gamma


def cavity_bcs(u, v, lid: float) -> None:
    """No-slip walls, the lid moving at `lid` on top; in place.  The right
    wall's u is set before the lid's ghost reads u[i_max, j_max]."""
    u[0, 1:-1] = 0.0
    v[0, 1:-1] = -v[1, 1:-1]
    u[-2, 1:-1] = 0.0
    v[-1, 1:-1] = -v[-2, 1:-1]
    v[1:-1, 0] = 0.0
    u[1:-1, 0] = -u[1:-1, 1]
    v[1:-1, -2] = 0.0
    u[1:-1, -1] = 2.0 * lid - u[1:-1, -2]


def _c(x, di: int, dj: int):
    """The interior of `x` shifted by (di, dj)."""
    ni, nj = x.shape
    return x[1 + di:ni - 1 + di, 1 + dj:nj - 1 + dj]


def tentative(u, v, dt: float, gamma: float, prm: Dict, g: Grid):
    """F and G (Griebel et al. eqs. 3.19-3.20 with the donor-cell terms);
    F = u on the x walls, G = v on the y walls, 0 elsewhere outside the
    update."""
    dx, dy, re = g.dx, g.dy, prm["Re"]
    uc, ue, uw, un, us = (_c(u, 0, 0), _c(u, 1, 0), _c(u, -1, 0),
                          _c(u, 0, 1), _c(u, 0, -1))
    vc, ve, vw, vn, vs = (_c(v, 0, 0), _c(v, 1, 0), _c(v, -1, 0),
                          _c(v, 0, 1), _c(v, 0, -1))
    # d(u^2)/dx and d(uv)/dy at u's faces.
    a_e, a_w = 0.5 * (uc + ue), 0.5 * (uw + uc)
    du2dx = ((a_e * a_e - a_w * a_w) / dx
             + gamma / dx * (a_e.abs() * 0.5 * (uc - ue)
                             - a_w.abs() * 0.5 * (uw - uc)))
    v_n = 0.5 * (vc + ve)
    v_s = 0.5 * (_c(v, 0, -1) + _c(v, 1, -1))
    duvdy = ((v_n * 0.5 * (uc + un) - v_s * 0.5 * (us + uc)) / dy
             + gamma / dy * (v_n.abs() * 0.5 * (uc - un)
                             - v_s.abs() * 0.5 * (us - uc)))
    lap_u = (ue - 2.0 * uc + uw) / dx ** 2 + (un - 2.0 * uc + us) / dy ** 2
    f_int = uc + dt * (lap_u / re - du2dx - duvdy + prm["g_x"])
    # d(uv)/dx and d(v^2)/dy at v's faces.
    u_e = 0.5 * (uc + un)
    u_w = 0.5 * (uw + _c(u, -1, 1))
    duvdx = ((u_e * 0.5 * (vc + ve) - u_w * 0.5 * (vw + vc)) / dx
             + gamma / dx * (u_e.abs() * 0.5 * (vc - ve)
                             - u_w.abs() * 0.5 * (vw - vc)))
    b_n, b_s = 0.5 * (vc + vn), 0.5 * (vs + vc)
    dv2dy = ((b_n * b_n - b_s * b_s) / dy
             + gamma / dy * (b_n.abs() * 0.5 * (vc - vn)
                             - b_s.abs() * 0.5 * (vs - vc)))
    lap_v = (ve - 2.0 * vc + vw) / dx ** 2 + (vn - 2.0 * vc + vs) / dy ** 2
    g_int = vc + dt * (lap_v / re - duvdx - dv2dy + prm["g_y"])

    F, G = torch.zeros_like(u), torch.zeros_like(v)
    F[1:g.i_max, 1:-1] = f_int[:g.i_max - 1]
    G[1:-1, 1:g.j_max] = g_int[:, :g.j_max - 1]
    F[0, 1:-1], F[g.i_max, 1:-1] = u[0, 1:-1], u[g.i_max, 1:-1]
    G[1:-1, 0], G[1:-1, g.j_max] = v[1:-1, 0], v[1:-1, g.j_max]
    return F, G


def poisson_rhs(F, G, dt: float, g: Grid):
    rhs = torch.zeros_like(F)
    rhs[1:-1, 1:-1] = ((_c(F, 0, 0) - _c(F, -1, 0)) / g.dx
                       + (_c(G, 0, 0) - _c(G, 0, -1)) / g.dy) / dt
    return rhs


def l2(x: torch.Tensor, g: Grid) -> float:
    """sqrt(sum(x^2) / (i_max j_max)) over an interior-shaped array."""
    return math.sqrt(float((x * x).sum()) / (g.i_max * g.j_max))


def residual(p, rhs, g: Grid):
    """A p - rhs on the interior, p's ghosts as they are."""
    return ((_c(p, 1, 0) - 2.0 * _c(p, 0, 0) + _c(p, -1, 0)) / g.dx ** 2
            + (_c(p, 0, 1) - 2.0 * _c(p, 0, 0) + _c(p, 0, -1)) / g.dy ** 2
            - _c(rhs, 0, 0))


def neumann_ghosts(p) -> None:
    """Each ghost cell takes its interior neighbour's value; in place."""
    p[0, 1:-1] = p[1, 1:-1]
    p[-1, 1:-1] = p[-2, 1:-1]
    p[1:-1, 0] = p[1:-1, 1]
    p[1:-1, -1] = p[1:-1, -2]


def sor(p, rhs, prm: Dict, g: Grid, check_every: int):
    """Red-black SOR with relaxation omega from p, the stopping rule read
    every `check_every` sweeps, at most max_it sweeps.  A half-sweep
    updates the cells of one colour ((i + j) even first) from the ghosts
    the Neumann closure gives the current values; its stencil and
    relaxation are one 3x3 convolution (a x p + coef x neighbours, with
    Neumann ghosts by replicate padding) less coef x rhs.  Returns (p,
    sweeps)."""
    omega = prm["omega"]
    dx2, dy2 = 1.0 / g.dx ** 2, 1.0 / g.dy ** 2
    coef = omega / (2.0 * (dx2 + dy2))
    weights = torch.tensor([[0.0, coef * dx2, 0.0],
                            [coef * dy2, 1.0 - omega, coef * dy2],
                            [0.0, coef * dx2, 0.0]], dtype=F64,
                           device=p.device).view(1, 1, 3, 3)
    p = p.clone()
    interior = p[1:-1, 1:-1]
    coef_rhs = coef * rhs[1:-1, 1:-1]
    ii = torch.arange(g.i_max, device=p.device).view(-1, 1)
    jj = torch.arange(g.j_max, device=p.device).view(1, -1)
    colours = [(ii + jj) % 2 == c for c in (0, 1)]
    threshold = prm["epsilon"] * (l2(interior, g) + NORM_OFFSET)
    done = 0
    while done < prm["max_it"]:
        n = min(check_every, prm["max_it"] - done)
        for _ in range(n):
            for mask in colours:
                padded = torch.nn.functional.pad(
                    interior.view(1, 1, g.i_max, g.j_max), (1, 1, 1, 1),
                    mode="replicate")
                new = torch.nn.functional.conv2d(padded, weights).view(
                    g.i_max, g.j_max) - coef_rhs
                torch.where(mask, new, interior, out=interior)
        done += n
        neumann_ghosts(p)
        if l2(residual(p, rhs, g), g) <= threshold:
            break
    neumann_ghosts(p)
    return p, done


def _dct_basis(n: int, device) -> torch.Tensor:
    """The orthonormal DCT-II matrix C (C @ x transforms a column), whose
    rows are the eigenvectors of the Neumann second difference."""
    k = torch.arange(n, dtype=F64, device=device).view(-1, 1)
    i = torch.arange(n, dtype=F64, device=device).view(1, -1)
    c = torch.cos(math.pi * k * (2.0 * i + 1.0) / (2.0 * n))
    c *= math.sqrt(2.0 / n)
    c[0] /= math.sqrt(2.0)
    return c


class DirectSolver:
    """The exact solve of the Neumann Poisson problem, zero mean, by the
    DCT-II that diagonalises the 5-point Laplacian with Neumann ghosts."""

    def __init__(self, g: Grid, device):
        self.ci = _dct_basis(g.i_max, device)
        self.cj = (self.ci if g.j_max == g.i_max
                   else _dct_basis(g.j_max, device))
        li = -4.0 / g.dx ** 2 * torch.sin(
            math.pi * torch.arange(g.i_max, dtype=F64, device=device)
            / (2.0 * g.i_max)) ** 2
        lj = -4.0 / g.dy ** 2 * torch.sin(
            math.pi * torch.arange(g.j_max, dtype=F64, device=device)
            / (2.0 * g.j_max)) ** 2
        lam = li.view(-1, 1) + lj.view(1, -1)
        lam[0, 0] = 1.0
        self.inv = 1.0 / lam
        self.inv[0, 0] = 0.0

    def __call__(self, p, rhs):
        hat = self.ci @ rhs[1:-1, 1:-1] @ self.cj.T
        out = torch.zeros_like(p)
        out[1:-1, 1:-1] = self.ci.T @ (hat * self.inv) @ self.cj
        neumann_ghosts(out)
        return out, 1


def solve(u0, v0, prm: Dict, pressure: str, check_every: int = 1,
          store: Optional[Callable] = None, max_steps: int = 0) -> Result:
    """Integrate the cavity from (u0, v0), p = 0, t = 0 to t >= T, or
    `max_steps` steps when it is > 0.  `pressure` is "sor" (red-black SOR,
    the stopping rule read every `check_every` sweeps) or "direct"."""
    if prm["problem"] != 1:
        raise ValueError("the reference runs the lid-driven cavity "
                         "(problem 1)")
    store = store or _identity
    g = grid(prm)
    u, v = store(u0.to(F64)), store(v0.to(F64))
    p = torch.zeros_like(u)
    direct = DirectSolver(g, u.device) if pressure == "direct" else None
    if pressure not in ("sor", "direct"):
        raise ValueError(f"unknown reference pressure solve {pressure!r}")
    t, steps, sweeps = 0.0, 0, 0
    while t < prm["T"] and not 0 < max_steps <= steps:
        u, v = u.clone(), v.clone()
        dt, gamma = time_step(u, v, prm, g)
        cavity_bcs(u, v, 1.0)
        F, G = tentative(u, v, dt, gamma, prm, g)
        F, G = store(F), store(G)
        rhs = store(poisson_rhs(F, G, dt, g))
        if direct is not None:
            p, n = direct(p, rhs)
        else:
            p, n = sor(p, rhs, prm, g, check_every)
        p = store(p)
        u[1:g.i_max, 1:-1] = (_c(F, 0, 0) - dt * (_c(p, 1, 0) - _c(p, 0, 0))
                              / g.dx)[:g.i_max - 1]
        v[1:-1, 1:g.j_max] = (_c(G, 0, 0) - dt * (_c(p, 0, 1) - _c(p, 0, 0))
                              / g.dy)[:, :g.j_max - 1]
        u, v = store(u), store(v)
        t += dt
        steps += 1
        sweeps += n
    return Result(u=u, v=v, p=p, t=t, steps=steps, sweeps=sweeps)
