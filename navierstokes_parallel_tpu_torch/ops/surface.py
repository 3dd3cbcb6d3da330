"""Free-surface (marker-and-cell) operators: the flag field from the marker
particles, the surface velocity conditions, and the pressure solve with the
Dirichlet surface condition.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/surface.py``
(Griebel et al. 1998 ch. 8):

  * the flag field is rebuilt every step from one integer scatter-add of
    the particle counts (exact in any order), so the geometry is data;
  * the surface cells' velocity condition is one divergence-zeroing
    correction spread over each surface cell's free faces (faces toward
    empty cells), with gravity integrated into the free faces first when
    `dt` is given, then one continuation pass into the first empty layer;
  * the pressure unknowns are the bulk fluid cells; surface cells carry
    the Dirichlet condition (p = 0, an explicit hydrostatic value, or the
    SUMMAC interpolated condition p_c = alpha p_ref refreshed once per
    outer pass).  The operator is ops/masked.py's neighbour-weight form,
    its weights built on the device from the flags every step (never
    cached: the flags change every step), and the solve is ops/sor.py's
    f64-master / f32-correction outer with its hooks, K masked red-black
    sweeps per pass.

Obstacle cells are folded out of the interior (``cell_flags``): they act as
the ghost ring does, and ``solve_pressure_free`` re-classifies flags made
by ``classify`` alone.  As in the JAX package, which runs this as jnp, no
kernel stands behind these operators: they are plain PyTorch on every
device.  ``solve_pressure_free``'s outer loop is ops/sor.py's, as
``masked.solve_pressure_masked``'s is: on the host, one flag read a pass.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import Params
from . import masked, obstacles, sor
from . import stencils as st
from .sor import SORResult, _checkerboard


class Flags(NamedTuple):
    """Per-step cell classification, padded (i_max+2, j_max+2) tensors.
    The ghost ring is neither fluid nor empty (walls)."""

    fluid: torch.Tensor    # interior cell holding >= 1 active particle
    empty: torch.Tensor    # interior cell with no particle
    surface: torch.Tensor  # fluid cell with >= 1 empty 4-neighbour
    bulk: torch.Tensor     # fluid cell with no empty neighbour (unknowns)
    fill: torch.Tensor     # fraction of the cell occupied by fluid


def _interior_mask(shape, device) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1] = True
    return m


def _domain_interior(params: Params, device) -> torch.Tensor:
    """The padded interior mask without the obstacle cells."""
    interior = _interior_mask(params.shape, device)
    if params.obstacles:
        interior &= obstacles.device_fluid_mask(params, device)
    return interior


def cell_flags(x: torch.Tensor, y: torch.Tensor, active: torch.Tensor,
               params: Params, ppc: Optional[int] = None,
               min_count: int = 1) -> Flags:
    """The flag field of the particle positions (Griebel sect. 8.1: a cell
    is fluid iff it holds a marker particle, at least `min_count`), by one
    integer scatter-add; inactive particles do not count.  count / ppc^2
    estimates the fill fraction; `ppc` defaults to
    params.particles_per_cell, the seeding density."""
    if ppc is None:
        ppc = params.particles_per_cell
    from ..particles import cell_indices  # particles imports the solver

    nx, ny = params.shape
    ci, cj = cell_indices(x, y, params)
    counts = torch.zeros(nx * ny, dtype=torch.int32, device=x.device)
    counts.index_add_(0, ci * ny + cj, active.to(torch.int32))
    counts = counts.view(nx, ny)
    interior = _domain_interior(params, x.device)
    fluid = (counts >= min_count) & interior
    fill = torch.clamp(st.div(counts.to(torch.float64), float(ppc * ppc)),
                       0.0, 1.0)
    return classify(fluid, interior, fill)


def classify(fluid: torch.Tensor, interior=None, fill=None) -> Flags:
    """The surface / bulk split of a padded fluid mask.  Only interior
    non-fluid cells count as empty neighbours: a wall never makes a
    surface cell."""
    if interior is None:
        interior = _interior_mask(fluid.shape, fluid.device)
    if fill is None:
        fill = fluid.to(torch.float32)
    empty = interior & ~fluid
    near_empty = torch.zeros_like(fluid)
    near_empty[1:-1, 1:-1] = (empty[2:, 1:-1] | empty[:-2, 1:-1]
                              | empty[1:-1, 2:] | empty[1:-1, :-2])
    return Flags(fluid=fluid, empty=empty, surface=fluid & near_empty,
                 bulk=fluid & ~near_empty, fill=fill)


def _interior_divergence(u, v, params: Params) -> torch.Tensor:
    """(i_max, j_max) cell divergences of padded face arrays."""
    return (st.div(u[1:-1, 1:-1] - u[:-2, 1:-1], params.dx)
            + st.div(v[1:-1, 1:-1] - v[1:-1, :-2], params.dy))


def apply_surface_bcs(u: torch.Tensor, v: torch.Tensor, flags: Flags,
                      params: Params, dt=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The free-surface velocity conditions, in place on u and v (returns
    them).  Pass 1: every surface cell zeroes its discrete divergence by
    correcting its free faces equally (Griebel eq. 8.10 for one free face,
    its symmetric generalisation for more; a free face has one fluid
    owner, so no face is written twice); with `dt` the body force is added
    to the free faces first.  Pass 2: faces between two empty cells take
    the mean of their defined neighbours (zero if none)."""
    em, surf = flags.empty, flags.surface
    si = surf[1:-1, 1:-1]
    e_free = si & em[2:, 1:-1]
    w_free = si & em[:-2, 1:-1]
    n_free = si & em[1:-1, 2:]
    s_free = si & em[1:-1, :-2]
    k = e_free.to(u.dtype) + w_free + n_free + s_free
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if dt is not None:
        gx = dt * params.g_x
        gy = dt * params.g_y
        u[1:-1, 1:-1] += torch.where(e_free, gx, zero)
        u[0:-2, 1:-1] += torch.where(w_free, gx, zero)
        v[1:-1, 1:-1] += torch.where(n_free, gy, zero)
        v[1:-1, 0:-2] += torch.where(s_free, gy, zero)
    div = _interior_divergence(u, v, params)
    share = torch.where(k > 0, div / torch.clamp(k, min=1), zero)
    dx, dy = params.dx, params.dy
    # The east face of cell (i, j) is u[i, j] (padded), the west u[i-1, j].
    u[1:-1, 1:-1] += torch.where(e_free, -share * dx, zero)
    u[0:-2, 1:-1] += torch.where(w_free, share * dx, zero)
    v[1:-1, 1:-1] += torch.where(n_free, -share * dy, zero)
    v[1:-1, 0:-2] += torch.where(s_free, share * dy, zero)

    # A u face (i, j) lies between cells (i, j) and (i+1, j): empty-empty
    # iff both are empty (faces next to the ghost ring are wall faces).
    u_ee = torch.zeros_like(em)
    u_ee[1:-2, 1:-1] = em[1:-2, 1:-1] & em[2:-1, 1:-1]
    v_ee = torch.zeros_like(em)
    v_ee[1:-1, 1:-2] = em[1:-1, 1:-2] & em[1:-1, 2:-1]
    u.copy_(_extend(u, u_ee))
    v.copy_(_extend(v, v_ee))
    return u, v


def _extend(a: torch.Tensor, undef: torch.Tensor) -> torch.Tensor:
    """One Jacobi continuation pass: undefined entries take the mean of
    their defined 4-neighbours (zero if none), reading them with wrapping
    rolls as the JAX module does.  A new tensor."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    defined = (~undef).to(a.dtype)
    av = torch.where(undef, zero, a)

    def nb(arr):
        return (torch.roll(arr, 1, 0) + torch.roll(arr, -1, 0)
                + torch.roll(arr, 1, 1) + torch.roll(arr, -1, 1))

    num = nb(av)
    den = nb(defined)
    return torch.where(undef, torch.where(den > 0,
                                          num / torch.clamp(den, min=1),
                                          zero), a)


def _traced_weights(flags: Flags, params: Params) -> masked._DeviceWeights:
    """The neighbour-weight operator of the free-surface Poisson problem
    (ops/masked.py's form) built from `flags` on their device, in `dtype`:
    the unknowns are the bulk cells; a fluid neighbour (bulk or surface)
    keeps its geometric weight, so a surface cell's Dirichlet value,
    which rides in the pressure array, enters with it; wall and empty
    neighbours drop out.  float64 weights, as the JAX module's;
    ``n_fluid`` (the bulk count, at least 1) stays a device tensor;
    ``red`` / ``black`` are the bulk cells of each colour."""
    device = flags.fluid.device
    f64 = torch.float64
    dx2_inv = st.scalar(1.0 / (params.dx * params.dx), f64, device)
    dy2_inv = st.scalar(1.0 / (params.dy * params.dy), f64, device)
    zero = torch.zeros((), dtype=f64, device=device)
    fl, bi = flags.fluid, flags.bulk[1:-1, 1:-1]
    w_e = torch.where(bi & fl[2:, 1:-1], dx2_inv, zero)
    w_w = torch.where(bi & fl[:-2, 1:-1], dx2_inv, zero)
    w_n = torch.where(bi & fl[1:-1, 2:], dy2_inv, zero)
    w_s = torch.where(bi & fl[1:-1, :-2], dy2_inv, zero)
    diag = w_e + w_w + w_n + w_s
    diag = torch.where(diag > 0.0, diag, torch.ones((), dtype=f64,
                                                     device=device))
    shape = bi.shape
    return masked._DeviceWeights(
        w_e=w_e, w_w=w_w, w_n=w_n, w_s=w_s, diag=diag, fluid=bi,
        n_fluid=torch.clamp(torch.sum(bi), min=1),
        red=_checkerboard(shape, 0, device=device) & bi,
        black=_checkerboard(shape, 1, device=device) & bi)


def _as_dtype(w: masked._DeviceWeights, dtype) -> masked._DeviceWeights:
    """`w`'s weights rounded to `dtype`."""
    return w._replace(w_e=w.w_e.to(dtype), w_w=w.w_w.to(dtype),
                      w_n=w.w_n.to(dtype), w_s=w.w_s.to(dtype),
                      diag=w.diag.to(dtype))


def surface_pressure(flags: Flags, params: Params) -> torch.Tensor:
    """The EXPLICIT sub-cell hydrostatic Dirichlet values of the surface
    cells (``p_surface="hydrostatic"``), kept as the JAX module keeps it:
    a measured negative (the explicit column-mass feedback pumps the
    sloshing mode until the flow shreds).  Grounded top-of-column surface
    cells take the column elevation eta_i = dy sum_j fill[i, j],
    p = |g_y| (eta_i - y_c); other surface cells the local fill,
    p = |g_y| dy (fill - 1/2)."""
    g = abs(params.g_y)
    dy = params.dy
    fill_int = flags.fill[1:-1, 1:-1]
    fluid_int = flags.fluid[1:-1, 1:-1].to(torch.int32)
    eta = dy * torch.sum(fill_int, dim=1, keepdim=True)
    above = torch.flip(torch.cumsum(torch.flip(fluid_int, [1]), 1), [1])
    above_excl = above - fluid_int
    empty_int = flags.empty[1:-1, 1:-1].to(torch.int32)
    empty_below_excl = torch.cumsum(empty_int, 1) - empty_int
    surf_int = flags.surface[1:-1, 1:-1]
    top = surf_int & (above_excl == 0) & (empty_below_excl == 0)
    y_c = (torch.arange(params.j_max, dtype=eta.dtype, device=eta.device)
           + 0.5) * dy
    p_col = g * (eta - y_c[None, :])
    p_loc = g * dy * (fill_int - 0.5)
    zero = torch.zeros((), dtype=p_col.dtype, device=p_col.device)
    p_int = torch.where(top, p_col, torch.where(surf_int, p_loc, zero))
    out = torch.zeros(flags.fill.shape, dtype=p_int.dtype,
                      device=p_int.device)
    out[1:-1, 1:-1] = p_int
    return out


def interp_coeffs(flags: Flags):
    """(use_below, use_above, alpha) of the SUMMAC interpolated surface
    condition (Chan & Street 1970): p_c = alpha p_ref through the vertical
    fluid neighbour, alpha = t / (1 + t), t = fill - 1/2 clipped to
    [-0.45, 0.5]; cells with both or neither vertical neighbour fluid keep
    p_c = 0.  Interior-shaped."""
    si = flags.surface[1:-1, 1:-1]
    fl = flags.fluid
    below_fl = fl[1:-1, :-2]
    above_fl = fl[1:-1, 2:]
    use_below = si & below_fl & ~above_fl
    use_above = si & above_fl & ~below_fl
    t = torch.clamp(flags.fill[1:-1, 1:-1] - 0.5, -0.45, 0.5)
    alpha = t / (1.0 + t)
    return use_below, use_above, alpha


def mask_pressure(p: torch.Tensor, flags: Flags,
                  p_surf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Dirichlet conditions: p_surf (default 0) on surface cells, 0 on
    empty cells and ghosts; bulk values pass through.  A new tensor."""
    out = torch.where(flags.bulk, p, torch.zeros((), dtype=p.dtype,
                                                  device=p.device))
    if p_surf is not None:
        out = torch.where(flags.surface, p_surf.to(p.dtype), out)
    return out


def solve_pressure_free(p: torch.Tensor, rhs: torch.Tensor, flags: Flags,
                        params: Params,
                        p_surf: Optional[torch.Tensor] = None,
                        interpolated: bool = False,
                        inner_fn=None) -> SORResult:
    """The pressure solve on the free-surface geometry: ops/sor.py's f64
    outer (``sor._solve_pressure_refined``) over ``_traced_weights``, with
    the masked solve's hooks (ops/masked.py::solve_pressure_masked) and the
    bulk cells as the valid ones.  The surface Dirichlet values (`p_surf`,
    default 0) ride in the master, set here once, so there is no null
    space and no deflation.  With `interpolated` they are the SUMMAC
    condition instead (``interp_coeffs``), refreshed from the current field
    in place on the master before each defect: once the set-up's masking
    is done, then after each pass's correction.  `inner_fn(neg_r32,
    n_inner, w32) -> delta` replaces the K masked red-black sweeps from
    delta = 0 (w32: the float32 ``_DeviceWeights``);
    parallel/sharded_free.py plugs its partitioned sweeps in here."""
    device = p.device
    f64, f32 = torch.float64, torch.float32
    if params.obstacles:
        # Flags made by classify() alone would mark obstacle cells empty;
        # idempotent for cell_flags' flags.
        interior = _domain_interior(params, device)
        flags = classify(flags.fluid & interior, interior, flags.fill)
    w = _traced_weights(flags, params)
    w32 = _as_dtype(w, f32)
    if inner_fn is None:
        omega32 = torch.tensor(params.omega, dtype=f32, device=device)
        one_minus_omega, omega_over_diag = 1.0 - omega32, omega32 / w32.diag

        def inner_fn(neg_r32, n_inner, w32):
            d = torch.zeros(params.shape, dtype=f32, device=device)
            return masked.relaxed_sweeps(d, neg_r32, w32, n_inner,
                                         one_minus_omega, omega_over_diag)

    if interpolated:
        use_below, use_above, alpha = interp_coeffs(flags)
        refresh_mask = use_below | use_above

        def residual_fn(p64, rhs_int64):
            ref = torch.where(use_below, p64[1:-1, :-2], p64[1:-1, 2:])
            p64[1:-1, 1:-1] = torch.where(refresh_mask, alpha * ref,
                                          p64[1:-1, 1:-1])
            return masked.masked_residual(p64, rhs_int64, w)
    else:
        def residual_fn(p64, rhs_int64):
            return masked.masked_residual(p64, rhs_int64, w)

    result = sor._solve_pressure_refined(
        mask_pressure(p.to(f64), flags, p_surf), rhs,
        params.replace(sor_refine_every=max(1, params.sor_refine_every),
                       outer_precision="float64"),
        inner_fn=lambda rhs_full, n: inner_fn(rhs_full[1:-1, 1:-1], n, w32),
        ghost_fn=lambda q: q, valid_mask=w.fluid,
        l2_fn=lambda r: masked._l2_fluid(r, w), residual_fn=residual_fn)
    # The master is float64: the result in p's dtype.
    return result._replace(
        p=result.p.to(p.dtype),
        res_norm=float(torch.tensor(result.res_norm, dtype=p.dtype)))


def fluid_face_masks(flags: Flags) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masks of the faces between two fluid cells, aligned with the
    projection's update slices: u[1:i_max, 1:-1] ((i_max - 1, j_max)) and
    v[1:-1, 1:j_max]."""
    fl = flags.fluid
    u_ff = fl[1:-2, 1:-1] & fl[2:-1, 1:-1]
    v_ff = fl[1:-1, 1:-2] & fl[1:-1, 2:-1]
    return u_ff, v_ff


def pin_fg(F: torch.Tensor, G: torch.Tensor, u: torch.Tensor,
           v: torch.Tensor, flags: Flags) -> Tuple[torch.Tensor, torch.Tensor]:
    """F = u, G = v on every face that is not fluid-fluid (Griebel eq.
    8.11): the rhs then reads the surface faces' values and the projection
    leaves them alone.  New tensors."""
    u_ff, v_ff = fluid_face_masks(flags)
    F_out = u.to(F.dtype, copy=True)
    G_out = v.to(G.dtype, copy=True)
    F_out[1:-2, 1:-1] = torch.where(u_ff, F[1:-2, 1:-1], F_out[1:-2, 1:-1])
    G_out[1:-1, 1:-2] = torch.where(v_ff, G[1:-1, 1:-2], G_out[1:-1, 1:-2])
    return F_out, G_out
