"""Differentiable solver path: reverse-mode gradients through the flow.

PyTorch counterpart of ``navierstokes_parallel_tpu/diff.py``.  A whole
n-step integration is a function of its inputs that autograd can
differentiate, so the gradient of a scalar loss with respect to the
initial state, the lid speed, the body force or a thermal coefficient is
exact (to solver tolerance): flow control, parameter estimation and design
by gradient.

Two pieces make it work:

* **The adjoint pressure solve** (``pressure_solve_ift``, a
  ``torch.autograd.Function``): the iterative solvers are not
  differentiated.  A p = rhs with A the symmetric Neumann 5-point
  Laplacian, so by the implicit function theorem the vector-Jacobian
  product of p with respect to rhs is one more pressure solve, A lambda =
  p_bar, by the same solver: forward and backward both run
  ``sor.solve_pressure`` (on the card its kernels: the multigrid smoother
  and coarse cycle under ``mg``, the SOR sweep kernel under
  ``pallas_sor``).  Obstacle domains take the masked operator's adjoint,
  symmetric on the fluid cells.
* **Rematerialized time stepping** (``solve_n_steps``,
  ``solve_thermal_n_steps``): a Python loop over the steps, each wrapped in
  ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` when
  ``remat`` is set (the counterpart of ``jax.checkpoint``): a step's
  activations are recomputed in the backward pass instead of stored, so
  the gradient's memory does not grow with the number of steps.

Contract and scope, as in the JAX package:

* Gradients are exact for losses invariant to the pressure's constant
  mode (every physical loss: only grad p enters the dynamics).  No
  cotangent flows into the next step's initial pressure guess.
* The forward solve must converge (``mg``, ``fft``, ``cg``, or a tight
  budget with SOR); the adjoint's error is O(residual).
* Problems 1-4, obstacle domains (``_ift_bwd_masked``) and the Boussinesq
  step of every ``ThermalConfig`` (``diff_thermal_step``).
* The plain formulations throughout: the fused momentum kernel has no
  backward, and never runs here.  The step's arithmetic is
  ``solver.step``'s; the BCs and the projection write in place, so the
  step hands each stage fields it may overwrite (clones) where an earlier
  operation saved them for the backward pass.
* Gradients are exact at generic states.  The donor-cell stencils take
  |u|, so a state on a kink (the from-rest cavity, mirror-symmetric) gets
  the subgradient: abs'(0) = 1 in both packages (``jnp.abs``'s, by
  ``stencils.upwind_abs``; torch.abs' is 0), ``torch.max`` over all
  elements spreads over ties as JAX's reduce_max does, and
  ``torch.maximum`` / ``torch.minimum`` give half at ties as lax.max /
  lax.min.  The tests break the symmetry before comparing with finite
  differences.

On a device mesh (``mesh``: a 2-D ``parallel.topology.Mesh`` over the
process group, one rank per shard) the integration runs the sharded
backend's step (parallel/sharded.py, sharded_thermal.py) under autograd:
its halo exchanges, reductions and the global scatter and gather are
Functions with their transposes (parallel/autograd.py), and the pressure
solve is the sharded solve with the sharded implicit-function adjoint
(``sharded._pressure_adjoint``; an obstacle domain by rb_sor or by the
masked V-cycle on blocks).  The forward is ``ShardedStepper``'s arithmetic
with one device's CFL rule, as JAX's mesh gradient runs the one-device
program under its GSPMD recipe: the maxima seeded with the global ghost
corner x[0, 0], which every step carries (``ShardedStepper`` seeds with 0,
as JAX's sharded backend does).  The caller passes the global state and
the controls on every rank and gets the global final state and dts back
on every rank, so a loss written for one device runs unchanged (every
rank computes it and calls backward).  JAX's refusal of a mesh with a
trivial axis is kept.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .config import Params
from .grid import State, resolve_device
from .ops import boundary, energy, momentum, obstacles, sor
from .ops import stencils as st
from .solver import _rhs


def _cfl(u, v, params: Params, limit):
    """(dt, gamma) of the CFL rule with AD-safe velocity terms
    (``momentum.cfl_dt_gamma``) from the fields' signed interior maxima
    seeded with x[0, 0]; `limit` is a 0-d tensor."""
    return momentum.cfl_dt_gamma(st.max_interior(u), st.max_interior(v),
                                 params, limit)


def _viscous_limit(params: Params) -> float:
    dx, dy = params.dx, params.dy
    return params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))


def _safe_dt_gamma(u, v, params: Params):
    """``momentum.adaptive_dt_gamma`` (reference main.c:89-92) with the
    AD-safe CFL terms of ``_cfl``."""
    return _cfl(u, v, params, st.scalar(_viscous_limit(params), u.dtype,
                                        u.device))


class Controls(NamedTuple):
    """Control inputs a gradient can flow into (0-d tensors): lid_scale
    multiplies the lid velocity (problems 1-2; the channel's inflow is
    fixed); g_x / g_y override the body force."""

    lid_scale: torch.Tensor
    g_x: torch.Tensor
    g_y: torch.Tensor


def default_controls(params: Params, device, dtype=None) -> Controls:
    """lid_scale 1 and the configuration's body force, on `device` in
    `dtype` (default: the state dtype of `params`)."""
    device = resolve_device(device)
    dtype = dtype or params.torch_dtype

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return Controls(lid_scale=scalar(1.0), g_x=scalar(params.g_x),
                    g_y=scalar(params.g_y))


def _embed(interior: torch.Tensor) -> torch.Tensor:
    """A padded field of zeros holding `interior`."""
    full = interior.new_zeros((interior.shape[0] + 2, interior.shape[1] + 2))
    full[1:-1, 1:-1] = interior
    return full


def _ghost_fill_transpose(p_bar: torch.Tensor) -> torch.Tensor:
    """The interior cotangent of ``sor.ghost_fill(embed(q))`` for the
    output cotangent `p_bar`: each edge ghost copies its adjacent interior
    cell, so its cotangent lands there; corners are never read."""
    y = p_bar[1:-1, 1:-1].clone()
    y[0, :] += p_bar[0, 1:-1]
    y[-1, :] += p_bar[-1, 1:-1]
    y[:, 0] += p_bar[1:-1, 0]
    y[:, -1] += p_bar[1:-1, -1]
    return y


def _ift_bwd(params: Params, method: str, p_bar: torch.Tensor):
    """(p0_bar, rhs_bar) of the unmasked solve: fold the cotangent through
    the ghost fill, deflate it (A is singular: project the adjoint rhs onto
    the compatible subspace, exact for every loss invariant to the constant
    mode), solve A lambda = y from zero, deflate lambda.  The converged
    solution does not depend on its initial guess: p0_bar = 0."""
    y = _ghost_fill_transpose(p_bar)
    y = y - torch.mean(y)
    lam = sor.solve_pressure(torch.zeros_like(p_bar), _embed(y), params,
                             method=method).p
    lam_int = lam[1:-1, 1:-1]
    return torch.zeros_like(p_bar), _embed(lam_int - torch.mean(lam_int))


def _ift_bwd_masked(params: Params, method: str, p_bar: torch.Tensor):
    """The obstacle-domain adjoint: the masked neighbour-weight operator
    (ops/masked.py) is symmetric on the fluid cells, so the product is one
    more masked solve of the cotangent deflated over the fluid cells.  The
    masked solve leaves ghost and solid cells at p0 (the identity), so
    their cotangents pass straight to p0_bar."""
    from .ops import masked  # it imports ops/sor.py

    w = masked._weights(params)
    fluid = torch.from_numpy(w.fluid).to(p_bar.device)
    zero = torch.zeros((), dtype=p_bar.dtype, device=p_bar.device)

    def deflated(x):
        x = torch.where(fluid, x, zero)
        return torch.where(fluid, x - st.div(torch.sum(x), w.n_fluid), zero)

    y = deflated(p_bar[1:-1, 1:-1])
    lam = sor.solve_pressure(torch.zeros_like(p_bar), _embed(y), params,
                             method=method).p
    p0_bar = p_bar.clone()
    p0_bar[1:-1, 1:-1] = torch.where(fluid, zero, p_bar[1:-1, 1:-1])
    return p0_bar, _embed(deflated(lam[1:-1, 1:-1]))


class _PressureSolveIFT(torch.autograd.Function):
    """``sor.solve_pressure(...).p`` with the implicit-function adjoint."""

    @staticmethod
    def forward(ctx, p0, rhs, params: Params, method: str):
        ctx.params, ctx.method = params, method
        return sor.solve_pressure(p0, rhs, params, method=method).p

    @staticmethod
    @once_differentiable
    def backward(ctx, p_bar):
        bwd = _ift_bwd_masked if ctx.params.obstacles else _ift_bwd
        p0_bar, rhs_bar = bwd(ctx.params, ctx.method, p_bar.contiguous())
        return p0_bar, rhs_bar, None, None


def pressure_solve_ift(p0: torch.Tensor, rhs: torch.Tensor, params: Params,
                       method: str) -> torch.Tensor:
    """The converged pressure solve with the implicit-function adjoint:
    forward ``sor.solve_pressure`` (never differentiated); backward one
    more solve of the same method on the deflated output cotangent (the
    masked one on obstacle domains).  On a CUDA tensor both solves launch
    the method's kernels."""
    return _PressureSolveIFT.apply(p0, rhs, params, method)


def diff_step(state: State, params: Params,
              controls: Optional[Controls] = None,
              pressure_method: str = "mg") -> Tuple[State, torch.Tensor]:
    """One differentiable time step: ``solver.step``'s arithmetic (reference
    main.c:86-146) with the adjoint pressure solve and the AD-safe CFL
    terms; obstacle domains with their BCs before and after, the pinned
    F/G and the masked solve.  Does not modify `state`.  Returns
    (new_state, dt)."""
    if controls is None:
        controls = default_controls(params, state.u.device, state.u.dtype)
    u, v, p, t, n = state

    dt, gamma = _safe_dt_gamma(u, v, params)
    u, v = u.clone(), v.clone()  # the BCs write in place; dt's max saved u
    if params.problem == 3:
        boundary.apply_channel_bcs(u, v, params)
    elif params.problem == 4:
        boundary.apply_freeslip_box(u, v)
    else:
        lid = boundary.lid_velocity(params.problem, params.f, t)
        boundary.apply_cavity_bcs(u, v, lid * controls.lid_scale)
    if params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)
    F, G = momentum.compute_fg(u, v, dt, gamma, params, g_x=controls.g_x,
                               g_y=controls.g_y)
    u, v, p = _advance(u, v, p, F, G, dt, params, pressure_method)
    return State(u=u, v=v, p=p, t=t + dt, n=n + 1), dt


def _advance(u, v, p, F, G, dt, params: Params, pressure_method: str):
    """The rhs, the adjoint pressure solve and the projection: the new
    (u, v, p)."""
    F, G, rhs = _rhs(F, G, u, v, dt, params)
    p_new = pressure_solve_ift(p, rhs, params, pressure_method)
    # The projection writes in place; F and G's stencils saved u and v.
    u, v = u.clone(), v.clone()
    momentum.project_velocities(u, v, F, G, p_new, dt, params)
    if params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)
    return u, v, p_new


def diff_thermal_step(ts, params: Params, cfg, pressure_method: str = "mg"):
    """One differentiable Boussinesq step (models/convection.py::
    thermal_step with the adjoint pressure solve and the AD-safe CFL
    terms): gradients flow through the energy transport, the buoyancy and
    the pressure solve, e.g. d(Nusselt)/d(wall temperature).  Every
    ThermalConfig: the heating and sidewall dispatch of ``_apply_t_bcs`` /
    ``_apply_vel_bcs``, lid_u (mixed convection), obstacle blocks with the
    masked adjoint.  cfg's numeric fields may be 0-d tensors.  Returns
    (new_state, dt)."""
    from .models.convection import ThermalState, _apply_t_bcs, _apply_vel_bcs

    u, v, p, T, t, n = ts
    limit = energy.thermal_dt_limit(params, cfg.alpha)
    visc = _viscous_limit(params)
    if isinstance(limit, torch.Tensor):
        limit = torch.minimum(st.scalar(visc, u.dtype, u.device), limit)
    else:
        limit = st.scalar(min(visc, limit), u.dtype, u.device)
    dt, gamma = _cfl(u, v, params, limit)

    u, v = _apply_vel_bcs(u.clone(), v.clone(), cfg)
    if params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)

    def t_bcs(T):
        T = _apply_t_bcs(T, params, cfg)
        return energy.apply_obstacle_temperature_bcs(T, params,
                                                     cfg.t_obstacle)

    T = t_bcs(T.clone())
    T_new = t_bcs(energy.advance_temperature(T, u, v, dt, gamma, params,
                                             cfg.alpha))
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = energy.buoyant_fg(F, G, T_new, dt, cfg.beta_gx, cfg.beta_gy)
    u, v, p = _advance(u, v, p, F, G, dt, params, pressure_method)
    return ThermalState(u=u, v=v, p=p, T=T_new, t=t + dt, n=n + 1), dt


# ThermalConfig fields that are numbers a gradient can flow into; the rest
# (the heating / sidewall dispatch strings, t_obstacle's None) is structure.
_THERMAL_TRACED_FIELDS = ("alpha", "beta_gx", "beta_gy", "t_left",
                          "t_right", "lid_u")


def _split_thermal_cfg(cfg) -> dict:
    """The numeric fields of cfg that the steps take as arguments (the
    JAX package's traced leaves): lid_u stays out under free-slip
    sidewalls (it must be the number 0 there), t_obstacle is in only when
    set."""
    traced = {f: getattr(cfg, f) for f in _THERMAL_TRACED_FIELDS}
    if cfg.sidewalls == "freeslip":
        del traced["lid_u"]
    if cfg.t_obstacle is not None:
        traced["t_obstacle"] = cfg.t_obstacle
    return traced


def _scan(one, carry, n_steps: int, remat: bool, *extra):
    """`n_steps` calls carry, dt = one(*carry, *extra) (each under a
    non-reentrant checkpoint with `remat`); returns the last carry and the
    stacked dts.  The step counter is the carry's last entry."""
    dts = []
    for _ in range(n_steps):
        if remat:
            fields = checkpoint(one, *carry, *extra, use_reentrant=False)
        else:
            fields = one(*carry, *extra)
        *fields, dt = fields
        carry = (*fields, carry[-1] + 1)
        dts.append(dt)
    if dts:
        return carry, torch.stack(dts)
    return carry, carry[0].new_zeros((0,))


def _mesh_scan(params: Params, mesh, fields, t, n: int, step, n_steps: int,
               remat: bool, extra):
    """The n-step integration on `mesh`: the global `fields` (given on
    every rank) scattered to this rank's blocks, t and the `extra` step
    arguments replicated, ``step(*blocks, t, *extra) -> (*blocks, dt)``
    through ``_scan`` (each step's collectives chained in order, its
    remat replaying all of them: no early stop), the final blocks gathered.
    Returns (global fields, t, n, dts), on every rank."""
    from .parallel import autograd as mad

    dtype = params.torch_dtype
    k = len(fields)
    with mad.ordered(mesh) as chain, set_checkpoint_early_stop(False):
        blocks = [mad.scatter(x, params, mesh) for x in fields]
        t = mad.replicate(torch.as_tensor(t, dtype=dtype), mesh, dtype)
        extra = [mad.replicate(x, mesh, dtype) for x in extra]

        def one(*args):
            *blocks, t, token, _ = args[:k + 3]
            with mad.ordered(mesh, token) as link:
                *blocks, dt = step(*blocks, t, *args[k + 3:])
            return (*blocks, t + dt, link.token, dt)

        carry, dts = _scan(one, (*blocks, t, chain.token, n), n_steps, remat,
                           *extra)
        chain.token = carry[k + 1]
        out = [mad.gather(x, params, mesh) for x in carry[:k]]
        return out, mad.publish(carry[k], mesh), carry[-1], mad.publish(
            dts, mesh)


def solve_thermal_n_steps(params: Params, ts, n_steps: int, cfg, *,
                          pressure_method: str = "mg", remat: bool = True,
                          mesh=None):
    """n differentiable Boussinesq steps, the thermal counterpart of
    ``solve_n_steps``: cfg's numeric fields may be 0-d tensors that require
    grad (wall temperatures, the buoyancy coefficients, alpha, the lid
    speed).  With `mesh` the steps are the sharded backend's
    (parallel/sharded_thermal.py), T sharded with u, v and p.  Returns
    (final ThermalState, dts)."""
    from .models.convection import ThermalState

    traced = _split_thermal_cfg(cfg)
    keys = tuple(traced)

    def config(values):
        return cfg._replace(**dict(zip(keys, values)))

    if mesh is not None:
        from .parallel import sharded, sharded_thermal

        sharded_thermal._check_thermal(
            sharded.check_gradient(params, mesh, pressure_method), cfg, mesh,
            pressure_method)

        def step(u, v, p, T, t, *values):
            u, v, p, T, dt, _ = sharded_thermal._sharded_thermal_step(
                u, v, p, T, params, config(values), pressure_method, mesh,
                corner=True)
            return u, v, p, T, dt

        fields, t, n, dts = _mesh_scan(params, mesh, ts[:4], ts.t, int(ts.n),
                                       step, n_steps, remat,
                                       traced.values())
        return ThermalState(*fields, t=t, n=n), dts

    def one(u, v, p, T, t, n, *values):
        s, dt = diff_thermal_step(ThermalState(u, v, p, T, t, n), params,
                                  config(values),
                                  pressure_method=pressure_method)
        return s.u, s.v, s.p, s.T, s.t, dt

    carry, dts = _scan(one, tuple(ts), n_steps, remat, *traced.values())
    return ThermalState(*carry), dts


def solve_n_steps(params: Params, state: State, n_steps: int, *,
                  controls: Optional[Controls] = None,
                  pressure_method: str = "mg", remat: bool = True,
                  mesh=None) -> Tuple[State, torch.Tensor]:
    """n differentiable time steps; with `remat` each step is checkpointed,
    so the backward pass recomputes its activations (the forward pressure
    solve included) instead of keeping them: memory does not grow with
    n_steps.  With `mesh` (module docstring) the steps are the sharded
    backend's on this rank's blocks.  Returns (final_state, dts)."""
    if mesh is not None:
        from .parallel import sharded

        sharded._check_isothermal(params, 1)
        sharded.check_gradient(params, mesh, pressure_method)
        if controls is None:
            controls = default_controls(params, mesh.device)

        def step(u, v, p, t, *c):
            u, v, p, dt, _, _ = sharded._sharded_step(
                u, v, p, t, params, pressure_method, mesh,
                controls=Controls(*c), corner=True)
            return u, v, p, dt

        fields, t, n, dts = _mesh_scan(params, mesh, state[:3], state.t,
                                       int(state.n), step, n_steps, remat,
                                       controls)
        return State(*fields, t=t, n=n), dts
    if controls is None:
        controls = default_controls(params, state.u.device, state.u.dtype)

    def one(u, v, p, t, n, *c):
        s, dt = diff_step(State(u, v, p, t, n), params, Controls(*c),
                          pressure_method=pressure_method)
        return s.u, s.v, s.p, s.t, dt

    carry, dts = _scan(one, tuple(state), n_steps, remat, *controls)
    return State(*carry), dts
