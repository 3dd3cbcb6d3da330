"""Natural convection (Boussinesq): the differentially heated cavity and its
family.

PyTorch counterpart of ``navierstokes_parallel_tpu/models/convection.py``
(problem 5): the energy equation of Griebel et al. 1998 ch. 9
(ops/energy.py) coupled to the isothermal momentum and pressure core, with
the convective velocity scale U = sqrt(g beta dT L), so Re = sqrt(Ra/Pr),
alpha = 1/(Re Pr) and a buoyancy coefficient of 1.  The de Vahl Davis
(1983) cavity: hot wall T = +1/2 on the left, cold -1/2 on the right,
adiabatic top and bottom, no-slip walls; its mean hot-wall Nusselt number
is 1.118 / 2.243 / 4.519 / 8.8 at Ra = 1e3..1e6 (``DE_VAHL_DAVIS_NU``).
The family adds Rayleigh-Benard (heated from below, free-slip sidewalls
optional), mixed convection under a moving lid, and a heated block (a
flag-field obstacle, ops/obstacles.py).

F and G come from the plain ``momentum.compute_fg`` on every device, as in
the JAX package: the fused momentum kernel forms the rhs before the
buoyancy is added, so it never runs on a thermal step.  The pressure solve
is ``sor.solve_pressure`` (the SOR kernel on the card under ``pallas_sor``,
the coarse cycle under ``mg``; the masked solve with obstacles).  The JAX
package's on-device loops are host loops here, as in solver.py:
``thermal_solve`` reads t once per step, ``solve_convection`` one rate
per chunk.  The sharded backend steps problem 5 with
parallel/sharded_thermal.py; the gspmd backend (``mesh=`` on
``thermal_solve`` and ``solve_convection``, ``ThermalGspmdStepper``) with
the same blocks' step under one device's CFL rule and pressure schedule.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Params
from ..grid import allocate_state, host_array
from ..ops import boundary, energy, momentum, obstacles
from ..ops import stencils as st
from ..solver import (StepDiagnostics, _advance, _rhs, ab2_extrapolate,
                      run_steps)
from ..utils.timing import device_fence


class ThermalConfig(NamedTuple):
    """Dimensionless thermal coupling constants (module docstring)."""

    alpha: float          # thermal diffusivity = 1/(Re*Pr)
    beta_gx: float        # buoyancy coefficient on F (usually 0)
    beta_gy: float        # buoyancy coefficient on G (-1: hot rises)
    t_left: float = 0.5   # hot wall
    t_right: float = -0.5  # cold wall
    # Interior obstacle cells: None = adiabatic blocks, a float =
    # isothermal blocks at that temperature.
    t_obstacle: Optional[float] = None
    # "side": t_left / t_right on the left / right walls (de Vahl Davis);
    # "below": on the bottom / top plates (Rayleigh-Benard).
    heating: str = "side"
    # Sidewall velocity condition: "noslip" or "freeslip" (a roll symmetry
    # plane); the plates stay no-slip.
    sidewalls: str = "noslip"
    # Lid (top wall) speed: mixed convection, Ri = 1/lid_u^2.
    lid_u: float = 0.0


class ThermalState(NamedTuple):
    """A ``grid.State`` with the cell-centred temperature T (padded)."""

    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    t: torch.Tensor
    n: int


def thermal_state_from_numpy(u, v, p, T, t=0.0, n=0, *, device,
                             dtype=torch.float32) -> ThermalState:
    """A ``ThermalState`` from host arrays (e.g. a JAX state through
    numpy), in `dtype` on `device`."""
    from ..grid import state_from_numpy

    base = state_from_numpy(u, v, p, t, n, device=device, dtype=dtype)
    return ThermalState(u=base.u, v=base.v, p=base.p,
                        T=torch.tensor(np.asarray(T), dtype=dtype,
                                       device=base.u.device),
                        t=base.t, n=base.n)


def convection_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                     tau: float = 0.5, epsilon: float = 1e-4,
                     dtype: str = "float32",
                     max_it: int = 20000) -> Tuple[Params, ThermalConfig]:
    """Params + ThermalConfig of the de Vahl Davis cavity at Rayleigh
    number Ra (unit square, convective velocity scale)."""
    Re = math.sqrt(Ra / Pr)
    params = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0, T=1e9,
                    Re=Re, tau=tau, omega=1.7, epsilon=epsilon,
                    max_it=max_it, dtype=dtype)
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0)
    return params, cfg


def _apply_t_bcs(T, params: Params, cfg: ThermalConfig) -> torch.Tensor:
    """The Dirichlet / adiabatic wall pattern of cfg.heating, in place."""
    if cfg.heating == "below":
        return energy.apply_temperature_bcs_rb(T, params, cfg.t_left,
                                               cfg.t_right)
    if cfg.heating != "side":
        raise ValueError(f"unknown heating mode {cfg.heating!r}")
    return energy.apply_temperature_bcs(T, params, cfg.t_left, cfg.t_right)


def _apply_vel_bcs(u, v, cfg: ThermalConfig):
    """No-slip plates, sidewalls per cfg.sidewalls, in place; the cavity's
    side order (sides before TOP).  cfg's wall values may be floats or 0-d
    tensors (the differentiable step, diff.py); free-slip sidewalls need a
    lid_u that is the number 0."""
    if cfg.sidewalls == "freeslip":
        if not (isinstance(cfg.lid_u, (int, float)) and cfg.lid_u == 0.0):
            raise ValueError("lid_u requires sidewalls='noslip' "
                             "(free-slip sidewalls have no moving lid)")
        boundary.set_freeslip(u, v, boundary.Side.LEFT)
        boundary.set_freeslip(u, v, boundary.Side.RIGHT)
        boundary.set_noslip(u, v, boundary.Side.BOTTOM)
        boundary.set_noslip(u, v, boundary.Side.TOP)
        return u, v
    if cfg.sidewalls != "noslip":
        raise ValueError(f"unknown sidewall mode {cfg.sidewalls!r}")
    lid = cfg.lid_u
    if not isinstance(lid, torch.Tensor):  # a tensor may carry a gradient
        lid = torch.tensor(lid, dtype=u.dtype, device=u.device)
    return boundary.apply_cavity_bcs(u, v, lid)


def rayleigh_benard_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                          aspect: float = 1.0, sidewalls: str = "noslip",
                          tau: float = 0.5, epsilon: float = 1e-4,
                          dtype: str = "float32",
                          max_it: int = 20000) -> Tuple[Params,
                                                        ThermalConfig]:
    """Rayleigh-Benard convection: hot bottom plate T = +1/2, cold top
    plate -1/2, adiabatic sidewalls; `aspect` = width / height, `n` the
    vertical resolution (the horizontal count scales with aspect)."""
    Re = math.sqrt(Ra / Pr)
    i_max = max(4, int(round(aspect * n)))
    params = Params(problem=1, i_max=i_max, j_max=n, a=float(aspect),
                    b=1.0, T=1e9, Re=Re, tau=tau, omega=1.7,
                    epsilon=epsilon, max_it=max_it, dtype=dtype)
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0,
                        heating="below", sidewalls=sidewalls)
    return params, cfg


def mixed_convection_setup(Re_lid: float, Gr: float, Pr: float = 0.71,
                           n: int = 64, tau: float = 0.5,
                           epsilon: float = 1e-4, dtype: str = "float32",
                           max_it: int = 20000) -> Tuple[Params,
                                                         ThermalConfig]:
    """Mixed convection (Iwatsu, Hyun & Kuwahara 1993): a hot moving top
    lid T = +1/2, a cold bottom plate -1/2, adiabatic no-slip sidewalls;
    params.Re = sqrt(Gr) and the lid speed Re_lid / sqrt(Gr)."""
    params, cfg = rayleigh_benard_setup(Gr * Pr, Pr=Pr, n=n, tau=tau,
                                        epsilon=epsilon, dtype=dtype,
                                        max_it=max_it)
    lid = float(Re_lid) / math.sqrt(Gr)
    return params, cfg._replace(t_left=-0.5, t_right=0.5, lid_u=lid)


def heated_block_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                       block_frac: float = 0.4, t_walls: float = -0.5,
                       t_block: float = 0.5, tau: float = 0.5,
                       epsilon: float = 1e-4, dtype: str = "float32",
                       max_it: int = 20000
                       ) -> Tuple[Params, ThermalConfig]:
    """An isothermal hot square block centred in a cavity with cooled side
    walls and adiabatic top and bottom: flag-field no-slip on the block,
    its temperature by the solid-ghost reflection, the masked solve."""
    Re = math.sqrt(Ra / Pr)
    half = max(1, int(round(0.5 * block_frac * n)))
    c0 = n // 2 - half + 1
    c1 = n // 2 + half
    params = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0, T=1e9,
                    Re=Re, tau=tau, omega=1.7, epsilon=epsilon,
                    max_it=max_it, dtype=dtype,
                    obstacles=((c0, c1, c0, c1),))
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0,
                        t_left=t_walls, t_right=t_walls,
                        t_obstacle=t_block)
    return params, cfg


def block_heat_flux(T, params: Params, t_block: float) -> float:
    """The heat flux leaving the obstacle block: over the fluid cells next
    to a solid one, the one-sided Dirichlet gradient 2 (t_block - T)/d
    times the face length, per direction.  At steady state with adiabatic
    top and bottom it balances the flux through the cooled walls."""
    fl = obstacles.fluid_mask(params)
    interior = np.zeros_like(fl)
    interior[1:-1, 1:-1] = True
    solid = interior & ~fl
    Tn = host_array(T)
    flux = 0.0
    for shift_ax, d, face in ((0, params.dx, params.dy),
                              (1, params.dy, params.dx)):
        for sgn in (-1, 1):
            adj = fl & np.roll(solid, sgn, shift_ax)
            flux += np.sum(2.0 * (t_block - Tn[adj])) / d * face
    return float(flux)


def allocate_thermal(params: Params, cfg: ThermalConfig,
                     device) -> ThermalState:
    """The state at rest with the conduction (linear) temperature profile,
    the exact zero-velocity solution, formed in float64 and rounded to the
    state's dtype once (the JAX package forms it so under the CLI's x64),
    then the T BCs."""
    base = allocate_state(params, device)
    if cfg.heating == "below":
        y = (np.arange(params.j_max + 2) - 0.5) / params.j_max
        T0 = cfg.t_left + (cfg.t_right - cfg.t_left) * y
        T = np.broadcast_to(T0[None, :], params.shape)
    else:
        x = (np.arange(params.i_max + 2) - 0.5) / params.i_max
        T0 = cfg.t_left + (cfg.t_right - cfg.t_left) * x
        T = np.broadcast_to(T0[:, None], params.shape)
    T = torch.tensor(np.ascontiguousarray(T), dtype=base.p.dtype,
                     device=base.p.device)
    return ThermalState(u=base.u, v=base.v, p=base.p,
                        T=_apply_t_bcs(T, params, cfg), t=base.t, n=base.n)


def _dt_gamma(u, v, params: Params, cfg: ThermalConfig):
    """The CFL dt with the energy equation's explicit-diffusion bound, and
    the donor-cell weight (momentum.adaptive_dt_gamma's arithmetic)."""
    dx, dy = params.dx, params.dy
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)

    def const(x):
        return st.scalar(x, u.dtype, u.device)

    dx_t, dy_t = const(dx), const(dy)
    visc = params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    limit = const(min(visc, energy.thermal_dt_limit(params, cfg.alpha)))
    dt = params.tau * torch.minimum(
        limit, torch.minimum(dx_t / torch.abs(u_max), dy_t / torch.abs(v_max)))
    if params.gamma_fixed is not None:
        gamma = const(params.gamma_fixed)
    else:
        gamma = torch.maximum(u_max * dt / dx_t, v_max * dt / dy_t)
    return dt, gamma


def _boundary_pass(ts: ThermalState, params: Params, cfg: ThermalConfig):
    """(u, v, T) of `ts` with the velocity BCs, the obstacle BCs, the T BCs
    and the obstacle T BCs, in that order; u, v and T are new tensors."""
    u, v = _apply_vel_bcs(ts.u.clone(), ts.v.clone(), cfg)
    if params.obstacles:
        obstacles.apply_obstacle_bcs(u, v, params)
    T = _apply_t_bcs(ts.T.clone(), params, cfg)
    return u, v, energy.apply_obstacle_temperature_bcs(T, params,
                                                       cfg.t_obstacle)


def _t_bcs(T, params: Params, cfg: ThermalConfig):
    T = _apply_t_bcs(T, params, cfg)
    return energy.apply_obstacle_temperature_bcs(T, params, cfg.t_obstacle)


def _max_dT(T_new, T) -> torch.Tensor:
    return torch.max(torch.abs(T_new[1:-1, 1:-1] - T[1:-1, 1:-1]))


def thermal_step(ts: ThermalState, params: Params, cfg: ThermalConfig,
                 pressure_method: str = "mg"):
    """One Boussinesq time step (Griebel ch. 9 order: T first with the old
    velocities, then momentum with the new temperature).  Does not modify
    `ts`.  Returns (new state, (dt, max |dT|, the StepDiagnostics))."""
    dt, gamma = _dt_gamma(ts.u, ts.v, params, cfg)
    u, v, T = _boundary_pass(ts, params, cfg)
    T_new = _t_bcs(energy.advance_temperature(T, u, v, dt, gamma, params,
                                              cfg.alpha), params, cfg)
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = energy.buoyant_fg(F, G, T_new, dt, cfg.beta_gx, cfg.beta_gy)
    state, diag = _advance(u, v, ts.p, ts.t, ts.n, *_rhs(F, G, u, v, dt,
                                                         params),
                           dt, params, pressure_method)
    new = ThermalState(u=state.u, v=state.v, p=state.p, T=T_new, t=state.t,
                       n=state.n)
    return new, (dt, _max_dT(T_new, T), diag)


class ThermalAB2State(NamedTuple):
    """The AB2 carry of the Boussinesq system: the state, the previous
    step's momentum and energy tendencies, and its dt (0: bootstrap)."""

    ts: ThermalState
    ru: torch.Tensor
    rv: torch.Tensor
    rT: torch.Tensor
    dt_prev: torch.Tensor


def thermal_ab2_init(ts: ThermalState) -> ThermalAB2State:
    """The Euler-bootstrap carry (dt_prev = 0, so w = 0 on the first step)."""
    return ThermalAB2State(ts=ts, ru=torch.zeros_like(ts.u),
                           rv=torch.zeros_like(ts.v),
                           rT=torch.zeros_like(ts.T),
                           dt_prev=torch.zeros_like(ts.t))


def thermal_step_ab2(ab2: ThermalAB2State, params: Params,
                     cfg: ThermalConfig, pressure_method: str = "mg"):
    """One variable-step Adams-Bashforth 2 Boussinesq step (the JAX
    package's ``thermal_step_ab2``): both tendencies extrapolate through
    the previous step, w = dt / (2 dt_prev),

        T_n+1 = T_n + dt [(1 + w) S_n - w S_n-1],
        u*    = u_n + dt [(1 + w) R_n - w R_n-1],

    S from ``energy.advance_temperature``, R from the Euler F/G with the
    buoyancy taken at T_n (not T_n+1: R_n must be the time-t_n tendency).
    Does not modify `ab2`.  Returns (new carry, (dt, max |dT|, diag))."""
    ts = ab2.ts
    dt, gamma = _dt_gamma(ts.u, ts.v, params, cfg)
    w = torch.where(ab2.dt_prev > 0, dt / (2.0 * ab2.dt_prev),
                    torch.zeros_like(dt))
    u, v, T = _boundary_pass(ts, params, cfg)
    S = (energy.advance_temperature(T, u, v, dt, gamma, params, cfg.alpha)
         - T) / dt
    T_new = _t_bcs(T + dt * (S + w * (S - ab2.rT)), params, cfg)
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = energy.buoyant_fg(F, G, T, dt, cfg.beta_gx, cfg.beta_gy)
    F, G, ru, rv = ab2_extrapolate(F, G, u, v, dt, ab2)
    state, diag = _advance(u, v, ts.p, ts.t, ts.n, *_rhs(F, G, u, v, dt,
                                                         params),
                           dt, params, pressure_method)
    new = ThermalState(u=state.u, v=state.v, p=state.p, T=T_new, t=state.t,
                       n=state.n)
    return (ThermalAB2State(ts=new, ru=ru, rv=rv, rT=S, dt_prev=dt),
            (dt, _max_dT(T_new, T), diag))


def config_from_params(params: Params) -> ThermalConfig:
    """The ThermalConfig of a problem-5 ``Params`` (the ``.in`` file's lines
    16-17 carry Ra and Pr): de Vahl Davis orientation, hot left wall
    params.t_hot, cold right wall params.t_cold, adiabatic top and bottom,
    buoyancy coefficient 1; obstacle cells (``--obstacle``) are adiabatic
    blocks."""
    if params.problem != 5:
        raise ValueError(
            f"config_from_params expects problem=5, got {params.problem}")
    return ThermalConfig(alpha=1.0 / (params.Re * params.Pr),
                         beta_gx=0.0, beta_gy=-1.0,
                         t_left=params.t_hot, t_right=params.t_cold)


class ThermalStepper:
    """Host-loop adapter for the Boussinesq system (the JAX CLI's
    ``_SingleChipStepper`` over ``make_thermal_step_fn``, and with
    `time_order` 2 its ``_ThermalAB2Stepper``): each ``step()`` is one
    ``thermal_step`` or ``thermal_step_ab2`` of the held state, and
    ``state()`` is the ``ThermalState``.  An AB2 stepper starts from the
    Euler bootstrap, also from a resumed state."""

    def __init__(self, params: Params, cfg: ThermalConfig,
                 state: ThermalState, pressure_method: str = "mg",
                 time_order: int = 1):
        if time_order not in (1, 2):
            raise ValueError(f"time_order must be 1 or 2, got {time_order}")
        self.params = params
        self.cfg = cfg
        self.pressure_method = pressure_method
        self.time_order = time_order
        self._carry = state if time_order == 1 else thermal_ab2_init(state)
        self.last_max_dT = None  # max |dT| of the last step (0-d tensor)

    def warm(self) -> None:
        """Build the kernels and take first-use costs (``warm_up``)."""
        warm_up(self.params, self.cfg, self.state().u.device,
                self.pressure_method, self.time_order)

    @property
    def t(self) -> float:
        return float(self.state().t)

    @property
    def n(self) -> int:
        return self.state().n

    def step(self) -> StepDiagnostics:
        fn = thermal_step if self.time_order == 1 else thermal_step_ab2
        self._carry, (_, self.last_max_dT, diag) = fn(
            self._carry, self.params, self.cfg,
            pressure_method=self.pressure_method)
        return diag

    def state(self) -> ThermalState:
        return self._carry if self.time_order == 1 else self._carry.ts

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank: one device has one rank."""
        return flag


def warm_up(params: Params, cfg: ThermalConfig, device,
            pressure_method: str = "mg", time_order: int = 1) -> None:
    """One throw-away step (a single sweep) from the conduction state, so a
    timed solve excludes the kernel build and first-use costs."""
    stepper = ThermalStepper(params.replace(max_it=1),
                             cfg, allocate_thermal(params, cfg, device),
                             pressure_method, time_order)
    stepper.step()
    device_fence(stepper.state())


def thermal_solve(params: Params, cfg: ThermalConfig,
                  state: Optional[ThermalState] = None, *, device=None,
                  pressure_method: str = "mg", max_steps: int = 0,
                  time_order: int = 1, mesh=None):
    """Integrate the Boussinesq system to t >= params.T (or `max_steps`
    steps when > 0) from `state` (the conduction state on `device` if
    None); returns (ThermalState, SolveStats).  With `mesh` (a 2-D
    ``parallel.topology.Mesh`` over the process group) the integration is
    the gspmd backend's (``ThermalGspmdStepper``), Euler only, and every
    rank returns the reference-layout state."""
    if mesh is not None:
        if time_order != 1:
            raise ValueError(
                "problem 5 with time_order 2 runs on one device (the "
                "multi-chip thermal steppers integrate first-order)")
        stepper = ThermalGspmdStepper(params, cfg, state, mesh,
                                      pressure_method)
        stats = run_steps(stepper, params, max_steps=max_steps)
        return stepper.state(), stats
    if state is None:
        if device is None:
            raise ValueError("thermal_solve needs a state or a device")
        state = allocate_thermal(params, cfg, device)
    stepper = ThermalStepper(params, cfg, state, pressure_method, time_order)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.state(), stats


# ---------------------------------------------------------------------------
# Problem 5 on the gspmd backend (parallel/gspmd.py): u, v, p and T as
# blocks of a process mesh, the sharded thermal step (parallel/
# sharded_thermal.py) with one device's CFL rule and pressure schedule.
# ---------------------------------------------------------------------------


def place_thermal(ts: ThermalState, params: Params, mesh) -> ThermalState:
    """This rank's padded blocks of a reference-layout ``ThermalState`` (the
    port's or the JAX package's) on the mesh's device; t, n replicated."""
    from ..parallel import sharded_thermal

    return sharded_thermal.scatter_thermal(params, ts, mesh)


def fetch_thermal(local: ThermalState, params: Params,
                  mesh) -> ThermalState:
    """The reference-layout ``ThermalState`` of every rank's blocks, on
    every rank (a collective)."""
    from ..parallel import sharded_thermal

    return sharded_thermal.gather_thermal(params, local, mesh)


class ThermalGspmdStepper:
    """Host-loop adapter for problem 5 on the gspmd backend (the JAX
    package's ``ThermalGspmdStepper``): this rank's blocks of a
    reference-layout ``ThermalState`` (`state`; None: the conduction state),
    advanced by ``sharded_thermal._sharded_thermal_step`` with one
    device's CFL rule (the ghost corner seed, carried) and one device's
    pressure schedule (``gspmd._pressure_solve``).  An obstacle domain
    (the heated block) is stepped by all-gathering the four fields onto
    every rank's device, one device's ``thermal_step`` there, and keeping
    the block: the sharded thermal step has no obstacle arm.  ``state()`` gathers on
    every rank (a collective); ``last_max_dT`` is the last step's global
    max |dT| (a collective, read on demand)."""

    def __init__(self, params: Params, cfg: ThermalConfig,
                 state: Optional[ThermalState] = None, mesh=None,
                 pressure_method: str = "mg"):
        from ..parallel import gspmd, sharded_thermal

        gspmd._check_method(pressure_method)
        sharded_thermal.check_thermal_config(params, cfg, obstacles=True)
        gspmd._check_route(params, pressure_method)
        if mesh is None:
            mesh = gspmd._default_mesh()
        gspmd._check_mesh(mesh)
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.pressure_method = pressure_method
        self._local = place_thermal(
            state if state is not None
            else allocate_thermal(params, cfg, mesh.device), params, mesh)
        self._dT = None

    def warm(self) -> None:
        """One throw-away step with a single sweep from the conduction
        state: the kernels' build and first-use costs."""
        ThermalGspmdStepper(self.params.replace(max_it=1), self.cfg, None,
                            self.mesh, self.pressure_method).step()
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    @property
    def t(self) -> float:
        return float(self._local.t)

    @property
    def n(self) -> int:
        return self._local.n

    def step(self) -> StepDiagnostics:
        from ..parallel import gspmd, sharded_thermal
        from ..parallel.autograd import block_of

        loc = self._local
        if self.params.obstacles:
            # An obstacle domain: the fields all-gathered on the device,
            # one device's thermal_step on every rank (its masked solve),
            # this rank's blocks kept.
            new, (_, _, diag) = thermal_step(self.state(), self.params,
                                             self.cfg, self.pressure_method)
            self._local = ThermalState(
                *(block_of(x, self.params, self.mesh).contiguous()
                  for x in new[:4]), t=new.t, n=new.n)
            self._dT = (self._local.T, loc.T)
            return diag
        u, v, p, T, dt, result = sharded_thermal._sharded_thermal_step(
            loc.u, loc.v, loc.p, loc.T, self.params, self.cfg,
            self.pressure_method, self.mesh, corner=True,
            solve=gspmd._pressure_solve)
        self._local = ThermalState(u=u, v=v, p=p, T=T, t=loc.t + dt,
                                   n=loc.n + 1)
        self._dT = (T, loc.T)
        return StepDiagnostics(dt=dt, sor_iterations=result.iterations,
                               sor_res_norm=result.res_norm,
                               sor_converged=result.converged)

    @property
    def last_max_dT(self) -> torch.Tensor:
        """max |T_new - T| of the last step over the global interior."""
        import torch.distributed as dist

        from ..parallel import sharded

        new, old = self._dT
        li, lj = new.shape[0] - 2, new.shape[1] - 2
        valid = sharded._valid_mask_or_none(self.params, li, lj,
                                            self.mesh)[0]
        d = _max_dT(new, old) if valid is None else torch.max(torch.where(
            valid, torch.abs(new[1:-1, 1:-1] - old[1:-1, 1:-1]),
            torch.zeros((), dtype=new.dtype, device=new.device)))
        dist.all_reduce(d, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return d

    def state(self) -> ThermalState:
        return fetch_thermal(self._local, self.params, self.mesh)

    def any_rank(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (collective)."""
        import torch.distributed as dist

        x = torch.tensor(int(flag), device=self.mesh.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(x)


def thermal_solve_ab2(params: Params, cfg: ThermalConfig,
                      state: Optional[ThermalState] = None, *,
                      device=None, pressure_method: str = "mg",
                      max_steps: int = 0):
    """``thermal_solve`` by Adams-Bashforth 2 from the Euler bootstrap."""
    return thermal_solve(params, cfg, state, device=device,
                         pressure_method=pressure_method,
                         max_steps=max_steps, time_order=2)


def solve_convection(params: Params, cfg: ThermalConfig,
                     state: Optional[ThermalState] = None, *,
                     device=None, pressure_method: str = "mg",
                     steady_tol: float = 1e-6, max_steps: int = 200_000,
                     chunk: int = 200, mesh=None):
    """Integrate to steady state: stop once max|dT|/dt of the last step of
    a chunk of `chunk` steps falls under `steady_tol` (or after
    `max_steps`), reading that rate once per chunk.  Returns (state, info
    dict).  With `mesh` (a 2-D ``parallel.topology.Mesh``) the steps are
    the gspmd backend's (``ThermalGspmdStepper``), and every rank returns
    the reference-layout state."""
    if mesh is not None:
        stepper = ThermalGspmdStepper(params, cfg, state, mesh,
                                      pressure_method)
    else:
        if state is None:
            if device is None:
                raise ValueError("solve_convection needs a state or a "
                                 "device")
            state = allocate_thermal(params, cfg, device)
        stepper = ThermalStepper(params, cfg, state, pressure_method)
    steps = failures = 0
    rate = math.inf
    while steps < max_steps:
        rate_dev = None
        for _ in range(chunk):
            diag = stepper.step()
            failures += 0 if diag.sor_converged else 1
            rate_dev = stepper.last_max_dT / diag.dt
        rate = float(rate_dev)  # the one read per chunk
        steps += chunk
        if rate < steady_tol:
            break
    return stepper.state(), {"steps": steps, "dT_rate": rate,
                             "sor_failures": failures,
                             "steady": rate < steady_tol}


def nusselt_hot_wall(T, params: Params, t_left: float = 0.5) -> float:
    """Mean Nusselt number at the hot (left) wall: the one-sided wall
    gradient 2 (T[1, j] - t_left) / dx of the Dirichlet ghost reflection,
    negated and averaged over the wall (conduction gives exactly 1)."""
    g = -2.0 * (_as_tensor(T)[1, 1:-1] - t_left) * params.i_max
    return float(torch.mean(g))


def nusselt_cold_wall(T, params: Params, t_right: float = -0.5) -> float:
    g = -2.0 * (t_right - _as_tensor(T)[-2, 1:-1]) * params.i_max
    return float(torch.mean(g))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


# de Vahl Davis (1983) benchmark mean hot-wall Nusselt numbers.
DE_VAHL_DAVIS_NU = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519, 1e6: 8.800}

# Linear stability of a layer between rigid conducting plates
# (Chandrasekhar 1961, ch. II): onset at Ra_c = 1707.762, wavenumber
# a_c = 3.117.  A free-slip sidewall is a roll symmetry plane, so a box of
# width pi/a_c hosts the infinite layer's critical eigenmode exactly.
RB_CRITICAL_RA = 1707.762
RB_CRITICAL_WAVENUMBER = 3.117
RB_CRITICAL_ASPECT = math.pi / RB_CRITICAL_WAVENUMBER


def nusselt_bottom(T, params: Params, t_bottom: float = 0.5) -> float:
    """Mean Nusselt number at the hot bottom plate (the one-sided Dirichlet
    gradient 2 (T[i, 1] - t_b) / dy, negated, times b)."""
    g = st.div(-2.0 * (_as_tensor(T)[1:-1, 1] - t_bottom) * params.j_max,
               params.b)
    return float(torch.mean(g))


def nusselt_top(T, params: Params, t_top: float = -0.5) -> float:
    """Mean Nusselt number at the cold top plate (equals nusselt_bottom at
    steady state with adiabatic sidewalls)."""
    g = st.div(-2.0 * (t_top - _as_tensor(T)[1:-1, -2]) * params.j_max,
               params.b)
    return float(torch.mean(g))


def seed_rb_perturbation(ts: ThermalState, params: Params,
                         cfg: ThermalConfig, amp: float = 1e-3,
                         mode: int = 1) -> ThermalState:
    """T plus the m-roll thermal eigenmode shape amp cos(m pi x / a)
    sin(pi y / b) at the cell centres (compatible with every RB boundary
    condition), then the T BCs."""
    dtype, device = ts.T.dtype, ts.T.device
    x = (torch.arange(params.i_max + 2, dtype=dtype, device=device)
         - 0.5) * params.dx
    y = (torch.arange(params.j_max + 2, dtype=dtype, device=device)
         - 0.5) * params.dy
    pert = (amp * torch.cos(st.div(mode * math.pi * x[:, None], params.a))
            * torch.sin(st.div(math.pi * y[None, :], params.b)))
    return ts._replace(T=_apply_t_bcs(ts.T + pert, params, cfg))


def kinetic_energy(ts: ThermalState) -> torch.Tensor:
    """Interior sum of u^2 + v^2 (0-d): the perturbation energy whose
    exponential trend ``rb_growth_rate`` fits."""
    return (torch.sum(ts.u[1:-1, 1:-1] ** 2)
            + torch.sum(ts.v[1:-1, 1:-1] ** 2))


def rb_growth_rate(Ra: float, *, Pr: float = 0.71, n: int = 32,
                   aspect: Optional[float] = None,
                   amp: Optional[float] = None,
                   t_transient: float = 10.0, t_measure: float = 20.0,
                   pressure_method: str = "mg", dtype: str = "float32",
                   chunk: int = 200, device=None) -> dict:
    """The linear growth rate sigma of the single-roll RB mode in the
    critical free-slip box: E(t) ~ exp(2 sigma t) fitted between the end
    of the transient window and the end of the run (t read once per chunk
    of `chunk` steps).  `amp` None: 1e-4 for n <= 32, 1e-3 above (the JAX
    package's measured window).  Returns {sigma, E0, E1, t0, t1, Ra}."""
    if device is None:
        raise ValueError("rb_growth_rate needs a device")
    if amp is None:
        amp = 1e-4 if n <= 32 else 1e-3
    if aspect is None:
        aspect = RB_CRITICAL_ASPECT
    params, cfg = rayleigh_benard_setup(
        Ra, Pr=Pr, n=n, aspect=aspect, sidewalls="freeslip",
        epsilon=1e-6, dtype=dtype)
    ts = seed_rb_perturbation(
        allocate_thermal(params, cfg, device), params, cfg,
        amp=amp)
    stepper = ThermalStepper(params, cfg, ts, pressure_method)

    def run_until(t_target):
        E, t = float(kinetic_energy(stepper.state())), stepper.t
        while t < t_target:
            for _ in range(chunk):
                stepper.step()
            E, t = float(kinetic_energy(stepper.state())), stepper.t
        return E, t

    E0, t0 = run_until(t_transient)
    E1, t1 = run_until(t_transient + t_measure)
    sigma = math.log(E1 / E0) / (2.0 * (t1 - t0))
    return {"sigma": sigma, "E0": E0, "E1": E1, "t0": t0, "t1": t1,
            "Ra": Ra}


# Mean Nusselt numbers of the square Rayleigh-Benard cavity (aspect 1,
# Pr = 0.71, rigid walls, adiabatic sidewalls, single roll): Ouertatani,
# Ben Cheikh, Ben Beya & Lili, C. R. Mecanique 336 (2008) 464-470.
OUERTATANI_RB_NU = {1e4: 2.154, 1e5: 3.907, 1e6: 6.363}
