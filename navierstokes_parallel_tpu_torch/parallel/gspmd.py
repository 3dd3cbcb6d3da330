"""The GSPMD backend: the one-device program on a block-distributed state.

Counterpart of ``navierstokes_parallel_tpu/parallel/gspmd.py``.  The JAX
package jits its UNMODIFIED single-device solver over arrays sharded on a
2-D device mesh and lets XLA's SPMD partitioner insert the collectives, so
its results are one device's and every pressure method in
``GSPMD_METHODS`` runs on any grid.  PyTorch has no partitioner that runs
the port's step (DTensor stops at the boundary conditions' slice writes),
so this module reaches the same contract on the manual backend's blocks
(parallel/sharded.py): one rank per (li + 2, lj + 2) block of a
``topology.Mesh``, the halo exchange, the all-reduced maxima, norms and
means, and a grid that does not divide the mesh padded to the next
multiple with its pad cells masked.  What it takes from one device:

  * the CFL rule: the global maxima seeded with the ghost corner x[0, 0],
    and the four ghost corners of u, v and p carried through every step
    (``sharded._keep_corners``), where the manual backend seeds with 0 and
    its exchange zeroes them;
  * the pressure schedule of ``ops/sor.py::solve_pressure``, method by
    method (``_pressure_solve``): rb_sor's f64 refinement every
    ``sor_refine_every`` sweeps around the deep-halo inner
    (parallel/deep_halo.py, kernel B6 on the card), jacobi's and the
    direct solve's exchange per half-sweep, cg's ``sor_refine_every``
    steps (the manual backend's routes, which are one device's schedule),
    and -- where the manual backend differs -- ``mg_cycles_per_outer``
    V-cycles over exactly one device's levels (``mg.build_levels_gspmd``)
    and ``fft_solves_per_outer`` direct solves (``fft.make_gspmd_inner``),
    on any grid;
  * obstacle domains by rb_sor (the masked deep-halo inner) or mg (the
    masked V-cycle on blocks, ops/masked.py), always with the f64 outer,
    as the one-device masked solve runs.

What each rank holds: its block of u, v, p (and the AB2 tendencies).
rb_sor, jacobi and cg, and mg's fine levels, update only the block.  mg
gathers from the first level that does not split into even blocks over the
mesh (``mg.split_depth``; level 0 on a grid that does not divide the mesh)
and, on the card, from the level where one device enters the coarse cycle;
every rank finishes the V-cycle there with the one-device ``v_cycle``.
fft's pencils run where they tile; elsewhere the rhs is gathered and every
rank solves the whole grid.

The JAX package's partitioner cannot shard its Pallas calls, so it sets
``disable_pallas`` and refuses ``pallas_sor``; the port keeps that refusal
and its refusal of a mesh of more than one device with a trivial axis
(``_check_mesh``).  On the card the kernels run wherever the route takes
them: B6 in the deep-halo sweeps and the sharded smoother, B3 and the
coarse cycle in mg's gathered tail.  The JAX package's ``while t < T`` on
the device is the host loop of ``solver.run_steps`` here, and its AOT
compile (``compile_gspmd_solve``) a warm-up step.  Problem 5 runs through
``models/convection.py`` (``ThermalGspmdStepper``) and problem 6 through
``models/freesurface.py`` (``solve_free(mesh=...)``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import Params
from ..grid import State
from ..ops import fft, mg, sor
from ..solver import SolveStats, StepDiagnostics, run_steps
from . import halo, sharded
from .topology import Mesh, choose_mesh_shape_square, make_grid_mesh

# Every pressure method of the one-device program that the JAX package's
# partitioner runs; pallas_sor is excluded by design (module docstring).
GSPMD_METHODS = ("rb_sor", "jacobi", "mg", "cg", "fft")


def _default_mesh(device=None) -> Mesh:
    """The near-square mesh over the process group (both axes > 1 when
    the rank count allows it; see ``_check_mesh``); the grid need not
    divide it."""
    return make_grid_mesh(shape=choose_mesh_shape_square(
        dist.get_world_size()), device=device)


def _check_method(pressure_method: str) -> None:
    if pressure_method not in GSPMD_METHODS:
        raise ValueError(
            f"gspmd backend supports pressure methods {GSPMD_METHODS}, "
            f"got {pressure_method!r} (the Pallas kernels are opaque to the "
            f"SPMD partitioner)")


def _check_mesh(mesh: Mesh) -> None:
    """Refuse a mesh of more than one device with a trivial axis, as the
    JAX package does (its partitioner gives wrong values there; the
    port's blocks would not, but the backends keep one contract)."""
    px, py = mesh.shape
    if px * py > 1 and min(px, py) == 1:
        raise ValueError(
            f"gspmd backend rejects the {px}x{py} mesh: XLA's SPMD "
            "partitioner miscompiles boundary slice-update compositions "
            "when one mesh axis is trivial (silently wrong results). "
            "Use a 2D factorization (topology.choose_mesh_shape_square) "
            "or --backend sharded, which is correct on 1D meshes.")


def _check_route(params: Params, pressure_method: str) -> None:
    """What the one-device program refuses on this configuration."""
    if params.obstacles and pressure_method not in ("rb_sor", "mg"):
        raise ValueError(
            f"method {pressure_method!r} does not support obstacle domains "
            "— use rb_sor or mg (fft transforms are separable, cg/pallas "
            "kernels are unmasked)")
    if pressure_method == "fft":
        fft.check_precision(params)


def _check_problem(params: Params) -> None:
    if params.problem == 5:
        raise ValueError(
            "problem 5 steps on the gspmd backend with "
            "models/convection.py (ThermalGspmdStepper, thermal_solve / "
            "solve_convection with mesh=...)")
    if params.problem == 6:
        raise ValueError(
            "problem 6 steps on the gspmd backend with "
            "models/freesurface.py (solve_free with mesh=...)")


def _pressure_solve(p, rhs, params: Params, pressure_method: str, li: int,
                    lj: int, valid, mesh: Mesh):
    """One device's pressure schedule (``sor.solve_pressure``) on this
    rank's block (module docstring); the signature of
    ``sharded._pressure_solve``."""
    if params.obstacles:
        # The one-device masked solve has the f64 outer only, and keeps the
        # ghost ring of its input (the masked operator never reads it).
        result = sharded._sharded_pressure_solve(
            p, rhs, params.replace(outer_precision="float64"),
            pressure_method, li, lj, valid, mesh)
        gi, gj = halo.padded_global_indices(p.shape, mesh)
        ring = ((gi == 0) | (gi == params.i_max + 1) | (gj == 0)
                | (gj == params.j_max + 1))
        return result._replace(p=torch.where(ring, p, result.p))
    if pressure_method not in ("mg", "fft"):
        return sharded._sharded_pressure_solve(p, rhs, params,
                                               pressure_method, li, lj,
                                               valid, mesh)
    hooks = sharded.solve_hooks(params, li, lj, valid, mesh)
    if pressure_method == "mg":
        levels = mg.build_levels_gspmd(params, mesh.shape,
                                       mesh.device.type == "cuda")
        inner = mg.make_sharded_inner(params, li, lj, mesh, levels)
        k = params.mg_cycles_per_outer
    else:
        inner = fft.make_gspmd_inner(params, li, lj, mesh)
        k = params.fft_solves_per_outer
    return sor._solve_pressure_refined(
        p, rhs, params.replace(sor_refine_every=max(1, k)), inner_fn=inner,
        valid_mask=valid, **hooks)


def place_ab2(state: State) -> sharded.AB2Carry:
    """The Euler-bootstrap AB2 carry of this rank's blocks: zero tendency
    blocks and dt_prev = 0."""
    return sharded.AB2Carry(torch.zeros_like(state.u),
                            torch.zeros_like(state.v),
                            torch.zeros_like(state.t))


def unpad_state(state: State, params: Params) -> State:
    """The reference-layout (i_max + 2, j_max + 2) state of a state padded
    to the mesh's multiple."""
    ni, nj = params.shape
    return State(u=state.u[:ni, :nj], v=state.v[:ni, :nj],
                 p=state.p[:ni, :nj], t=state.t, n=state.n)


def fetch_state(local: State, params: Params, mesh: Mesh) -> State:
    """The reference-layout state of every rank's blocks, on every rank:
    all-gathered into the padded global layout, then ``unpad_state``.  A
    collective: every rank calls it."""
    return unpad_state(State(*(sharded.gather_field(params, x, mesh, True)
                               for x in local[:3]), t=local.t, n=local.n),
                       params)


def _step_local(local: State, params: Params, pressure_method: str,
                mesh: Mesh, ab2=None):
    """One gspmd step of this rank's blocks: (state, diagnostics, the next
    AB2 carry or None)."""
    u, v, p, dt, result, carry = sharded._sharded_step(
        local.u, local.v, local.p, local.t, params, pressure_method, mesh,
        ab2, corner=True, solve=_pressure_solve)
    return (State(u=u, v=v, p=p, t=local.t + dt, n=local.n + 1),
            StepDiagnostics(dt=dt, sor_iterations=result.iterations,
                            sor_res_norm=result.res_norm,
                            sor_converged=result.converged), carry)


class GspmdStepper(sharded.ShardedStepper):
    """Host-loop adapter for the gspmd backend (JAX
    ``parallel/gspmd.py::GspmdStepper``): this rank's blocks of a
    reference-layout `state` (None: the zero state), advanced one step per
    ``step()``, with `time_order` 2 by Adams-Bashforth 2 from the Euler
    bootstrap.  ``state()`` is ``fetch_state``, a collective."""

    def __init__(self, params: Params, state=None,
                 mesh: Optional[Mesh] = None,
                 pressure_method: str = "rb_sor", time_order: int = 1):
        _check_method(pressure_method)
        _check_problem(params)
        _check_route(params, pressure_method)
        if time_order not in (1, 2):
            raise ValueError(f"time_order must be 1 or 2, got {time_order}")
        if mesh is None:
            mesh = _default_mesh()
        _check_mesh(mesh)
        self.params = params
        self.mesh = mesh
        self.pressure_method = pressure_method
        self.time_order = time_order
        self._local = sharded.scatter_state(params, state, mesh)
        self._ab2 = place_ab2(self._local) if time_order == 2 else None

    def warm(self) -> None:
        """One throw-away step of this route with a single sweep from the
        zero state: the kernels' build and first-use costs."""
        GspmdStepper(self.params.replace(max_it=1), None, self.mesh,
                     self.pressure_method, self.time_order).step()
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

    def step(self) -> StepDiagnostics:
        self._local, diag, self._ab2 = _step_local(
            self._local, self.params, self.pressure_method, self.mesh,
            self._ab2)
        return diag

    def state(self) -> State:
        return fetch_state(self._local, self.params, self.mesh)


def compile_gspmd_solve(params: Params, state=None,
                        mesh: Optional[Mesh] = None, *,
                        pressure_method: str = "rb_sor",
                        time_order: int = 1, max_steps: int = 0):
    """Place the state and warm the route; returns ``run() -> (State,
    SolveStats)``, which integrates to t >= T (or `max_steps`) from the
    placed state on every call, so a timed call excludes the build (the
    JAX package's AOT compile).  The returned state is reference-layout on
    every rank."""
    stepper = GspmdStepper(params, state, mesh, pressure_method, time_order)
    stepper.warm()
    placed, ab2 = stepper._local, stepper._ab2

    def run() -> Tuple[State, SolveStats]:
        stepper._local, stepper._ab2 = placed, ab2
        stats = run_steps(stepper, params, max_steps=max_steps)
        return stepper.state(), stats

    return run


def solve_gspmd(params: Params, state=None, mesh: Optional[Mesh] = None, *,
                pressure_method: str = "rb_sor", max_steps: int = 0,
                time_order: int = 1) -> Tuple[State, SolveStats]:
    """The gspmd counterpart of ``solver.solve`` over the initialised
    process group: one device's results from the blocks of `mesh`
    (default: ``_default_mesh``)."""
    return compile_gspmd_solve(params, state, mesh,
                               pressure_method=pressure_method,
                               time_order=time_order, max_steps=max_steps)()
