"""Free surfaces (problem 6) on the sharded backend: a replicated master and
partitioned correction sweeps.

Counterpart of ``navierstokes_parallel_tpu/parallel/sharded_free.py``.  The
free-surface geometry is rebuilt from the marker particles every step, so
the static block layout of the obstacle path does not apply.  Every rank
holds the whole state (fields and particles) and steps it as one device
does; only the f32 correction sweeps inside
``ops/surface.py::solve_pressure_free`` are partitioned, through its
`inner_fn` hook:

  * each rank cuts an (li + 2H, lj + 2H) window around its block out of
    the replicated delta, rhs and weights, zero-padded by H on every side
    and by the pad-to-divisible extent on the high side (an explicit pad:
    a slice past the end would come back shorter and shift the last
    block's core);
  * it runs C = ``Params.sor_comm_every`` masked red-black sweeps there,
    ops/masked.py's half-sweeps; with H = 2C the window's edge effects
    never reach the (li, lj) core;
  * the cores are summed back into the replicated delta by one
    ``dist.all_reduce`` per C sweeps (each cell has one owner, so the sum
    is exact).

The numerics are the single-device solve's (same sweeps, masks and order);
the f64 master, the SUMMAC refresh and the defect stay
``solve_pressure_free``'s (ops/sor.py's outer with its hooks, which hands
this hook the interior of its padded f32 rhs).  As in the JAX package,
where these sweeps are jnp, no kernel stands behind them: plain PyTorch on
every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as nnf

from ..config import Params
from ..models import freesurface as FS
from ..ops import masked
from ..solver import SolveStats, run_steps
from .topology import Mesh, local_block_dims, make_grid_mesh


def make_free_inner(params: Params, mesh: Mesh):
    """The `inner_fn(neg_r32, n_inner, w32) -> delta` hook of
    ``surface.solve_pressure_free``: n_inner sweeps from delta = 0,
    partitioned over `mesh` (module docstring); delta is padded-shaped
    with a zero ghost ring and replicated on every rank."""
    px, py = mesh.shape
    I, J = params.i_max, params.j_max
    li, lj = local_block_dims((px, py), I, J)
    C = max(1, params.sor_comm_every)
    H = 2 * C
    ex, ey = px * li - I, py * lj - J
    ox, oy = mesh.origin(li, lj)
    f32 = torch.float32
    omega = torch.tensor(params.omega, dtype=f32, device=mesh.device)

    def win(a: torch.Tensor) -> torch.Tensor:
        # Interior-shaped replicated array -> this rank's H-ringed window.
        padded = torch.zeros((I + ex + 2 * H, J + ey + 2 * H), dtype=a.dtype,
                             device=a.device)
        padded[H:H + I, H:H + J] = a
        return padded[ox:ox + li + 2 * H, oy:oy + lj + 2 * H]

    def inner_fn(neg_r32, n_inner: int, w32: masked._DeviceWeights):
        rhs_w = win(neg_r32)
        # Pad cells take diag 1 (their masks are False: never updated).
        diag_w = win(w32.diag - 1.0) + 1.0
        w_win = masked._DeviceWeights(
            w_e=win(w32.w_e), w_w=win(w32.w_w), w_n=win(w32.w_n),
            w_s=win(w32.w_s), diag=diag_w, fluid=None, n_fluid=None,
            red=win(w32.red), black=win(w32.black))
        one_minus_omega, omega_over_diag = 1.0 - omega, omega / diag_w
        delta = torch.zeros((I, J), dtype=f32, device=mesh.device)
        remaining = int(n_inner)
        while remaining > 0:
            ns = min(remaining, C)
            # One zero cell around the window stands in for the wrapping
            # rolls of the JAX twin: either way only ring cells differ.
            d = nnf.pad(win(delta).unsqueeze(0), (1, 1, 1, 1)).squeeze(0)
            d = masked.relaxed_sweeps(d, rhs_w, w_win, ns, one_minus_omega,
                                      omega_over_diag)
            own = torch.zeros((px * li, py * lj), dtype=f32,
                              device=mesh.device)
            own[ox:ox + li, oy:oy + lj] = d[1 + H:1 + H + li,
                                            1 + H:1 + H + lj]
            dist.all_reduce(own, op=dist.ReduceOp.SUM, group=mesh.group)
            delta = own[:I, :J]
            remaining -= ns
        out = torch.zeros(params.shape, dtype=f32, device=mesh.device)
        out[1:-1, 1:-1] = delta
        return out

    return inner_fn


def make_free_step_sharded(params: Params, mesh: Mesh, *,
                           wall: str = "noslip", ppc: Optional[int] = None,
                           p_surface: str = "interpolated"):
    """``step(fs) -> (fs, diag)``: ``freesurface.free_step`` with the
    sweeps partitioned over `mesh`; the state stays replicated (the JAX
    package's ``make_free_step_sharded``)."""
    inner = make_free_inner(params, mesh)

    def step(fs: FS.FreeSurfaceState):
        return FS.free_step(fs, params, wall=wall, ppc=ppc,
                            p_surface=p_surface, pressure_inner_fn=inner)

    return step


def make_free_stepper(params: Params, fs: FS.FreeSurfaceState,
                      mesh: Optional[Mesh] = None, *, wall: str = "noslip",
                      ppc: Optional[int] = None,
                      p_surface: str = "interpolated") -> FS.FreeStepper:
    """A ``FreeStepper`` of the replicated state whose pressure sweeps run
    partitioned over `mesh` (default: the pad-optimal mesh over the
    group); ``any_rank`` is collective over the mesh."""
    if mesh is None:
        mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max)
    return FS.FreeStepper(params, fs, wall=wall, ppc=ppc,
                          p_surface=p_surface,
                          inner_fn=make_free_inner(params, mesh), mesh=mesh)


def solve_free_sharded(params: Params, fs: FS.FreeSurfaceState,
                       mesh: Optional[Mesh] = None, *, wall: str = "noslip",
                       ppc: Optional[int] = None,
                       p_surface: str = "interpolated", max_steps: int = 0
                       ) -> Tuple[FS.FreeSurfaceState, SolveStats]:
    """``freesurface.solve_free`` with the partitioned sweeps over the
    initialised process group; every rank returns the same state."""
    stepper = make_free_stepper(params, fs, mesh, wall=wall, ppc=ppc,
                                p_surface=p_surface)
    stats = run_steps(stepper, params, max_steps=max_steps)
    return stepper.free_state(), stats
