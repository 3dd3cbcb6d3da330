"""Pressure-Poisson solve: red-black SOR, Jacobi, multigrid, CG and DCT.

PyTorch counterpart of ``navierstokes_parallel_tpu/ops/sor.py``.
Convergence contract (serial reference, integration.c:135,164): stop when
L2(residual) <= eps * (||p_0|| + 1.5), ||p_0|| the L2 norm of p at entry, or
after max_it sweeps.

An f32 state cannot meet that threshold on grids >= ~64^2 by plain f32
sweeps (the Laplacian amplifies p's storage rounding), so the f32 solve is
the JAX package's mixed-precision iterative refinement: an f64 master
pressure, an f64 defect and L2 check every K = ``sor_refine_every`` sweeps,
and K f32 red-black sweeps on the correction in between.  The H100 has
native FP64, so the outer runs in float64: one problem with the default
hooks takes one hand-written kernel a pass for the master update, defect,
norm and stop test (ops/cuda/defect_kernel.py), every other call plain
PyTorch.  The sweeps are hand-written kernels
(ops/cuda/sor_kernel.py::inner_sweeps), routed as the JAX package routes
its Pallas kernels: the temporal-blocked tiled kernel
where the grid exceeds the JAX whole-grid budget (2048^2 and up), else the
whole-grid kernel (or the colour-compressed one with
``sor_kernel.USE_COMPRESSED``).  ``method="pallas_sor"`` and ``"rb_sor"``
take this same route: in JAX they differ only in how the TPU lowers the
sweeps.  The f32 inner is the only one: ``sor_inner_dtype="bfloat16"``,
which JAX's kernel route honours, is refused on ``pallas_sor`` (ROADMAP
"Left out"); ``rb_sor`` ignores it, as JAX's jnp route does.
``method="mg"``, ``"cg"`` and ``"fft"`` run the same outer around another
inner stage, as the JAX package does: ``mg_cycles_per_outer`` multigrid
V-cycles (ops/mg.py), ``sor_refine_every`` conjugate-gradient steps, or
``fft_solves_per_outer`` direct DCT solves (ops/fft.py); ``iterations``
then counts V-cycles, CG steps or direct solves.

``method="jacobi"`` is damped Jacobi (omega > 1 diverges: it is clamped to
0.8 with a warning).  It, and ``rb_sor`` on a shard of the sharded backend
(hooks given), take the JAX package's plain f32 inner: n red-black or
Jacobi sweeps in the reference's slice formulation, ``ghost_fn`` called
before each half-sweep (``_plain_inner``).

An f64 state, or ``sor_refine_every = 0``, takes the direct solve
(``_solve_pressure_direct``): the reference algorithm in the state's dtype,
the residual checked after every sweep.  JAX checks it inside one
``while_loop``; here the go-on flag stays on the device, a sweep after the
stop leaves p as it is (``torch.where``), and the flag is read once per
chunk of sweeps, so the count and the bits are those of a check after
every sweep.  No kernel stands behind the direct solve or the plain inner:
the JAX package runs them in jnp.

The refinement loop runs on the host: each outer pass reads one flag (the
norm above the threshold) back to decide whether to go on, i.e. one device
sync per K sweeps.  It is the port's one f64-master outer: obstacle domains
(ops/masked.py) and free surfaces (ops/surface.py) run it with the masked
operator's hooks, on one device as on a shard.
``outer_precision="compensated"`` runs the JAX package's two-float outer
instead (``_solve_pressure_refined_compensated``: an f32 pair master and a
compensated f32 defect, ops/compensated.py) around the same inner stages;
obstacle domains keep the f64 outer, as in the JAX package.

``solve_pressure_batch`` solves a batch of independent problems (a leading
member axis, solver.solve_ensemble) with per-member thresholds, counts and
stops: rb_sor, jacobi and fft through the same refined outer and inner
stages (rb_sor's f32 sweeps: every member in the same kernel launches) or
the same direct solve, whose loops take a per-member mask; mg, cg and the
compensated outer member by member.

Problem 3 (the channel) has an outflow, so its rhs is compatible with the
Neumann problem only to the rounding of the flux balance: every method
removes the constant mode from the rhs once and, in the refinement, from
every defect (the ``mean_fn`` hook, all-reduced on a shard).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from ..config import Params
from ..utils import timing
from . import compensated, fft, mg
from .cuda import defect_kernel, sor_kernel
from .stencils import l2_norm

# The serial reference's convergence-threshold offset (integration.c:164).
NORM_OFFSET = 1.5

# The pressure methods of solve_pressure.
METHODS = ("rb_sor", "pallas_sor", "jacobi", "mg", "cg", "fft")

# Sweeps of the direct solve between two reads of the residual norms
# (direct_bench.py: a chunk doubling from 4 to 256 was no faster; PERF.md).
DIRECT_CHUNK = 32

# An inner stage: (rhs_full, n) -> delta, n steps of an approximate solve of
# A delta = rhs_full from delta = 0 on the padded f32 grid (ring of rhs_full
# is 0).
Inner = Callable[[torch.Tensor, int], torch.Tensor]


class SORResult(NamedTuple):
    p: torch.Tensor       # solved pressure field (with ghosts)
    iterations: int       # sweeps performed
    res_norm: float       # final L2 residual norm, rounded to p's dtype
    converged: bool


def ghost_fill(p: torch.Tensor) -> torch.Tensor:
    """Homogeneous Neumann ghost update, IN PLACE (the ghost ring of the
    refinement master is scratch): copy the adjacent interior strip.
    Reference integration.c:138-146; corners are never read."""
    p[..., 0, 1:-1] = p[..., 1, 1:-1]
    p[..., -1, 1:-1] = p[..., -2, 1:-1]
    p[..., 1:-1, 0] = p[..., 1:-1, 1]
    p[..., 1:-1, -1] = p[..., 1:-1, -2]
    return p


def residual(p: torch.Tensor, rhs_int: torch.Tensor, dx2_inv,
             dy2_inv) -> torch.Tensor:
    """Pointwise Poisson residual on the interior (integration.c:156-160)."""
    return (
        (p[..., 2:, 1:-1] - 2.0 * p[..., 1:-1, 1:-1] + p[..., :-2, 1:-1])
        * dx2_inv
        + (p[..., 1:-1, 2:] - 2.0 * p[..., 1:-1, 1:-1] + p[..., 1:-1, :-2])
        * dy2_inv
        - rhs_int
    )


def _checkerboard(shape, color: int, offset=0, device="cpu") -> torch.Tensor:
    """Boolean mask over an interior of `shape`: True where (i + j + offset)
    % 2 == color, i, j the 0-based interior indices (the 1-based global
    parity of main.cu:490 once a shard passes its origin's parity)."""
    ii = torch.arange(shape[0], device=device).view(-1, 1)
    jj = torch.arange(shape[1], device=device).view(1, -1)
    return (ii + jj + offset) % 2 == color


def _relaxed(p, rhs_int, one_minus_omega, coef, dx2_inv,
             dy2_inv) -> torch.Tensor:
    """The relaxed update of every interior cell of p (the stencil of both
    red-black and Jacobi sweeps); coef = omega / (2 (dx2_inv + dy2_inv)),
    as JAX's _half_sweep forms it (_relaxation, once per solve)."""
    neighbors = ((p[..., 2:, 1:-1] + p[..., :-2, 1:-1]) * dx2_inv
                 + (p[..., 1:-1, 2:] + p[..., 1:-1, :-2]) * dy2_inv)
    return (one_minus_omega * p[..., 1:-1, 1:-1]
            + coef * (neighbors - rhs_int))


def _half_sweep(p, rhs_int, mask, one_minus_omega, coef, dx2_inv,
                dy2_inv) -> torch.Tensor:
    """One masked SOR half-sweep over the interior (one checkerboard
    colour), IN PLACE on p (the solve's own tensor); returns p."""
    p_new = _relaxed(p, rhs_int, one_minus_omega, coef, dx2_inv, dy2_inv)
    p[..., 1:-1, 1:-1] = torch.where(mask, p_new, p[..., 1:-1, 1:-1])
    return p


def _relaxation(omega, dx2_inv, dy2_inv):
    """(1 - omega, omega / (2 (dx2_inv + dy2_inv))) in the constants'
    dtype, the order of operations of JAX's sweeps."""
    return 1.0 - omega, omega / (2.0 * (dx2_inv + dy2_inv))


def rb_sor_iteration(p, rhs_int, omega, dx2_inv, dy2_inv, red_mask,
                     black_mask, ghost_fn=ghost_fill) -> torch.Tensor:
    """One full red-black iteration: ghost fill + red sweep + ghost fill +
    black sweep (structure of main.cu:684-698).  `ghost_fn` refreshes the
    ghost/halo ring: the Neumann copy on one device, the halo exchange with
    the Neumann closure on a shard.  May work in place on p."""
    return _make_iteration("rb_sor", rhs_int, omega, dx2_inv, dy2_inv,
                           red_mask, black_mask, ghost_fn)(p)


def jacobi_iteration(p, rhs_int, omega, dx2_inv, dy2_inv,
                     ghost_fn=ghost_fill) -> torch.Tensor:
    """One damped-Jacobi iteration; may work in place on p."""
    return _make_iteration("jacobi", rhs_int, omega, dx2_inv, dy2_inv, None,
                           None, ghost_fn)(p)


def _make_iteration(method, rhs_int, omega, dx2_inv, dy2_inv, red_mask,
                    black_mask, ghost_fn=ghost_fill):
    """p -> one rb_sor or jacobi iteration of p (in place where the ghost
    fill is), the relaxation constants formed once."""
    one_minus_omega, coef = _relaxation(omega, dx2_inv, dy2_inv)
    if method == "rb_sor":
        def iteration(p):
            for mask in (red_mask, black_mask):
                p = ghost_fn(p)
                p = _half_sweep(p, rhs_int, mask, one_minus_omega, coef,
                                dx2_inv, dy2_inv)
            return p
    elif method == "jacobi":
        def iteration(p):
            p = ghost_fn(p)
            p[..., 1:-1, 1:-1] = _relaxed(p, rhs_int, one_minus_omega, coef,
                                          dx2_inv, dy2_inv)
            return p
    else:
        raise ValueError(f"unknown pressure solver method {method!r}")
    return iteration


def _sweep_constants(params: Params, dtype, device):
    """(omega, dx2_inv, dy2_inv) as 0-d tensors of `dtype`, as the JAX
    package makes them (jnp.asarray of the Python doubles)."""
    return tuple(torch.tensor(x, dtype=dtype, device=device) for x in (
        params.omega, 1.0 / (params.dx * params.dx),
        1.0 / (params.dy * params.dy)))


def _colour_masks(shape, parity, valid_mask, device):
    """(red, black) over an interior of `shape`, a block's parity offset
    applied and its pad cells (outside valid_mask) left out."""
    red = _checkerboard(shape, 0, parity, device)
    black = _checkerboard(shape, 1, parity, device)
    if valid_mask is not None:
        red, black = red & valid_mask, black & valid_mask
    return red, black


def _masker(valid_mask, dtype):
    """arr -> arr with the cells outside valid_mask zeroed (identity when
    there is no mask), for arrays of `dtype`: the zero is made once."""
    if valid_mask is None:
        return lambda arr: arr
    zero = torch.zeros((), dtype=dtype, device=valid_mask.device)

    def masked(arr):
        return torch.where(valid_mask, arr, zero)
    return masked


def _default_l2(params: Params):
    def l2_fn(arr):
        return l2_norm(arr, params.i_max, params.j_max)
    return l2_fn


def default_method(params: Params, device) -> str:
    """The JAX package's auto choice: the kernel route on the accelerator
    (CUDA here), rb_sor elsewhere — both run the same refinement here.
    Obstacle domains take the masked rb_sor (ops/masked.py) on every
    device: the kernels carry no fluid masks."""
    if params.obstacles:
        return "rb_sor"
    return "pallas_sor" if torch.device(device).type == "cuda" else "rb_sor"


def solve_pressure(p: torch.Tensor, rhs: torch.Tensor, params: Params, *,
                   method: str = "rb_sor", **hooks) -> SORResult:
    """Iterate until L2(res) <= eps*(||p0|| + 1.5) or max_it sweeps.

    `hooks` (ghost_fn, l2_fn, parity, valid_mask, mean_fn) adapt the solve
    to a shard's padded block (parallel/sharded.py); only rb_sor and jacobi
    take them, as in the JAX package.  Problem 3 deflates the rhs once by
    `mean_fn` (default: the interior mean) and, in the refinement, every
    defect.  Obstacle domains go to the masked solve (ops/masked.py; rb_sor
    and mg only) before that deflation: it deflates its defects alone, over
    the fluid cells."""
    if method not in METHODS:
        raise ValueError(f"unknown pressure solver method {method!r}")
    # Popped, so that the other hooks forward to the inner stages as they
    # are; the refined solve takes it (the direct solve has no defect to
    # deflate).
    mean_fn = hooks.pop("mean_fn", None) or torch.mean
    if params.obstacles:
        if hooks:
            raise ValueError(
                "obstacle domains are single-chip here: solve_pressure takes "
                "no shard hooks for them (the sharded and gspmd backends run "
                "their masked routes, parallel/sharded.py)")
        from . import masked  # it imports this module

        return masked.solve_pressure_masked(p, rhs, params, method=method)
    rhs, params = _prepare(rhs, params, method, mean_fn)
    if hooks and method in ("mg", "cg", "fft", "pallas_sor"):
        raise ValueError(
            f"{method} via solve_pressure is single-device (got shard hooks); "
            f"the sharded backend brings its own inner (parallel/sharded.py)")
    if method == "mg":
        # mg_cycles_per_outer V-cycles per f64 defect check; iterations
        # count V-cycles.
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.mg_cycles_per_outer)),
            inner_fn=lambda r, n: mg.inner_v_cycle(r, n, params),
            mean_fn=mean_fn)
    if method == "cg":
        # K = sor_refine_every CG steps per outer pass (a restart each);
        # iterations count CG steps.
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.sor_refine_every)),
            inner_fn=_cg_inner(params), mean_fn=mean_fn)
    if method == "fft":
        # K = fft_solves_per_outer direct solves per f64 defect check (the
        # inner re-evaluates the defect in f32 between them); iterations
        # count direct solves.
        fft.check_precision(params)
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.fft_solves_per_outer)),
            inner_fn=lambda r, n: fft.inner_direct(r, n, params),
            mean_fn=mean_fn)
    if method == "pallas_sor":
        if params.sor_inner_dtype != "float32":
            raise NotImplementedError(
                f"sor_inner_dtype={params.sor_inner_dtype!r} (bf16 sweeps and "
                f"transport) is not ported: ROADMAP A, \"Left out of the "
                f"port\"; the kernels sweep in float32")
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.sor_refine_every)),
            mean_fn=mean_fn)
    if p.dtype == torch.float32 and params.sor_refine_every > 0:
        inner_fn = None  # rb_sor on the whole grid: the kernel route
        if hooks or method == "jacobi":
            inner_fn = _plain_inner(p.shape, params, method, p.device,
                                    **hooks)
        return _solve_pressure_refined(p, rhs, params, inner_fn=inner_fn,
                                       mean_fn=mean_fn, **hooks)
    return _solve_pressure_direct(p, rhs, params, method=method, **hooks)


class BatchResult(NamedTuple):
    """``solve_pressure_batch``'s result: one entry per member."""

    p: torch.Tensor           # (B, i_max + 2, j_max + 2)
    iterations: torch.Tensor  # (B,) int64
    res_norm: torch.Tensor    # (B,) in p's dtype
    converged: torch.Tensor   # (B,) bool


# The methods solve_pressure_batch runs on the whole batch at once.
BATCHED_METHODS = ("rb_sor", "jacobi", "fft")


def solve_pressure_batch(p: torch.Tensor, rhs: torch.Tensor, params: Params,
                         *, method: str = "rb_sor",
                         active=None) -> BatchResult:
    """``solve_pressure`` of B independent problems stacked on a leading
    axis (solver.solve_ensemble), each member with its own threshold,
    count and stop, as the JAX package's vmapped solve: a member that has
    converged keeps its pressure and its count while the others go on.

    rb_sor, jacobi and fft run ``solve_pressure``'s outer and inner on the
    whole batch (the `going` mask of ``_solve_pressure_refined`` and
    ``_solve_pressure_direct``): rb_sor's f32 sweeps take the SOR kernel
    route, every member in the same launches on the card (its plain twin
    on the CPU), jacobi the plain inner, fft the DCT over the last two
    axes; on an f32 state the pass after the inner is one launch of the
    fused pass for every member (``_fused_outer``), and each outer pass
    reads one flag for the whole batch.  mg and cg,
    and the compensated outer, solve member by member (``solve_pressure``
    on each).  Obstacle domains are refused: solver.solve_ensemble steps
    them member by member.  `active` (host bools, default all) names the
    members to solve; the others keep p, with 0 iterations."""
    if method not in METHODS:
        raise ValueError(f"unknown pressure solver method {method!r}")
    if params.obstacles:
        raise ValueError("solve_pressure_batch takes no obstacle domain: "
                         "solver.solve_ensemble steps those member by member")
    n_members = p.shape[0]
    active = [True] * n_members if active is None else list(active)
    if (method not in BATCHED_METHODS
            or params.outer_precision == "compensated"):
        return _member_by_member(p, rhs, params, method, active)
    going = torch.tensor(active, device=p.device)

    def mean_fn(r):
        return torch.mean(r, dim=(-2, -1), keepdim=True)

    rhs, params = _prepare(rhs, params, method, mean_fn)
    if method == "fft":
        fft.check_precision(params)
        return _solve_pressure_refined(
            p, rhs, params.replace(
                sor_refine_every=max(1, params.fft_solves_per_outer)),
            inner_fn=lambda r, n: fft.inner_direct(r, n, params),
            mean_fn=mean_fn, going=going)
    if p.dtype == torch.float32 and params.sor_refine_every > 0:
        inner_fn = None  # rb_sor: the kernel route
        if method == "jacobi":
            inner_fn = _plain_inner(p.shape[1:], params, method, p.device)
        return _solve_pressure_refined(p, rhs, params, inner_fn=inner_fn,
                                       mean_fn=mean_fn, going=going)
    return _solve_pressure_direct(p, rhs, params, method=method, going=going)


def _member_by_member(p, rhs, params: Params, method: str,
                      active) -> BatchResult:
    """``solve_pressure`` on each active member (the others keep p)."""
    ps, iters, norms, conv = [], [], [], []
    for k, flag in enumerate(active):
        if flag:
            r = solve_pressure(p[k], rhs[k], params, method=method)
            ps.append(r.p)
            iters.append(r.iterations)
            norms.append(r.res_norm)
            conv.append(r.converged)
        else:
            ps.append(p[k])
            iters.append(0)
            norms.append(0.0)
            conv.append(True)
    device = p.device
    return BatchResult(
        p=torch.stack(ps), iterations=torch.tensor(iters, device=device),
        res_norm=torch.tensor(norms, dtype=p.dtype, device=device),
        converged=torch.tensor(conv, device=device))


def _members(going: Optional[torch.Tensor], device) -> torch.Tensor:
    """A copy of the `going` mask of a batch, or the 0-d True of one
    problem: the loops clear its entries in place."""
    if going is None:
        return torch.ones((), dtype=torch.bool, device=device)
    return going.clone()


def _finish(p_out: torch.Tensor, going: Optional[torch.Tensor],
            iterations, res_norm: torch.Tensor, threshold: torch.Tensor,
            dtype):
    """The solve's result: a BatchResult for a batch (`going` given), else
    the SORResult of the one problem, with host numbers.  `iterations` is
    a device count, or a host int (one refined problem's lean pass).
    Convergence is read on the norm before its rounding to the state's
    dtype."""
    converged = res_norm <= threshold
    res_norm = res_norm.to(dtype)
    if going is not None:
        return BatchResult(p=p_out, iterations=iterations, res_norm=res_norm,
                           converged=converged)
    timing.count("sync.pressure_result",
                 3 if isinstance(iterations, torch.Tensor) else 2)
    with timing.span("pressure.finish"):
        return SORResult(p=p_out, iterations=int(iterations),
                         res_norm=float(res_norm), converged=bool(converged))


def _still_going(on: torch.Tensor, one: bool = False) -> bool:
    """Whether any problem of the solve is still going: the host read of
    the go-on flags, once a pass (once a chunk of the direct solve).  The
    one flag of one refined problem is read as it is, with no reduction
    launched."""
    timing.count("sync.pressure_flag")
    with timing.span("pressure.flag"):
        return bool(on if one else on.any())


def _prepare(rhs, params: Params, method: str, mean_fn: Callable):
    """(rhs, params) as the unmasked solves take them: problem 3's rhs
    without its constant mode, and jacobi's omega clamped.  The outflow
    problem's flux balance (boundary.apply_channel_bcs) holds only to
    rounding, which leaves a constant (Neumann null space) mode in the rhs
    that no iteration removes: it goes once here, and from every defect of
    the refinement.  A sharded caller passes the all-reduced mean (a
    per-block mean would change the problem), a batch the per-member one.
    Damped Jacobi diverges for omega > 1 (spectral radius |1 - omega +
    omega*mu| with mu in (-1, 1)): it is clamped, with a warning on the
    solve's caller."""
    if params.problem == 3:
        interior = rhs[..., 1:-1, 1:-1]
        rhs = rhs.clone()
        rhs[..., 1:-1, 1:-1] = interior - mean_fn(interior)
    if method == "jacobi" and params.omega > 1.0:
        warnings.warn(
            f"method='jacobi' diverges for omega={params.omega} > 1; "
            "clamping to 0.8 (damped Jacobi)", stacklevel=3)
        params = params.replace(omega=0.8)
    return rhs, params


def _plain_inner(shape, params: Params, method: str, device, *,
                 ghost_fn: Callable = ghost_fill, parity: int = 0,
                 valid_mask: Optional[torch.Tensor] = None,
                 l2_fn: Optional[Callable] = None) -> Inner:
    """The JAX package's plain f32 inner (``_make_inner_sweeps``' last
    branch): n red-black or Jacobi iterations on A delta = rhs_full from
    delta = 0 in the slice formulation, `ghost_fn` before each half-sweep.
    Plain PyTorch: the JAX package runs it in jnp."""
    del l2_fn  # the outer's hook, not the inner's
    omega, dx2_inv, dy2_inv = _sweep_constants(params, torch.float32, device)
    red, black = _colour_masks((shape[0] - 2, shape[1] - 2), parity,
                               valid_mask, device)

    def inner(rhs_full: torch.Tensor, n: int) -> torch.Tensor:
        iteration = _make_iteration(method, rhs_full[..., 1:-1, 1:-1], omega,
                                    dx2_inv, dy2_inv, red, black,
                                    ghost_fn=ghost_fn)
        delta = torch.zeros_like(rhs_full)  # f32, a batch's shape too
        for _ in range(int(n)):
            delta = iteration(delta)
        return delta

    return inner


def _solve_pressure_direct(p: torch.Tensor, rhs: torch.Tensor,
                           params: Params, *, method: str,
                           ghost_fn: Callable = ghost_fill,
                           l2_fn: Optional[Callable] = None, parity: int = 0,
                           valid_mask: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None,
                           going: Optional[torch.Tensor] = None):
    """The solve in the state's dtype with the residual check after every
    sweep (exact serial semantics, integration.c:136-169).

    A sweep updates p only while the problem is still going (the norm of
    the last sweep above the threshold): ``torch.where`` keeps p and the
    count once it stops, so the result is the per-sweep loop's.  The flag
    stays on the device and is read once per `chunk` (default
    DIRECT_CHUNK) sweeps.  `valid_mask` (interior-shaped bool) restricts
    updates, the residual and the norms to the true interior cells of a
    padded shard (parallel/sharded.py).  With `going` (bool, one per
    member; solve_pressure_batch), p and rhs carry a leading member axis,
    every member has its own threshold, count and stop, and the result is
    a BatchResult; without it, one problem's SORResult."""
    dtype, device = p.dtype, p.device
    omega, dx2_inv, dy2_inv = _sweep_constants(params, dtype, device)
    rhs_int = rhs[..., 1:-1, 1:-1]
    l2_fn = l2_fn or _default_l2(params)
    red, black = _colour_masks((p.shape[-2] - 2, p.shape[-1] - 2), parity,
                               valid_mask, device)
    masked = _masker(valid_mask, dtype)
    iteration = _make_iteration(method, rhs_int, omega, dx2_inv, dy2_inv,
                                red, black, ghost_fn=ghost_fn)

    p = p.clone()  # the sweeps work in place, on a copy of it
    # In the state's dtype, as JAX compares.
    threshold = params.epsilon * (l2_fn(masked(p[..., 1:-1, 1:-1]))
                                  + NORM_OFFSET)
    on = _members(going, device)
    on3 = on.view(*on.shape, 1, 1)  # follows `on` in place
    iterations = torch.zeros(on.shape, dtype=torch.int64, device=device)
    res_norm = torch.full(on.shape, math.inf, dtype=dtype, device=device)
    chunk = chunk or DIRECT_CHUNK
    done = 0
    while done < params.max_it and _still_going(on):  # one read a chunk
        for _ in range(min(chunk, params.max_it - done)):
            p = torch.where(on3, iteration(p.clone()), p)
            norm = l2_fn(masked(residual(p, rhs_int, dx2_inv, dy2_inv)))
            res_norm = torch.where(on, norm, res_norm)
            iterations += on
            # Goes on while norm > threshold: a NaN stops it, as JAX's
            # while_loop condition does.
            on &= norm > threshold
            done += 1
    # Final ghost/halo refresh: the last half-sweep leaves the ring one
    # update stale.
    return _finish(ghost_fn(p), going, iterations, res_norm, threshold,
                   dtype)


def _cg_inner(params: Params) -> Inner:
    """n f32 conjugate-gradient steps on B x = -b, B = -A (symmetric
    positive semi-definite), from x = 0, on mg's level-0 Laplacian.  Plain
    PyTorch: the JAX package has no kernel behind it.  Every scalar stays a
    0-d device tensor, so the steps need no host sync."""
    lvl = mg.build_levels(params)[0]

    def B(x):
        return -mg._lap(mg.ghost_zero(x), lvl)

    def dot(a, c):
        return torch.sum(a[1:-1, 1:-1] * c[1:-1, 1:-1])

    def inner(b: torch.Tensor, n_steps: int) -> torch.Tensor:
        x = torch.zeros_like(b)
        r = -b
        d = r
        rs = dot(r, r)
        zero = torch.zeros_like(rs)
        for _ in range(int(n_steps)):
            Bd = B(d)
            denom = dot(d, Bd)
            alpha = torch.where(denom > 0, rs / denom, zero)
            x = x + alpha * d
            r = r - alpha * Bd
            rs_new = dot(r, r)
            beta = torch.where(rs > 0, rs_new / rs, zero)
            d = r + beta * d
            rs = rs_new
        return x

    return inner


def _solve_pressure_refined(p: torch.Tensor, rhs: torch.Tensor,
                            params: Params, *,
                            ghost_fn: Callable = ghost_fill,
                            l2_fn: Optional[Callable] = None, parity: int = 0,
                            inner_fn: Optional[Inner] = None,
                            valid_mask: Optional[torch.Tensor] = None,
                            mean_fn: Callable = torch.mean,
                            residual_fn: Optional[Callable] = None,
                            going: Optional[torch.Tensor] = None):
    """Mixed-precision iterative refinement around an f32 inner stage: the
    port's one f64-master outer.

    Outer loop (f64, once per K inner steps): defect r = A p - RHS, L2
    norm, convergence test against the reference threshold, p += delta.
    Inner (f32): `inner_fn(-r, K)`, by default K red-black sweeps on
    A delta = -r from delta = 0 (the SOR kernel route).

    The hooks are the JAX package's (``_refined_setup``), for a shard of
    the sharded backend (parallel/sharded.py) or another operator:
    `ghost_fn` fills the ring before each defect (it may work in place or
    return a new tensor) and once on the result, `l2_fn` is the norm of an
    interior-shaped array (all-reduced across shards), `valid_mask` zeroes
    the pad cells of a padded block (or the solid cells of an obstacle
    domain) in the defect and the norms, and `parity` is the block's
    colour offset (ox + oy) % 2, which the default inner (the whole grid,
    parity 0) cannot take: a shard brings its own `inner_fn`.  On problem 3
    every defect loses its constant mode, `mean_fn` of it (the interior
    mean; the all-reduced one on a shard; the fluid mean of an obstacle
    domain), and is masked again, so that the masked cells stay 0.
    `residual_fn(p64, rhs_int64)`, when given, takes the place of the
    ghost fill and the Laplacian's defect: it returns the interior defect
    of another operator, the masked one of obstacle domains
    (ops/masked.py::solve_pressure_masked on one device, the sharded
    backend's on a shard) or of the free surface
    (ops/surface.py::solve_pressure_free).

    With `going` (bool, one per member; solve_pressure_batch), p and rhs
    carry a leading member axis: every member has its own f64 defect,
    norm, threshold and count, every member still going has taken the
    same sweeps, so one inner call serves them all, and a member stops by
    keeping its master (``torch.where``, ``outer_pass_plain``) while the
    others go on; the result is a BatchResult.  Without it the result is
    one problem's SORResult, and its flag is True until a pass reads it
    False: the pass adds delta to the master in place and keeps its count
    on the host.  Either way each pass reads one flag.

    ``params.outer_precision == "compensated"`` swaps the f64 outer for the
    two-float f32 one (``_solve_pressure_refined_compensated``), with every
    hook but `residual_fn`, which it refuses as the JAX package does; it
    solves one problem (a batch goes member by member).

    Where ``_fused_outer`` holds (the default hooks, one problem or a
    batch), the pass after the inner is ``defect_kernel.outer_pass``: one
    kernel launch on the card for every member (``outer_pass_plain`` on
    the CPU); one problem's flag is read without a reduction, a batch's as
    the any() of its flags.
    """
    if params.outer_precision == "compensated":
        if residual_fn is not None:
            raise ValueError(
                "residual_fn (masked sharded defect) is wired for the "
                "float64 outer only — obstacle runs require x64")
        if going is not None:
            raise ValueError("the compensated outer solves one problem")
        return _solve_pressure_refined_compensated(
            p, rhs, params, ghost_fn=ghost_fn, l2_fn=l2_fn, parity=parity,
            inner_fn=inner_fn, valid_mask=valid_mask, mean_fn=mean_fn)
    fused = _fused_outer(p, rhs, params, ghost_fn=ghost_fn, l2_fn=l2_fn,
                         valid_mask=valid_mask, residual_fn=residual_fn,
                         going=going)
    # One problem off the fused pass: the lean pass below.
    lean = going is None and not fused
    inner_fn = _default_inner(params, parity, inner_fn)
    K = params.sor_refine_every
    f64, f32 = torch.float64, torch.float32
    l2_fn = l2_fn or _default_l2(params)
    masked = _masker(valid_mask, f64)

    with timing.span("pressure.setup"):
        p64 = p.to(f64, copy=True)  # the master; updated in place below
        rhs_int64 = rhs[..., 1:-1, 1:-1].to(f64)
        threshold = params.epsilon * (l2_fn(masked(p64[..., 1:-1, 1:-1]))
                                      + NORM_OFFSET)
        defect = _make_defect(rhs_int64, params, ghost_fn=ghost_fn,
                              masked=masked, mean_fn=mean_fn,
                              residual_fn=residual_fn)
        # rhs_full's ghost ring stays 0; only its interior is rewritten.
        rhs_full = torch.zeros(p.shape, dtype=f32, device=p.device)
        r64 = defect(p64)
        on = _members(going, p.device)
        iterations = 0 if lean else torch.zeros(on.shape, dtype=torch.int64,
                                                device=p.device)
        res_norm = torch.full(on.shape, math.inf, dtype=f64, device=p.device)
        if fused:
            outer_pass = defect_kernel.outer_pass(p64, rhs_int64, rhs_full,
                                                  threshold, params)
        else:
            outer_pass = functools.partial(
                outer_pass_plain, defect=defect, l2_fn=l2_fn,
                threshold=threshold, rhs_full=rhs_full)
        if not lean:
            # The first pass's rhs; each pass writes the next one's.
            rhs_full[..., 1:-1, 1:-1] = -r64.to(f32)
        done = 0  # the sweeps of every problem still going
        go_on = done < params.max_it and (
            lean or _still_going(on, going is None))
    while go_on:
        timing.count("pressure.passes")
        with timing.span("pressure.pass"):
            n_inner = min(K, params.max_it - done)
            if lean:
                # f32(-r) in two launches: the rounding copy, the sign.
                rhs_full[..., 1:-1, 1:-1].copy_(r64).neg_()
            with timing.span("pressure.inner"):
                delta = inner_fn(rhs_full, n_inner)
            with timing.span("pressure.defect"):
                if lean:
                    p64[..., 1:-1, 1:-1].add_(delta[..., 1:-1, 1:-1])
                    r64 = defect(p64)
                    res_norm = l2_fn(r64)
                    iterations += n_inner
                    on = res_norm > threshold
                else:
                    if fused:
                        timing.count("pressure.fused_passes")
                    p64 = outer_pass(p64, delta, on, iterations, res_norm,
                                     n_inner)
                done += n_inner
            # The one sync a pass: whether to go on.
            go_on = done < params.max_it and _still_going(on, going is None)
    return _finish(ghost_fn(p64).to(p.dtype), going, iterations, res_norm,
                   threshold, p.dtype)


def _make_defect(rhs_int64: torch.Tensor, params: Params, *,
                 ghost_fn: Callable = ghost_fill,
                 masked: Callable = lambda arr: arr,
                 mean_fn: Callable = torch.mean,
                 residual_fn: Optional[Callable] = None) -> Callable:
    """p64 -> the f64 outer's defect r = A p - rhs on the interior, with
    the hooks of ``_solve_pressure_refined`` (`masked` is its
    ``_masker``); the default hooks give the Laplacian's defect after the
    Neumann ghost fill, in place on p64's ring."""
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)

    def defect(p64):
        if residual_fn is None:
            r = masked(residual(ghost_fn(p64), rhs_int64, dx2_inv, dy2_inv))
        else:
            r = masked(residual_fn(p64, rhs_int64))
        if params.problem == 3:
            # Exact at the outer's precision; its rounding shrinks with the
            # defect (a deflation of the f32 rhs alone leaves a floor above
            # the threshold on the channel's first step).
            r = masked(r - mean_fn(r))
        return r

    return defect


def outer_pass_plain(p64, delta, on, iterations, res_norm, n_inner, *,
                     defect: Callable, l2_fn: Callable, threshold,
                     rhs_full) -> torch.Tensor:
    """The f64 outer's pass after its inner stage in plain PyTorch, for
    every problem of a solve at once (``on``: one go-on flag each, or the
    0-d flag of one): where a problem goes on, its master takes delta (in
    place on p64), then `defect(p64)`, its norm, the result's norm and
    count and the go-on flag (in place on res_norm, iterations and on),
    and the next pass's rhs, f32(-r), in the interior of rhs_full; returns
    p64.  The pass of the calls with hooks, and the CPU twin of
    ``defect_kernel.outer_pass`` for one problem or a batch."""
    interior = p64[..., 1:-1, 1:-1]
    on3 = on.view(*on.shape, 1, 1)
    interior.copy_(torch.where(
        on3, interior + delta[..., 1:-1, 1:-1].to(torch.float64), interior))
    r64 = defect(p64)
    norm = l2_fn(r64)
    res_norm.copy_(torch.where(on, norm, res_norm))
    iterations += on * n_inner
    on &= norm > threshold
    rhs_full[..., 1:-1, 1:-1] = -r64.to(torch.float32)
    return p64


def _fused_outer(p: torch.Tensor, rhs: torch.Tensor, params: Params, *,
                 ghost_fn: Callable, l2_fn: Optional[Callable],
                 valid_mask: Optional[torch.Tensor],
                 residual_fn: Optional[Callable],
                 going: Optional[torch.Tensor]) -> bool:
    """Whether the f64 outer's pass after the inner takes
    ``defect_kernel.outer_pass``: a contiguous float32 state, 2-D for one
    problem or 3-D for a batch (`going` given: one launch a pass for every
    member, each with its own flag, count and norm), outside autograd,
    with the default hooks (a shard's ghost fill, norm, pad mask or masked
    defect each need the plain statements) and no deflation (problem 3's
    needs a second global reduction before the norm)."""
    return (p.dim() == (2 if going is None else 3)
            and p.dtype == torch.float32
            and p.is_contiguous() and ghost_fn is ghost_fill and l2_fn is None
            and valid_mask is None and residual_fn is None
            and params.problem != 3
            and not (torch.is_grad_enabled()
                     and (p.requires_grad or rhs.requires_grad)))


def _default_inner(params: Params, parity: int,
                   inner_fn: Optional[Inner]) -> Inner:
    """`inner_fn`, or when it is None the SOR kernel route over the whole
    grid (parity 0 only: a block of parity 1 brings its own inner)."""
    if inner_fn is not None:
        return inner_fn
    if parity % 2:
        raise ValueError(
            "the SOR kernel route sweeps a whole grid (parity 0); a "
            "block of parity 1 needs its own inner_fn")

    def inner(rhs_full, n):
        return sor_kernel.inner_sweeps(rhs_full, n, params)

    return inner


def _solve_pressure_refined_compensated(
        p: torch.Tensor, rhs: torch.Tensor, params: Params, *,
        ghost_fn: Callable = ghost_fill, l2_fn: Optional[Callable] = None,
        parity: int = 0, inner_fn: Optional[Inner] = None,
        valid_mask: Optional[torch.Tensor] = None,
        mean_fn: Callable = torch.mean) -> SORResult:
    """The two-float (compensated f32) refinement outer, with no f64 in the
    loop: the JAX package's ``_solve_pressure_refined_compensated``.

    The structure and the stopping rule are ``_solve_pressure_refined``'s;
    the master pressure is an error-free f32 pair (hi, lo), updated by
    ``df_add_f32``, and the defect is ``residual_df`` (ops/compensated.py).
    `ghost_fn` is applied to hi and lo apart: it copies or exchanges, which
    commutes with the hi + lo split, so the sharded hooks work unchanged.
    The norm and the threshold are f32, so where a norm lands within the
    f32 sum's rounding of the threshold the two outers can differ by one
    pass (the JAX package's caveat).  A float64 state splits its p and rhs
    into (hi, lo) words, and gets back the full value the pair carries."""
    inner_fn = _default_inner(params, parity, inner_fn)
    K = params.sor_refine_every
    f32 = torch.float32
    device = p.device
    dx2_inv = torch.tensor(1.0 / (params.dx * params.dx), dtype=f32,
                           device=device)
    dy2_inv = torch.tensor(1.0 / (params.dy * params.dy), dtype=f32,
                           device=device)
    l2_fn = l2_fn or _default_l2(params)
    masked = _masker(valid_mask, f32)

    # For a float64 state the low f32 words of p and rhs are significant:
    # dropping them would certify convergence of a rounded problem.
    wide = p.dtype.itemsize > 4
    with timing.span("pressure.setup"):
        hi = p.to(f32, copy=True)  # the master pair; updated in place below
        rhs_int = rhs[1:-1, 1:-1]
        rhs_int32 = rhs_int.to(f32)
        if wide:
            lo = (p - hi.to(p.dtype)).to(f32)
            rhs_lo32 = (rhs_int - rhs_int32.to(rhs.dtype)).to(f32)
        else:
            lo = torch.zeros_like(hi)
            rhs_lo32 = None
        norm_p0 = l2_fn(masked(hi[1:-1, 1:-1]))
        # f32, as the JAX package forms it; exact as a Python float.
        timing.count("sync.pressure_result")
        threshold = float(torch.tensor(params.epsilon, dtype=f32,
                                       device=device)
                          * (norm_p0 + NORM_OFFSET))

        def defect():
            r = masked(compensated.residual_df(
                ghost_fn(hi), ghost_fn(lo), rhs_int32, dx2_inv, dy2_inv,
                rhs_lo=rhs_lo32))
            if params.problem == 3:
                # The constant-mode deflation of the f64 outer, here
                # relative to the shrinking f32 defect.
                r = masked(r - mean_fn(r))
            return r

        rhs_full = torch.zeros(p.shape, dtype=f32, device=device)
        r32 = defect()
    it = 0
    res_norm = math.inf
    while it < params.max_it and res_norm > threshold:
        timing.count("pressure.passes")
        with timing.span("pressure.pass"):
            n_inner = min(K, params.max_it - it)
            rhs_full[1:-1, 1:-1] = -r32
            with timing.span("pressure.inner"):
                delta = inner_fn(rhs_full, n_inner)
            with timing.span("pressure.defect"):
                h2, l2 = compensated.df_add_f32(hi[1:-1, 1:-1],
                                                lo[1:-1, 1:-1],
                                                delta[1:-1, 1:-1])
                hi[1:-1, 1:-1] = h2
                lo[1:-1, 1:-1] = l2
                r32 = defect()
                norm = l2_fn(r32)
            # The one sync a pass.
            timing.count("sync.pressure_flag")
            with timing.span("pressure.flag"):
                res_norm = float(norm)
            it += n_inner
    # (hi, lo) stays normalized, so hi alone is the correctly rounded f32
    # master; a wider state gets the ~48-bit value of the pair.
    if wide:
        p_out = ghost_fn(hi.to(p.dtype) + lo.to(p.dtype))
    else:
        p_out = ghost_fn(hi).to(p.dtype)
    with timing.span("pressure.finish"):
        return SORResult(
            p=p_out,
            iterations=it,
            res_norm=float(torch.tensor(res_norm, dtype=p.dtype)),
            converged=res_norm <= threshold,
        )
