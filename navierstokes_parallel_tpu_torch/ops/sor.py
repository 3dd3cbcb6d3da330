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
native FP64, so the outer is plain PyTorch in float64; the sweeps are
hand-written kernels (ops/cuda/sor_kernel.py::inner_sweeps), routed as the
JAX package routes its Pallas kernels: the temporal-blocked tiled kernel
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
``while_loop``; here the sweeps run in chunks whose norms are read once per
chunk, and a chunk in which the solve stops is run again from its start
for exactly the sweeps it needs, so the count and the bits are those of a
check after every sweep.  No kernel stands behind the direct solve or the
plain inner: the JAX package runs them in jnp.

The refinement loop runs on the host: each outer pass reads one scalar (the
residual norm) back to decide whether to go on, i.e. one device sync per K
sweeps.

Problem 3 (the channel) has an outflow, so its rhs is compatible with the
Neumann problem only to the rounding of the flux balance: every method
removes the constant mode from the rhs once and, in the refinement, from
every defect (the ``mean_fn`` hook, all-reduced on a shard).
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, List, NamedTuple, Optional

import torch

from ..config import Params
from . import fft, mg
from .cuda import sor_kernel
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
    p[0, 1:-1] = p[1, 1:-1]
    p[-1, 1:-1] = p[-2, 1:-1]
    p[1:-1, 0] = p[1:-1, 1]
    p[1:-1, -1] = p[1:-1, -2]
    return p


def residual(p: torch.Tensor, rhs_int: torch.Tensor, dx2_inv,
             dy2_inv) -> torch.Tensor:
    """Pointwise Poisson residual on the interior (integration.c:156-160)."""
    return (
        (p[2:, 1:-1] - 2.0 * p[1:-1, 1:-1] + p[:-2, 1:-1]) * dx2_inv
        + (p[1:-1, 2:] - 2.0 * p[1:-1, 1:-1] + p[1:-1, :-2]) * dy2_inv
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
    neighbors = ((p[2:, 1:-1] + p[:-2, 1:-1]) * dx2_inv
                 + (p[1:-1, 2:] + p[1:-1, :-2]) * dy2_inv)
    return one_minus_omega * p[1:-1, 1:-1] + coef * (neighbors - rhs_int)


def _half_sweep(p, rhs_int, mask, one_minus_omega, coef, dx2_inv,
                dy2_inv) -> torch.Tensor:
    """One masked SOR half-sweep over the interior (one checkerboard
    colour), IN PLACE on p (the solve's own tensor); returns p."""
    p_new = _relaxed(p, rhs_int, one_minus_omega, coef, dx2_inv, dy2_inv)
    p[1:-1, 1:-1] = torch.where(mask, p_new, p[1:-1, 1:-1])
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
            p[1:-1, 1:-1] = _relaxed(p, rhs_int, one_minus_omega, coef,
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


def _masker(valid_mask):
    """arr -> arr with the cells outside valid_mask zeroed (identity when
    there is no mask)."""
    def masked(arr):
        if valid_mask is None:
            return arr
        return torch.where(valid_mask, arr,
                           torch.zeros((), dtype=arr.dtype, device=arr.device))
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
            raise ValueError("obstacle domains are single-chip/gspmd only "
                             "(the shard_map halo machinery is unmasked)")
        from . import masked  # it imports this module

        return masked.solve_pressure_masked(p, rhs, params, method=method)
    if params.problem == 3:
        # The outflow problem's flux balance (boundary.apply_channel_bcs)
        # holds only to rounding, which leaves a constant (Neumann null
        # space) mode in the rhs that no iteration removes: project it out
        # once here, and from every defect of the refinement.  A sharded
        # caller passes the all-reduced mean: a per-block mean would change
        # the problem.
        interior = rhs[1:-1, 1:-1]
        rhs = rhs.clone()
        rhs[1:-1, 1:-1] = interior - mean_fn(interior)
    if params.outer_precision == "compensated":
        raise NotImplementedError(
            "outer_precision='compensated' is not ported (the H100 has "
            "native FP64): ROADMAP A9")
    if method == "jacobi" and params.omega > 1.0:
        # Damped Jacobi diverges for omega > 1 (spectral radius
        # |1 - omega + omega*mu| with mu in (-1, 1)): clamp, and say so.
        warnings.warn(
            f"method='jacobi' diverges for omega={params.omega} > 1; "
            "clamping to 0.8 (damped Jacobi)", stacklevel=2)
        params = params.replace(omega=0.8)
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
        iteration = _make_iteration(method, rhs_full[1:-1, 1:-1], omega,
                                    dx2_inv, dy2_inv, red, black,
                                    ghost_fn=ghost_fn)
        delta = torch.zeros(shape, dtype=torch.float32, device=device)
        for _ in range(int(n)):
            delta = iteration(delta)
        return delta

    return inner


def _solve_pressure_direct(p: torch.Tensor, rhs: torch.Tensor,
                           params: Params, *, method: str,
                           ghost_fn: Callable = ghost_fill,
                           l2_fn: Optional[Callable] = None, parity: int = 0,
                           valid_mask: Optional[torch.Tensor] = None,
                           chunk: Optional[int] = None) -> SORResult:
    """The solve in the state's dtype with the residual check after every
    sweep (exact serial semantics, integration.c:136-169).

    The sweeps run in chunks of `chunk` (default DIRECT_CHUNK): each chunk
    keeps a copy of p, stacks its sweeps' norms on the device and reads
    them once.  Where the loop would stop inside the chunk (a norm no
    longer above the threshold), p goes back to the copy and runs exactly
    those sweeps again: every operation repeats the same bits, so the
    result is the per-sweep loop's.  `valid_mask` (interior-shaped bool)
    restricts updates, the residual and the norms to the true interior
    cells of a padded shard (parallel/sharded.py)."""
    dtype, device = p.dtype, p.device
    omega, dx2_inv, dy2_inv = _sweep_constants(params, dtype, device)
    rhs_int = rhs[1:-1, 1:-1]
    l2_fn = l2_fn or _default_l2(params)
    red, black = _colour_masks((p.shape[0] - 2, p.shape[1] - 2), parity,
                               valid_mask, device)
    masked = _masker(valid_mask)
    iteration = _make_iteration(method, rhs_int, omega, dx2_inv, dy2_inv,
                                red, black, ghost_fn=ghost_fn)

    p = p.clone()  # the sweeps work in place
    norm_p0 = l2_fn(masked(p[1:-1, 1:-1]))
    # In the state's dtype, as JAX compares; exact as a Python float.
    threshold = float(params.epsilon * (norm_p0 + NORM_OFFSET))

    def sweep(q):
        q = iteration(q)
        return q, l2_fn(masked(residual(q, rhs_int, dx2_inv, dy2_inv)))

    chunk = chunk or DIRECT_CHUNK
    it, res_norm = 0, math.inf
    while it < params.max_it and res_norm > threshold:
        n = min(chunk, params.max_it - it)
        start = p.clone()
        norms: List[torch.Tensor] = []
        for _ in range(n):
            p, norm = sweep(p)
            norms.append(norm)
        values = torch.stack(norms).tolist()  # the one read per chunk
        # The per-sweep loop goes on while norm > threshold (a NaN stops
        # it, as JAX's while_loop condition does).
        stop = next((k for k, v in enumerate(values) if not v > threshold),
                    n - 1)
        if stop < n - 1:
            p = start
            for _ in range(stop + 1):
                p = iteration(p)
        it += stop + 1
        res_norm = values[stop]
    # Final ghost/halo refresh: the last half-sweep leaves the ring one
    # update stale.
    p = ghost_fn(p)
    return SORResult(p=p, iterations=it, res_norm=res_norm,
                     converged=res_norm <= threshold)


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
                            residual_fn: Optional[Callable] = None
                            ) -> SORResult:
    """Mixed-precision iterative refinement around an f32 inner stage.

    Outer loop (f64, once per K inner steps): defect r = A p - RHS, L2
    norm, convergence test against the reference threshold, p += delta.
    Inner (f32): `inner_fn(-r, K)`, by default K red-black sweeps on
    A delta = -r from delta = 0 (the SOR kernel route).

    The hooks are the JAX package's (``_refined_setup``), for a shard of
    the sharded backend (parallel/sharded.py): `ghost_fn` fills the ring
    before each defect (it may work in place or return a new tensor),
    `l2_fn` is the norm of an interior-shaped array (all-reduced across
    shards), `valid_mask` zeroes the pad cells of a padded block in the
    defect and the norms, and `parity` is the block's colour offset
    (ox + oy) % 2, which the default inner (the whole grid, parity 0)
    cannot take: a shard brings its own `inner_fn`.  On problem 3 every
    defect loses its constant mode, `mean_fn` of it (the interior mean; the
    all-reduced one on a shard), and is masked again, so that a padded
    block's pad cells stay 0.  `residual_fn(p64, rhs_int64)`, when given,
    takes the place of the ghost fill and the Laplacian's defect: it returns
    the interior defect of another operator (the masked one of the sharded
    backend's obstacle domains, parallel/sharded.py; one device takes
    ops/masked.py instead).  The compensated outer, which JAX runs with
    every hook but `residual_fn`, is not ported (ROADMAP A9) and raises.
    """
    if params.outer_precision == "compensated":
        raise NotImplementedError(
            "outer_precision='compensated' (the two-float refinement outer "
            "and its mean_fn hook; JAX refuses residual_fn there) is not "
            "ported (the H100 has native FP64): ROADMAP A9")
    if inner_fn is None:
        if parity % 2:
            raise ValueError(
                "the SOR kernel route sweeps a whole grid (parity 0); a "
                "block of parity 1 needs its own inner_fn")

        def inner_fn(rhs_full, n):
            return sor_kernel.inner_sweeps(rhs_full, n, params)
    K = params.sor_refine_every
    f64, f32 = torch.float64, torch.float32
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    l2_fn = l2_fn or _default_l2(params)
    masked = _masker(valid_mask)

    p64 = p.to(f64, copy=True)  # the master; updated in place below
    rhs_int64 = rhs[1:-1, 1:-1].to(f64)
    norm_p0 = l2_fn(masked(p64[1:-1, 1:-1]))
    threshold = float(params.epsilon * (norm_p0 + NORM_OFFSET))

    def defect():
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

    rhs_full = torch.zeros(p.shape, dtype=f32, device=p.device)
    r64 = defect()
    it = 0
    res_norm = math.inf
    while it < params.max_it and res_norm > threshold:
        n_inner = min(K, params.max_it - it)
        # rhs_full's ghost ring stays 0; only its interior is rewritten.
        rhs_full[1:-1, 1:-1] = -r64.to(f32)
        delta = inner_fn(rhs_full, n_inner)
        p64[1:-1, 1:-1] += delta[1:-1, 1:-1].to(f64)
        r64 = defect()
        res_norm = float(l2_fn(r64))  # the one sync per pass
        it += n_inner
    p_out = ghost_fn(p64).to(p.dtype)
    return SORResult(
        p=p_out,
        iterations=it,
        res_norm=float(torch.tensor(res_norm, dtype=p.dtype)),
        converged=res_norm <= threshold,
    )
