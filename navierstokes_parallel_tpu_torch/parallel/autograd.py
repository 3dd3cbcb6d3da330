"""The sharded backend's collectives under autograd.

Reverse-mode gradients through an integration on a process mesh
(``diff.solve_n_steps(mesh=...)``, ``diff.solve_thermal_n_steps(mesh=...)``)
run the sharded step itself (parallel/sharded.py, sharded_thermal.py) on
blocks that require grad.  Its local arithmetic is ordinary PyTorch; what
autograd cannot see is the communication.  Each collective the step issues
is a ``torch.autograd.Function`` here, and the step's primitives
(``halo._shift_pair``, ``sharded._all_reduce``, ``sharded._global_maxima``,
the pressure solve) take it where a block requires grad, their plain form
everywhere else.  The forward of every Function is that plain form, so a
differentiated step computes the same bits as ``ShardedStepper``'s.

The transposes, for replicated values held on every rank:

  * the shift of halo strips to the mesh neighbours (which the halo
    exchange, the F / G seam fill and the deep halo are made of): the
    cotangent of a received strip goes back to the rank that sent it, one
    shift the other way; a halo the exchange overwrites gets zero
    (autograd's slice writes);
  * the all-reduce SUM (the channel's flux balance) and a replicated input
    (``replicate``: the Controls, the thermal coefficients, t): every rank
    holds a share of the cotangent, so the backward all-reduces it;
  * the global maxima of the CFL rule (``global_maxima``): the cotangent is
    all-reduced and spread evenly over the tied cells of every rank, with
    the global tie count, as ``torch.max`` spreads it over one field;
  * ``scatter`` of a global field to this rank's padded block: the block
    cotangents are all-gathered and summed into the global one, so every
    rank's input holds the whole gradient;
  * ``gather`` of the blocks to the global field, on every rank: every rank
    computes the same loss from its copy, so it takes its own block of the
    cotangent and sums nothing; ``publish`` (t and dt out of the mesh) keeps
    the cotangent on rank 0;
  * the pressure solve (``pressure_solve``): forward the sharded solve,
    backward its implicit-function adjoint (``sharded._pressure_adjoint``).

Every rank must issue the same collectives in the same order, in the
backward pass too, where autograd's engine picks among the nodes that are
ready.  So every Function takes and returns a token, a 0-d tensor that
chains each collective to the one before it (``ordered`` holds the chain's
end): in the backward pass the collectives run in exactly the reverse of
their forward order on every rank.  A rematerialized step
(``torch.utils.checkpoint``, non-reentrant) replays its forward
collectives when its first saved tensor is unpacked, which on every rank is
after the next step's backward collectives and before its own; early
stopping is switched off (diff.py), so every rank replays all of them.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

from .topology import Mesh

# The innermost active chain's last token (``ordered``).
_CHAINS: List["_Chain"] = []


class _Chain:
    def __init__(self, token: torch.Tensor):
        self.token = token


@contextlib.contextmanager
def ordered(mesh: Mesh, token: Optional[torch.Tensor] = None):
    """Chain the differentiable collectives issued in the block, starting
    at `token` (a fresh one by default); yields the chain, whose ``token``
    is the last collective's on exit."""
    if token is None:
        token = torch.zeros((), device=mesh.device, requires_grad=True)
    chain = _Chain(token)
    _CHAINS.append(chain)
    try:
        yield chain
    finally:
        _CHAINS.pop()


def tracked(*tensors) -> bool:
    """Whether autograd records an operation on `tensors` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _apply(fn, *args):
    """fn.apply(token, *args) on the innermost chain, which moves on to the
    token fn returns first; returns fn's other outputs."""
    if not _CHAINS:
        raise RuntimeError(
            "a block that requires grad reached a collective outside an "
            "ordered() chain: differentiate the sharded step through "
            "diff.solve_n_steps(mesh=...) / solve_thermal_n_steps(mesh=...)")
    chain = _CHAINS[-1]
    chain.token, *outs = fn.apply(chain.token, *args)
    return outs


# ---------------------------------------------------------------------------
# Halo strips, sums and replicated scalars.
# ---------------------------------------------------------------------------

class _ShiftPair(Function):
    """``halo._post_pair``: every rank sends `up` to its next-higher and
    `down` to its next-lower neighbour along `axis`."""

    @staticmethod
    def forward(ctx, token, up, down, mesh, axis):
        from . import halo

        ctx.mesh, ctx.axis = mesh, axis
        ctx.has = (up is not None, down is not None)
        from_lo, from_hi = halo._post_pair(up, down, mesh, axis)
        return token.clone(), from_lo, from_hi

    @staticmethod
    def backward(ctx, g_token, g_lo, g_hi):
        from . import halo

        has_up, has_down = ctx.has
        # My from_hi came down from hi: its cotangent goes back up, and the
        # one of my from_lo back down; what comes back is the cotangent of
        # my own down (from lo) and up (from hi).
        r_lo, r_hi = halo._post_pair(g_hi if has_down else None,
                                     g_lo if has_up else None, ctx.mesh,
                                     ctx.axis)
        return (g_token, r_hi if has_up else None,
                r_lo if has_down else None, None, None)


def shift_pair(up, down, mesh: Mesh, axis: str):
    """``halo._shift_pair`` under autograd."""
    return tuple(_apply(_ShiftPair, up, down, mesh, axis))


class _SumOfShares(Function):
    """The all-reduce SUM (`reduce`) or the identity of a replicated value:
    either way each rank holds a share of the output's cotangent, and the
    backward all-reduces them."""

    @staticmethod
    def forward(ctx, token, x, mesh, reduce):
        ctx.mesh = mesh
        y = x.clone()
        if reduce:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
        return token.clone(), y

    @staticmethod
    def backward(ctx, g_token, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        return g_token, g, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks, on every rank."""
    return _apply(_SumOfShares, x, mesh, True)[0]


def replicate(x, mesh: Mesh, dtype: torch.dtype):
    """`x` (a number or a tensor held alike on every rank) as a 0-d or
    larger tensor on the mesh's device that every rank's block uses: its
    gradient is the sum of every rank's share.  A number stays a number
    (nothing flows into it)."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.to(device=mesh.device, dtype=dtype)
    return _apply(_SumOfShares, x, mesh, False)[0] if tracked(x) else x


class _Publish(Function):
    @staticmethod
    def forward(ctx, x, rank0):
        ctx.rank0 = rank0
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank0 else torch.zeros_like(g)), None


def publish(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated value handed out of the mesh (every rank holds it and
    computes the same loss from it): the cotangent stays on rank 0, so the
    sums of ``replicate`` and the collectives count it once."""
    if not tracked(x):
        return x
    return _Publish.apply(x, all(c == 0 for c in mesh.coords))


# ---------------------------------------------------------------------------
# The global maxima of the CFL rule.
# ---------------------------------------------------------------------------

def _interiors(blocks, valid):
    """Each block's interior, -inf on the pad cells (outside `valid`)."""
    out = []
    for x in blocks:
        inner = x[1:-1, 1:-1]
        if valid is not None:
            inner = torch.where(valid, inner, torch.full(
                (), -torch.inf, dtype=x.dtype, device=x.device))
        out.append(inner)
    return out


def maxima(blocks, valid, mesh: Mesh) -> torch.Tensor:
    """[max_0, corner_0, max_1, corner_1, ...]: for each field's padded
    blocks the maximum over the true interior cells and the global corner
    x[0, 0] (rank (0, 0)'s; every other rank offers -inf), in one
    all-reduce MAX."""
    origin = all(c == 0 for c in mesh.coords)
    cand = []
    for x, inner in zip(blocks, _interiors(blocks, valid)):
        cand += [torch.max(inner),
                 x[0, 0] if origin else x.new_full((), -torch.inf)]
    vec = torch.stack(cand)
    dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=mesh.group)
    return vec


class _Maxima(Function):
    @staticmethod
    def forward(ctx, token, valid, mesh, *blocks):
        vec = maxima(blocks, valid, mesh)
        ties = [inner == vec[2 * k]
                for k, inner in enumerate(_interiors(blocks, valid))]
        ctx.save_for_backward(*ties)
        ctx.mesh = mesh
        ctx.origin = all(c == 0 for c in mesh.coords)
        return (token.clone(), *vec.unbind())

    @staticmethod
    def backward(ctx, g_token, *grads):
        ties = ctx.saved_tensors
        n = len(ties)
        counts = [t.sum().to(grads[0].dtype) for t in ties]
        vec = torch.stack([*grads, *counts])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        out = []
        for k, tie in enumerate(ties):
            g = vec.new_zeros((tie.shape[0] + 2, tie.shape[1] + 2))
            g[1:-1, 1:-1] = tie * (vec[2 * k] / vec[2 * n + k])
            if ctx.origin:
                g[0, 0] += vec[2 * k + 1]
            out.append(g)
        return (g_token, None, None, *out)


def global_maxima(blocks, valid, mesh: Mesh):
    """``maxima`` under autograd: the cotangent of a field's maximum is
    spread evenly over its tied cells on every rank (the global count),
    that of its corner lands on rank (0, 0)'s x[0, 0]."""
    return _apply(_Maxima, valid, mesh, *blocks)


# ---------------------------------------------------------------------------
# Global fields in and out of the mesh.
# ---------------------------------------------------------------------------

def _block_origin(params, mesh: Mesh):
    from .topology import local_block_dims

    li, lj = local_block_dims(mesh.shape, params.i_max, params.j_max)
    return li, lj, mesh.coords[0] * li, mesh.coords[1] * lj


def _padded(x: torch.Tensor, params, mesh: Mesh) -> torch.Tensor:
    """The global field zero-padded to the mesh's (px li + 2, py lj + 2)."""
    px, py = mesh.shape
    li, lj, _, _ = _block_origin(params, mesh)
    g = x.new_zeros((px * li + 2, py * lj + 2))
    g[:x.shape[0], :x.shape[1]] = x
    return g


def block_of(x: torch.Tensor, params, mesh: Mesh) -> torch.Tensor:
    """This rank's padded block of a global (i_max + 2, j_max + 2) field,
    halo copies included (``sharded._scatter_blocks``' layout)."""
    li, lj, ox, oy = _block_origin(params, mesh)
    return _padded(x, params, mesh)[ox:ox + li + 2, oy:oy + lj + 2]


class _Scatter(Function):
    @staticmethod
    def forward(ctx, token, x, params, mesh):
        ctx.params, ctx.mesh = params, mesh
        ctx.like = (x.shape, x.dtype, x.device)
        block = block_of(x.detach(), params, mesh)
        return token.clone(), block.to(device=mesh.device,
                                       dtype=params.torch_dtype).contiguous()

    @staticmethod
    def backward(ctx, g_token, g):
        params, mesh = ctx.params, ctx.mesh
        shape, dtype, device = ctx.like
        px, py = mesh.shape
        li, lj, _, _ = _block_origin(params, mesh)
        parts = [torch.empty_like(g) for _ in range(px * py)]
        dist.all_gather(parts, g.contiguous(), group=mesh.group)
        total = g.new_zeros((px * li + 2, py * lj + 2))
        for k, part in enumerate(parts):  # rank order: the same sums
            ax, ay = k // py, k % py
            total[ax * li:ax * li + li + 2, ay * lj:ay * lj + lj + 2] += part
        return (g_token, total[:shape[0], :shape[1]].to(device=device,
                                                         dtype=dtype),
                None, None)


def scatter(x, params, mesh: Mesh) -> torch.Tensor:
    """This rank's padded block of a global field given on every rank, on
    the mesh's device in the configuration's dtype; under autograd the
    input's gradient is the whole one on every rank."""
    x = torch.as_tensor(x)
    if tracked(x):
        return _apply(_Scatter, x, params, mesh)[0]
    return block_of(x, params, mesh).to(device=mesh.device,
                                        dtype=params.torch_dtype).contiguous()


class _Gather(Function):
    @staticmethod
    def forward(ctx, token, x, params, mesh):
        from .sharded import gather_field

        ctx.params, ctx.mesh = params, mesh
        return token.clone(), gather_field(params, x, mesh)

    @staticmethod
    def backward(ctx, g_token, g):
        params, mesh = ctx.params, ctx.mesh
        px, py = mesh.shape
        ax, ay = mesh.coords
        li, lj, _, _ = _block_origin(params, mesh)
        # The cells of this block that the gather reads: the interior, and
        # the ring where the block's side is the padded grid's.
        r = torch.arange(li + 2, device=g.device)
        c = torch.arange(lj + 2, device=g.device)
        rows = ((r >= 1) & (r <= li)) | ((r == 0) & (ax == 0)) | (
            (r == li + 1) & (ax == px - 1))
        cols = ((c >= 1) & (c <= lj)) | ((c == 0) & (ay == 0)) | (
            (c == lj + 1) & (ay == py - 1))
        keep = rows.view(-1, 1) & cols.view(1, -1)
        block = block_of(g, params, mesh)
        return g_token, torch.where(keep, block, 0.0), None, None


def gather(x: torch.Tensor, params, mesh: Mesh) -> torch.Tensor:
    """The global (i_max + 2, j_max + 2) field of every rank's block, on
    every rank (``sharded.gather_field``)."""
    if tracked(x):
        return _apply(_Gather, x, params, mesh)[0]
    from .sharded import gather_field

    return gather_field(params, x, mesh)


# ---------------------------------------------------------------------------
# The pressure solve.
# ---------------------------------------------------------------------------

class _PressureSolveIFT(Function):
    @staticmethod
    def forward(ctx, token, p0, rhs, params, method, li, lj, valid, mesh,
                results):
        from .sharded import _sharded_pressure_solve

        result = _sharded_pressure_solve(p0, rhs, params, method, li, lj,
                                         valid, mesh)
        results.append(result)
        ctx.args = (params, method, li, lj, valid, mesh)
        return token.clone(), result.p

    @staticmethod
    def backward(ctx, g_token, p_bar):
        from .sharded import _pressure_adjoint

        with torch.no_grad():
            p0_bar, rhs_bar = _pressure_adjoint(p_bar.contiguous(),
                                                *ctx.args)
        return (g_token, p0_bar, rhs_bar) + (None,) * 7


def pressure_solve(p0, rhs, params, method: str, li: int, lj: int, valid,
                   mesh: Mesh):
    """``sharded._sharded_pressure_solve`` (never differentiated) with the
    implicit-function adjoint: its SORResult, whose p carries the
    gradient."""
    results = []
    p = _apply(_PressureSolveIFT, p0, rhs, params, method, li, lj, valid,
               mesh, results)[0]
    return results[-1]._replace(p=p)
