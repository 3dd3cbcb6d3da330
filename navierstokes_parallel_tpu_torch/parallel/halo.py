"""Halo exchange between the shards of a process mesh.

Counterpart of ``navierstokes_parallel_tpu/parallel/halo.py``.  Each rank
holds a (li+2, lj+2) padded block: li x lj interior plus a one-cell halo
ring.  The JAX package refreshes interior shard boundaries with
``lax.ppermute`` inside ``shard_map``; here a strip goes to the neighbour
rank with ``torch.distributed`` point-to-point operations, both directions
of one mesh axis posted in one ``batch_isend_irecv`` (so no pair of ranks
waits on the other's order), and a rank with no neighbour receives zeros,
as ``ppermute`` gives.  Send buffers are made contiguous (a column strip of
a row-major block is strided); receive buffers are fresh.

Exchange order is y (axis 1) first, then x (axis 0) sending full rows
*including* the freshly filled y-halo entries, so corner halo cells pick up
the diagonal neighbour's value, as the donor-cell stencils need.

A strip that requires grad (a differentiated step: diff.py's mesh path)
is shifted by parallel/autograd.py's Function, whose backward sends the
cotangents back; the exchange's slice writes are autograd's own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import autograd
from .topology import Mesh


def _shift_pair(up, down, mesh: Mesh, axis: str):
    """(what `up` sends, what `down` sends) as received: every rank sends
    `up` to its next-higher neighbour along `axis` and `down` to its
    next-lower one, in one batch.  Returns (from the lower neighbour, from
    the higher one), zeros where there is none; pass None for a direction
    not wanted (its result is None)."""
    if autograd.tracked(up, down):
        return autograd.shift_pair(up, down, mesh, axis)
    return _post_pair(up, down, mesh, axis)


def _post_pair(up, down, mesh: Mesh, axis: str):
    """``_shift_pair``'s point-to-point operations."""
    lo, hi = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
    ops = []
    from_lo = from_hi = None
    if up is not None:
        from_lo = torch.zeros_like(up)
        if hi is not None:
            ops.append(dist.P2POp(dist.isend, up.contiguous(), hi,
                                  mesh.group, tag=0))
        if lo is not None:
            ops.append(dist.P2POp(dist.irecv, from_lo, lo, mesh.group, tag=0))
    if down is not None:
        from_hi = torch.zeros_like(down)
        if lo is not None:
            ops.append(dist.P2POp(dist.isend, down.contiguous(), lo,
                                  mesh.group, tag=1))
        if hi is not None:
            ops.append(dist.P2POp(dist.irecv, from_hi, hi, mesh.group, tag=1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_lo, from_hi


def _shift_up(strip: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Each shard's strip from the next-lower shard along `axis`; the lowest
    shard receives zeros."""
    return _shift_pair(strip, None, mesh, axis)[0]


def exchange_halo(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A copy of the padded block with all four halo strips refreshed from
    the mesh neighbours.  Halos at physical domain edges receive zeros:
    callers overwrite them with the field's boundary-condition closure."""
    local = local.clone()
    from_below, from_above = _shift_pair(local[:, -2], local[:, 1], mesh, "y")
    local[:, 0] = from_below
    local[:, -1] = from_above
    from_left, from_right = _shift_pair(local[-2, :], local[1, :], mesh, "x")
    local[0, :] = from_left
    local[-1, :] = from_right
    return local


def edge_masks(mesh: Mesh) -> dict:
    """Whether this shard lies on each side of the physical boundary."""
    ax, ay = mesh.coords
    px, py = mesh.shape
    return {"left": ax == 0, "right": ax == px - 1,
            "bottom": ay == 0, "top": ay == py - 1}


def close_pressure_halo(p: torch.Tensor, edges: dict) -> torch.Tensor:
    """Homogeneous Neumann closure at physical edges (integration.c:138-146),
    IN PLACE: the ghost cell copies its interior neighbour.  The four global
    corners are left alone, as the serial ghost fill leaves them; halo
    copies of a neighbour shard's ghost cells at this block's strip ends
    are written, which keeps them equal to their owner's."""
    ni, nj = p.shape
    c0, c1 = int(edges["bottom"]), nj - int(edges["top"])
    if edges["left"]:
        p[0, c0:c1] = p[1, c0:c1]
    if edges["right"]:
        p[-1, c0:c1] = p[-2, c0:c1]
    r0, r1 = int(edges["left"]), ni - int(edges["right"])
    if edges["bottom"]:
        p[r0:r1, 0] = p[r0:r1, 1]
    if edges["top"]:
        p[r0:r1, -1] = p[r0:r1, -2]
    return p


def neumann_or_exchange(p: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sharded ghost_fn of the SOR solve for grids the mesh divides
    evenly (the physical boundary on the block edges): exchange the halos,
    Neumann-close the physical ones.  Padded blocks take
    `make_masked_ghost_fn`."""
    return close_pressure_halo(exchange_halo(p, mesh), edge_masks(mesh))


def padded_global_indices(shape, mesh: Mesh):
    """(gi, gj), broadcastable (ni, 1) and (1, nj) int tensors on the
    mesh's device: the global PADDED-layout indices of a padded local
    block's cells, ring included.  gi == 0 is the global left ghost column
    and gi == i_max + 1 the right one, which under pad-to-divisible
    sharding may lie inside a block rather than on its ring."""
    ni, nj = shape
    ox, oy = mesh.origin(ni - 2, nj - 2)
    gi = torch.arange(ni, device=mesh.device).view(ni, 1) + ox
    gj = torch.arange(nj, device=mesh.device).view(1, nj) + oy
    return gi, gj


def make_masked_ghost_fn(i_max: int, j_max: int, mesh: Mesh):
    """ghost_fn for (possibly padded) blocks: exchange, then the Neumann
    closure as global-index-masked roll copies, wherever the true boundary
    falls; junk cells beyond the ghost ring (pad) are zeroed.  The masked
    writes land on halo positions too, which keeps every halo copy of a
    ghost cell equal to its owner's without a second exchange."""

    def ghost(p: torch.Tensor) -> torch.Tensor:
        p = exchange_halo(p, mesh)
        gi, gj = padded_global_indices(p.shape, mesh)
        in_j = (gj >= 1) & (gj <= j_max)
        in_i = (gi >= 1) & (gi <= i_max)
        p = torch.where((gi == 0) & in_j, torch.roll(p, -1, 0), p)
        p = torch.where((gi == i_max + 1) & in_j, torch.roll(p, 1, 0), p)
        p = torch.where(in_i & (gj == 0), torch.roll(p, -1, 1), p)
        p = torch.where(in_i & (gj == j_max + 1), torch.roll(p, 1, 1), p)
        return torch.where((gi > i_max + 1) | (gj > j_max + 1),
                           torch.zeros((), dtype=p.dtype, device=p.device), p)

    return ghost
