"""Process-mesh topology for 2-D grid sharding.

Counterpart of ``navierstokes_parallel_tpu/parallel/topology.py``.  The
JAX package lays a 2-D ("x", "y") ``jax.sharding.Mesh`` over its devices;
the port lays the same mesh over the ranks of the ``torch.distributed``
group, one shard per rank: rank k sits at (k // py, k % py), the row-major
order of JAX's ``np.asarray(devices).reshape(px, py)``, so the blocks of
``sharded._scatter_blocks`` / ``_gather_blocks`` land on the same mesh
positions in both packages.

JAX's collectives over one mesh axis (``lax.all_to_all(..., "y")``,
``lax.all_gather(..., "x")``) act within one row or column of the mesh;
``make_grid_mesh`` builds those process groups once (every rank creates
every group, in the same order) and ``Mesh.axis_group`` hands out this
rank's.  A group rank is the rank's position along the axis, since
``dist.new_group`` orders its members by global rank; the combined
("x", "y") axis is the whole group, where the rank is ax * py + ay.

``make_batch_mesh`` lays the 1-D ("b",) mesh of the data-parallel ensemble
(solver.solve_ensemble) over the same ranks: rank k holds the k-th
contiguous slice of the members.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import distributed

MESH_AXES = ("x", "y")


def _factor_pairs(n: int):
    """All (px, py) with px * py == n, ordered nearest-square first."""
    pairs = [(px, n // px) for px in range(1, n + 1) if n % px == 0]
    pairs.sort(key=lambda ab: abs(ab[0] - ab[1]))
    return pairs


def choose_mesh_shape(n_devices: int, i_max: int,
                      j_max: int) -> Tuple[int, int]:
    """(px, py) with px * py == n_devices that evenly divides the interior,
    nearest-square first; raises when no factorization does."""
    for px, py in _factor_pairs(n_devices):
        if i_max % px == 0 and j_max % py == 0:
            return px, py
    raise ValueError(
        f"cannot shard a {i_max}x{j_max} interior over {n_devices} devices: "
        f"no factorization divides the grid evenly")


def choose_mesh_shape_padded(n_devices: int, i_max: int,
                             j_max: int) -> Tuple[int, int]:
    """(px, py) with px * py == n_devices minimizing the padded interior
    area ceil(i/px)*px * ceil(j/py)*py, ties nearest-square.  Always
    succeeds: pad cells are masked out of every update and reduction."""
    best = None
    for px, py in _factor_pairs(n_devices):
        ip = -(-i_max // px) * px
        jp = -(-j_max // py) * py
        cost = (ip * jp, abs(px - py))
        if best is None or cost < best[0]:
            best = (cost, (px, py))
    return best[1]


def choose_mesh_shape_square(n_devices: int) -> Tuple[int, int]:
    """Nearest-square (px, py) with px * py == n_devices and, whenever the
    count allows it, both axes > 1: the gspmd backend's mesh (it refuses a
    trivial axis on more than one device, as the JAX package's does).
    Raises for a prime count, which has only 1 x n factorizations (2
    included, as in the JAX package)."""
    for px, py in _factor_pairs(n_devices):
        if min(px, py) > 1 or n_devices == 1:
            return px, py
    raise ValueError(
        f"{n_devices} devices admit only 1x{n_devices} meshes (prime "
        f"count); the gspmd backend needs both mesh axes > 1 — use a "
        f"composite device count or the manual sharded backend")


def local_block_dims(mesh_shape: Tuple[int, int], i_max: int,
                     j_max: int) -> Tuple[int, int]:
    """Per-shard interior block dims (li, lj) = ceil(i_max/px),
    ceil(j_max/py); the global interior is padded to (px*li, py*lj)."""
    px, py = mesh_shape
    return -(-i_max // px), -(-j_max // py)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (px, py) mesh over the default process group:
    ``shape`` (px, py), ``coords`` (ax, ay), the ``group``, the ``device``
    the rank computes on, and ``axis_groups``: this rank's groups along
    "x" (its column: the ranks of equal ay) and "y" (its row), None for a
    group of one rank.  A batch mesh (``make_batch_mesh``) has one axis,
    ``axes`` ("b",): ``shape`` (n,) and ``coords`` (k,)."""

    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    group: object
    axis_groups: dict = field(default_factory=dict, compare=False)
    axes: Tuple[str, ...] = MESH_AXES

    def neighbour(self, axis: str, step: int) -> Optional[int]:
        """Rank of the shard `step` positions away along `axis`, or None
        past the mesh edge."""
        coords = list(self.coords)
        k = MESH_AXES.index(axis)
        coords[k] += step
        if not 0 <= coords[k] < self.shape[k]:
            return None
        return coords[0] * self.shape[1] + coords[1]

    def origin(self, li: int, lj: int) -> Tuple[int, int]:
        """Global interior origin (ox, oy) of this rank's (li, lj) block."""
        return self.coords[0] * li, self.coords[1] * lj

    def axis_group(self, axis: str):
        """(group, size) of the collectives along `axis`: "x", "y", or "xy"
        for the whole mesh."""
        if axis == "xy":
            return self.group, self.shape[0] * self.shape[1]
        return self.axis_groups.get(axis), self.shape[MESH_AXES.index(axis)]


def _axis_groups(px: int, py: int, rank: int) -> dict:
    """This rank's "x" and "y" groups of a (px, py) mesh over the default
    group.  Every rank calls ``dist.new_group`` for every row and column
    group of more than one rank and fewer than all, in the same order; an
    axis that spans the mesh is the default group, one of extent 1 has no
    group."""
    world = px * py
    mine = {}
    for axis, extent, groups in (
            ("y", py, [[ax * py + ay for ay in range(py)]
                       for ax in range(px)]),
            ("x", px, [[ax * py + ay for ax in range(px)]
                       for ay in range(py)])):
        if extent == 1:
            continue
        for ranks in groups:
            group = (dist.group.WORLD if extent == world
                     else dist.new_group(ranks=ranks))
            if rank in ranks:
                mine[axis] = group
    return mine


def make_grid_mesh(n_devices: Optional[int] = None, i_max: int = 0,
                   j_max: int = 0, *, shape: Optional[Tuple[int, int]] = None,
                   device=None) -> Mesh:
    """The mesh over the initialised default process group: `shape`, or
    the pad-optimal (px, py) for an i_max x j_max interior.  `n_devices`,
    when given, must equal the group's size; `device` defaults to the
    group's (utils.distributed.default_device)."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of that size; this one has {world} ranks")
    if shape is None:
        shape = choose_mesh_shape_padded(world, i_max, j_max)
    px, py = (int(s) for s in shape)
    if px < 1 or py < 1 or px * py != world:
        raise ValueError(f"mesh {px}x{py} needs {px * py} ranks; the process "
                         f"group has {world}")
    rank = dist.get_rank()
    device = (distributed.default_device() if device is None
              else torch.device(device))
    return Mesh((px, py), (rank // py, rank % py), device, dist.group.WORLD,
                _axis_groups(px, py, rank))


def make_batch_mesh(device=None) -> Mesh:
    """The 1-D ("b",) mesh over the initialised default process group, one
    rank per slice of an ensemble's members (the JAX package's
    ``Mesh(devices, ("b",))``); `device` defaults to the group's."""
    device = (distributed.default_device() if device is None
              else torch.device(device))
    return Mesh((dist.get_world_size(),), (dist.get_rank(),), device,
                dist.group.WORLD, axes=("b",))
