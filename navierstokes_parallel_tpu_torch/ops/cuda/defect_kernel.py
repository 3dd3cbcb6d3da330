"""The f64 outer's pass after its inner stage: the hand-written CUDA kernel
and its plain twin.

One pass of ops/sor.py::_solve_pressure_refined, once the inner stage has
returned delta, updates the f64 master where the problem is still going,
fills the Neumann ghost ring, forms the f64 defect r = A p - rhs, takes its
L2 norm and updates the result's norm, the count and the go-on flag; the
next pass's inner solves A delta = -r.  With the default hooks
(ops/sor.py::_fused_outer) ``outer_pass`` makes that pass for one solve,
the next pass's rhs, f32(-r), included: for one problem, or for a batch
whose tensors carry a leading member axis (the master (B, i_max + 2,
j_max + 2), the flags, counts, norms and thresholds (B,)), every member
with its own norm, count and stop.  CPU tensors take the outer's own plain
pass (ops/sor.py::outer_pass_plain with the default defect and norm),
which takes a batch too; CUDA tensors one launch of ``csrc/defect.cu`` a
pass for the whole batch, which raises on anything the kernel does not
take.  Its source note says what bounds it on the card.  No TPU kernel
stands behind it: the JAX package's outer is jnp.

The kernel's launches are counted in utils/timing.py's table under
"launch.pressure_defect", one a call.
"""

from __future__ import annotations

import functools

import torch

from ...config import Params
from ...utils import timing
from . import _build

# A block's interior cells (csrc/defect.cu::kTileRows, kTileCols): the
# kernel's blocks, and so its partial sums, follow from them.
TILE_ROWS = 16
TILE_COLS = 32


def blocks(i_max: int, j_max: int, members: int = 1) -> int:
    """Blocks of one launch over `members` i_max x j_max interiors."""
    return members * -(-i_max // TILE_ROWS) * -(-j_max // TILE_COLS)


def workspace_len(i_max: int, j_max: int, members: int = 1) -> int:
    """Doubles of a launch's workspace: a row a member of one partial per
    block, then the member's ticket."""
    return blocks(i_max, j_max, members) + members


def _lead(master) -> tuple:
    """The member axis of a solve's master: (B,) for a batch (3-D), else
    ()."""
    return tuple(master.shape[:1]) if master.dim() == 3 else ()


def _spacing(params: Params):
    """(dx2_inv, dy2_inv) as Python doubles, as the outer forms them."""
    return 1.0 / (params.dx * params.dx), 1.0 / (params.dy * params.dy)


def check_inputs(p64, rhs_int64, rhs_full, threshold, params: Params) -> None:
    """Raise on a solve's tensors that the kernel does not take: one
    problem's, or a batch's with one leading member axis on each (the
    threshold (B,))."""
    lead = _lead(p64)
    for name, x, dtype, want in (
            ("master", p64, torch.float64, lead + params.shape),
            ("rhs_full", rhs_full, torch.float32, lead + params.shape),
            ("rhs", rhs_int64, torch.float64,
             lead + (params.i_max, params.j_max)),
            ("threshold", threshold, torch.float64, lead)):
        if x.dtype != dtype:
            raise TypeError(f"pressure defect kernel takes {dtype} {name}, "
                            f"got {x.dtype}")
        if tuple(x.shape) != want:
            raise ValueError(f"pressure defect kernel takes {name} of shape "
                             f"{want}, got {tuple(x.shape)}")
        if x.device != p64.device:
            raise ValueError(f"{name} on {x.device}, the master on "
                             f"{p64.device}")
    if not (p64.is_contiguous() and rhs_full.is_contiguous()
            and threshold.is_contiguous()):
        raise ValueError("pressure defect kernel takes a contiguous master, "
                         "rhs_full and threshold")
    if rhs_int64.stride(-1) != 1:
        raise ValueError("pressure defect kernel takes rhs rows of unit "
                         "stride")


def _check_pass(master, delta, on, iterations, res_norm, shape) -> None:
    """Raise on a pass's tensors that the kernel does not take: a
    contiguous float64 master of the solve's `shape` (its member axis
    included), delta of that shape in float32, a flag, count and norm for
    each member (0-d for one problem).  The solve builds the flag, count
    and norm contiguous and updates them in place."""
    shape, lead = tuple(shape), tuple(shape[:-2])
    if (master.dtype != torch.float64 or tuple(master.shape) != shape
            or not master.is_contiguous()):
        raise ValueError(f"pressure defect kernel takes a contiguous float64 "
                         f"master of the solve's shape {shape}, got "
                         f"{master.dtype} {tuple(master.shape)}")
    if (delta.dtype != torch.float32 or tuple(delta.shape) != shape
            or not delta.is_contiguous()):
        raise ValueError(f"pressure defect kernel takes a contiguous float32 "
                         f"delta of shape {shape}, got {delta.dtype} "
                         f"{tuple(delta.shape)}")
    for name, x, dtype in (("on", on, torch.bool),
                           ("iterations", iterations, torch.int64),
                           ("res_norm", res_norm, torch.float64)):
        if x.dtype != dtype or tuple(x.shape) != lead:
            want = f"shape {lead}" if lead else "0-d"
            raise ValueError(f"pressure defect kernel takes a {want} {dtype} "
                             f"{name}, got {x.dtype} of shape "
                             f"{tuple(x.shape)}")
    for name, x in (("delta", delta), ("on", on), ("iterations", iterations),
                    ("res_norm", res_norm)):
        if x.device != master.device:
            raise ValueError(f"{name} on {x.device}, the master on "
                             f"{master.device}")


def outer_pass(p64, rhs_int64, rhs_full, threshold, params: Params):
    """The pass of one solve, of one problem or of a batch (p64 3-D): a
    function (p64, delta, on, iterations, res_norm, n_inner) -> the new
    master, which updates res_norm, iterations and on in place and writes
    the next pass's rhs into the interior of rhs_full (its ring stays 0).
    CPU tensors take ``sor.outer_pass_plain``, which works on p64 in place;
    CUDA tensors the kernel, one launch a pass for every member, which
    writes the new master into a second buffer and returns it (the
    caller's p64 becomes the next pass's spare)."""
    if p64.device.type == "cpu":
        from .. import sor  # sor imports this module

        return functools.partial(
            sor.outer_pass_plain, defect=sor._make_defect(rhs_int64, params),
            l2_fn=sor._default_l2(params), threshold=threshold,
            rhs_full=rhs_full)
    if p64.device.type != "cuda":
        raise ValueError(f"no pressure defect kernel for device "
                         f"{p64.device}")
    check_inputs(p64, rhs_int64, rhs_full, threshold, params)
    lib = _build.load()
    lead = _lead(p64)
    members = lead[0] if lead else 1
    rhs_member_stride = rhs_int64.stride(0) if lead else 0
    # The clone carries the master's corners, which no pass writes.
    spare = p64.clone()
    # A row a member: one partial per block, then the member's ticket,
    # which each launch leaves 0.
    workspace = torch.zeros(workspace_len(params.i_max, params.j_max,
                                          members),
                            dtype=torch.float64, device=p64.device)
    dx2_inv, dy2_inv = _spacing(params)

    def launch(master, delta, on, iterations, res_norm, n_inner):
        nonlocal spare
        _check_pass(master, delta, on, iterations, res_norm, spare.shape)
        out = spare
        if out.data_ptr() == master.data_ptr():
            raise ValueError("the pass's master is its own spare: pass the "
                             "master the last pass returned")
        status = lib.nsp_pressure_defect(
            master.data_ptr(), out.data_ptr(), delta.data_ptr(),
            rhs_int64.data_ptr(), rhs_int64.stride(-2), rhs_member_stride,
            rhs_full.data_ptr(), on.data_ptr(), iterations.data_ptr(),
            res_norm.data_ptr(), threshold.data_ptr(), workspace.data_ptr(),
            workspace.numel(), members, params.i_max, params.j_max,
            int(n_inner), dx2_inv, dy2_inv,
            *_build.device_and_stream(master))
        _build.check_status(status, "nsp_pressure_defect")
        timing.count("launch.pressure_defect")
        spare = master
        return out

    return launch
