"""The f64 outer's fused pass (ops/cuda/defect_kernel.py) on the CPU.

The default call of ``sor._solve_pressure_refined`` (one problem, a 2-D
float32 state, the default hooks, no deflation) takes the fused pass, on
the CPU its plain twin, the outer's own plain pass
(``sor.outer_pass_plain`` with the default defect and norm); every other
call keeps the outer's plain statements.  Both give the same bits: a call
with an explicit ``l2_fn=_default_l2(params)`` takes the plain statements
and serves as the yardstick.  The kernel itself runs on the card
(tests/test_torch_cuda.py).
"""

import math

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.ops import sor
from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel
from navierstokes_parallel_tpu_torch.utils import timing

# A 24 x 20 problem; at eps 1e-12 every solve runs into max_it (4 passes
# of K = 64 and one of 44).
PRM = Params(i_max=24, j_max=20, Re=1000.0, T=0.3, tau=0.5, max_it=300,
             epsilon=1e-12)
COUNTERS = ("pressure.passes", "pressure.fused_passes",
            "launch.pressure_defect")


def since(start) -> dict:
    now = timing.counts()
    return {name: now.get(name, 0) - start.get(name, 0) for name in COUNTERS}


def _problem(prm, seed=0):
    """(p, rhs): p = 0 and a zero-mean seeded rhs on the interior."""
    g = torch.Generator().manual_seed(seed)
    p = torch.zeros(prm.shape)
    rhs = torch.zeros(prm.shape)
    rhs[1:-1, 1:-1] = torch.randn((prm.i_max, prm.j_max), generator=g)
    rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
    return p, rhs


def _same(a, b) -> bool:
    return (torch.equal(a.p, b.p)
            and (a.iterations, a.res_norm, a.converged)
            == (b.iterations, b.res_norm, b.converged))


def test_default_call_takes_the_fused_pass_with_the_plain_bits():
    p, rhs = _problem(PRM)
    start = timing.counts()
    fused = sor._solve_pressure_refined(p, rhs, PRM)
    counted = since(start)
    assert counted["pressure.fused_passes"] == counted["pressure.passes"] == 5
    assert counted["launch.pressure_defect"] == 0  # the CPU twin
    start = timing.counts()
    plain = sor._solve_pressure_refined(p, rhs, PRM,
                                        l2_fn=sor._default_l2(PRM))
    counted = since(start)
    assert counted["pressure.passes"] == 5
    assert counted["pressure.fused_passes"] == 0
    assert _same(fused, plain)
    assert fused.iterations == PRM.max_it and not fused.converged


def _dx2(prm):
    return 1.0 / (prm.dx * prm.dx), 1.0 / (prm.dy * prm.dy)


# Hooks equal to the defaults: a shard's hooks, each of which alone sends
# the call to the plain statements, with the default call's bits.
EQUAL_HOOKS = {
    "ghost_fn": lambda prm: dict(ghost_fn=lambda q: sor.ghost_fill(q)),
    "l2_fn": lambda prm: dict(l2_fn=sor._default_l2(prm)),
    "valid_mask": lambda prm: dict(valid_mask=torch.ones(
        (prm.i_max, prm.j_max), dtype=torch.bool)),
    "residual_fn": lambda prm: dict(residual_fn=lambda p64, r: sor.residual(
        sor.ghost_fill(p64), r, *_dx2(prm))),
}


@pytest.mark.parametrize("hook", sorted(EQUAL_HOOKS))
def test_a_shard_hook_takes_the_plain_statements(hook):
    p, rhs = _problem(PRM, seed=1)
    want = sor._solve_pressure_refined(p, rhs, PRM)
    start = timing.counts()
    got = sor._solve_pressure_refined(p, rhs, PRM, **EQUAL_HOOKS[hook](PRM))
    counted = since(start)
    assert counted["pressure.passes"] == 5
    assert counted["pressure.fused_passes"] == 0
    assert _same(got, want)


def _batch():
    ps, rhss = zip(*(_problem(PRM, seed=s) for s in (2, 3)))
    return sor.solve_pressure_batch(torch.stack(ps), torch.stack(rhss), PRM)


def _channel():
    prm = PRM.replace(problem=3, a=2.0, b=1.0)
    return sor.solve_pressure(*_problem(prm, seed=4), prm)


def _compensated():
    return sor.solve_pressure(*_problem(PRM, seed=5),
                              PRM.replace(outer_precision="compensated"))


def _float64_state():
    p, rhs = _problem(PRM, seed=6)
    return sor.solve_pressure(p.double(), rhs.double(), PRM, method="mg")


def _under_autograd():
    p, rhs = _problem(PRM, seed=7)
    with torch.enable_grad():
        return sor._solve_pressure_refined(p.requires_grad_(), rhs, PRM)


PLAIN_CALLS = {"going": _batch, "problem 3": _channel,
               "compensated": _compensated, "float64 state": _float64_state,
               "autograd": _under_autograd}


@pytest.mark.parametrize("call", sorted(PLAIN_CALLS))
def test_other_calls_take_the_plain_statements(call):
    start = timing.counts()
    PLAIN_CALLS[call]()
    counted = since(start)
    assert counted["pressure.passes"] >= 1
    assert counted["pressure.fused_passes"] == 0


def _plain_refined(monkeypatch):
    """Send every refined solve to the plain statements (an explicit
    default norm)."""
    refined = sor._solve_pressure_refined

    def plain(p, rhs, params, **kw):
        return refined(p, rhs, params, **{"l2_fn": sor._default_l2(params),
                                          **kw})

    monkeypatch.setattr(sor, "_solve_pressure_refined", plain)


@pytest.mark.parametrize("method", ["rb_sor", "mg", "fft"])
def test_fused_cavity_steps_equal_the_plain_ones(method, monkeypatch):
    """Two steps of a small cavity with a seeded velocity: the fused twin's
    fields, counts and norms equal the plain statements' bit for bit."""
    prm = Params(i_max=24, j_max=24, Re=1000.0, T=0.3, tau=0.5, max_it=300,
                 epsilon=1e-3)
    state = allocate_state(prm, "cpu")
    g = torch.Generator().manual_seed(8)
    u = state.u.clone()
    u[1:-1, 1:-1] += 0.01 * torch.randn(u[1:-1, 1:-1].shape, generator=g)
    state = state._replace(u=u)
    runs = {}
    for name in ("fused", "plain"):
        if name == "plain":
            _plain_refined(monkeypatch)
        stepper = solver.Stepper(prm, state, method)
        start = timing.counts()
        stats = solver.run_steps(stepper, prm, max_steps=2)
        runs[name] = (stepper.state(), stats, since(start))
    (fs, fstats, fcount), (ps, pstats, pcount) = runs["fused"], runs["plain"]
    assert fstats == pstats
    for field in ("u", "v", "p"):
        assert torch.equal(getattr(fs, field), getattr(ps, field)), field
    assert fcount["pressure.fused_passes"] == fcount["pressure.passes"] >= 2
    assert pcount["pressure.fused_passes"] == 0
    assert pcount["pressure.passes"] == fcount["pressure.passes"]


def _pass_inputs(prm, seed):
    rng = np.random.default_rng(seed)
    p64 = torch.from_numpy(rng.standard_normal(prm.shape))
    delta = torch.from_numpy(rng.standard_normal(prm.shape).astype(
        np.float32))
    rhs = torch.from_numpy(rng.standard_normal((prm.i_max, prm.j_max)))
    return p64, delta, rhs


@pytest.mark.parametrize("going", [True, False])
@pytest.mark.parametrize("stops", [False, True])
def test_one_pass_of_the_twin(going, stops):
    """One pass from a random master against the outer's statements
    written out here: a problem that has stopped keeps its master, norm
    and count; one whose norm falls to the threshold stops."""
    prm = Params(i_max=13, j_max=9, a=1.0, b=0.7)
    p64, delta, rhs = _pass_inputs(prm, 9)
    dx2, dy2 = _dx2(prm)
    # The statements, on copies.
    q = p64.clone()
    interior = q[1:-1, 1:-1]
    on_want = torch.tensor(going)
    interior.copy_(torch.where(on_want, interior + delta[1:-1, 1:-1].double(),
                               interior))
    r = sor.residual(sor.ghost_fill(q), rhs, dx2, dy2)
    norm = sor.l2_norm(r, prm.i_max, prm.j_max)
    threshold = torch.tensor(
        float(norm) * (2.0 if stops else 0.5), dtype=torch.float64)
    # The twin through the dispatch, on the CPU.
    rhs_full = torch.zeros(prm.shape)
    on = torch.tensor(going)
    iterations = torch.tensor(5)
    res_norm = torch.tensor(math.inf, dtype=torch.float64)
    pass_fn = defect_kernel.outer_pass(p64, rhs, rhs_full, threshold, prm)
    assert pass_fn.func is sor.outer_pass_plain  # the outer's own pass
    out = pass_fn(p64, delta, on, iterations, res_norm, 64)
    assert out is p64 and torch.equal(out, q)
    assert torch.equal(rhs_full[1:-1, 1:-1], -r.float())
    assert not rhs_full[0].any() and not rhs_full[:, -1].any()
    assert int(iterations) == (69 if going else 5)
    assert float(res_norm) == (float(norm) if going else math.inf)
    assert bool(on) == (going and not stops)


BAD_INPUTS = ["master_dtype", "master_shape", "rhs_full_dtype",
              "rhs_shape", "threshold_shape", "strided_master",
              "rhs_column_stride", "other_device"]


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_kernel_checks_a_solves_tensors(bad):
    prm = Params(i_max=12, j_max=10, a=1.0, b=1.0)
    p64, _, rhs = _pass_inputs(prm, 10)
    rhs_full = torch.zeros(prm.shape)
    threshold = torch.tensor(1.0, dtype=torch.float64)
    args = dict(p64=p64, rhs_int64=rhs, rhs_full=rhs_full,
                threshold=threshold)
    error = ValueError
    if bad == "master_dtype":
        args["p64"], error = p64.float(), TypeError
    elif bad == "master_shape":
        args["p64"] = p64[:-1]
    elif bad == "rhs_full_dtype":
        args["rhs_full"], error = rhs_full.double(), TypeError
    elif bad == "rhs_shape":
        args["rhs_int64"] = rhs[:, :-1]
    elif bad == "threshold_shape":
        args["threshold"] = threshold.reshape(1)
    elif bad == "strided_master":
        args["p64"] = p64.t().contiguous().t()
    elif bad == "rhs_column_stride":
        args["rhs_int64"] = rhs.t().contiguous().t()
    else:
        args["threshold"] = threshold.to("meta")
    with pytest.raises(error):
        defect_kernel.check_inputs(params=prm, **args)
    # The same tensors as they should be pass.
    defect_kernel.check_inputs(p64, rhs, rhs_full,
                               torch.tensor(1.0, dtype=torch.float64),
                               Params(i_max=12, j_max=10, a=1.0, b=1.0))


def test_outer_pass_raises_on_other_devices():
    prm = Params(i_max=6, j_max=6, a=1.0, b=1.0)
    p64, _, rhs = _pass_inputs(prm, 11)
    args = [x.to("meta") for x in (p64, rhs, torch.zeros(prm.shape),
                                   torch.tensor(1.0, dtype=torch.float64))]
    with pytest.raises(ValueError, match="no pressure defect kernel"):
        defect_kernel.outer_pass(*args, prm)


@pytest.mark.parametrize("interior,want", [((256, 256), 128),
                                           ((2048, 2048), 8192),
                                           ((128, 64), 16), ((5, 3), 1),
                                           ((17, 33), 4)])
def test_blocks_of_one_launch(interior, want):
    assert defect_kernel.blocks(*interior) == want
