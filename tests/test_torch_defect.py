"""The f64 outer's fused pass (ops/cuda/defect_kernel.py) on the CPU.

The default call of ``sor._solve_pressure_refined`` (a float32 state,
2-D for one problem or 3-D for a batch, the default hooks, no deflation)
takes the fused pass, on the CPU its plain twin, the outer's own plain
pass (``sor.outer_pass_plain`` with the default defect and norm); every
other call keeps the outer's plain statements.  Both give the same bits: a
call with an explicit ``l2_fn=_default_l2(params)`` takes the plain
statements and serves as the yardstick.  The kernel itself runs on the
card (tests/test_torch_cuda.py).
"""

import math
import warnings

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


def _stacked(prm, seeds=(2, 3)):
    """(p, rhs) of a batch: _problem's of each seed on a member axis."""
    ps, rhss = zip(*(_problem(prm, seed=s) for s in seeds))
    return torch.stack(ps), torch.stack(rhss)


def _going(n_members=2):
    return torch.ones(n_members, dtype=torch.bool)


def _batch():
    """A batch with a hook (an explicit default norm): a batch off the
    default hooks keeps the plain statements."""
    return sor._solve_pressure_refined(*_stacked(PRM), PRM,
                                       l2_fn=sor._default_l2(PRM),
                                       going=_going())


def _batch_channel():
    prm = PRM.replace(problem=3, a=2.0, b=1.0)
    return sor.solve_pressure_batch(*_stacked(prm, (4, 5)), prm)


def _batch_float64_state():
    p, rhs = _stacked(PRM, (6, 7))
    return sor._solve_pressure_refined(p.double(), rhs.double(), PRM,
                                       going=_going())


def _batch_under_autograd():
    p, rhs = _stacked(PRM, (7, 8))
    with torch.enable_grad():
        return sor._solve_pressure_refined(p.requires_grad_(), rhs, PRM,
                                           going=_going())


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
               "autograd": _under_autograd,
               "going, problem 3": _batch_channel,
               "going, float64 state": _batch_float64_state,
               "going, autograd": _batch_under_autograd}


@pytest.mark.parametrize("call", sorted(PLAIN_CALLS))
def test_other_calls_take_the_plain_statements(call):
    start = timing.counts()
    PLAIN_CALLS[call]()
    counted = since(start)
    assert counted["pressure.passes"] >= 1
    assert counted["pressure.fused_passes"] == 0


def _gate(case: str) -> bool:
    """sor._fused_outer on a default call changed as `case` says."""
    p, rhs = _stacked(PRM)
    prm, kw = PRM, dict(ghost_fn=sor.ghost_fill, l2_fn=None,
                        valid_mask=None, residual_fn=None, going=_going())
    if case == "one problem":
        p, rhs, kw["going"] = p[0], rhs[0], None
    elif case == "one problem, 3-D state":
        kw["going"] = None
    elif case == "batch, 2-D state":
        p, rhs = p[0], rhs[0]
    elif case == "batch, strided state":
        p = p.transpose(-2, -1).contiguous().transpose(-2, -1)
    elif case == "batch, float64 state":
        p, rhs = p.double(), rhs.double()
    elif case == "batch, problem 3":
        prm = PRM.replace(problem=3, a=2.0, b=1.0)
    elif case == "batch, autograd":
        p.requires_grad_()
    elif case.startswith("batch, hook "):
        kw.update(EQUAL_HOOKS[case[len("batch, hook "):]](PRM))
    with torch.enable_grad():
        return sor._fused_outer(p, rhs, prm, **kw)


GATE_CASES = {"one problem": True, "batch": True,
              "one problem, 3-D state": False, "batch, 2-D state": False,
              "batch, strided state": False, "batch, float64 state": False,
              "batch, problem 3": False, "batch, autograd": False,
              **{f"batch, hook {hook}": False for hook in EQUAL_HOOKS}}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_fused_outer_takes_a_default_batch(case):
    """The gate holds for a default float32 call, one problem (2-D) or a
    batch (3-D, `going` given), and for no call with a hook, problem 3,
    autograd, a float64 or strided state or a state of the other rank."""
    assert _gate(case) is GATE_CASES[case]


BATCH_ACTIVE = (True, False, True)


@pytest.mark.parametrize("method", sorted(sor.BATCHED_METHODS))
def test_a_batch_takes_the_fused_pass_with_the_plain_bits(method,
                                                          monkeypatch):
    """A batch of three, the middle member held (`active`), by each
    batched method: every pass is fused (the twin on the CPU) and the
    result equals the plain statements' bit for bit."""
    p, rhs = _stacked(PRM, (10, 11, 12))
    runs = {}
    for name in ("fused", "plain"):
        if name == "plain":
            _plain_refined(monkeypatch)
        start = timing.counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # jacobi's omega clamp
            runs[name] = (sor.solve_pressure_batch(p, rhs, PRM, method=method,
                                                   active=BATCH_ACTIVE),
                          since(start))
    (fused, fcount), (plain, pcount) = runs["fused"], runs["plain"]
    assert fcount["pressure.fused_passes"] == fcount["pressure.passes"] >= 1
    assert fcount["launch.pressure_defect"] == 0  # the CPU twin
    assert pcount["pressure.fused_passes"] == 0
    assert pcount["pressure.passes"] == fcount["pressure.passes"]
    for field in fused._fields:
        assert torch.equal(getattr(fused, field), getattr(plain, field)), field
    assert int(fused.iterations[1]) == 0
    assert torch.equal(fused.p[1], p[1])


@pytest.mark.parametrize("hook", sorted(EQUAL_HOOKS))
def test_a_batch_hook_takes_the_plain_statements(hook):
    """A batch with one of a shard's hooks equal to the defaults: the
    plain statements, with the default batch's bits."""
    p, rhs = _stacked(PRM, (13, 14))
    want = sor._solve_pressure_refined(p, rhs, PRM, going=_going())
    start = timing.counts()
    got = sor._solve_pressure_refined(p, rhs, PRM, going=_going(),
                                      **EQUAL_HOOKS[hook](PRM))
    counted = since(start)
    assert counted["pressure.passes"] == 5
    assert counted["pressure.fused_passes"] == 0
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


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


@pytest.mark.parametrize("interior,members,want", [
    ((256, 256), 1, (128, 129)), ((256, 256), 8, (1024, 1032)),
    ((97, 61), 3, (42, 45)), ((5, 3), 2, (2, 4))])
def test_blocks_and_workspace_of_a_batch(interior, members, want):
    """A launch over `members` interiors: each member's blocks, and a
    workspace row a member of one partial a block and the ticket; one
    member is one problem's launch."""
    assert (defect_kernel.blocks(*interior, members),
            defect_kernel.workspace_len(*interior, members)) == want
    if members == 1:
        assert defect_kernel.blocks(*interior) == want[0]


def _batch_pass_inputs(prm, n_members, seed):
    """(master, delta, rhs) of a batch's pass: _pass_inputs' of each
    member on a member axis."""
    members = [_pass_inputs(prm, seed + k) for k in range(n_members)]
    return tuple(torch.stack(x) for x in zip(*members))


def _flags(lead, on=True):
    """(on, iterations, res_norm) of one problem (lead ()) or a batch."""
    return (torch.full(lead, on, dtype=torch.bool),
            torch.zeros(lead, dtype=torch.int64),
            torch.full(lead, math.inf, dtype=torch.float64))


BAD_BATCH_INPUTS = ["rhs_full_members", "rhs_members", "threshold_members",
                    "threshold_0d", "strided_threshold"]


@pytest.mark.parametrize("bad", BAD_BATCH_INPUTS + ["none"])
def test_kernel_checks_a_batchs_tensors(bad):
    """A batch's tensors carry one member axis, of one length on all of
    them, the threshold (B,)."""
    prm = Params(i_max=12, j_max=10, a=1.0, b=1.0)
    p64, _, rhs = _batch_pass_inputs(prm, 3, 20)
    rhs_full = torch.zeros((3, *prm.shape))
    threshold = torch.ones(3, dtype=torch.float64)
    args = dict(p64=p64, rhs_int64=rhs, rhs_full=rhs_full,
                threshold=threshold)
    if bad == "rhs_full_members":
        args["rhs_full"] = rhs_full[:2]
    elif bad == "rhs_members":
        args["rhs_int64"] = rhs[:2]
    elif bad == "threshold_members":
        args["threshold"] = threshold[:2]
    elif bad == "threshold_0d":
        args["threshold"] = threshold[0]
    elif bad == "strided_threshold":
        args["threshold"] = torch.ones(6, dtype=torch.float64)[::2]
    if bad == "none":
        defect_kernel.check_inputs(params=prm, **args)
    else:
        with pytest.raises(ValueError):
            defect_kernel.check_inputs(params=prm, **args)


BAD_BATCH_PASSES = ["delta_members", "on_0d", "iterations_0d",
                    "res_norm_members", "master_members", "flag_of_a_batch",
                    "master_dtype"]


@pytest.mark.parametrize("bad", BAD_BATCH_PASSES + ["none", "one problem"])
def test_kernel_checks_a_batch_pass(bad):
    """A pass of a batch takes a master of the solve's shape, delta of
    that shape, a flag, a count and a norm (B,) each; one problem's pass
    takes them 0-d, and a (B,) flag on a solve of one problem is
    refused."""
    prm = Params(i_max=12, j_max=10, a=1.0, b=1.0)
    master, delta, _ = _batch_pass_inputs(prm, 3, 21)
    on, iterations, res_norm = _flags((3,))
    shape = master.shape  # the solve's
    if bad == "delta_members":
        delta = delta[:2]
    elif bad == "on_0d":
        on = on[0]
    elif bad == "iterations_0d":
        iterations = iterations[0]
    elif bad == "res_norm_members":
        res_norm = res_norm[:2]
    elif bad == "master_members":
        master, delta = master[:2], delta[:2]
        on, iterations, res_norm = _flags((2,))
    elif bad == "flag_of_a_batch":
        master, delta = master[0], delta[0]
        shape = prm.shape
    elif bad == "master_dtype":
        master = master.float()
    elif bad == "one problem":
        master, delta = master[0], delta[0]
        on, iterations, res_norm = _flags(())
        shape = prm.shape
    args = (master, delta, on, iterations, res_norm, shape)
    if bad in ("none", "one problem"):
        defect_kernel._check_pass(*args)
    else:
        with pytest.raises(ValueError):
            defect_kernel._check_pass(*args)


# The members of the twin's batch pass: going, stopped before the pass,
# and one whose norm meets its threshold in the pass.
TWIN_MEMBERS = {"going": (True, 0.0), "stopped": (False, 0.0),
                "stops": (True, 1e300)}


@pytest.mark.parametrize("interior", [(13, 9), (97, 61)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_batch_pass_of_the_twin_equals_each_members_pass(interior):
    """Two passes of the twin over a batch of three (going, stopped,
    stops) against two of the twin on each member alone: masters, next
    rhs, flags and counts bit for bit; the norms to rounding (torch.sum
    over a member axis need not add in one member's order)."""
    prm = Params(i_max=interior[0], j_max=interior[1], a=1.0, b=0.7)
    n = len(TWIN_MEMBERS)
    p64, delta, rhs = _batch_pass_inputs(prm, n, 22)
    flags = [TWIN_MEMBERS[name][0] for name in TWIN_MEMBERS]
    thresholds = [TWIN_MEMBERS[name][1] for name in TWIN_MEMBERS]

    def run(master, delta, rhs, on, threshold):
        master = master.clone()
        rhs_full = torch.zeros(master.shape)
        on = torch.tensor(on)
        iterations = torch.zeros(on.shape, dtype=torch.int64)
        res_norm = torch.full(on.shape, math.inf, dtype=torch.float64)
        pass_fn = defect_kernel.outer_pass(
            master, rhs, rhs_full,
            torch.tensor(threshold, dtype=torch.float64), prm)
        for _ in range(2):
            master = pass_fn(master, delta, on, iterations, res_norm, 64)
        return master, rhs_full, on, iterations, res_norm

    batch = run(p64, delta, rhs, flags, thresholds)
    assert batch[3].tolist() == [128, 0, 64]
    assert batch[2].tolist() == [True, False, False]
    for k in range(n):
        solo = run(p64[k], delta[k], rhs[k], flags[k], thresholds[k])
        for got, want in zip(batch[:4], solo[:4]):
            assert torch.equal(got[k], want)
        assert (float(batch[4][k]) == float(solo[4]) == math.inf
                if not flags[k] else
                abs(float(batch[4][k]) - float(solo[4]))
                <= 1e-13 * float(solo[4]))
    # The stopped member keeps its master's interior (the twin fills the
    # ring in place).
    assert torch.equal(batch[0][1, 1:-1, 1:-1], p64[1, 1:-1, 1:-1])
