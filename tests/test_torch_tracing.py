"""The port's spans and counters (utils/timing.py) on the CPU at 24^2.

Spans are profiler ranges only while a profiler records; counters always
count.  Per step of a one-device solve the pressure outer counts its
passes, the loop its read of t, and the outer its host reads: one flag a
pass (one more when the flag, not max_it, ends the loop) and three reads
of the result.  The refined outer keeps the parent's loop: its fields and
counts equal a transcription of that loop (``_parent_refined``) bit for
bit.  The masked solve of obstacle domains, on a 40 x 16 channel, runs
that same outer (``pressure.*`` spans and counters, one flag read a pass
and none at the set-up), keeps its bits under the profiler and counts its
V-cycles or sweeps, with the masked levels' spans inside the outer's
inner stage.  A batch of 24^2 cavities (solver.EnsembleStepper) marks
the solo step's spans and its holds, counts its steps, the members it
steps and those it holds, reads t once a step and no pressure result, and
keeps its bits under the profiler.
"""

import json
import math

import pytest
import torch

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.ops import fft, masked, mg, obstacles, sor
from navierstokes_parallel_tpu_torch.utils import timing

# One 24^2 lid-driven cavity.  pallas_sor at eps 1e-12 runs every step into
# max_it (300 sweeps: 4 passes of K = 64 and one of 44); mg and fft
# converge, so their flag ends the loop.
PRM = Params(i_max=24, j_max=24, Re=1000.0, T=0.3, tau=0.5, max_it=300)
EPS = {"pallas_sor": 1e-12, "mg": 1e-4, "fft": 1e-4}
# Inner steps per outer pass, by method.
K = {"pallas_sor": PRM.sor_refine_every, "mg": PRM.mg_cycles_per_outer,
     "fft": PRM.fft_solves_per_outer}


def since(start):
    """The counters' increase since the snapshot `start`."""
    return {name: n - start.get(name, 0)
            for name, n in timing.counts().items()
            if n != start.get(name, 0)}


def _state(prm, seed=0):
    """A cavity state with a seeded interior velocity, so that the first
    pressure solve has work to do."""
    state = allocate_state(prm, "cpu")
    g = torch.Generator().manual_seed(seed)
    u = state.u.clone()
    u[1:-1, 1:-1] += 0.01 * torch.randn(u[1:-1, 1:-1].shape, generator=g)
    return state._replace(u=u)


def _parent_refined(p, rhs, params, inner_fn):
    """The f64 refinement outer of one problem as the parent wrote it (the
    flag read in the while condition, no spans): (p, iterations,
    res_norm, converged)."""
    K_ = params.sor_refine_every
    f64, f32 = torch.float64, torch.float32
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    p64 = p.to(f64, copy=True)
    rhs_int64 = rhs[1:-1, 1:-1].to(f64)
    threshold = params.epsilon * (
        sor.l2_norm(p64[1:-1, 1:-1], params.i_max, params.j_max)
        + sor.NORM_OFFSET)

    def defect():
        return sor.residual(sor.ghost_fill(p64), rhs_int64, dx2_inv, dy2_inv)

    rhs_full = torch.zeros(p.shape, dtype=f32)
    r64 = defect()
    on = torch.ones((), dtype=torch.bool)
    iterations = torch.zeros((), dtype=torch.int64)
    res_norm = torch.full((), math.inf, dtype=f64)
    done = 0
    while done < params.max_it and bool(on.any()):
        n_inner = min(K_, params.max_it - done)
        rhs_full[1:-1, 1:-1] = -r64.to(f32)
        delta = inner_fn(rhs_full, n_inner)
        interior = p64[1:-1, 1:-1]
        interior.copy_(torch.where(on, interior + delta[1:-1, 1:-1].to(f64),
                                   interior))
        r64 = defect()
        norm = sor.l2_norm(r64, params.i_max, params.j_max)
        res_norm = torch.where(on, norm, res_norm)
        iterations += on * n_inner
        done += n_inner
        on &= norm > threshold
    converged = res_norm <= threshold
    return (sor.ghost_fill(p64).to(p.dtype), int(iterations),
            float(res_norm.to(p.dtype)), bool(converged))


def _inner(method, params):
    if method == "mg":
        return lambda r, n: mg.inner_v_cycle(r, n, params)
    if method == "fft":
        return lambda r, n: fft.inner_direct(r, n, params)
    return lambda r, n: sor.sor_kernel.inner_sweeps(r, n, params)


def test_spans_off_without_a_profiler_and_the_outer_keeps_its_bits():
    first = timing.span("pressure.pass")
    assert first is timing.span("mg.level0") is timing.span("x")
    with first:
        pass
    assert timing.span("pressure.pass") is first
    for method in ("pallas_sor", "mg", "fft"):
        prm = PRM.replace(epsilon=EPS[method], sor_refine_every=K[method])
        g = torch.Generator().manual_seed(3)
        p = torch.zeros(prm.shape)
        rhs = torch.zeros(prm.shape)
        rhs[1:-1, 1:-1] = torch.randn((24, 24), generator=g)
        rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
        got = sor._solve_pressure_refined(p, rhs, prm,
                                          inner_fn=_inner(method, prm))
        want = _parent_refined(p, rhs, prm, _inner(method, prm))
        assert torch.equal(got.p, want[0]), method
        assert (got.iterations, got.res_norm, got.converged) == want[1:]


@pytest.mark.parametrize("method", ["pallas_sor", "mg", "fft"])
def test_counters_per_step(method):
    prm = PRM.replace(epsilon=EPS[method])
    stepper = solver.Stepper(prm, _state(prm), method)
    for _ in range(2):
        start = timing.counts()
        stats = solver.run_steps(stepper, prm, max_steps=1)
        counted = since(start)
        passes = math.ceil(stats.total_sor_iterations / K[method])
        assert counted["pressure.passes"] == passes >= 1
        assert counted["sync.loop_t"] == 1
        assert counted["sync.pressure_result"] == 3
        if method == "pallas_sor":
            assert stats.sor_failures == 1
            assert passes == math.ceil(prm.max_it / K[method])
            assert counted["sync.pressure_flag"] == passes
        else:
            assert stats.sor_failures == 0
            assert counted["sync.pressure_flag"] == passes + 1
        assert counted.get("mg.cycles", 0) == (passes if method == "mg"
                                               else 0)
        # The CPU launches no kernel.
        assert not [name for name in counted if name.startswith("launch.")]
    # A solve that ends at T reads t once more, to stop.
    start = timing.counts()
    stats = solver.run_steps(solver.Stepper(prm, _state(prm), method), prm)
    assert since(start)["sync.loop_t"] == stats.steps + 1


def _user_spans(prof_trace):
    with open(prof_trace) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return spans


def _inside(inner, outer):
    return any(a <= s and e <= b for a, b in outer for s, e in [inner])


def test_spans_nest_under_the_profiler(tmp_path):
    prm = PRM.replace(epsilon=EPS["mg"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solver.solve(prm, _state(prm), pressure_method="mg", max_steps=1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _user_spans(path)
    for name in ("nsp.loop.read_t", "nsp.step.dt_bcs", "nsp.step.project",
                 "nsp.pressure.setup", "nsp.pressure.finish",
                 "nsp.pressure.defect", "nsp.pressure.flag"):
        assert spans.get(name), name
    passes = spans["nsp.pressure.pass"]
    assert spans["nsp.pressure.inner"] and len(
        spans["nsp.pressure.inner"]) == len(passes)
    assert all(_inside(s, passes) for s in spans["nsp.pressure.inner"])
    assert all(_inside(s, passes) for s in spans["nsp.pressure.defect"])
    # The flag read that starts the loop is set-up's; every other, its
    # pass's.
    setup = spans["nsp.pressure.setup"]
    assert all(_inside(s, passes) or _inside(s, setup)
               for s in spans["nsp.pressure.flag"])
    assert len(spans["nsp.mg.level1"]) == len(spans["nsp.mg.level0"]) > 0
    assert all(_inside(s, spans["nsp.mg.level0"])
               for s in spans["nsp.mg.level1"])
    assert all(_inside(s, spans["nsp.pressure.inner"])
               for s in spans["nsp.mg.level0"])


def test_compensated_outer_counts_the_same_passes():
    counted = {}
    for outer in ("float64", "compensated"):
        prm = PRM.replace(epsilon=EPS["pallas_sor"], outer_precision=outer)
        start = timing.counts()
        stats = solver.run_steps(
            solver.Stepper(prm, _state(prm), "pallas_sor"), prm, max_steps=1)
        counted[outer] = since(start)
        assert stats.total_sor_iterations == prm.max_it
    f64, comp = counted["float64"], counted["compensated"]
    assert comp["pressure.passes"] == f64["pressure.passes"] == math.ceil(
        PRM.max_it / K["pallas_sor"])
    # Its one read a pass is the norm; its threshold is read once.
    assert comp["sync.pressure_flag"] == comp["pressure.passes"]
    assert comp["sync.pressure_result"] == 1


# A 40 x 16 channel with a 4 x 4 block: the masked outer's passes at a size
# the CPU takes in a moment.
MASKED = Params(problem=3, i_max=40, j_max=16, a=5.0, b=2.0, Re=100.0,
                tau=0.5, max_it=2000, epsilon=1e-4, sor_refine_every=16,
                obstacles=((8, 11, 7, 10),))
MASKED_K = {"mg": MASKED.mg_cycles_per_outer,
            "rb_sor": MASKED.sor_refine_every}
MASKED_COUNTER = {"mg": "masked.cycles", "rb_sor": "masked.sweeps"}


def _masked_rhs(prm):
    g = torch.Generator().manual_seed(5)
    rhs = torch.zeros(prm.shape, dtype=torch.float32)
    rhs[1:-1, 1:-1] = torch.randn((prm.i_max, prm.j_max), generator=g)
    return obstacles.mask_rhs(rhs, prm)


@pytest.mark.parametrize("method", ["mg", "rb_sor"])
def test_masked_spans_keep_the_bits_and_counters_add_up(method, tmp_path):
    p = torch.zeros(MASKED.shape)
    rhs = _masked_rhs(MASKED)
    start = timing.counts()
    plain = masked.solve_pressure_masked(p, rhs, MASKED, method)
    counted = since(start)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = masked.solve_pressure_masked(p, rhs, MASKED, method)
    assert torch.equal(plain.p, traced.p)
    assert (plain.iterations, plain.res_norm, plain.converged) == (
        traced.iterations, traced.res_norm, traced.converged)
    assert plain.converged and plain.iterations > MASKED_K[method]
    passes = math.ceil(plain.iterations / MASKED_K[method])
    # The one outer's counters: a flag read a pass, none at the set-up,
    # and the result's two reads (its count is a host int).
    assert counted["pressure.passes"] == counted["sync.pressure_flag"] \
        == passes
    assert counted["sync.pressure_result"] == 2
    assert "pressure.fused_passes" not in counted
    assert counted[MASKED_COUNTER[method]] == plain.iterations
    assert not {"masked.cycles", "masked.sweeps"} - {MASKED_COUNTER[method]} \
        & set(counted)

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _user_spans(path)
    assert not [name for name in spans if name.startswith("nsp.masked.")
                and not name.startswith("nsp.masked.level")]
    for name in ("setup", "pass", "inner", "defect", "flag", "finish"):
        assert spans.get("nsp.pressure." + name), name
    assert len(spans["nsp.pressure.pass"]) == passes
    for name in ("inner", "defect", "flag"):
        assert len(spans["nsp.pressure." + name]) == passes
        assert all(_inside(s, spans["nsp.pressure.pass"])
                   for s in spans["nsp.pressure." + name])
    if method == "mg":
        levels = spans["nsp.masked.level0"]
        assert len(levels) == plain.iterations
        assert all(_inside(s, spans["nsp.pressure.inner"]) for s in levels)
        assert len(spans["nsp.masked.level1"]) == len(levels)
        assert all(_inside(s, levels) for s in spans["nsp.masked.level1"])
    else:
        assert "nsp.masked.level0" not in spans


def test_an_obstacle_step_keeps_its_bits_and_marks_its_bcs(tmp_path):
    prm = MASKED.replace(T=1.0, epsilon=1e-4)
    state = _state(prm)
    plain, _ = solver.step(state, prm, pressure_method="mg")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced, _ = solver.step(state, prm, pressure_method="mg")
    for name in ("u", "v", "p"):
        assert torch.equal(getattr(plain, name), getattr(traced, name))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _user_spans(path)
    # Once with the outer walls' BCs, once after the projection.
    assert len(spans["nsp.obstacle.bcs"]) == 2
    assert _inside(spans["nsp.obstacle.bcs"][0], spans["nsp.step.dt_bcs"])
    assert _inside(spans["nsp.obstacle.bcs"][1], spans["nsp.step.project"])


# Three seeded 24^2 cavities and a fourth already at T, held throughout: the
# batched step of solver.EnsembleStepper.


def _batch(prm):
    members = [_state(prm, seed) for seed in range(3)]
    done = members[0]._replace(t=torch.tensor(prm.T, dtype=prm.torch_dtype))
    return solver.stack_states(members + [done])


def test_ensemble_counters_add_up():
    prm = PRM.replace(epsilon=1e-4)
    stepper = solver.EnsembleStepper(prm, _batch(prm), "rb_sor")
    start = timing.counts()
    solver.run_steps(stepper, prm, max_steps=1)
    counted = since(start)
    assert counted["sync.loop_t"] == counted["ensemble.steps"] == 1
    assert counted["ensemble.member_steps"] == 3
    assert counted["ensemble.held"] == 1

    stepper = solver.EnsembleStepper(prm, _batch(prm), "rb_sor")
    start = timing.counts()
    loop = solver.run_steps(stepper, prm)
    counted = since(start)
    members = stepper.stats().steps
    assert members.tolist()[3] == 0 and loop.steps == int(members.max()) > 1
    assert counted["ensemble.steps"] == loop.steps
    # One read of t a step, and the one that stops the loop.
    assert counted["sync.loop_t"] == loop.steps + 1
    assert counted["ensemble.member_steps"] == int(members.sum())
    assert counted["ensemble.held"] == 4 * loop.steps - int(members.sum())
    assert counted["pressure.passes"] >= loop.steps
    # The batched outer reads its flags and never a result: the members'
    # stats stay on the device.
    assert "sync.pressure_result" not in counted
    assert {name for name in counted if name.startswith("sync.")} == {
        "sync.loop_t", "sync.pressure_flag"}


def test_ensemble_step_keeps_its_bits_under_the_profiler(tmp_path):
    prm = PRM.replace(epsilon=1e-4)
    plain = solver.EnsembleStepper(prm, _batch(prm), "rb_sor")
    solver.run_steps(plain, prm, max_steps=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = solver.EnsembleStepper(prm, _batch(prm), "rb_sor")
        solver.run_steps(traced, prm, max_steps=2)
    for name in ("u", "v", "p", "t", "n"):
        assert torch.equal(getattr(plain.state(), name),
                           getattr(traced.state(), name)), name
    for want, got in zip(plain.stats(), traced.stats()):
        assert torch.equal(want, got)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _user_spans(path)
    for name in ("nsp.step.dt_bcs", "nsp.step.project", "nsp.ensemble.hold",
                 "nsp.loop.read_t"):
        assert len(spans.get(name, ())) == 2, name
    assert spans["nsp.pressure.pass"] and spans["nsp.pressure.setup"]
    assert not _inside(spans["nsp.ensemble.hold"][0],
                       spans["nsp.step.project"])
