"""The port's free-surface model (models/freesurface.py, problem 6) vs the
JAX package's, mirroring tests/test_freesurface.py:

  * the setups (dam break, filled box, drop, sloshing) give JAX's Params
    and particle sets bit for bit;
  * ``dam_break(n=15, T=0.25)`` and the free-slip dam break of JAX's
    physics test against JAX's ``solve_free``: equal steps, sweeps and
    failures, u/v/p within 1e-4, the ``active`` mask equal, the fluid
    volume within 1e-12 relative; every ``p_surface`` variant step by step;
  * the physics of JAX's tests, with its bounds, on the port: hydrostatic
    equilibrium (SUMMAC and plain MAC), the drop's free fall, the dam
    break's front and column, the free-slip walls, the obstacle-domain
    equivalence, the submerged block, no particle leakage into a block,
    the sloshing period;
  * the observables on the same state within 1e-12 of JAX's;
  * the CLI on configs/dambreak.in cut to a few steps against the JAX
    CLI (stats, centre values, frames, final output, history) and the
    whole-run record (tests/jax_free_records.json) step by step; a run
    stopped and resumed from its checkpoint equals the straight run bit
    for bit; a checkpoint without particles is refused with JAX's reason;
    a JAX checkpoint resumes in the port; the --method and --backend
    pallas warnings are JAX's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import cli
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.grid import allocate_state
from navierstokes_parallel_tpu_torch.models import freesurface as FS
from navierstokes_parallel_tpu_torch.ops import boundary

HERE = os.path.dirname(os.path.abspath(__file__))
DAMBREAK = os.path.join(HERE, "..", "configs", "dambreak.in")
RECORDS = os.path.join(HERE, "jax_free_records.json")
CONTRACT = 1e-4
CLI_STEPS = 6


def _jax_params(prm):
    from navierstokes_parallel_tpu.config import Params as JaxParams

    return JaxParams(**dataclasses.asdict(prm))


def _assert_close(a, b, tol=CONTRACT):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=tol)


def _assert_free_close(fs, jfs, tol=CONTRACT, xtol=None):
    for name in ("u", "v", "p"):
        _assert_close(getattr(fs.state, name), getattr(jfs.state, name), tol)
    _assert_close(fs.pset.x, jfs.pset.x, tol if xtol is None else xtol)
    _assert_close(fs.pset.y, jfs.pset.y, tol if xtol is None else xtol)
    np.testing.assert_array_equal(fs.pset.active.numpy(),
                                  np.asarray(jfs.pset.active))


SETUPS = [("dam_break", {"n": 8}), ("filled_box", {"n": 12}),
          ("drop", {"n": 16}), ("sloshing", {"n": 16})]


@pytest.mark.parametrize("case", SETUPS, ids=lambda c: c[0])
def test_setups_match_jax(case):
    from navierstokes_parallel_tpu.models import freesurface as JF

    name, kw = case
    prm, fs = getattr(FS, name)(**kw, device="cpu")
    jprm, jfs = getattr(JF, name)(**kw)
    assert dataclasses.asdict(prm) == dataclasses.asdict(jprm)
    assert fs.pset.x.dtype == torch.float64
    for a, b in zip(fs.pset, jfs.pset):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert fs.state.u.dtype == torch.float64 and fs.state.n == 0


@pytest.mark.parametrize("case", [
    ("dam_break_15", dict(n=15, T=0.25), "noslip"),
    ("dam_break_freeslip", dict(n=16, T=0.5, a=4.0, b=3.0), "freeslip")],
    ids=lambda c: c[0])
def test_solve_free_matches_jax(case):
    from navierstokes_parallel_tpu.models import freesurface as JF

    _, kw, wall = case
    prm, fs = FS.dam_break(**kw, device="cpu")
    jprm, jfs = JF.dam_break(**kw)
    out, stats = FS.solve_free(prm, fs, wall=wall)
    jout, jstats = JF.solve_free(jprm, jfs, wall=wall)
    assert (stats.steps, stats.total_sor_iterations, stats.sor_failures) \
        == (int(jstats.steps), int(jstats.total_sor_iterations),
            int(jstats.sor_failures))
    assert out.state.n == stats.steps > 2
    _assert_free_close(out, jout)
    vol, jvol = FS.fluid_volume(out, prm), JF.fluid_volume(jout, jprm)
    assert abs(vol - jvol) <= 1e-12 * jvol
    # The input state is left alone.
    assert fs.state.n == 0 and not bool(fs.state.u.any())


@pytest.mark.parametrize("p_surface", ["interpolated", "atmospheric",
                                       "hydrostatic"])
def test_free_steps_of_each_surface_condition_match_jax(p_surface):
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm, fs = FS.sloshing(n=16, T=1.0, device="cpu")
    jprm, jfs = JF.sloshing(n=16, T=1.0)
    jstep = JF.make_free_step_fn(jprm, "freeslip", None, p_surface)
    for _ in range(4):
        fs, diag = FS.free_step(fs, prm, wall="freeslip",
                                p_surface=p_surface)
        jfs, jdiag = jstep(jfs)
        assert diag.sor_iterations == int(jdiag.sor_iterations)
        assert diag.sor_converged is bool(jdiag.sor_converged)
        assert float(diag.dt) == pytest.approx(float(jdiag.dt), rel=1e-6)
    _assert_free_close(fs, jfs)


def test_hydrostatic_equilibrium():
    """JAX's test on the port: velocities at the solver-tolerance level,
    the exact discrete hydrostatic profile of the true surface under the
    SUMMAC condition, the cell-centre one under plain MAC; p within the
    contract of JAX's."""
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm, fs = FS.filled_box(n=24, T=0.1, device="cpu")
    jprm, jfs = JF.filled_box(n=24, T=0.1)
    out, stats = FS.solve_free(prm, fs)
    assert stats.sor_failures == 0
    assert float(out.state.u.abs().max()) < 1e-9
    assert float(out.state.v.abs().max()) < 1e-9
    p = out.state.p.numpy()
    for j in range(1, 13):
        np.testing.assert_allclose(p[1:-1, j], (12 - j + 0.5) * prm.dy,
                                   atol=1e-9)
    _assert_close(p, JF.solve_free(jprm, jfs)[0].state.p)
    out3, _ = FS.solve_free(prm, fs, p_surface="atmospheric")
    np.testing.assert_allclose(out3.state.p.numpy()[1:-1, 1], 11 * prm.dy,
                               atol=1e-9)
    assert float(out3.state.v.abs().max()) < 1e-10


def test_drop_free_fall_com():
    """The airborne blob's centre of mass follows y0 - g t^2 / 2 up to the
    O(dt) splitting bias, which halves with dt; no x drift (JAX's test,
    its bounds); the centres within 1e-12 of JAX's."""
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm, fs = FS.drop(n=32, T=0.3, device="cpu")
    cx0, cy0 = FS.center_of_mass(fs)
    out, _ = FS.solve_free(prm, fs)
    t = float(out.state.t)
    cx, cy = FS.center_of_mass(out)
    assert abs(cx - cx0) < 1e-10
    err = cy - (cy0 - 0.5 * t * t)
    dt = t / 3
    assert abs(err + 0.5 * t * dt) < 0.2 * abs(0.5 * t * dt)
    prm2, fs2 = FS.drop(n=32, T=0.3, tau=0.2, device="cpu")
    out3, _ = FS.solve_free(prm2, fs2)
    t3 = float(out3.state.t)
    err3 = FS.center_of_mass(out3)[1] - (cy0 - 0.5 * t3 * t3)
    assert abs(err3) < 0.65 * abs(err)
    jprm, jfs = JF.drop(n=32, T=0.3)
    jcx, jcy = JF.center_of_mass(JF.solve_free(jprm, jfs)[0])
    assert abs(cx - jcx) < 1e-12 and abs(cy - jcy) < 1e-12


def test_dam_break_physics():
    """JAX's test on the port: the front moves out below the shallow-water
    bound, the free-slip column drains, the volume holds to 8 %, no
    particle leaves the box and no solve fails."""
    prm, fs = FS.dam_break(n=16, T=1.0, width=1.0, height=2.0, a=4.0, b=3.0,
                           device="cpu")
    v0, h0, f0 = (FS.fluid_volume(fs, prm), FS.column_height(fs),
                  FS.front_position(fs))
    out, stats = FS.solve_free(prm, fs, wall="freeslip")
    assert stats.sor_failures == 0
    t = float(out.state.t)
    front = FS.front_position(out)
    assert f0 + 0.25 * np.sqrt(2.0) * t < front < f0 + 2.0 * np.sqrt(
        2.0) * t
    assert FS.column_height(out) < h0 - 0.1
    assert abs(FS.fluid_volume(out, prm) - v0) / v0 < 0.08
    assert bool(out.pset.active.all())


def test_freeslip_wall_semantics_as_jax():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu.models import freesurface as JF

    prm = Params(problem=1, i_max=8, j_max=8, dtype="float64")
    rng = np.random.default_rng(11)
    u, v = rng.normal(size=prm.shape), rng.normal(size=prm.shape)
    for wall in ("noslip", "freeslip"):
        got = FS._box_bcs(torch.from_numpy(u.copy()),
                          torch.from_numpy(v.copy()), wall)
        want = JF._box_bcs(jnp.asarray(u), jnp.asarray(v), wall)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u2, v2 = boundary.set_freeslip(torch.from_numpy(u.copy()),
                                   torch.from_numpy(v.copy()),
                                   boundary.Side.LEFT)
    assert bool((u2[0, 1:-1] == 0).all())
    assert torch.equal(v2[0, 1:-1], torch.from_numpy(v)[1, 1:-1])
    us, vs = torch.ones(prm.shape), torch.zeros(prm.shape)
    uf, vf = FS._box_bcs(us.clone(), vs.clone(), "freeslip")
    assert torch.equal(uf[1:-2, :], us[1:-2, :]) and torch.equal(vf, vs)
    with pytest.raises(ValueError, match="wall"):
        FS._box_bcs(us, vs, "slippery")
    with pytest.raises(ValueError, match="wall"):
        JF._box_bcs(jnp.ones(prm.shape), jnp.zeros(prm.shape), "slippery")


def test_free_step_across_geometries():
    """One step function serves every geometry (JAX traces the flag field
    once): two different fills of one Params step without touching their
    inputs, each equal to JAX's step."""
    from navierstokes_parallel_tpu.grid import allocate_state as jallocate
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm = Params(problem=1, i_max=12, j_max=12, T=0.01, Re=100.0, tau=0.4,
                 epsilon=1e-6, max_it=2000, dtype="float64")
    jprm = _jax_params(prm)
    jstep = JF.make_free_step_fn(jprm)
    for region in ((0, 1, 0, 0.4), (0, 0.4, 0, 1)):
        fs = FS.FreeSurfaceState(allocate_state(prm, "cpu"),
                                 FS.fill_region(prm, *region, device="cpu"))
        jfs = JF.FreeSurfaceState(jallocate(jprm),
                                  JF.fill_region(jprm, *region))
        x0 = fs.pset.x.clone()
        out, diag = FS.free_step(fs, prm)
        jout, jdiag = jstep(jfs)
        assert torch.equal(fs.pset.x, x0) and fs.state.n == 0
        assert diag.sor_iterations == int(jdiag.sor_iterations)
        _assert_free_close(out, jout)
    assert jstep._cache_size() == 1


def test_trace_free_matches_solve_free_and_jax():
    from navierstokes_parallel_tpu.models import freesurface as JF

    kw = dict(n=8, T=0.3, width=1.0, height=1.5, a=2.0, b=2.0)
    prm, fs = FS.dam_break(**kw, device="cpu")
    out_d, stats_d = FS.solve_free(prm, fs)
    out_h, stats_h, frames = FS.trace_free(prm, fs)
    assert stats_d == stats_h and frames.shape[0] == stats_h.steps + 1
    assert torch.equal(out_d.pset.x, out_h.pset.x)
    assert torch.equal(out_d.state.u, out_h.state.u)
    jprm, jfs = JF.dam_break(**kw)
    *_, jframes = JF.trace_free(jprm, jfs)
    assert frames.shape == jframes.shape
    _assert_close(frames, jframes, 1e-9)


def _equivalence_pair(n=8):
    """The wide dam break with its right fifth blocked, and the narrow one
    (JAX's exact composition check)."""
    pw, _ = FS.dam_break(n=n, a=5.0, b=3.0, device="cpu")
    pw = pw.replace(obstacles=((4 * n + 1, 5 * n, 1, 3 * n),))
    fw = FS.FreeSurfaceState(allocate_state(pw, "cpu"),
                             FS.fill_region(pw, 0.0, 1.0, 0.0, 2.0,
                                            device="cpu"))
    pn, fn = FS.dam_break(n=n, a=4.0, b=3.0, device="cpu")
    return pw, fw, pn, fn


def test_obstacle_domain_equivalence():
    n = 8
    pw, fw, pn, fn = _equivalence_pair(n)
    for _ in range(12):
        fw, _ = FS.free_step(fw, pw)
        fn, _ = FS.free_step(fn, pn)
    assert float(fw.state.t) == pytest.approx(float(fn.state.t), rel=1e-12)
    ue = 4 * n + 1
    _assert_close(fw.state.u[:ue], fn.state.u[:ue], 1e-11)
    _assert_close(fw.state.v[1:ue], fn.state.v[1:ue], 1e-11)
    _assert_close(fw.state.p[1:ue], fn.state.p[1:ue], 1e-9)
    assert int(fw.pset.active.sum()) == int(fn.pset.active.sum())
    _assert_close(fw.pset.x, fn.pset.x, 1e-11)


def test_obstacle_submerged_block_hydrostatic():
    from navierstokes_parallel_tpu_torch.ops.obstacles import fluid_mask

    params, _ = FS.filled_box(n=24, T=0.1, device="cpu")
    params = params.replace(obstacles=((8, 13, 3, 6),))
    fs = FS.FreeSurfaceState(allocate_state(params, "cpu"),
                             FS.fill_region(params, 0.0, 1.0, 0.0, 0.5,
                                            device="cpu"))
    out, stats = FS.solve_free(params, fs)
    assert stats.sor_failures == 0
    assert float(out.state.u.abs().max()) < 1e-9
    assert float(out.state.v.abs().max()) < 1e-9
    p, fl = out.state.p.numpy(), fluid_mask(params)
    for j in range(1, 13):
        col = fl[1:-1, j]
        np.testing.assert_allclose(p[1:-1, j][col], (12 - j + 0.5)
                                   * params.dy, atol=1e-9)


def test_obstacle_no_particle_leakage():
    from navierstokes_parallel_tpu_torch.ops.obstacles import fluid_mask

    n = 8
    params, _ = FS.dam_break(n=n, a=5.0, b=3.0, T=1.5, device="cpu")
    params = params.replace(obstacles=((2 * n + 1, 3 * n, 1, n // 2),))
    fs = FS.FreeSurfaceState(allocate_state(params, "cpu"),
                             FS.fill_region(params, 0.0, 1.0, 0.0, 2.0,
                                            device="cpu"))
    n0 = int(fs.pset.active.sum())
    out, _ = FS.solve_free(params, fs, wall="freeslip")
    fl = fluid_mask(params)
    x, y = out.pset.x.numpy(), out.pset.y.numpy()
    ci = np.clip(np.floor(x / params.dx).astype(int) + 1, 1, params.i_max)
    cj = np.clip(np.floor(y / params.dy).astype(int) + 1, 1, params.j_max)
    act = out.pset.active.numpy()
    assert fl[ci, cj][act].all()
    assert int(act.sum()) >= 0.97 * n0


def test_refusals_as_jax():
    """The cut-cell apertures, an unknown surface condition and the GSPMD
    `mesh` are refused (JAX's messages for the first two); the setups need
    a device."""
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm, fs = FS.dam_break(n=8, device="cpu")
    jprm, jfs = JF.dam_break(n=8)
    ap = dict(obstacles=((30, 32, 1, 4),),
              obstacle_surfaces=(("box", 29.0 / 8, 32.0 / 8, 0.0, 0.5),))
    for args, needle in (((prm.replace(**ap), {}), "staircase"),
                         ((prm, {"p_surface": "steam"}), "p_surface")):
        with pytest.raises(ValueError, match=needle) as got:
            FS.free_step(fs, args[0], **args[1])
        jp = jprm.replace(**ap) if args[0] is not prm else jprm
        with pytest.raises(ValueError, match=needle) as want:
            JF.free_step(jfs, jp, **args[1])
        assert str(got.value) == str(want.value)
    # solve_free(mesh=...) is the gspmd backend's (tests/test_torch_gspmd.py
    # runs it), which refuses a trivial mesh axis as the JAX package does.
    from navierstokes_parallel_tpu_torch.parallel import topology

    with pytest.raises(ValueError, match="rejects the 1x4 mesh"):
        FS.solve_free(prm, fs, mesh=topology.Mesh(
            (1, 4), (0, 0), torch.device("cpu"), None))
    with pytest.raises(ValueError, match="device"):
        FS.dam_break(n=8)


def test_sloshing_dispersion():
    """JAX's test on the port: the mode-1 standing wave's period within 5 %
    of omega^2 = g k tanh(k h), its amplitude held, its volume held."""
    n, depth, amp, g, ppc = 48, 0.5, 0.04, 1.0, 6
    params, fs = FS.sloshing(n=n, depth=depth, amp=amp, g=g, T=5.6, ppc=ppc,
                             device="cpu")
    stepper = FS.FreeStepper(params, fs, wall="freeslip", ppc=ppc)
    ts, es = [], []
    while stepper.t < params.T:
        stepper.step()
        el = FS.surface_elevation(stepper.free_state(), params, ppc=ppc)
        ts.append(stepper.t)
        es.append(el[0] - el[-1])
    ts, es = np.array(ts), np.array(es)
    idx = np.where(np.diff(np.sign(es)) != 0)[0]
    cross = np.array([ts[i] - es[i] * (ts[i + 1] - ts[i])
                      / (es[i + 1] - es[i]) for i in idx])
    assert len(cross) >= 3
    period = cross[2] - cross[0]
    k = np.pi / params.a
    expected = 2 * np.pi / np.sqrt(g * k * np.tanh(k * depth))
    assert abs(period - expected) / expected < 0.05
    assert np.max(np.abs(es[idx[1]:idx[2] + 1])) > 0.5 * 2 * amp
    v_end = FS.fluid_volume(stepper.free_state(), params)
    assert abs(v_end - depth * params.a) / (depth * params.a) < 0.05


def test_observables_and_state_from_numpy_match_jax():
    import jax.numpy as jnp

    from navierstokes_parallel_tpu import particles as JP
    from navierstokes_parallel_tpu.grid import State as JState
    from navierstokes_parallel_tpu.models import freesurface as JF

    prm, fs = FS.dam_break(n=8, T=0.4, device="cpu")
    fs, _ = FS.solve_free(prm, fs, wall="freeslip")
    arrays = [getattr(fs.state, k).numpy() for k in "uvp"]
    active = fs.pset.active.numpy().copy()
    active[::7] = False
    got = FS.free_state_from_numpy(*arrays, float(fs.state.t), fs.state.n,
                                   fs.pset.x.numpy(), fs.pset.y.numpy(),
                                   active, device="cpu",
                                   dtype=torch.float64)
    jfs = JF.FreeSurfaceState(
        JState(*(jnp.asarray(a) for a in arrays), jnp.asarray(0.4),
               jnp.asarray(3)),
        JP.ParticleSet(jnp.asarray(fs.pset.x.numpy()),
                       jnp.asarray(fs.pset.y.numpy()), jnp.asarray(active)))
    jprm = _jax_params(prm)
    assert FS.fluid_volume(got, prm) == JF.fluid_volume(jfs, jprm)
    assert FS.front_position(got) == JF.front_position(jfs)
    assert FS.column_height(got) == JF.column_height(jfs)
    np.testing.assert_array_equal(FS.surface_elevation(got, prm),
                                  JF.surface_elevation(jfs, jprm))
    for a, b in zip(FS.center_of_mass(got), JF.center_of_mass(jfs)):
        assert abs(a - b) < 1e-12
    view = FS.free_view(got)
    assert view.u is got.state.u and view.pset is got.pset


# --- the CLI and its protocol ----------------------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _stats(err):
    line = next(x for x in err.splitlines() if x.startswith("steps="))
    return line.split()[:3]


def _files(where, tag):
    return ["--output-dir", str(where / f"{tag}_frames"),
            "--final-output-prefix", str(where / f"{tag}_final"),
            "--history-file", str(where / f"{tag}.csv")]


def test_cli_matches_jax_cli_and_record(tmp_path, capsys):
    """configs/dambreak.in --free-wall freeslip --max-steps CLI_STEPS with
    frames (n_print 10: frame 0), final output and history: the JAX CLI's
    stats and centre values, its files within the contract, and each
    step's sweeps as the whole-run record's."""
    from navierstokes_parallel_tpu.utils import io as jio

    argv = [DAMBREAK, "--free-wall", "freeslip", "--max-steps",
            str(CLI_STEPS), "--stats"]
    rc, out, err = _run(cli.main, [*argv, "--device", "cpu",
                                   *_files(tmp_path, "port")], capsys)
    from navierstokes_parallel_tpu import cli as jcli

    jrc, jout, jerr = _run(jcli.main, [*argv, *_files(tmp_path, "jax")],
                           capsys)
    assert rc == jrc == 3 and out == jout
    assert _stats(err) == _stats(jerr)
    names = sorted(os.listdir(tmp_path / "port_frames"))
    assert names == sorted(os.listdir(tmp_path / "jax_frames")) and names
    pairs = [(tmp_path / "port_frames" / f, tmp_path / "jax_frames" / f)
             for f in names]
    pairs += [(tmp_path / f"port_final_{s}.txt", tmp_path / f"jax_final_{s}.txt")
              for s in "uvp"]
    for a, b in pairs:
        assert jio.compare_outputs_with_tolerance(str(a), str(b)), a
    with open(RECORDS) as fh:
        rec = json.load(fh)["free"]
    rows = np.loadtxt(tmp_path / "port.csv", delimiter=",", skiprows=1)
    jrows = np.loadtxt(tmp_path / "jax.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(rows[:, 3], jrows[:, 3])
    assert list(rows[:, 3]) == rec["per_step"]["iterations"][:CLI_STEPS]
    np.testing.assert_allclose(rows[:, 1], rec["per_step"]["t"][:CLI_STEPS],
                               rtol=1e-6)


def test_cli_resume_bit_for_bit_and_checkpoint_refusal(tmp_path, capsys):
    """A run stopped after 2 steps and resumed from its checkpoint (which
    carries the particles) ends with the straight run's checkpoint byte
    for byte; a checkpoint without particles is refused with JAX's
    reason; a JAX checkpoint of the same run resumes in the port."""
    from navierstokes_parallel_tpu import cli as jcli

    base = [DAMBREAK, "--free-wall", "freeslip", "--checkpoint-every", "1"]
    straight = str(tmp_path / "straight.npz")
    pieces = str(tmp_path / "pieces.npz")
    assert cli.main([*base, "--device", "cpu", "--max-steps", "4",
                     "--checkpoint-path", straight]) == 3
    assert cli.main([*base, "--device", "cpu", "--max-steps", "2",
                     "--checkpoint-path", pieces]) == 3
    assert cli.main([*base, "--device", "cpu", "--max-steps", "2",
                     "--checkpoint-path", pieces, "--resume", pieces]) == 3
    with np.load(straight) as a, np.load(pieces) as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"px", "py", "pactive"} <= set(a.files)
        assert a["px"].dtype == np.float64 and int(a["n"]) == 4
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    capsys.readouterr()
    iso = str(tmp_path / "iso.npz")
    with np.load(straight) as a:
        np.savez(iso, **{k: a[k] for k in ("u", "v", "p", "t", "n")})
    rc, out, err = _run(cli.main, [DAMBREAK, "--device", "cpu", "--resume",
                                   iso], capsys)
    jrc, jout, jerr = _run(jcli.main, [DAMBREAK, "--resume", iso], capsys)
    assert rc == jrc == 1 and out == jout == ""
    assert err.strip() == jerr.strip() and "no particle set" in err
    jck = str(tmp_path / "jax.npz")
    assert jcli.main([*base, "--max-steps", "2", "--checkpoint-path",
                      jck]) == 3
    capsys.readouterr()
    rc, _, err = _run(cli.main, [*base[:3], "--device", "cpu", "--resume",
                                 jck, "--max-steps", "2", "--stats"], capsys)
    jrc, _, jerr = _run(jcli.main, [*base[:3], "--resume", jck,
                                    "--max-steps", "2", "--stats"], capsys)
    assert rc == jrc == 3 and _stats(err) == _stats(jerr)


@pytest.mark.parametrize("argv", [["--method", "mg"], ["--backend",
                                                        "pallas"]],
                         ids=["method", "pallas"])
def test_cli_warnings_as_jax(argv, capsys):
    from navierstokes_parallel_tpu import cli as jcli

    full = [DAMBREAK, "--max-steps", "1", *argv]
    rc, _, err = _run(cli.main, [*full, "--device", "cpu"], capsys)
    jrc, _, jerr = _run(jcli.main, full, capsys)
    assert rc == jrc == 3
    assert err.startswith("warning: problem 6")
    assert jerr.startswith("warning: problem 6")
    assert err.split("; ")[1].splitlines()[0] == \
        jerr.split("; ")[1].splitlines()[0]
