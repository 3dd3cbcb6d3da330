"""The reference protocol of the port's CLI (frames, final output,
checkpoint/resume, history CSV) vs the JAX CLI's, on small cavities, f32
state, K = 64, the CPU.

  * Frames and the final output: the same file names, every file within
    the notebook comparator's 1e-4 contract (the JAX package's
    ``compare_outputs_with_tolerance``).
  * History: the same header; step, t, dt and sor_iterations equal;
    res_norm within 1e-2 relative (the packages' final SOR residuals differ
    by XLA's FMAs: up to 1e-3 seen); kinetic_energy, enstrophy and psi_min
    within 1e-5 relative (sums in other orders: up to 6e-7 seen);
    max_divergence, a cancelling difference of O(1/dx) terms, within 1e-5
    absolute.
  * The host loop's fields equal ``solver.solve``'s bit for bit; a run cut
    by --max-steps and resumed writes the straight run's frames, history
    and final checkpoint byte for byte.
  * Checkpoints of either package resume in the other.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.utils import checkpoint as jcheckpoint
from navierstokes_parallel_tpu.utils import io as jio
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.utils import checkpoint

CASES = {
    # name: JAX Params fields (the cavities of tests/test_torch_solver.py,
    # run a few steps longer)
    "16x16": dict(i_max=16, j_max=16, T=0.15, Re=100.0, tau=0.5),
    "lid2": dict(problem=2, f=3.0, i_max=20, j_max=12, T=0.1, Re=50.0,
                 tau=0.5),
}
RES_RTOL = 1e-2
MONITOR_RTOL = 1e-5
DIVERGENCE_ATOL = 1e-5


def _config(tmp_path, name="16x16", **kw):
    ref = JaxParams(dtype="float32", epsilon=1e-4, omega=1.7,
                    sor_refine_every=64, **{"max_it": 2000, **CASES[name],
                                            **kw})
    path = str(tmp_path / f"{name}.in")
    ref.to_file(path)
    return path, Params.from_mapping(dataclasses.asdict(ref))


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _files(where, tag, history_physics=True):
    """The protocol flags writing under `where` with names tagged `tag`."""
    argv = ["--output-dir", str(where / f"{tag}_frames"),
            "--final-output-prefix", str(where / f"{tag}_final"),
            "--history-file", str(where / f"{tag}.csv"),
            "--checkpoint-every", "2",
            "--checkpoint-path", str(where / f"{tag}.npz"), "--stats"]
    return argv + (["--history-physics"] if history_physics else [])


def _rows(path):
    with open(path) as fh:
        header = fh.readline().strip()
        rows = [line.strip().split(",") for line in fh]
    return header, rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_files_match_jax_cli(name, tmp_path, capsys):
    path, _ = _config(tmp_path, name)
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--log-every",
                                   "2", *_files(tmp_path, "port")], capsys)
    jrc, jout, jerr = _run(jcli.main, [path, "--log-every", "2",
                                       *_files(tmp_path, "jax")], capsys)
    assert rc == jrc == 0
    assert out.splitlines()[2] == jout.splitlines()[2] == "Output created!"
    assert err.splitlines()[-3].split()[:3] == \
        jerr.splitlines()[-3].split()[:3]
    steps = int(err.splitlines()[-3].split()[0].split("=")[1])
    assert steps >= 3
    logs = [line for line in err.splitlines() if line.startswith("step=")]
    assert len(logs) == steps // 2 == len(
        [line for line in jerr.splitlines() if line.startswith("step=")])

    frames = sorted(os.listdir(tmp_path / "port_frames"))
    assert frames == sorted(os.listdir(tmp_path / "jax_frames"))
    assert len(frames) == 3 * steps  # one frame before every step
    pairs = [(tmp_path / "port_frames" / f, tmp_path / "jax_frames" / f)
             for f in frames]
    pairs += [(tmp_path / f"port_final_{s}.txt", tmp_path / f"jax_final_{s}.txt")
              for s in "uvp"]
    for mine, theirs in pairs:
        assert jio.compare_outputs_with_tolerance(str(mine), str(theirs)), \
            mine.name

    header, rows = _rows(tmp_path / "port.csv")
    jheader, jrows = _rows(tmp_path / "jax.csv")
    assert header == jheader == cli._history_columns(
        cli.build_parser().parse_args(["--history-physics"]))
    assert len(rows) == len(jrows) == steps
    got, want = np.array(rows, float), np.array(jrows, float)
    assert [r[:4] for r in rows] == [r[:4] for r in jrows]  # step t dt iters
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=RES_RTOL)
    for col in (5, 6, 8):  # kinetic_energy, enstrophy, psi_min
        np.testing.assert_allclose(got[:, col], want[:, col],
                                   rtol=MONITOR_RTOL)
    np.testing.assert_allclose(got[:, 7], want[:, 7], atol=DIVERGENCE_ATOL)

    with np.load(tmp_path / "port.npz") as mine, \
            np.load(tmp_path / "jax.npz") as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for key in mine.files:
            assert mine[key].dtype == theirs[key].dtype, key
            assert mine[key].shape == theirs[key].shape, key
        assert int(mine["n"]) == int(theirs["n"]) == steps - steps % 2


def test_host_loop_equals_solve(tmp_path, capsys):
    """The host loop's steps are solve's: same stats, same bits, with and
    without --debug-nans."""
    path, prm = _config(tmp_path)
    state, stats = solver.solve(prm, device="cpu",
                                pressure_method="pallas_sor")
    for extra in ([], ["--debug-nans"]):
        ck = tmp_path / f"ck{len(extra)}.npz"
        rc, _, err = _run(cli.main, [path, "--device", "cpu", "--stats",
                                     "--checkpoint-every", "1",
                                     "--checkpoint-path", str(ck), *extra],
                          capsys)
        assert rc == 0
        assert err.splitlines()[0].split()[:3] == [
            f"steps={stats.steps}",
            f"sor_iterations={stats.total_sor_iterations}",
            f"sor_failures={stats.sor_failures}"]
        loaded = checkpoint.load_checkpoint(str(ck), prm, "cpu")
        for name in ("u", "v", "p", "t"):
            assert torch.equal(getattr(loaded, name), getattr(state, name))
        assert loaded.n == state.n == stats.steps


def test_max_steps_and_resume_equal_the_straight_run(tmp_path, capsys):
    """Stopped after 2 steps (rc 3), resumed to T (rc 0): the frames, the
    history CSV and the final checkpoint are the straight run's, byte for
    byte and bit for bit."""
    path, _ = _config(tmp_path)
    common = [path, "--device", "cpu", "--checkpoint-every", "1"]

    def files(tag):
        return ["--output-dir", str(tmp_path / tag), "--history-file",
                str(tmp_path / f"{tag}.csv"), "--history-physics",
                "--checkpoint-path", str(tmp_path / f"{tag}.npz")]

    rc, out, _ = _run(cli.main, [*common, *files("straight")], capsys)
    assert rc == 0
    rc1, _, _ = _run(cli.main, [*common, *files("pieces"), "--max-steps",
                                "2"], capsys)
    assert rc1 == 3
    assert len(_rows(tmp_path / "pieces.csv")[1]) == 2
    rc2, out2, _ = _run(cli.main, [*common, *files("pieces"), "--resume",
                                   str(tmp_path / "pieces.npz")], capsys)
    assert rc2 == 0 and out2 == out
    frames = sorted(os.listdir(tmp_path / "straight"))
    assert frames == sorted(os.listdir(tmp_path / "pieces"))
    for f in frames:
        assert (tmp_path / "straight" / f).read_bytes() == \
            (tmp_path / "pieces" / f).read_bytes(), f
    assert (tmp_path / "straight.csv").read_bytes() == \
        (tmp_path / "pieces.csv").read_bytes()
    with np.load(tmp_path / "straight.npz") as a, \
            np.load(tmp_path / "pieces.npz") as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_checkpoints_resume_across_packages(tmp_path, capsys):
    """A JAX checkpoint resumed by the port and a port checkpoint resumed
    by JAX end where the straight runs end, within the contract."""
    path, prm = _config(tmp_path)
    for tag, first in (("jax", jcli.main), ("port", cli.main)):
        argv = [path, "--max-steps", "2", "--checkpoint-every", "2",
                "--checkpoint-path", str(tmp_path / f"{tag}.npz")]
        if first is cli.main:
            argv += ["--device", "cpu"]
        assert _run(first, argv, capsys)[0] == 3
    rc, _, err = _run(cli.main, [path, "--device", "cpu", "--stats",
                                 "--resume", str(tmp_path / "jax.npz"),
                                 "--final-output-prefix",
                                 str(tmp_path / "from_jax")], capsys)
    jrc, _, jerr = _run(jcli.main, [path, "--stats", "--resume",
                                    str(tmp_path / "port.npz"),
                                    "--final-output-prefix",
                                    str(tmp_path / "from_port")], capsys)
    assert rc == jrc == 0
    assert err.splitlines()[0].split()[:3] == jerr.splitlines()[0].split()[:3]
    straight, stats = solver.solve(prm, device="cpu",
                                   pressure_method="pallas_sor")
    assert err.splitlines()[0].startswith(f"steps={stats.steps - 2} ")
    from navierstokes_parallel_tpu_torch.utils import io as nsio
    nsio.output(straight.u, straight.v, straight.p, float(straight.t),
                prm.a, prm.b, str(tmp_path / "straight"), verbose=False)
    for s in "uvp":
        for tag in ("from_jax", "from_port"):
            assert jio.compare_outputs_with_tolerance(
                str(tmp_path / f"{tag}_{s}.txt"),
                str(tmp_path / f"straight_{s}.txt")), (tag, s)

    # The loaded states: the same arrays in both packages.
    mine = checkpoint.load_checkpoint(str(tmp_path / "jax.npz"), prm, "cpu")
    theirs = jcheckpoint.load_checkpoint(str(tmp_path / "jax.npz"),
                                         JaxParams(**dataclasses.asdict(prm)))
    for name in ("u", "v", "p", "t"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    assert mine.n == int(theirs.n) == 2 and mine.u.dtype == torch.float32
    f64 = checkpoint.load_checkpoint(str(tmp_path / "jax.npz"),
                                     prm.replace(dtype="float64"), "cpu")
    assert f64.p.dtype == f64.t.dtype == torch.float64


def _isothermal_checkpoint(tmp_path, prm):
    path = str(tmp_path / "isothermal.npz")
    z = np.zeros(prm.shape, np.float32)
    np.savez(path, u=z, v=z, p=z, t=np.float32(0.0), n=np.int32(0))
    return path


@pytest.mark.parametrize("case,needle", [
    ("wrong_grid", "does not match config grid"),
    # Problem 5 is ported: its run refuses an isothermal checkpoint.
    ("thermal", "no temperature field"),
    ("columns", "has columns"),
    ("physics_alone", "--history-physics requires --history-file"),
    ("missing", "cannot resume"),
])
def test_refusals(case, needle, tmp_path, capsys):
    path, prm = _config(tmp_path)
    argv = [path, "--device", "cpu"]
    if case == "wrong_grid":
        lid2, _ = _config(tmp_path, "lid2")
        assert _run(cli.main, [lid2, "--device", "cpu", "--max-steps", "1",
                               "--checkpoint-every", "1", "--checkpoint-path",
                               str(tmp_path / "lid2.npz")], capsys)[0] == 3
        argv += ["--resume", str(tmp_path / "lid2.npz")]
    elif case == "thermal":
        conv = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "convection.in")
        argv = [conv, "--device", "cpu", "--resume", _isothermal_checkpoint(
            tmp_path, Params.from_file(conv))]
    elif case == "columns":
        hist = tmp_path / "h.csv"
        assert _run(cli.main, [*argv, "--max-steps", "1", "--history-file",
                               str(hist), "--history-physics",
                               "--checkpoint-every", "1", "--checkpoint-path",
                               str(tmp_path / "c.npz")], capsys)[0] == 3
        argv += ["--resume", str(tmp_path / "c.npz"), "--history-file",
                 str(hist)]
    elif case == "physics_alone":
        argv += ["--history-physics"]
    else:
        argv += ["--resume", str(tmp_path / "none.npz")]
    rc, out, err = _run(cli.main, argv, capsys)
    assert rc == 1 and out == "" and needle in err, err


@pytest.mark.parametrize("argv,label", [
    # AB2 runs problems 1-5 on one device; problem 5 on the sharded backend
    # is refused with the JAX CLI's message.
    (["--time-order", "2", "--backend", "sharded"], "runs single-chip"),
    # Obstacles run on one device (A7) and on the sharded backend (A10 item
    # 8) by the masked rb_sor; another sharded method is JAX's ValueError.
    (["--obstacle", "3:5:3:5", "--backend", "sharded", "--method", "mg"],
     "masked deep-halo rb_sor"),
    # Free surfaces run (A8): the flag drives configs/dambreak.in's walls;
    # its label is the JAX CLI's stats line of the same run.
    (["--free-wall", "freeslip"], None),
    # The compensated outer runs (A9): the JAX CLI's record of the run.
    (["--outer", "compensated"], None),
], ids=["time_order", "obstacle", "free_wall", "outer"])
def test_later_slice_flags_refused(argv, label, tmp_path, capsys):
    path, _ = _config(tmp_path)
    if "--outer" in argv:
        runs = [_run(main, [path, *argv, "--stats", *extra], capsys)
                for main, extra in ((cli.main, ["--device", "cpu"]),
                                    (jcli.main, []))]
        (rc, out, err), (jrc, jout, jerr) = runs
        assert rc == jrc == 0 and out == jout
        # steps, sor_iterations, sor_failures
        assert err.split()[:3] == jerr.split()[:3]
        return
    if "--free-wall" in argv:
        dam = [os.path.join(os.path.dirname(__file__), "..", "configs",
                            "dambreak.in"), *argv, "--max-steps", "2",
               "--stats"]
        rc, out, err = _run(cli.main, [*dam, "--device", "cpu"], capsys)
        jrc, jout, jerr = _run(jcli.main, dam, capsys)
        assert rc == jrc == 3 and out == jout
        assert err.split()[:3] == jerr.split()[:3]
        return
    if "--time-order" in argv:
        path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "convection.in")
    rc, out, err = _run(cli.main, [path, "--device", "cpu", *argv], capsys)
    assert rc == 1 and out == "" and label in err


def test_later_slice_defaults_accepted(tmp_path, capsys):
    path, _ = _config(tmp_path)
    base = _run(cli.main, [path, "--device", "cpu", "--stats"], capsys)
    same = _run(cli.main, [path, "--device", "cpu", "--stats",
                           "--time-order", "1", "--outer", "float64",
                           "--free-wall", "noslip"], capsys)
    assert base[0] == same[0] == 0 and base[1] == same[1]
    assert base[2].splitlines()[0].split()[:4] == \
        same[2].splitlines()[0].split()[:4]


def test_writer_errors_surface(tmp_path, capsys, monkeypatch):
    """A frame that cannot be written stops the run: through the CLI (the
    output directory is a file), and at the next frame or at ``close`` for
    the writer itself."""
    path, prm = _config(tmp_path)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--output-dir",
                                   str(blocker)], capsys)
    assert rc == 1 and out == "" and "error" in err

    calls = []

    def failing_output(*args, **kw):
        calls.append(args[-1])
        raise OSError(f"disk full at {args[-1]}")

    monkeypatch.setattr(cli.nsio, "output", failing_output)
    state = solver.allocate_state(prm, "cpu")
    with pytest.raises(OSError, match="disk full at a"):
        with cli._FrameWriter(prm) as frames:
            frames.submit(state, "a")
            frames._pending[0].exception()  # wait for the first frame
            frames.submit(state, "b")
    with pytest.raises(OSError, match="disk full at c"):
        with cli._FrameWriter(prm) as frames:
            frames.submit(state, "c")
            frames.close()
    assert calls == ["a", "c"]


def test_debug_nans_names_the_step(tmp_path, capsys):
    """A NaN planted in a checkpoint's p spreads through the first step
    after the resume; --debug-nans stops there and names that step."""
    path, prm = _config(tmp_path, max_it=50)
    ck = str(tmp_path / "ck.npz")
    assert _run(cli.main, [path, "--device", "cpu", "--max-steps", "2",
                           "--checkpoint-every", "2", "--checkpoint-path",
                           ck], capsys)[0] == 3
    state = checkpoint.load_checkpoint(ck, prm, "cpu")
    state.p[5, 5] = float("nan")
    checkpoint.save_checkpoint(ck, state)
    rc, out, err = _run(cli.main, [path, "--device", "cpu", "--resume", ck,
                                   "--debug-nans"], capsys)
    assert rc == 1 and out == ""
    assert "non-finite values in u at step 3" in err


def test_steppers_and_checkpoint_round_trip(tmp_path):
    _, prm = _config(tmp_path)
    stepper = solver.Stepper(prm, solver.allocate_state(prm, "cpu"),
                             "pallas_sor")
    stepper.warm()
    assert (stepper.n, stepper.t) == (0, 0.0)
    diag = stepper.step()
    assert stepper.n == 1 and stepper.t == float(diag.dt) > 0
    ck = str(tmp_path / "s.npz")
    checkpoint.save_checkpoint(ck, stepper.state())
    back = checkpoint.load_checkpoint(ck, prm, "cpu")
    assert back.n == 1 and all(torch.equal(a, b) for a, b in
                               zip(back[:4], stepper.state()[:4]))
    theirs = jcheckpoint.load_checkpoint(ck, JaxParams(
        **dataclasses.asdict(prm)))
    np.testing.assert_array_equal(np.asarray(theirs.p), back.p.numpy())
    assert int(theirs.n) == 1
