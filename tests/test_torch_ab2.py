"""``--time-order 2`` and the channel through the port's CLI vs the JAX
CLI, on the CPU.

  * configs/channel.in stopped after 3 steps, Euler and AB2: rc 3 in both,
    equal steps, iteration totals and failures, the centre values within
    the reference contract (1e-4).
  * The AB2 warnings and refusals of the JAX CLI: tau > 0.5 warns (the same
    line on standard error), problem 6 is refused (the same message).
  * Resume: a checkpoint holds the state only, so a resumed AB2 run starts
    again from the Euler bootstrap, in both packages.  The port's resumed
    run equals a fresh AB2 stepper from the checkpoint bit for bit, differs
    from the straight run, and matches the JAX CLI's resumed run within the
    contract, with equal counts.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu import cli as jcli
from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu_torch import cli, solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.utils import checkpoint

from conftest import assert_close_reference_contract

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _stats(err):
    return next(line for line in err.splitlines()
                if line.startswith("steps=")).split()[:3]


def _centres(out):
    return [float(line.split()[1]) for line in out.splitlines()]


@pytest.mark.parametrize("order", ["1", "2"], ids=["euler", "ab2"])
def test_cli_channel_matches_jax_cli(order, capsys):
    argv = [os.path.join(CONFIGS, "channel.in"), "--stats", "--max-steps",
            "3", "--time-order", order]
    rc, out, err = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    jrc, jout, jerr = _run(jcli.main, argv, capsys)
    assert rc == jrc == 3
    assert _stats(err) == _stats(jerr)
    assert _stats(err)[0] == "steps=3" and _stats(err)[2] == "sor_failures=0"
    assert_close_reference_contract(_centres(out), _centres(jout))


def _small(tmp_path, name, **kw):
    ref = JaxParams(**{**dict(problem=3, i_max=24, j_max=12, a=2.0, b=1.0,
                              Re=10.0, T=1.0, tau=0.5, omega=1.7,
                              epsilon=1e-4, max_it=20000, dtype="float32",
                              sor_refine_every=64), **kw})
    path = str(tmp_path / f"{name}.in")
    ref.to_file(path)
    return path, Params.from_mapping(dataclasses.asdict(ref))


def test_cli_tau_warning_and_problem6_refusal(tmp_path, capsys):
    path, _ = _small(tmp_path, "tau", problem=1, i_max=12, j_max=12,
                     a=1.0, tau=0.8)
    argv = [path, "--time-order", "2", "--max-steps", "1"]
    rc, _, err = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    jrc, _, jerr = _run(jcli.main, argv, capsys)
    warning = "warning: --time-order 2 with tau=0.8 > 0.5"
    assert rc == jrc == 3
    assert err.splitlines()[0] == jerr.splitlines()[0]
    assert err.startswith(warning)
    dam = [os.path.join(CONFIGS, "dambreak.in"), "--time-order", "2"]
    rc, out, err = _run(cli.main, [*dam, "--device", "cpu"], capsys)
    jrc, jout, jerr = _run(jcli.main, dam, capsys)
    assert rc == jrc == 1 and out == jout == ""
    assert err.strip() == jerr.strip()
    assert "does not apply to problem 6" in err


def test_cli_ab2_resume_restarts_from_euler(tmp_path, capsys):
    path, prm = _small(tmp_path, "resume")
    where = {}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        ck = str(tmp_path / f"{tag}.npz")
        common = [path, "--time-order", "2", "--stats", "--checkpoint-every",
                  "2", "--checkpoint-path", ck, "--max-steps", "2", *extra]
        first = _run(main, common, capsys)
        second = _run(main, [*common, "--resume", ck], capsys)
        assert first[0] == second[0] == 3
        where[tag] = (ck, _stats(first[2]), _stats(second[2]))
    # Equal counts in both pieces; the resumed states within the contract.
    assert where["port"][1:] == where["jax"][1:]
    mine = checkpoint.load_checkpoint(where["port"][0], prm, "cpu")
    theirs = checkpoint.load_checkpoint(where["jax"][0], prm, "cpu")
    assert mine.n == theirs.n == 4
    for name in ("u", "v", "p"):
        assert_close_reference_contract(getattr(mine, name).numpy(),
                                        getattr(theirs, name).numpy())
    # The resumed run is an AB2 stepper from the 2-step state (the Euler
    # bootstrap again), not the straight 4-step run.
    straight = solver.Stepper(prm, solver.allocate_state(prm, "cpu"),
                              "rb_sor", time_order=2)
    for _ in range(2):
        straight.step()
    resumed = solver.Stepper(prm, straight.state(), "rb_sor", time_order=2)
    for _ in range(2):
        straight.step()
        resumed.step()
    assert all(torch.equal(a, b) for a, b in zip(mine[:4],
                                                 resumed.state()[:4]))
    assert not torch.equal(mine.u, straight.state().u)
    assert np.isfinite(mine.u.numpy()).all()
