"""The benchmark's plain reference of flow past a cylinder
(``nsbench/reference/schaefer_turek.py``) against the port, on the CPU.

  * The reference's geometry, in closed form, equals the port's, which
    bisects: the circle's cells, the face fractions, the ghost-fluid
    weights and the pressure operator's couplings, at 10 and 20 cells a
    diameter.
  * Its exact pressure solve meets its residual and is blind to a constant
    in the rhs.
  * From a seeded kicked state, the port in float64 at a tight epsilon
    steps as the reference does; from that state spun up by the
    reference, as the cell's set-up does, in its
    configured float32 and 1e-4 its readings sit below the cell
    ``schaefer_turek.mg``'s limits, and the bfloat16 control sits above
    one of them at least.  Both on a channel
    cut to 8 diameters (80 x 41) so that the file keeps to its minute on
    the CPU: the impulsive start's solves take ~900 V-cycles a step at the
    tight epsilon there, ~5000 on the whole 22-diameter channel.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.models import karman
from navierstokes_parallel_tpu_torch.ops import masked, obstacles

from nsbench.calibrate import bfloat16_store
from nsbench.families import schaefer_turek as family
from nsbench.reference import schaefer_turek as ref

BENCH = Path(__file__).resolve().parents[1] / "nsbench"
LIMITS = json.loads((BENCH / "limits/schaefer_turek.mg.json").read_text())
# Closed form against 60 bisections: both within a few ulps of the root.
GEOMETRY_TOL = 1e-12
# The port in float64 at epsilon 1e-10 against the exact solve, 2 steps:
# its pressure stops at its rule (read 4.4e-9 on p, 3e-11 on u and v), the
# geometry differs by the bisection's rounding.  The port in float32 reads
# ~3e-5 on u and v and ~4e-3 on p here, far above it.
STEP_TOL = 1e-7
TIGHT_EPSILON = 1e-10
KICK = 0.3


def short_channel(**overrides) -> Params:
    """The Schäfer-Turek geometry at 10 cells a diameter with the channel
    cut to 8 diameters: the same cylinder, inflow and cells up to x = 8."""
    return karman.schafer_turek(n_per_d=10, T=1.0, **overrides).replace(
        i_max=80, a=8.0)


def test_the_configuration_is_schafer_turek_at_20_cells_a_diameter():
    config = json.loads((BENCH / "configs/schaefer_turek_2d2.json")
                        .read_text())
    assert config["family"] == "schaefer_turek"
    assert Params(**config["params"]) == karman.schafer_turek(n_per_d=20,
                                                              T=0.85)


@pytest.mark.parametrize("n_per_d", [10, 20])
def test_geometry_equals_the_port_s(n_per_d):
    prm = karman.schafer_turek(n_per_d=n_per_d)
    d = dataclasses.asdict(prm)
    cells = ref.circle_cells(ref.circle(d), prm.dx, prm.dy, prm.i_max,
                             prm.j_max)
    assert np.array_equal(cells.numpy(), karman.circle_cells(
        2.0, 2.0, 1.0, prm.dx, prm.dy, prm.i_max, prm.j_max))
    rects = np.zeros_like(cells.numpy())
    for i0, i1, j0, j1 in karman.circle_rects(2.0, 2.0, 1.0, prm.dx, prm.dy,
                                               prm.i_max, prm.j_max):
        rects[i0 - 1:i1, j0 - 1:j1] = True
    assert np.array_equal(cells.numpy(), rects)

    geo = ref.geometry(d)
    m = obstacles.masks(prm)
    for name in ("fluid", "u_solid", "v_solid"):
        assert np.array_equal(getattr(geo, name).numpy(), getattr(m, name))
    ap = obstacles.apertures(prm)
    assert np.abs(geo.au.numpy() - ap.au).max() <= GEOMETRY_TOL
    assert np.abs(geo.av.numpy() - ap.av).max() <= GEOMETRY_TOL
    ib = obstacles.ib_weights(prm)
    mine = [w for w, _, _ in geo.u_weights + geo.v_weights]
    for name, w in zip(ib._fields, mine):
        assert np.abs(w.numpy() - getattr(ib, name)).max() <= GEOMETRY_TOL
        assert (getattr(ib, name) != 0).sum() > 0, name
    assert np.array_equal(geo.inflow.numpy(), obstacles.inflow_profile(prm))

    pressure = ref.ExactPoisson(d, geo)
    w = masked._weights(prm)
    scale = 1.0 / (prm.dx * prm.dx)
    for mine, port in ((pressure.w_e, w.w_e), (pressure.w_n, w.w_n)):
        assert np.abs(mine.numpy() - port).max() <= GEOMETRY_TOL * scale


def test_the_reference_refuses_rectangles_that_are_not_the_circle():
    d = dataclasses.asdict(short_channel())
    d["obstacles"] = d["obstacles"][1:]
    with pytest.raises(ValueError, match="not the circle's cells"):
        ref.geometry(d)


def test_the_exact_pressure_solve():
    d = dataclasses.asdict(short_channel())
    pressure = ref.ExactPoisson(d, ref.geometry(d))
    g = torch.Generator().manual_seed(7)
    rhs = torch.zeros((82, 43), dtype=torch.float64)
    rhs[1:-1, 1:-1] = torch.randn((80, 41), generator=g,
                                  dtype=torch.float64)
    p = pressure(rhs)
    fl = pressure.fluid
    r = torch.where(fl, rhs[1:-1, 1:-1], torch.zeros(()))
    r = torch.where(fl, r - r[fl].mean(), torch.zeros(()))
    res = pressure.apply(p[1:-1, 1:-1]) - r
    assert float(res.norm() / r.norm()) <= ref.SOLVE_TOL
    assert abs(float(p[1:-1, 1:-1][fl].mean())) < 1e-14
    assert float(p[1:-1, 1:-1][~fl].abs().max()) == 0.0
    shifted = pressure(torch.where(
        torch.nn.functional.pad(fl, (1, 1, 1, 1)), rhs + 3.0, rhs))
    assert float((shifted - p).abs().max()) < 1e-11


class _Cell:
    def __init__(self, prm: Params):
        self.prm = dataclasses.asdict(prm)


def _port_steps(prm: Params, state, n: int):
    for _ in range(n):
        state, diag = solver.step(state, prm, pressure_method="mg")
        assert diag.sor_converged
    return state


def test_the_port_in_float64_steps_as_the_reference():
    prm = short_channel(dtype="float64", epsilon=TIGHT_EPSILON)
    start = karman.initial_state(prm, perturb=KICK, device="cpu")
    out = _port_steps(prm, start, 2)
    plain = ref.solve(start.u, start.v, float(start.t),
                      dataclasses.asdict(prm), max_steps=2)
    assert plain.steps == 2
    assert plain.t == pytest.approx(float(out.t), rel=1e-12)
    readings = family.readings(family.fields(out), 2, plain, _Cell(prm))
    assert readings["steps"] == 0.0
    for name in ("u_err", "v_err", "p_err"):
        assert readings[name] <= STEP_TOL, (name, readings)
        assert STEP_TOL * 100 <= LIMITS[name]


def test_the_limits_pass_float32_and_refuse_the_bfloat16_control():
    """From a flow the reference spun up for 3 steps, as the cell's set-up
    does: the impulsive start's own steps read p_err ~4e-3 here (the port's
    solves stop at the rule far from the exact p), the developed flow's
    ~5e-5."""
    prm = short_channel()
    d = dataclasses.asdict(prm)
    start = karman.initial_state(prm, perturb=KICK, device="cpu")
    start = family.program_state(start, ref.solve(
        start.u, start.v, float(start.t), d, max_steps=3))
    out = _port_steps(prm, start, 2)
    plain = ref.solve(start.u, start.v, float(start.t), d, max_steps=2)
    cell = _Cell(prm)
    own = family.readings(family.fields(out), 2, plain, cell)
    control = ref.solve(start.u, start.v, float(start.t), d,
                        store=bfloat16_store, max_steps=2)
    ctl = family.readings(family.fields(control), control.steps, plain,
                          cell)
    fields = ("u_err", "v_err", "p_err")
    assert own["steps"] == ctl["steps"] == 0.0
    assert all(own[k] <= LIMITS[k] for k in fields), own
    assert any(ctl[k] > LIMITS[k] for k in fields), ctl
    # The float64 comparison's tolerance would refuse the float32 run.
    assert all(own[k] > STEP_TOL for k in ("u_err", "v_err")), own
