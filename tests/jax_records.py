"""The JAX package's records for the port's chip check (chip_smoke.py) that
its CLI does not print: the channel's profile errors after N steps and the
Taylor-Green AB2 run's counts and errors.  Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_records.py channel 50
    JAX_PLATFORMS=cpu python tests/jax_records.py taylor-green 1024 3
    JAX_PLATFORMS=cpu python tests/jax_records.py obstacles \
        tests/jax_obstacle_records.json

``channel N``: configs/channel.in, N steps from rest by the CLI's method
on the CPU (rb_sor), Euler and AB2: counts, centre values,
``models/channel.py::profile_errors`` of the final u and each step's
outer passes (sweeps / K).  ``taylor-green n
N``: ``models/taylorgreen.py::taylor_green(n)``, N steps of ``step_ab2``
with the multigrid pressure solve (the port's ``solve_ab2(...,
max_steps=N)``): counts, per-step V-cycles, centre values, ``errors`` and
``kinetic_energy``.  ``thermal PATH``: the problem-5 runs of chip_smoke.py's "convection"
phase (THERMAL_CLI through the JAX CLI: stdout, stats line and each step's
iterations; the heated block of THERMAL_BLOCK stepped by
``thermal_step``) and the witness run of
scripts/torch_convection_witness.py (configs/convection.in whole: stats,
centre values and the hot- and cold-wall Nusselt numbers).
``sharded-obstacles PATH``: the runs of chip_smoke.py's "sharded
obstacles" phase on the JAX sharded backend over a one-device CPU mesh
(SHARDED_OBSTACLE_RUNS stepped by ``ShardedStepper``: per step the
iterations and convergence, then the centre values and max |u|, |v|; and
the JAX CLI on SHARDED_OBSTACLE_CLI with each step's iterations).  Both
write their section of PATH (tests/jax_thermal_records.json), keeping the
other.  ``obstacles PATH``: the obstacle runs of
``OBSTACLE_RUNS`` (full grids, cut to a few steps), each from its model's
initial state by ``make_step_fn`` or ``make_ab2_step_fn``: per step the
iterations, convergence and the records of the run's record function,
then the centre values and max |u|, |v| of the final state; and the JAX
CLI on ``OBSTACLE_CLI``'s argv (its standard output and stats line); all
written to PATH as JSON with each run's definition, which chip_smoke.py
reads to run the same steps on the card.  ``sharded-thermal PATH``:
configs/convection.in on the JAX sharded thermal backend over a one-device
CPU mesh, SHARDED_THERMAL_STEPS steps by rb_sor and by mg (the JAX CLI's
record with --backend sharded --mesh 1x1, and each step's iterations and
convergence from ``ThermalShardedStepper``), written to PATH
(tests/jax_sharded_thermal_records.json).  ``free PATH``: FREE_CLI, the
dam break of configs/dambreak.in with free-slip walls to T = 2.0, through
the JAX CLI (standard output and stats line) and stepped by
``make_free_step_fn`` as its host loop steps: per step t, dt, the
iterations, convergence, the centre values, ``fluid_volume``,
``front_position`` and ``column_height``; and the first FREE_CUT steps of
it through the CLI with --max-steps (chip_smoke.py's cut), written to
PATH (tests/jax_free_records.json).  A script, not a test module: it
imports JAX, which the port never does.

    JAX_PLATFORMS=cpu python tests/jax_records.py sharded-thermal \
        tests/jax_sharded_thermal_records.json
    JAX_PLATFORMS=cpu python tests/jax_records.py free \
        tests/jax_free_records.json

``diff``, ``compensated`` and ``ensemble`` write their sections of
tests/jax_a9_records.json (A9_RECORDS; a path may follow): the gradients
of DIFF_CAVITY, DIFF_THERMAL and DIFF_MASKED with JAX's own central
differences of the cavity's, COMPENSATED_CLI through the JAX CLI, and the
ENSEMBLE runs by each method (per member: steps, iterations, failures, t,
centre values, max |u| of the interior), each with its definition:

    JAX_PLATFORMS=cpu python tests/jax_records.py diff
    JAX_PLATFORMS=cpu python tests/jax_records.py compensated
    JAX_PLATFORMS=cpu python tests/jax_records.py ensemble

``gspmd`` writes tests/jax_gspmd_records.json (GSPMD_RECORDS; a path may
follow, ~4 min): the JAX gspmd backend's runs of GSPMD_RUNS on a 1x1 mesh
(chip_smoke.py's "gspmd" phase: per step the iterations, convergence and
t, then the centre values and max |u|, |v|; the dam break's fluid
volume), and tests/test_torch_gspmd.py's cases on a 2x2 mesh of four CPU
devices (every method at each of GSPMD_SIZES, GSPMD_CASES, and the CLI on
GSPMD_CLI).  The script asks XLA for eight CPU devices before it imports
jax:

    JAX_PLATFORMS=cpu python tests/jax_records.py gspmd
"""

import os
import sys

# The gspmd records' 2x2 meshes take four CPU devices (before jax loads).
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
        " --xla_force_host_platform_device_count=8")).strip()

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # run as a script from the root of a checkout
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from navierstokes_parallel_tpu import solver  # noqa: E402
from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.grid import allocate_state  # noqa: E402
from navierstokes_parallel_tpu.models import channel  # noqa: E402
from navierstokes_parallel_tpu.models import karman  # noqa: E402
from navierstokes_parallel_tpu.models import step as step_model  # noqa: E402
from navierstokes_parallel_tpu.models import taylorgreen  # noqa: E402

# name: (model, its keyword arguments, pressure method, time order, steps,
# record function).  The Schäfer-Turek 2D-2 cylinder at 20 cells per
# diameter (440 x 82, sharp: immersed-boundary velocity BCs and the cut-cell
# pressure operator) from initial_state(perturb=0.3); the confined square
# cylinder at 8 (160 x 64, staircase) likewise; the backward-facing step of
# artifacts/bfs_re150_128x32.png (Re = 150, 128 x 32) from rest.
OBSTACLE_RUNS = {
    "schafer_turek mg": ("schafer_turek", {"n_per_d": 20}, "mg", 1, 3,
                         "surface_force"),
    "schafer_turek mg ab2": ("schafer_turek", {"n_per_d": 20}, "mg", 2, 3,
                             "surface_force"),
    "schafer_turek rb_sor": ("schafer_turek", {"n_per_d": 20}, "rb_sor", 1,
                             3, "surface_force"),
    "square_cylinder mg": ("square_cylinder", {"n_per_d": 8}, "mg", 1, 5,
                           "force"),
    "step rb_sor": ("backward_facing_step", {"Re": 150.0, "nx": 128,
                                             "ny": 32}, "rb_sor", 1, 3, None),
    "step rb_sor ab2": ("backward_facing_step", {"Re": 150.0, "nx": 128,
                                                 "ny": 32}, "rb_sor", 2, 3,
                        None),
}
OBSTACLE_CLI = ["configs/channel.in", "--obstacle", "17:24:27:34",
                "--max-steps", "20", "--stats"]

# The problem-5 CLI runs (tag: extra arguments after configs/convection.in),
# the heated block (heated_block_setup's keyword arguments and steps), and
# the witness's whole run.
THERMAL_CONFIG = "configs/convection.in"
THERMAL_STEPS = 300
THERMAL_CLI = {"convection": [], "convection mg": ["--method", "mg"],
               "convection ab2": ["--time-order", "2"]}
THERMAL_BLOCK = ({"Ra": 1e4, "n": 32}, 20)

# The sharded obstacle runs: (model, its keyword arguments, time order,
# steps); the backward-facing step and the Schäfer-Turek circle as
# OBSTACLE_RUNS records them on one device, cut to the steps named.
SHARDED_OBSTACLE_RUNS = {
    "sharded step": ("backward_facing_step",
                     {"Re": 150.0, "nx": 128, "ny": 32}, 1, 3),
    "sharded step ab2": ("backward_facing_step",
                         {"Re": 150.0, "nx": 128, "ny": 32}, 2, 3),
    "sharded schafer_turek": ("schafer_turek", {"n_per_d": 20}, 1, 1),
}
SHARDED_OBSTACLE_CLI = ["configs/channel.in", "--obstacle", "17:24:27:34",
                        "--backend", "sharded", "--mesh", "1x1",
                        "--max-steps", "5", "--stats"]


# The sharded thermal runs: configs/convection.in, by each method.
SHARDED_THERMAL_STEPS = 300
SHARDED_THERMAL_METHODS = ("rb_sor", "mg")

# The dam break: the whole run, and the cut of chip_smoke.py's phase.
FREE_CLI = ["configs/dambreak.in", "--free-wall", "freeslip", "--stats"]
FREE_CUT = 60


# The runs of chip_smoke.py's "gradients", "compensated" and "ensemble"
# phases, written by the diff, compensated and ensemble commands to one
# file (each command its section); each record carries its definition,
# from which chip_smoke.py rebuilds the same inputs.  A perturbation is
# `bump` times a standard normal of numpy's default_rng(seed) on the
# interior (zero on the ghost ring).
A9_RECORDS = "tests/jax_a9_records.json"
# configs/1.in's 256^2 cavity in f64 to epsilon 1e-9, 3 steps by mg from a
# symmetry-broken start (u += bump); loss = sum u^2 + sum v^2 of the
# interior; the gradient w.r.t. lid_scale and the directional derivative
# w.r.t. the initial u along a direction of seed direction_seed, each with
# JAX's own central differences (steps h_lid, h_dir).
DIFF_CAVITY = {"config": "configs/1.in", "dtype": "float64",
               "epsilon": 1e-9, "steps": 3, "method": "mg", "bump_seed": 42,
               "bump": 0.05, "direction_seed": 7, "h_lid": 1e-5,
               "h_dir": 1e-6}
# configs/convection.in's 64^2 de Vahl Davis cavity in f64 to epsilon 1e-9,
# 3 steps by mg from the conduction state with u and v perturbed (two
# draws of one generator); the hot-wall Nusselt number of the final T and
# its derivative w.r.t. t_left.
DIFF_THERMAL = {"config": "configs/convection.in", "dtype": "float64",
                "epsilon": 1e-9, "steps": 3, "method": "mg", "bump_seed": 3,
                "bump": 0.02}
# The backward-facing step of OBSTACLE_RUNS (Re 150, 128 x 32) in f64 to
# epsilon 1e-9, 2 steps by the masked mg from rest with u and v perturbed
# by one draw; loss and the directional derivative w.r.t. the initial u
# (the masked adjoint).
DIFF_MASKED = {"model": "backward_facing_step",
               "kwargs": {"Re": 150.0, "nx": 128, "ny": 32},
               "dtype": "float64", "epsilon": 1e-9, "steps": 2,
               "method": "mg", "bump_seed": 11, "bump": 0.02,
               "direction_seed": 13}
# configs/1.in through the JAX CLI with the compensated outer.
COMPENSATED_CLI = {
    "k64": ["configs/1.in", "--outer", "compensated", "--stats"],
    "k2048": ["configs/1.in", "--outer", "compensated", "--refine-every",
              "2048", "--stats"],
    "sharded rb_sor": ["configs/1.in", "--outer", "compensated",
                       "--backend", "sharded", "--mesh", "1x1", "--stats"],
    "sharded mg": ["configs/1.in", "--outer", "compensated", "--backend",
                   "sharded", "--mesh", "1x1", "--method", "mg", "--stats"],
}
# members copies of configs/1.in's 256^2 cavity (f32, max_it cut to
# 2000), member k's u perturbed by scale * k (member 0 at rest), by each
# method through solve_ensemble.
ENSEMBLE = {"config": "configs/1.in", "dtype": "float32", "max_it": 2000,
            "members": 8, "seed": 5, "scale": 0.01,
            "methods": ["rb_sor", "fft", "mg"]}


def perturbation(shape, seed: int, scale: float, rng=None) -> np.ndarray:
    """scale * standard normal of default_rng(seed) (or of `rng`) on the
    interior of a padded (ni + 2, nj + 2) field."""
    rng = np.random.default_rng(seed) if rng is None else rng
    out = np.zeros(shape)
    out[1:-1, 1:-1] = scale * rng.standard_normal((shape[0] - 2,
                                                   shape[1] - 2))
    return out


def record_diff(path: str) -> None:
    import time

    import jax.numpy as jnp

    from navierstokes_parallel_tpu import diff
    from navierstokes_parallel_tpu.models import convection

    out = {}
    d = DIFF_CAVITY
    prm = Params.from_file(os.path.join(ROOT, d["config"]),
                           dtype=d["dtype"], epsilon=d["epsilon"])
    base = allocate_state(prm)
    base = base._replace(u=base.u + perturbation(prm.shape, d["bump_seed"],
                                                 d["bump"]))
    direction = jnp.asarray(perturbation(prm.shape, d["direction_seed"],
                                         1.0))

    def loss(lid_scale, u0):
        c = diff.default_controls(prm)._replace(lid_scale=lid_scale)
        final, _ = diff.solve_n_steps(prm, base._replace(u=u0), d["steps"],
                                      controls=c,
                                      pressure_method=d["method"])
        return (jnp.sum(final.u[1:-1, 1:-1] ** 2)
                + jnp.sum(final.v[1:-1, 1:-1] ** 2))

    t0 = time.perf_counter()
    one = jnp.asarray(1.0, jnp.float64)
    g_lid, g_u = jax.grad(loss, argnums=(0, 1))(one, base.u)
    seconds = time.perf_counter() - t0
    h, hd = d["h_lid"], d["h_dir"]
    out["cavity"] = {
        **d, "loss": float(loss(one, base.u)), "grad_lid": float(g_lid),
        "directional": float(jnp.sum(g_u * direction)),
        "fd_lid": (float(loss(one + h, base.u))
                   - float(loss(one - h, base.u))) / (2 * h),
        "fd_dir": (float(loss(one, base.u + hd * direction))
                   - float(loss(one, base.u - hd * direction))) / (2 * hd),
        "jax_cpu_grad_seconds": seconds}
    print("cavity", out["cavity"], flush=True)

    d = DIFF_THERMAL
    prm = Params.from_file(os.path.join(ROOT, d["config"]),
                           dtype=d["dtype"], epsilon=d["epsilon"])
    cfg = convection.config_from_params(prm)
    ts = convection.allocate_thermal(prm, cfg)
    rng = np.random.default_rng(d["bump_seed"])
    ts = ts._replace(u=ts.u + perturbation(prm.shape, 0, d["bump"], rng),
                     v=ts.v + perturbation(prm.shape, 0, d["bump"], rng))

    def nusselt(t_left):
        final, _ = diff.solve_thermal_n_steps(
            prm, ts, d["steps"], cfg._replace(t_left=t_left),
            pressure_method=d["method"])
        return jnp.mean(-2.0 * (final.T[1, 1:-1] - t_left) * prm.i_max)

    t_left = jnp.asarray(cfg.t_left, jnp.float64)
    out["thermal"] = {**d, "t_left": float(cfg.t_left),
                      "nu_hot": float(nusselt(t_left)),
                      "grad_t_left": float(jax.grad(nusselt)(t_left))}
    print("thermal", out["thermal"], flush=True)

    d = DIFF_MASKED
    prm = step_model.backward_facing_step(**d["kwargs"], dtype=d["dtype"],
                                          epsilon=d["epsilon"])
    base = allocate_state(prm)
    bump = perturbation(prm.shape, d["bump_seed"], d["bump"])
    base = base._replace(u=base.u + bump, v=base.v + bump)
    direction = jnp.asarray(perturbation(prm.shape, d["direction_seed"],
                                         1.0))

    def masked_loss(u0):
        final, _ = diff.solve_n_steps(prm, base._replace(u=u0), d["steps"],
                                      pressure_method=d["method"])
        return (jnp.sum(final.u[1:-1, 1:-1] ** 2)
                + jnp.sum(final.v[1:-1, 1:-1] ** 2))

    out["masked"] = {**d, "loss": float(masked_loss(base.u)),
                     "directional": float(jnp.sum(
                         jax.grad(masked_loss)(base.u) * direction))}
    print("masked", out["masked"], flush=True)
    _update(path, "diff", out)


def record_compensated(path: str) -> None:
    out = {}
    for tag, argv in COMPENSATED_CLI.items():
        out[tag] = _cli_record(argv)
        print(tag, out[tag], flush=True)
    _update(path, "compensated", out)


def ensemble_members(prm, e: dict):
    """The ensemble's initial states: member k's u perturbed by
    scale * k * standard normal of one default_rng(seed), drawn in turn."""
    rng = np.random.default_rng(e["seed"])
    members = []
    for k in range(e["members"]):
        s = allocate_state(prm)
        du = perturbation(prm.shape, 0, e["scale"] * k, rng)
        members.append(s._replace(u=s.u + du.astype(prm.jnp_dtype)))
    return members


def record_ensemble(path: str) -> None:
    import time

    e = ENSEMBLE
    prm = Params.from_file(os.path.join(ROOT, e["config"]),
                           dtype=e["dtype"], max_it=e["max_it"])
    out = {}
    for method in e["methods"]:
        t0 = time.perf_counter()
        state, stats = solver.solve_ensemble(
            prm, solver.stack_states(ensemble_members(prm, e)),
            pressure_method=method)
        i_c, j_c = prm.i_max // 2, prm.j_max // 2
        out[method] = {
            "steps": np.asarray(stats.steps).tolist(),
            "iterations": np.asarray(stats.total_sor_iterations).tolist(),
            "failures": np.asarray(stats.sor_failures).tolist(),
            "t": np.asarray(state.t).tolist(),
            "centre": [[float(state.u[k, i_c, j_c]),
                        float(state.v[k, i_c, j_c])]
                       for k in range(e["members"])],
            "max_abs_u": np.abs(np.asarray(state.u)[:, 1:-1, 1:-1]).max(
                axis=(1, 2)).tolist(),
            "jax_cpu_seconds": time.perf_counter() - t0}
        print(method, out[method], flush=True)
    _update(path, "ensemble", {**e, "runs": out})


def _steps(fn, carry, n):
    iters, failures, per_step = 0, 0, []
    for _ in range(n):
        carry, diag = fn(carry)
        per_step.append(int(diag.sor_iterations))
        failures += 0 if bool(diag.sor_converged) else 1
    return carry, sum(per_step), failures, per_step


def record_channel(n_steps: int) -> None:
    prm = Params.from_file(os.path.join(ROOT, "configs", "channel.in"))
    for order in (1, 2):
        if order == 1:
            fn, carry = solver.make_step_fn(prm), allocate_state(prm)
        else:
            fn = solver.make_ab2_step_fn(prm)
            carry = solver.ab2_init(allocate_state(prm))
        carry, iters, failures, per_step = _steps(fn, carry, n_steps)
        state = carry if order == 1 else carry.s
        uc, vc = (float(x) for x in solver.center_values(state, prm))
        quanta = [n // prm.sor_refine_every for n in per_step]
        print(f"channel order={order} steps={n_steps} sor_iterations={iters} "
              f"sor_failures={failures} centre={uc:.6f},{vc:.6f} "
              f"profile_errors="
              f"{channel.profile_errors(np.asarray(state.u), prm)!r} "
              f"passes_per_step={quanta}")


def record_taylor_green(n: int, n_steps: int) -> None:
    prm, state = taylorgreen.taylor_green(n=n)
    fn = solver.make_ab2_step_fn(prm, "mg")
    carry, iters, failures, per_step = _steps(fn, solver.ab2_init(state),
                                              n_steps)
    state = carry.s
    uc, vc = (float(x) for x in solver.center_values(state, prm))
    print(f"taylor-green n={n} steps={n_steps} sor_iterations={iters} "
          f"per_step={per_step} sor_failures={failures} "
          f"centre={uc:.6f},{vc:.6f} errors="
          f"{taylorgreen.errors(state, prm)!r} kinetic_energy="
          f"{taylorgreen.kinetic_energy(state, prm)!r}")


def obstacle_setup(model: str, kwargs: dict, record: str):
    """(params, initial state, record function or None) of a run."""
    if model == "backward_facing_step":
        prm = step_model.backward_facing_step(**kwargs)
        return prm, allocate_state(prm), None
    prm = getattr(karman, model)(**kwargs)
    probe = karman.probe_node(prm)
    fn = {"force": karman.force_record_fn,
          "surface_force": karman.surface_force_record_fn}[record]
    return prm, karman.initial_state(prm, perturb=0.3), fn(prm, 5, *probe)


def record_obstacles(path: str) -> None:
    import contextlib
    import io
    import json

    from navierstokes_parallel_tpu import cli

    out = {"runs": {}, "cli": {}}
    for name, (model, kwargs, method, order, n_steps,
               record) in OBSTACLE_RUNS.items():
        prm, state, record_fn = obstacle_setup(model, kwargs, record)
        if order == 1:
            fn, carry = solver.make_step_fn(prm, method), state
        else:
            fn = solver.make_ab2_step_fn(prm, method)
            carry = solver.ab2_init(state)
        rec = jax.jit(record_fn) if record_fn else None
        iters, converged, records = [], [], {}
        for _ in range(n_steps):
            carry, diag = fn(carry)
            iters.append(int(diag.sor_iterations))
            converged.append(bool(diag.sor_converged))
            base = carry if order == 1 else carry.s
            for key, val in (rec(base) if rec else {}).items():
                records.setdefault(key, []).append(float(val))
        base = carry if order == 1 else carry.s
        uc, vc = (float(x) for x in solver.center_values(base, prm))
        out["runs"][name] = {
            "model": model, "kwargs": kwargs, "method": method,
            "time_order": order, "steps": n_steps, "record": record,
            "iterations": iters, "converged": converged, "records": records,
            "centre": [uc, vc],
            "max_abs": [float(np.max(np.abs(np.asarray(base.u)))),
                        float(np.max(np.abs(np.asarray(base.v))))]}
        print(name, prm.shape, iters, converged, [uc, vc], flush=True)
    printed, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(err):
        rc = cli.main([os.path.join(ROOT, OBSTACLE_CLI[0]),
                       *OBSTACLE_CLI[1:]])
    stats = next(line for line in err.getvalue().splitlines()
                 if line.startswith("steps="))
    # The CLI's steps one by one (its host loop steps make_step_fn of the
    # CLI's method, rb_sor on the CPU): the iterations per step.
    prm = Params.from_file(os.path.join(ROOT, OBSTACLE_CLI[0]),
                           obstacles=((17, 24, 27, 34),))
    fn, carry = solver.make_step_fn(prm, "rb_sor"), allocate_state(prm)
    iters = []
    for _ in range(int(OBSTACLE_CLI[OBSTACLE_CLI.index("--max-steps") + 1])):
        carry, diag = fn(carry)
        iters.append(int(diag.sor_iterations))
    out["cli"] = {"argv": OBSTACLE_CLI, "rc": rc,
                  "stdout": printed.getvalue().splitlines(),
                  "stats": dict(tok.split("=") for tok in stats.split()),
                  "iterations": iters}
    print("cli", out["cli"])
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


def _cli_record(argv) -> dict:
    """The JAX CLI on `argv` (paths relative to the checkout): rc, standard
    output lines and the stats line as a dict."""
    import contextlib
    import io

    from navierstokes_parallel_tpu import cli

    printed, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(err):
        rc = cli.main([os.path.join(ROOT, argv[0]), *argv[1:]])
    stats = next(line for line in err.getvalue().splitlines()
                 if line.startswith("steps="))
    return {"argv": argv, "rc": rc,
            "stdout": [line for line in printed.getvalue().splitlines()
                       if line.startswith(("U-CENTER", "V-CENTER"))],
            "stats": dict(tok.split("=") for tok in stats.split())}


def _update(path: str, section: str, value) -> None:
    import json

    out = {}
    if os.path.exists(path):
        with open(path) as fh:
            out = json.load(fh)
    out[section] = value
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


def record_thermal(path: str) -> None:
    from navierstokes_parallel_tpu.models import convection

    prm = Params.from_file(os.path.join(ROOT, THERMAL_CONFIG))
    cfg = convection.config_from_params(prm)
    runs = {}
    for tag, extra in THERMAL_CLI.items():
        argv = [THERMAL_CONFIG, "--max-steps", str(THERMAL_STEPS), "--stats",
                *extra]
        rec = _cli_record(argv)
        # The CLI's steps one by one (the host loop's step of the CLI's
        # method on the CPU: rb_sor, or mg).
        method = "mg" if "mg" in extra else "rb_sor"
        state = convection.allocate_thermal(prm, cfg)
        if "--time-order" in extra:
            fn = convection.make_thermal_step_ab2_fn(prm, cfg, method)
            carry = convection.thermal_ab2_init(state)
        else:
            fn, carry = convection.make_thermal_step_fn(prm, cfg, method), \
                state
        carry, _, _, rec["iterations"] = _steps(fn, carry, THERMAL_STEPS)
        ts = carry.ts if "--time-order" in extra else carry
        rec["nusselt"] = [convection.nusselt_hot_wall(ts.T, prm),
                          convection.nusselt_cold_wall(ts.T, prm)]
        runs[tag] = rec
        print(tag, rec, flush=True)
    kwargs, n_steps = THERMAL_BLOCK
    bprm, bcfg = convection.heated_block_setup(**kwargs)
    fn = convection.make_thermal_step_fn(bprm, bcfg, "rb_sor")
    carry, _, failures, iters = _steps(
        fn, convection.allocate_thermal(bprm, bcfg), n_steps)
    uc, vc = (float(x) for x in solver.center_values(carry, bprm))
    runs["heated block"] = {
        "kwargs": kwargs, "steps": n_steps, "iterations": iters,
        "failures": failures, "centre": [uc, vc],
        "max_abs": [float(np.max(np.abs(np.asarray(carry.u)))),
                    float(np.max(np.abs(np.asarray(carry.v))))],
        "max_T": float(np.max(np.asarray(carry.T)[1:-1, 1:-1])),
        "block_flux": convection.block_heat_flux(carry.T, bprm,
                                                 bcfg.t_obstacle)}
    print("heated block", runs["heated block"], flush=True)
    # The witness: the whole run by the CLI's method on the CPU.
    ts, stats = convection.thermal_solve(prm, cfg, pressure_method="rb_sor")
    uc, vc = (float(x) for x in solver.center_values(ts, prm))
    runs["witness"] = {
        "argv": [THERMAL_CONFIG], "method": "rb_sor",
        "steps": int(stats.steps),
        "sor_iterations": int(stats.total_sor_iterations),
        "sor_failures": int(stats.sor_failures), "centre": [uc, vc],
        "nusselt_hot": convection.nusselt_hot_wall(ts.T, prm),
        "nusselt_cold": convection.nusselt_cold_wall(ts.T, prm)}
    print("witness", runs["witness"], flush=True)
    _update(path, "thermal", runs)


def record_sharded_obstacles(path: str) -> None:
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    mesh = make_grid_mesh(1)
    runs = {}
    for name, (model, kwargs, order, n_steps) in \
            SHARDED_OBSTACLE_RUNS.items():
        prm, state, _ = obstacle_setup(model, kwargs, "surface_force")
        stepper = sharded.ShardedStepper(prm, state, mesh, "rb_sor", order)
        iters, converged = [], []
        for _ in range(n_steps):
            diag = stepper.step()
            iters.append(int(diag.sor_iterations))
            converged.append(bool(diag.sor_converged))
        base = stepper.state()
        uc, vc = (float(x) for x in solver.center_values(base, prm))
        runs[name] = {
            "model": model, "kwargs": kwargs, "method": "rb_sor",
            "time_order": order, "steps": n_steps, "iterations": iters,
            "converged": converged, "centre": [uc, vc],
            "max_abs": [float(np.max(np.abs(np.asarray(base.u)))),
                        float(np.max(np.abs(np.asarray(base.v))))]}
        print(name, prm.shape, runs[name], flush=True)
    rec = _cli_record(SHARDED_OBSTACLE_CLI)
    prm = Params.from_file(os.path.join(ROOT, SHARDED_OBSTACLE_CLI[0]),
                           obstacles=((17, 24, 27, 34),))
    stepper = sharded.ShardedStepper(prm, allocate_state(prm), mesh,
                                     "rb_sor")
    rec["iterations"] = [
        int(stepper.step().sor_iterations) for _ in range(int(
            SHARDED_OBSTACLE_CLI[SHARDED_OBSTACLE_CLI.index("--max-steps")
                                 + 1]))]
    runs["cli"] = rec
    print("cli", rec, flush=True)
    _update(path, "sharded_obstacles", runs)


def record_sharded_thermal(path: str) -> None:
    from navierstokes_parallel_tpu.models import convection
    from navierstokes_parallel_tpu.parallel import sharded_thermal
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    mesh = make_grid_mesh(1)
    prm = Params.from_file(os.path.join(ROOT, THERMAL_CONFIG))
    cfg = convection.config_from_params(prm)
    runs = {}
    for method in SHARDED_THERMAL_METHODS:
        rec = _cli_record([THERMAL_CONFIG, "--backend", "sharded", "--mesh",
                           "1x1", "--method", method, "--max-steps",
                           str(SHARDED_THERMAL_STEPS), "--stats"])
        stepper = sharded_thermal.ThermalShardedStepper(
            prm, cfg, convection.allocate_thermal(prm, cfg), mesh, method)
        iters, converged = [], []
        for _ in range(SHARDED_THERMAL_STEPS):
            diag = stepper.step()
            iters.append(int(diag.sor_iterations))
            converged.append(bool(diag.sor_converged))
        rec.update(method=method, steps=SHARDED_THERMAL_STEPS,
                   iterations=iters, converged=converged)
        runs[method] = rec
        print(method, rec["stats"], rec["stdout"], flush=True)
    _update(path, "sharded_thermal", runs)


def record_free(path: str) -> None:
    from navierstokes_parallel_tpu.models import freesurface as FS

    whole = _cli_record(FREE_CLI)
    cut = _cli_record([*FREE_CLI, "--max-steps", str(FREE_CUT)])
    prm = Params.from_file(os.path.join(ROOT, FREE_CLI[0]))
    fs = FS.initial_free_state(prm)
    fn = FS.make_free_step_fn(prm, "freeslip")
    per_step = {key: [] for key in (
        "t", "dt", "iterations", "converged", "centre", "fluid_volume",
        "front_position", "column_height")}
    T = float(np.asarray(prm.T, prm.jnp_dtype))
    while float(fs.state.t) < T:
        fs, diag = fn(fs)
        per_step["t"].append(float(fs.state.t))
        per_step["dt"].append(float(diag.dt))
        per_step["iterations"].append(int(diag.sor_iterations))
        per_step["converged"].append(bool(diag.sor_converged))
        per_step["centre"].append(
            [float(x) for x in solver.center_values(fs.state, prm)])
        per_step["fluid_volume"].append(FS.fluid_volume(fs, prm))
        per_step["front_position"].append(FS.front_position(fs))
        per_step["column_height"].append(FS.column_height(fs))
    init = FS.initial_free_state(prm)
    out = {"argv": FREE_CLI, "cut": FREE_CUT, "whole": whole,
           "cut_cli": cut, "initial": {
               "fluid_volume": FS.fluid_volume(init, prm),
               "front_position": FS.front_position(init),
               "column_height": FS.column_height(init),
               "particles": int(np.sum(np.asarray(init.pset.active)))},
           "per_step": per_step}
    print("whole", whole, "cut", cut, "steps", len(per_step["t"]),
          flush=True)
    _update(path, "free", out)


# The gspmd backend's runs (record_gspmd): chip_smoke.py's "gspmd" phase on
# a 1x1 mesh (name: configuration or model, pressure method, steps; the
# cavity of configs/1.in by every method, configs/4.in by mg, convection
# by mg, the dam break with free-slip walls, the square cylinder of
# OBSTACLE_RUNS by the masked mg from initial_state(perturb=0.3)), and
# tests/test_torch_gspmd.py's cases on a 2x2 mesh of four CPU devices
# (GSPMD_SMALL's fields at each size of GSPMD_SIZES by every method, and
# the AB2 and obstacle cases of GSPMD_CASES).
GSPMD_RECORDS = "tests/jax_gspmd_records.json"
GSPMD_RUNS = {
    "cavity rb_sor": ("configs/1.in", "rb_sor", 1),
    "cavity jacobi": ("configs/1.in", "jacobi", 1),
    "cavity cg": ("configs/1.in", "cg", 1),
    "cavity mg": ("configs/1.in", "mg", 3),
    "cavity fft": ("configs/1.in", "fft", 3),
    "big mg": ("configs/4.in", "mg", 4),
    "convection mg": ("configs/convection.in", "mg", 300),
    "dambreak": ("configs/dambreak.in", "freeslip", 60),
    "square_cylinder mg": ("square_cylinder", "mg", 5),
}
GSPMD_SMALL = {"problem": 1, "T": 0.05, "Re": 100.0, "tau": 0.5,
               "omega": 1.7, "epsilon": 1e-4, "max_it": 500,
               "dtype": "float32"}
GSPMD_SIZES = (16, 17, 18)
GSPMD_METHODS = ("rb_sor", "jacobi", "mg", "cg", "fft")
# tag: (extra fields over GSPMD_SMALL, pressure method, time order).
GSPMD_CASES = {
    "ab2 mg 16": ({"i_max": 16, "j_max": 16}, "mg", 2),
    "ab2 rb_sor 18": ({"i_max": 18, "j_max": 18}, "rb_sor", 2),
    "obstacle rb_sor 16": ({"i_max": 16, "j_max": 16,
                            "obstacles": [[6, 10, 6, 10]]}, "rb_sor", 1),
    "obstacle mg 16": ({"i_max": 16, "j_max": 16,
                        "obstacles": [[6, 10, 6, 10]]}, "mg", 1),
    "obstacle mg 18": ({"i_max": 18, "j_max": 18,
                        "obstacles": [[6, 10, 6, 10]]}, "mg", 1),
}
# The CLI on a 2x2 mesh (a parameter file written from GSPMD_SMALL at
# 16^2 with T = 0.2 by the test, the path given as {path}).
GSPMD_CLI = ["{path}", "--backend", "gspmd", "--mesh", "2x2", "--method",
             "mg", "--stats"]


def gspmd_params(fields: dict) -> Params:
    """GSPMD_SMALL with `fields` (obstacles as tuples)."""
    kw = {**GSPMD_SMALL, **fields}
    if "obstacles" in kw:
        kw["obstacles"] = tuple(tuple(o) for o in kw["obstacles"])
    return Params(**kw)


def _gspmd_steps(stepper, n_steps=None, T=None):
    """Step to `n_steps` (or t >= T): per step iterations and convergence,
    and t after each."""
    iters, converged, ts = [], [], []
    while (len(iters) < n_steps) if n_steps else (stepper.t < T):
        diag = stepper.step()
        iters.append(int(diag.sor_iterations))
        converged.append(bool(diag.sor_converged))
        ts.append(stepper.t)
    return {"iterations": iters, "converged": converged, "t": ts}


def _summary(state, prm) -> dict:
    uc, vc = (float(x) for x in solver.center_values(state, prm))
    return {"centre": [uc, vc],
            "max_abs": [float(np.max(np.abs(np.asarray(state.u)))),
                        float(np.max(np.abs(np.asarray(state.v))))]}


def record_gspmd(path: str) -> None:
    from jax.sharding import Mesh

    from navierstokes_parallel_tpu.models import convection
    from navierstokes_parallel_tpu.models import freesurface as FS
    from navierstokes_parallel_tpu.parallel import gspmd

    one = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("x", "y"))
    runs = {}
    for name, (what, method, n_steps) in GSPMD_RUNS.items():
        rec = {"config": what, "method": method, "steps": n_steps}
        if what == "square_cylinder":
            prm, state, _ = obstacle_setup(what, {"n_per_d": 8}, "force")
            rec["kwargs"] = {"n_per_d": 8}
        else:
            prm = Params.from_file(os.path.join(ROOT, what))
        if prm.problem == 5:
            cfg = convection.config_from_params(prm)
            stepper = convection.ThermalGspmdStepper(
                prm, cfg, convection.allocate_thermal(prm, cfg), mesh=one,
                pressure_method=method)
            rec.update(_gspmd_steps(stepper, n_steps))
            final = stepper.state()
        elif prm.problem == 6:
            fn = FS.make_free_step_gspmd(prm, one, wall=method)
            fs = FS.place_free(FS.initial_free_state(prm), prm, one)
            per = {"iterations": [], "converged": [], "t": []}
            for _ in range(n_steps):
                fs, diag = fn(fs)
                per["iterations"].append(int(diag.sor_iterations))
                per["converged"].append(bool(diag.sor_converged))
                per["t"].append(float(fs.state.t))
            final_fs = FS.fetch_free(fs, prm)
            rec.update(per, fluid_volume=FS.fluid_volume(final_fs, prm))
            final = final_fs.state
        else:
            if what != "square_cylinder":
                state = allocate_state(prm)
            stepper = gspmd.GspmdStepper(prm, state, mesh=one,
                                         pressure_method=method)
            rec.update(_gspmd_steps(stepper, n_steps))
            final = stepper.state()
        rec.update(_summary(final, prm))
        runs[name] = rec
        print(name, prm.shape, sum(rec["iterations"]), rec["centre"],
              flush=True)
    _update(path, "chip", runs)

    four = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    cases = {}
    todo = {f"{m} {n}": ({"i_max": n, "j_max": n}, m, 1)
            for n in GSPMD_SIZES for m in GSPMD_METHODS}
    todo.update(GSPMD_CASES)
    for tag, (fields, method, order) in todo.items():
        prm = gspmd_params(fields)
        stepper = gspmd.GspmdStepper(prm, allocate_state(prm), mesh=four,
                                     pressure_method=method,
                                     time_order=order)
        rec = {"fields": fields, "method": method, "time_order": order,
               **_gspmd_steps(stepper, T=float(np.float32(prm.T)))}
        rec.update(_summary(stepper.state(), prm))
        cases[tag] = rec
        print(tag, rec["iterations"], rec["centre"], flush=True)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        prm_path = os.path.join(tmp, "gspmd16.in")
        gspmd_params({"i_max": 16, "j_max": 16, "T": 0.2}).to_file(prm_path)
        cli = _cli_record([a.format(path=prm_path) for a in GSPMD_CLI])
    cli["argv"] = GSPMD_CLI
    cases["cli"] = cli
    print("cli", cli, flush=True)
    _update(path, "mesh_2x2", cases)


if __name__ == "__main__":
    what, *args = sys.argv[1:]
    if what == "channel":
        record_channel(int(args[0]))
    elif what == "taylor-green":
        record_taylor_green(int(args[0]), int(args[1]))
    elif what == "obstacles":
        record_obstacles(args[0])
    elif what == "thermal":
        record_thermal(args[0])
    elif what == "sharded-obstacles":
        record_sharded_obstacles(args[0])
    elif what == "sharded-thermal":
        record_sharded_thermal(args[0])
    elif what == "free":
        record_free(args[0])
    elif what == "gspmd":
        record_gspmd(args[0] if args else os.path.join(ROOT, GSPMD_RECORDS))
    elif what in ("diff", "compensated", "ensemble"):
        {"diff": record_diff, "compensated": record_compensated,
         "ensemble": record_ensemble}[what](
            args[0] if args else os.path.join(ROOT, A9_RECORDS))
    else:
        sys.exit(f"unknown record {what!r}: channel, taylor-green, "
                 f"obstacles, thermal, sharded-obstacles, sharded-thermal, "
                 f"free, gspmd, diff, compensated or ensemble")
