"""The JAX package's records for the port's chip check (chip_smoke.py) that
its CLI does not print: the channel's profile errors after N steps and the
Taylor-Green AB2 run's counts and errors.  Run on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_records.py channel 50
    JAX_PLATFORMS=cpu python tests/jax_records.py taylor-green 1024 3

``channel N``: configs/channel.in, N steps from rest by the CLI's method
on the CPU (rb_sor), Euler and AB2: counts, centre values,
``models/channel.py::profile_errors`` of the final u and each step's
outer passes (sweeps / K).  ``taylor-green n
N``: ``models/taylorgreen.py::taylor_green(n)``, N steps of ``step_ab2``
with the multigrid pressure solve (the port's ``solve_ab2(...,
max_steps=N)``): counts, per-step V-cycles, centre values, ``errors`` and
``kinetic_energy``.  A script, not a test module: it imports JAX, which
the port never does.
"""

import os
import sys

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # run as a script from the root of a checkout
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from navierstokes_parallel_tpu import solver  # noqa: E402
from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.grid import allocate_state  # noqa: E402
from navierstokes_parallel_tpu.models import channel  # noqa: E402
from navierstokes_parallel_tpu.models import taylorgreen  # noqa: E402


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


if __name__ == "__main__":
    what, *args = sys.argv[1:]
    if what == "channel":
        record_channel(int(args[0]))
    elif what == "taylor-green":
        record_taylor_green(int(args[0]), int(args[1]))
    else:
        sys.exit(f"unknown record {what!r}: channel or taylor-green")
