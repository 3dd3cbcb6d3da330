#!/usr/bin/env python3
"""Which rounding moves the plane channel's outer passes on a CUDA card.

    python3 scripts/torch_channel_witness.py   # from the root of a checkout

configs/channel.in (128 x 64, problem 3), chip_smoke.CHANNEL_STEPS steps
from rest through the PyTorch port, stepped as chip_smoke.py's channel
phase steps it (chip_smoke.stepped_channel), by Euler and by AB2, in these
variants:

  * ``card``: the path as it runs on the card;
  * ``card, B2 barred``: F, G and the rhs from the plain ``compute_fg`` /
    ``compute_rhs`` (true divisions) in place of the fused kernel, whose
    constants are reciprocals (Euler only: AB2 never takes it);
  * ``card, reductions on the host``: every ``torch.sum`` and
    ``torch.mean`` of the path (the flux balance's q_in and q_out, the rhs
    mean, the defect mean, the residual norms) taken on the CPU in
    PyTorch's CPU order;
  * ``card, B2 barred, reductions on the host``: both;
  * ``cpu``: the port on the CPU;
  * three controls, each a fault that a port could make: in the pressure
    solve's f64 outer, ``control: f32 defect mean`` (the deflation of
    every defect rounded to f32) and ``control: f32 outer`` (every defect
    formed from p rounded to f32); in the boundary conditions, ``control:
    no flux balance`` (the outflow edge left uncorrected).

For each variant it prints the sweeps, the steps whose passes differ from
JAX's record (chip_smoke.JAX_CHANNEL_PASSES) with the margin (norm -
threshold) / threshold of the deciding pass, whether chip_smoke's
per-step gate (chip_smoke.channel_gate) holds the run, and its final u, v
and p against the CPU run's: bit for bit or the max abs difference.

Then it takes the Euler steps apart (``lockstep``): each stage of each
step on the card and on the CPU from the same inputs, bit for bit or the
max abs difference, and every outer pass of the first pressure solve that
differs with its reductions on the host (``probe_solve``).  Exits 1 when
no CUDA card is present.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))  # run as a script from the root of a checkout


@contextlib.contextmanager
def host_reductions(torch):
    """torch.sum and torch.mean of a CUDA tensor taken on the CPU (the
    result goes back to the tensor's device) for the block.  The copy keeps
    the tensor's strides: the CPU adds a strided view (the rhs interior) in
    another order than a contiguous copy of it."""
    saved = torch.sum, torch.mean

    def on_host(fn):
        def reduce(x, *args, **kw):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                y = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype)
                return fn(y.copy_(x), *args, **kw).to(x.device)
            return fn(x, *args, **kw)
        return reduce

    torch.sum, torch.mean = on_host(saved[0]), on_host(saved[1])
    try:
        yield
    finally:
        torch.sum, torch.mean = saved


@contextlib.contextmanager
def b2_barred():
    """The solver takes the plain F, G and rhs for the block."""
    from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

    saved = momentum_kernel.usable
    momentum_kernel.usable = lambda *_args, **_kw: False
    try:
        yield
    finally:
        momentum_kernel.usable = saved


@contextlib.contextmanager
def no_flux_balance():
    """The channel's BCs without the flux balance of the outflow edge for
    the block (ops/boundary.py::apply_channel_bcs less its correction)."""
    from navierstokes_parallel_tpu_torch.ops import boundary

    saved = boundary.apply_channel_bcs

    def bcs(u, v, params):
        boundary.set_inflow(u, v, boundary.Side.LEFT,
                            boundary._inflow(params, u.dtype, u.device), 0.0)
        boundary.set_outflow(u, v, boundary.Side.RIGHT)
        boundary.set_noslip(u, v, boundary.Side.BOTTOM)
        boundary.set_noslip(u, v, boundary.Side.TOP)
        return u, v

    boundary.apply_channel_bcs = bcs
    try:
        yield
    finally:
        boundary.apply_channel_bcs = saved


def control_hooks(torch, name: str) -> dict:
    from navierstokes_parallel_tpu_torch.ops import sor

    if name == "control: f32 defect mean":
        return {"mean_fn": lambda r: torch.mean(r.float()).double()}
    if name == "control: f32 outer":
        return {"ghost_fn": lambda p: sor.ghost_fill(p).float().double()}
    return {}


def probe_solve(torch, prm, p, rhs) -> dict:
    """One pressure solve from (p, rhs) on the CPU and on the card (its
    reductions on the host), every outer pass's inner call recorded: the
    passes of each, the passes at which the card's kernel, given the CPU's
    inner input, returns other bits than the CPU's twin, and the first
    pass at which the card solve's inner input, and its output, departs
    from the CPU solve's."""
    from navierstokes_parallel_tpu_torch.ops import sor
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    real = sor_kernel.inner_sweeps
    calls = {"cpu": [], "card": []}
    twin_differs = []

    def recorded(rhs_full, n, params):
        out = real(rhs_full, n, params)
        if rhs_full.is_cuda:
            calls["card"].append((rhs_full.cpu(), out.cpu()))
        else:
            calls["cpu"].append((rhs_full.clone(), out.clone()))
            if not torch.equal(real(rhs_full.cuda(), n, params).cpu(), out):
                twin_differs.append(len(calls["cpu"]) - 1)
        return out

    sor_kernel.inner_sweeps = recorded
    try:
        sor.solve_pressure(p, rhs, prm, method="rb_sor")
        with host_reductions(torch):
            sor.solve_pressure(p.cuda(), rhs.cuda(), prm,
                               method="pallas_sor")
    finally:
        sor_kernel.inner_sweeps = real
    pairs = list(zip(calls["cpu"], calls["card"]))
    return {"passes": [len(calls["cpu"]), len(calls["card"])],
            "kernel_vs_cpu_twin_differs_at": twin_differs,
            "first_input_departs": next(
                (k for k, (a, b) in enumerate(pairs)
                 if not torch.equal(a[0], b[0])), None),
            "first_output_departs": next(
                (k for k, (a, b) in enumerate(pairs)
                 if not torch.equal(a[1], b[1])), None)}


def lockstep(torch, prm):
    """CHANNEL_STEPS Euler steps of the channel on the CPU, each stage of
    each step (solver.step's, in its order) also taken on the card from
    the CPU's inputs of that stage: F, G and the rhs by the plain
    compute_fg / compute_rhs and by B2, the pressure solve with the card's
    reductions and with them on the host.  Returns {stage: (the steps at
    which the card's output differed from the CPU's, the max abs
    difference)}, with "probe": probe_solve of the first step whose solve
    differs with the reductions on the host, and the final state on the
    CPU."""
    import chip_smoke
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.grid import State
    from navierstokes_parallel_tpu_torch.ops import boundary, momentum, sor
    from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

    out = {}

    def held(name, k, cpu, card):
        steps, worst = out.setdefault(name, ([], 0.0))
        diff = max(float((a.double() - b.cpu().double()).abs().max())
                   for a, b in zip(cpu, card))
        if not all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)):
            steps.append(k)
        out[name] = (steps, max(worst, diff))

    def cuda(*args):
        return [a.cuda() for a in args]

    state = solver.allocate_state(prm, "cpu")
    for k in range(chip_smoke.CHANNEL_STEPS):
        u, v, p, t, n = state
        u, v = u.clone(), v.clone()
        dt, gamma = momentum.adaptive_dt_gamma(u, v, prm)
        held("adaptive_dt_gamma", k, (dt, gamma),
             momentum.adaptive_dt_gamma(*cuda(u, v), prm))
        card = boundary.apply_channel_bcs(*cuda(u, v), prm)
        boundary.apply_channel_bcs(u, v, prm)
        held("apply_channel_bcs", k, (u, v), card)
        F, G = momentum.compute_fg(u, v, dt, gamma, prm)
        held("compute_fg", k, (F, G),
             momentum.compute_fg(*cuda(u, v, dt, gamma), prm))
        rhs = momentum.compute_rhs(F, G, dt, prm)
        held("compute_rhs", k, (rhs,),
             (momentum.compute_rhs(*cuda(F, G, dt), prm),))
        held("momentum_rhs (B2)", k, (F, G, rhs),
             momentum_kernel.momentum_rhs(*cuda(u, v, dt, gamma), prm))
        res = sor.solve_pressure(p, rhs, prm, method="rb_sor")
        card = sor.solve_pressure(*cuda(p, rhs), prm, method="pallas_sor")
        held("solve_pressure", k, (res.p,), (card.p,))
        with host_reductions(torch):
            card = sor.solve_pressure(*cuda(p, rhs), prm,
                                      method="pallas_sor")
        held("solve_pressure, reductions on the host", k, (res.p,),
             (card.p,))
        if "probe" not in out and not torch.equal(res.p, card.p.cpu()):
            out["probe"] = {"step": k, **probe_solve(torch, prm, p, rhs)}
        card = momentum.project_velocities(
            *cuda(u, v, F, G, res.p, dt), prm)
        momentum.project_velocities(u, v, F, G, res.p, dt, prm)
        held("project_velocities", k, (u, v), card)
        state = State(u=u, v=v, p=res.p, t=t + dt, n=n + 1)
    return out, state


def main() -> int:
    import torch

    import chip_smoke
    from navierstokes_parallel_tpu_torch.config import Params

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available")
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())
    chip_smoke.phase_build()
    prm = Params.from_file(str(ROOT / "configs" / "channel.in"))
    variants = {1: ("cpu", "card", "card, B2 barred",
                    "card, reductions on the host",
                    "card, B2 barred, reductions on the host",
                    "control: f32 defect mean", "control: f32 outer",
                    "control: no flux balance"),
                2: ("cpu", "card", "card, reductions on the host")}
    for order, names in variants.items():
        tag = "channel" if order == 1 else "channel ab2"
        jax_passes = chip_smoke.JAX_CHANNEL_PASSES[tag]
        reference = None
        for name in names:
            with contextlib.ExitStack() as stack:
                if "B2 barred" in name:
                    stack.enter_context(b2_barred())
                if "on the host" in name:
                    stack.enter_context(host_reductions(torch))
                if name == "control: no flux balance":
                    stack.enter_context(no_flux_balance())
                t0 = time.perf_counter()
                state, passes, margins = chip_smoke.stepped_channel(
                    torch, prm, order, "cpu" if name == "cpu" else "cuda",
                    control_hooks(torch, name))
                seconds = time.perf_counter() - t0
            fields = {f: getattr(state, f).cpu() for f in ("u", "v", "p")}
            if name == "cpu":
                reference = fields
                if order == 1:
                    stages, final = lockstep(torch, prm)
                    same = all(torch.equal(getattr(final, f), fields[f])
                               for f in fields)
                    print(f"[witness] stages {json.dumps(stages)}; the "
                          f"lockstep's final state equals solver.step's "
                          f"{same}", flush=True)
            rows = chip_smoke.channel_gate(passes, margins, jax_passes)
            same = {f: bool(torch.equal(fields[f], reference[f]))
                    for f in fields}
            diff = {f: float((fields[f] - reference[f]).abs().max())
                    for f in fields}
            record = {
                "integrator": "euler" if order == 1 else "ab2",
                "variant": name,
                "sweeps": sum(passes) * prm.sor_refine_every,
                "moved": [{"step": k, "passes": mine, "jax": theirs,
                           "margin": margin} for k, mine, theirs, margin, _
                          in rows],
                "max_abs_moved": max((abs(m - t) for _, m, t, _, _ in rows),
                                     default=0),
                "gate_holds": all(ok for *_, ok in rows),
                "equal_to_cpu": same, "max_abs_diff_to_cpu": diff,
                "seconds": seconds}
            print(f"[witness] {json.dumps(record)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
