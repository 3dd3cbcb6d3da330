#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

    python3 chip_smoke.py --profile   # also a torch.profiler split of one
                                      # 2048^2 outer pass: mg, SOR, sharded,
                                      # sharded mg, and one 256^2 outer pass
                                      # of SOR

Builds the hand-written CUDA kernels from csrc/, holds each against its
plain PyTorch version (and each SOR sweep kernel against the first
whole-grid kernels, sor_sweeps_simple and sor_warm_sweeps_simple, which
launch once per half-sweep and share nothing with the temporal-blocked tile
but the cell update; the compressed kernel also against its first kernel,
and the fused momentum kernel against its first, two-launch kernel) on the
card with error 0.0 (every kernel rounds each f32 operation once, as its
plain twin does: csrc/nsp_round.cuh), and the f64 outer's fused pass
(csrc/defect.cu) against its twin over two passes, master and next rhs
with error 0.0 and the norm within DEFECT_NORM_RTOL, for one problem and
for the ensemble's batch of 8 x 258^2 in one launch a pass (each member
also against its own launch, bit for bit); times them beside
those first kernels (the fused pass beside its twin), drives the paths and
checks each answer against the JAX package's recorded answer:

  * SOR: ``python -m navierstokes_parallel_tpu_torch configs/1.in --stats``
    through ``cli.main`` (kernels sor_sweeps and momentum_rhs), at the
    CLI's K = 64 sweeps per outer pass and again with ``--refine-every
    2048``;
  * multigrid: ``... configs/4.in --method mg --stats`` through
    ``cli.main``, the 2048^2 cavity (kernels sor_warm_sweeps, the smoother
    of the four levels from 2050^2 to 258^2, mg_restrict and mg_prolong,
    their grid transfers, mg_coarse_cycle, the rest of each V-cycle from
    130^2 down in one launch, and momentum_rhs), with the plain twins of
    the smoother, the coarse cycle and the transfers barred;
  * tiled SOR: ``... configs/4.in --max-steps 2 --stats`` through
    ``cli.main``, the default method on the 2048^2 cavity, which routes the
    sweeps to the temporal-blocked kernel sor_tiled_sweeps, with the
    whole-grid kernel and the plain sweeps barred; then the same 2 steps
    through ``solver.solve`` on the tiled route and on the first whole-grid
    kernel, which must give the same fields bit for bit;
  * compressed SOR: configs/1.in through ``solver.solve`` with
    ``sor_kernel.USE_COMPRESSED`` (kernel sor_compressed_sweeps, B1's tile
    over colour-compacted arrays), the whole-grid kernel barred; it must
    give the JAX record exactly and the whole-grid route's and the first
    whole-grid kernel's fields bit for bit, and prints its solve time beside
    the whole-grid route's;
  * sharded SOR: ``... configs/4.in --backend sharded --mesh 1x1
    --max-steps 2 --stats`` through ``cli.main`` on a one-rank NCCL group,
    every chunk of sweeps through the extended-block kernel sor_ext_sweeps,
    with every other SOR kernel and every plain sweep function barred; then
    the same steps through ``solve_sharded`` against ``solver.solve`` on the
    tiled route;
  * the other pressure methods through ``cli.main`` (METHOD_PATHS), each
    held to its JAX record: configs/1.in with an f64 state on the direct
    solve (no kernel at all) and with ``--method jacobi`` (omega clamped
    to 0.8, the warning printed; momentum_rhs only), configs/4.in with
    ``--method fft`` (momentum_rhs once per step and once for the warm-up,
    the transforms cuFFT's, no sweep kernel; one DCT solve at 2048^2 and
    at an odd size held against the CPU's), and on the sharded backend over
    a 1x1 mesh configs/4.in with ``--method mg`` (the V-cycle's smoother on
    every sharded level is sor_ext_sweeps, B6's second caller, and the
    replicated coarse solve one mg_coarse_cycle) and ``--method fft``,
    configs/1.in with ``--method cg``, ``--method rb_sor_sync`` and an f64
    state;

  * the reference protocol (the "protocol" phase): the CLI's host loop
    with frames, the final output, checkpoints and the history CSV with
    the physics monitors, on configs/1.in (also stopped after 2 steps and
    resumed: the straight run's files and state bit for bit),
    configs/4.in --method mg, configs/4.in --max-steps 2 with frames and
    the sharded 1x1 path in two pieces, each with the record and the
    kernel launches of the same run without files, the solve seconds of
    both printed; it also times one 2048^2 frame and one checkpoint;

  * the obstacle domains (the "obstacles" phase): the Schäfer-Turek
    cylinder at 440 x 82 (immersed-boundary BCs and cut-cell pressure) by
    masked mg (Euler and AB2) and masked rb_sor, the square cylinder at
    160 x 64 by mg and the backward-facing step at 128 x 32 by rb_sor
    (Euler and AB2), each stepped as tests/jax_obstacle_records.json
    records it, and ``... configs/channel.in --obstacle 17:24:27:34
    --max-steps 20 --stats`` through ``cli.main``: every step's passes
    held to JAX's (a step may move by one pass only within 1 % of its
    threshold), the failures, the force and probe records and the centre
    values within the contract, and no other route's kernel launched
    (every route and plain sweep twin barred): the masked rb_sor solves
    launch nothing, and every masked V-cycle of an mg run takes the masked
    kernels (ops/cuda/masked_kernel.py, csrc/masked_cycle.cu: 11 launches
    a cycle at 440 x 82, one one-block launch a cycle, every cycle fused);
    its seconds are printed; then one masked V-cycle at 440 x 82 by the
    kernels and by the plain cycle on the card, in turns, bits equal and
    timed, the one-block launch and one half-sweep launch beside their
    bounds; last, one profiled outer pass of each masked solve counts its
    launches;

  * obstacle domains on the sharded backend (the "sharded obstacles"
    phase, a one-rank NCCL group): the backward-facing step at 128 x 32
    (3 steps by Euler and AB2) and one Schäfer-Turek 440 x 82 step by
    rb_sor through ``sharded.ShardedStepper``, and ``... configs/
    channel.in --obstacle 17:24:27:34 --backend sharded --mesh 1x1
    --max-steps 5 --stats`` through ``cli.main``: every step's passes
    held to the JAX sharded backend's record (tests/
    jax_thermal_records.json) and to the one-device record, the
    masked deep-halo inner launching no kernel (every route and plain
    twin barred);

  * natural convection (the "convection" phase): ``... configs/
    convection.in --max-steps 300 --stats`` through ``cli.main`` by the
    default pallas_sor (sor_sweeps once per outer pass, no momentum_rhs),
    with ``--method mg`` (mg_coarse_cycle once per V-cycle) and with
    ``--time-order 2``, every plain twin barred, each step's passes held
    to the JAX CLI's; the run stopped at step 150 and resumed, bit for
    bit with the straight run; the 32^2 heated block (masked, no kernel);

  * natural convection on the sharded backend (the "sharded convection"
    phase, a one-rank NCCL group): ``... configs/convection.in --backend
    sharded --mesh 1x1 --max-steps 300 --stats`` by pallas_sor
    (sor_ext_sweeps once per chunk of 8 sweeps) and by mg (sor_ext_sweeps
    as the smoother, mg_coarse_cycle once per V-cycle), every other route
    and plain twin barred, each step's passes held to the JAX sharded
    backend's record (tests/jax_sharded_thermal_records.json);

  * free surfaces (the "free surface" phase): the dam break of
    ``configs/dambreak.in --free-wall freeslip`` cut to 60 steps through
    ``cli.main`` on one device and by ``--backend sharded --mesh 1x1``,
    every kernel route and plain sweep twin barred (no launch: the step
    is plain PyTorch, as it is jnp in the JAX package), each step's passes
    held to the JAX record (tests/jax_free_records.json), the fluid volume
    within 1e-10 of JAX's, and the run stopped halfway and resumed from
    its checkpoint bit for bit with the straight run;

  * marker particles (the "particles" phase): configs/1.in with a 16^2
    lattice of particles and a streakline source through
    ``particles.trace_particles`` by pallas_sor (sor_sweeps and
    momentum_rhs, the main path's counts and record), and its first step
    on the card and on the CPU, the positions within 1e-5;

  * gradients (the "gradients" phase, diff.py): 3 differentiable steps of
    configs/1.in's 256^2 cavity in f64 to epsilon 1e-9 by mg from a
    seeded symmetry-broken start, d(loss)/d(lid_scale) and a directional
    derivative w.r.t. the initial u held to JAX's record
    (tests/jax_a9_records.json) and to central differences of the card's
    own forward; sor_warm_sweeps and mg_coarse_cycle counted in the
    forward pass, the recomputed forward and the adjoint solves apart
    (the plain twins barred); remat and no remat equal bit for bit, their
    peak device memory at 3 and 12 steps; the seconds of a gradient
    beside a forward; the same gradient by pallas_sor (sor_sweeps in both
    passes); d(Nu_hot)/d(t_left) on configs/convection.in's 64^2 and a
    masked-adjoint derivative on the 128 x 32 backward-facing step (no
    kernel), each against its JAX record;

  * the compensated outer (the "compensated" phase, ops/compensated.py):
    the error-free transformations exact on 2^20 pairs on the card, the
    compensated defect at 2050^2 within its error bound, and configs/1.in
    with --outer compensated through ``cli.main`` at K = 64 and 2048 and
    on the sharded 1x1 mesh by rb_sor and mg, each against the JAX CLI's
    record with its kernels' launches;

  * ensembles (the "ensemble" phase, ``solver.solve_ensemble``): 8 seeded
    members of configs/1.in's 256^2 cavity (max_it cut to 2000) by rb_sor
    (batched: the momentum and the SOR sweep kernels and the f64 outer's
    fused pass take every member in one launch) and fft (batched; the
    momentum kernel and the fused pass) and mg (member by member), each
    member's counts against JAX's ensemble record and its
    solo run on the card, the batch's seconds (after a warm-up of the
    batched route) and launches beside the solo runs';

  * gradients on a mesh (the "mesh gradients" phase, a one-rank NCCL
    group, ``diff.solve_n_steps(mesh=...)`` on the 1x1 mesh): the
    gradients phase's cavity by mg against JAX's record and by pallas_sor
    against the unmeshed pallas_sor gradient, sor_ext_sweeps (and
    mg_coarse_cycle under mg) counted in the forward, the recompute and
    the adjoint, the seconds and peak memory beside the unmeshed
    gradient's; the thermal gradient on the mesh against its record;

  * the data-parallel ensemble (the "mesh ensemble" phase,
    ``solve_ensemble(mesh=...)`` on a one-device batch mesh): the
    ensemble phase's 8 members by rb_sor equal to the unmeshed batch bit
    for bit, sor_sweeps 96, pressure_defect 96 and momentum_rhs 3
    launches, its seconds;

  * the gspmd backend (the "gspmd" phase, a one-rank NCCL group,
    parallel/gspmd.py on the 1x1 mesh): the runs of
    tests/jax_gspmd_records.json "chip" (JAX's gspmd backend on one CPU
    device): configs/1.in by rb_sor, jacobi, cg, mg and fft, configs/4.in
    by mg (one device's V-cycles: its levels, not the sharded backend's),
    configs/convection.in by mg (ThermalGspmdStepper), the dam break
    (the sharded backend's replicated free-surface stepper, as
    solve_free(mesh=...)) and the square cylinder by the masked mg, each
    step's passes through the gate, failures, centre values and max |u|,
    |v| within the contract; each run's sor_ext_sweeps, sor_warm_sweeps
    and mg_coarse_cycle launches (mg: two B6 calls on each sharded level
    above one device's coarse-cycle depth and one coarse cycle per
    V-cycle) and its seconds; then the 32^2 heated block 20 steps through
    ThermalGspmdStepper (its fields all-gathered on the card every step)
    and through ThermalStepper, each JAX's passes, the two equal bit for
    bit, both timed;

then runs small converging cavities (SOR and mg) on the GPU and on the CPU
and compares them.  Before the paths, the "decomposition" check cuts whole
grids into the blocks of 1x1, 2x2 and 2x4 meshes, sweeps each block's
extended block with sor_ext_sweeps and holds the assembled cores against
the whole-grid kernels bit for bit (the deep-halo exactness argument,
parallel/deep_halo.py).  The "cycle" phase times one V-cycle at 2048^2 and
counts its kernel launches under the profiler, as it is and as it was with
the first smoother kernel on every level; after it the "ensemble profile"
counts the launches of one batched outer pass of the 8 members beside one
solo pass on the SOR kernel.  Each path runs with the launch
counts set to 0 just before it and read just after; the JSON record's
``launches`` sums a kernel's counts over the paths.  Each phase prints its
seconds.  Any failed phase prints ``FAIL: ...`` and exits 1 before the last
line; on success the last two lines are the kernels' JSON record (with each
kernel's bound: the least time the card could take for its timed call,
from the bytes it must move and the f32 operations it must do) and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The JAX package's answer on configs/1.in (256^2 cavity, Re=1000, T=0.01,
# SOR omega=1.7, eps=1e-4, max_it=20000, f32 state, K=64), recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/1.in --stats
# which printed U-CENTER: -0.003054, V-CENTER: 0.000017 and
# steps=3 sor_iterations=60000 sor_failures=3 last_res_norm=2.637e-04.
JAX_U_CENTER = -0.003054
JAX_V_CENTER = 0.000017
JAX_STATS = {"steps": 3, "sor_iterations": 60000, "sor_failures": 3}
# The JAX package's answer on configs/4.in (2048^2 cavity, Re=1000, T=0.01,
# f32 state) with the multigrid pressure solve, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --method mg --stats
# which printed U-CENTER: -0.002993, V-CENTER: 0.000003 and
# steps=168 sor_iterations=673 sor_failures=0 last_res_norm=1.182e-04
# (sor_iterations counts V-cycles).
JAX_MG_U_CENTER = -0.002993
JAX_MG_V_CENTER = 0.000003
JAX_MG_STATS = {"steps": 168, "sor_iterations": 673, "sor_failures": 0}
# The JAX package's answer on configs/4.in with its default method (the SOR
# route; on the TPU the strip-tiled kernel, on the CPU _roll_sweeps_xla, the
# same sweeps), stopped after 2 steps, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --backend pallas --max-steps 2 --stats
# which printed U-CENTER: -0.000006, V-CENTER: 0.000000 and
# steps=2 sor_iterations=40000 sor_failures=2 last_res_norm=1.075e+02
# (both steps run into max_it).
TILED_STEPS = 2
JAX_TILED_U_CENTER = -0.000006
JAX_TILED_V_CENTER = 0.000000
JAX_TILED_STATS = {"steps": 2, "sor_iterations": 40000, "sor_failures": 2}
# Its last residual norm, printed to 4 digits; held to 2e-3 relative.
JAX_TILED_RES_NORM = 1.075e2
RES_NORM_RTOL = 2e-3
# The JAX package's answer on configs/1.in stopped after 2 steps, recorded
# with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/1.in \
#       --max-steps 2 --stats
# which printed U-CENTER: -0.002439, V-CENTER: 0.000013 and steps=2
# sor_iterations=40000 sor_failures=2 last_res_norm=1.036e-03 (rc 3).
JAX_1IN_2STEPS_U = -0.002439
JAX_1IN_2STEPS_V = 0.000013
# The protocol phase's files (build/ is git-ignored; removed at its end) and
# the --history-file header of --history-physics.
PROTOCOL_DIR = ROOT / "build" / "protocol"
PROTOCOL_COLUMNS = ("step,t,dt,sor_iterations,res_norm,kinetic_energy,"
                    "enstrophy,max_divergence,psi_min")
# The JAX package's sharded backend on configs/4.in over a one-device mesh
# (the deep-halo SOR inner), stopped after 2 steps, recorded with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/4.in \
#       --backend sharded --mesh 1x1 --max-steps 2 --stats
# printed the single-device record above: U-CENTER: -0.000006, V-CENTER:
# 0.000000 and steps=2 sor_iterations=40000 sor_failures=2
# last_res_norm=1.075e+02.  The sharded path is held to the same numbers.
SHARDED_ARGV = ["--backend", "sharded", "--mesh", "1x1", "--max-steps",
                str(TILED_STEPS), "--stats"]
# The JAX package's answers on the paths of the other pressure methods,
# each recorded on the CPU with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu configs/<config> \
#       <JAX arguments> --stats
# (the port's run adds --backend jnp to the f64 run: the port's auto
# backend would take the refined kernel route on the card, where the JAX
# CLI on the CPU takes rb_sor, the direct solve).  Each printed:
#   direct f64, --dtype float64: U-CENTER -0.003054, V-CENTER 0.000017,
#     steps=3 sor_iterations=60000 sor_failures=3 last_res_norm=2.646e-04;
#   jacobi, --method jacobi: -0.003056, 0.000018, steps=3
#     sor_iterations=60000 sor_failures=3 last_res_norm=2.200e-01;
#   fft, configs/4.in --method fft: -0.002993, 0.000003, steps=168
#     sor_iterations=336 sor_failures=0 last_res_norm=5.866e-08 (direct
#     solves);
#   sharded mg, configs/4.in --backend sharded --mesh 1x1 --method mg:
#     -0.002993, 0.000003, steps=168 sor_iterations=665 sor_failures=0
#     last_res_norm=1.123e-04 (V-cycles of the sharded hierarchy, not the
#     single-device 673);
#   sharded fft, the same with --method fft: -0.002993, 0.000003,
#     steps=168 sor_iterations=336 sor_failures=0 last_res_norm=2.854e-07;
#   sharded cg, configs/1.in --backend sharded --mesh 1x1 --method cg:
#     -0.003054, 0.000017, steps=3 sor_iterations=13248 sor_failures=0
#     last_res_norm=1.421e-04 (CG steps);
#   sharded rb_sor_sync, ... --method rb_sor_sync --max-steps 1 (rc 3):
#     -0.001621, 0.000008, steps=1 sor_iterations=20000 sor_failures=1
#     last_res_norm=2.105e-03;
#   sharded f64, ... --dtype float64 --max-steps 1 (rc 3): -0.001621,
#     0.000008, steps=1 sor_iterations=20000 sor_failures=1
#     last_res_norm=2.112e-03.
# tag: (config, the port's CLI arguments, U-CENTER, V-CENTER, stats, rc)
SHARDED_1X1 = ["--backend", "sharded", "--mesh", "1x1"]
METHOD_PATHS = {
    "direct f64": ("1.in", ["--backend", "jnp", "--dtype", "float64"],
                   -0.003054, 0.000017, (3, 60000, 3), 0),
    "jacobi": ("1.in", ["--method", "jacobi"], -0.003056, 0.000018,
               (3, 60000, 3), 0),
    "fft": ("4.in", ["--method", "fft"], -0.002993, 0.000003, (168, 336, 0),
            0),
    "sharded mg": ("4.in", [*SHARDED_1X1, "--method", "mg"], -0.002993,
                   0.000003, (168, 665, 0), 0),
    "sharded fft": ("4.in", [*SHARDED_1X1, "--method", "fft"], -0.002993,
                    0.000003, (168, 336, 0), 0),
    "sharded cg": ("1.in", [*SHARDED_1X1, "--method", "cg"], -0.003054,
                   0.000017, (3, 13248, 0), 0),
    "sharded rb_sor_sync": ("1.in", [*SHARDED_1X1, "--method", "rb_sor_sync",
                                     "--max-steps", "1"], -0.001621,
                            0.000008, (1, 20000, 1), 3),
    "sharded f64": ("1.in", [*SHARDED_1X1, "--dtype", "float64",
                             "--max-steps", "1"], -0.001621, 0.000008,
                    (1, 20000, 1), 3),
}
# Problem 3, the plane channel of configs/channel.in (128 x 64, a = 2,
# Re = 10, tau = 0.5, f32 state, K = 64), stopped after CHANNEL_STEPS
# steps, by Euler (kernels B1 and B2) and by Adams-Bashforth 2 (B1 alone:
# the AB2 step takes the plain F/G, as JAX's does), on one card and on the
# sharded backend over a 1x1 mesh (B6); and the same channel at the full
# width of CHANNEL_WIDE (channel.in with lines 3-4 set to 2048 and 1024,
# written under build/ at run time), stopped after 2 steps, both of which
# run into max_it.  The JAX package's records, each taken on the CPU with
#   JAX_PLATFORMS=cpu python -m navierstokes_parallel_tpu <config> --stats \
#       --max-steps <steps> <arguments>
# printed:
#   configs/channel.in, 50 steps: U-CENTER 0.728982, V-CENTER 0.000000,
#     steps=50 sor_iterations=250304 sor_failures=0 last_res_norm=2.731e-04;
#   ... --time-order 2: 0.729175, 0.000000, 50 250304 0, 2.684e-04;
#   ... --time-order 2 --backend sharded --mesh 1x1: 0.729175, 0.000000,
#     50 250176 0, 2.698e-04 (the sharded backend's own count: its
#     reductions and stencils round otherwise, two K-quanta fewer);
#   the 2048 x 1024 channel, 2 steps: 0.081013, -0.000003, 2 40000 2,
#     3.036e+06;
#   ... --time-order 2: 0.081008, -0.000003, 2 40000 2, 3.037e+06.
# And
#   JAX_PLATFORMS=cpu python tests/jax_records.py channel 50
# printed the same counts, the profile errors of u after 50 steps (outflow
# column, mid column; models/channel.py::profile_errors) and each step's
# outer passes (JAX_CHANNEL_PASSES).
#
# The single-device channel's 50-step counts are held step by step.  At
# some steps the residual of the pass that decides to stop lies within 1 %
# of the threshold, where the rounding of one step can move the decision
# by one pass either way: the card's sums and means add in another order
# than the CPU's (with every torch.sum and torch.mean taken on the host,
# the card gives JAX's 250304 by both integrators, and with the plain F/G
# in place of B2 the CPU run's fields bit for bit;
# scripts/torch_channel_witness.py).  A step may differ from
# JAX_CHANNEL_PASSES by one pass only where the card's residual at the
# deciding pass lies within NEAR_THRESHOLD of the threshold
# (channel_gate); every other step must be equal, and the CLI's total must
# equal the stepped run's.  phase_channel prints every step that moved
# with its margin.
NEAR_THRESHOLD = 1e-2
JAX_CHANNEL_PASSES = {
    "channel": (185, 118, 102, 100, 97, 95, 93, 91, 89, 87, 85, 84, 83, 81,
                80, 79, 78, 78, 77, 76, 75, 75, 74, 74, 73, 72, 72, 71, 71,
                70, 70, 70, 69, 69, 68, 68, 67, 67, 67, 66, 66, 66, 65, 65,
                65, 64, 64, 64, 63, 63),
    "channel ab2": (185, 118, 113, 102, 100, 87, 92, 88, 88, 86, 85, 84, 82,
                    81, 80, 79, 78, 78, 77, 76, 75, 75, 74, 73, 73, 72, 72,
                    71, 71, 70, 70, 69, 69, 69, 68, 68, 67, 67, 67, 66, 66,
                    66, 65, 65, 65, 64, 64, 64, 64, 63)}
# tag: (config, the port's CLI arguments, U-CENTER, V-CENTER, stats, rc,
# time order, JAX's profile errors or None)
CHANNEL_STEPS = 50
CHANNEL_WIDE = (2048, 1024)
CHANNEL_WIDE_CONFIG = ROOT / "build" / "channel_2048x1024.in"
CONVECTION_CONFIG = ROOT / "configs" / "convection.in"
CHANNEL_STEPS_ARGV = ["--max-steps", str(CHANNEL_STEPS)]
CHANNEL_PATHS = {
    "channel": ("configs/channel.in", CHANNEL_STEPS_ARGV, 0.728982, 0.0,
                (50, 250304, 0), 3, 1,
                (0.35494035482406616, 0.3339797854423523)),
    "channel ab2": ("configs/channel.in", [*CHANNEL_STEPS_ARGV,
                                           "--time-order", "2"],
                    0.729175, 0.0, (50, 250304, 0), 3, 2,
                    (0.35383927822113037, 0.33303970098495483)),
    "channel sharded ab2": ("configs/channel.in", [
        *CHANNEL_STEPS_ARGV, *SHARDED_1X1, "--time-order", "2"], 0.729175,
        0.0, (50, 250176, 0), 3, 2, None),
    "channel 2048x1024": (CHANNEL_WIDE_CONFIG, ["--max-steps", "2"],
                          0.081013, -0.000003, (2, 40000, 2), 3, 1, None),
    "channel 2048x1024 ab2": (CHANNEL_WIDE_CONFIG, [
        "--max-steps", "2", "--time-order", "2"], 0.081008, -0.000003,
        (2, 40000, 2), 3, 2, None),
}
# The Taylor-Green vortex in the free-slip box (problem 4) at 1024^2
# (models/taylorgreen.py::taylor_green(1024): Re = 50, eps = 1e-6, f32),
# 3 steps of solver.solve_ab2 with the multigrid pressure solve (kernels
# B3 and the coarse cycle; no B2 under AB2).  The JAX record, taken on the
# CPU with
#   JAX_PLATFORMS=cpu python tests/jax_records.py taylor-green 1024 3
# printed steps=3 sor_iterations=15 per_step=[7, 4, 4] sor_failures=0
# centre=0.001534,-0.001534 and errors {'u': 1.0520008630887645e-07, 'v':
# 1.0520008630887645e-07, 'p': 2.5512697132856754e-05}; the port's errors
# are held to at most JAX's times (1 + TG_ERRORS_RTOL).
TG_N, TG_STEPS = 1024, 3
JAX_TG_STATS = (3, 15, 0)
JAX_TG_CENTRE = (0.001534, -0.001534)
JAX_TG_ERRORS = {"u": 1.0520008630887645e-07, "v": 1.0520008630887645e-07,
                 "p": 2.5512697132856754e-05}
TG_ERRORS_RTOL = 1e-3
# One DCT solve on the card (cuFFT) against the CPU's (pocketfft): max
# |difference| over max|p|.
DCT_RTOL = 1e-5
DCT_SIZES = ((2048, 2048), (999, 757))
# The reference comparator's contract: 1e-4, absolute where |x| <= 1,
# relative above (tests/conftest.py::assert_close_reference_contract).
CONTRACT = 1e-4
SOR_SWEEPS = 64  # the main path's K: one kernel call = 64 sweeps
# The members of the ensemble phase (tests/jax_a9_records.json "ensemble").
ENSEMBLE_MEMBERS = 8
# The kernels each method's batched ensemble step launches on the card.
ENSEMBLE_KERNELS = {"rb_sor": ("momentum", "sor", "pressure_defect"),
                    "fft": ("momentum", "pressure_defect"),
                    "mg": ("momentum", "sor_warm", "mg_restrict",
                           "mg_prolong", "mg_coarse_cycle",
                           "pressure_defect")}
# The refinement interval of the benchmark's SOR arm; the main path runs a
# second time with it.
BENCH_REFINE_EVERY = 2048
MG_SWEEPS = 2    # one multigrid smoother call (V(2,2)); 32 on the coarsest
# configs/4.in's finest multigrid level: 2048^2 cells, padded, 1/dx^2.
MG_FINE_SHAPE = (2050, 2050)
MG_FINE_DX2_INV = 2048.0 ** 2
# The tiled kernel's tile heights held against the plain twin: the default
# (64) and 256, whose rhs no longer fits the threads' registers (the
# kernel reads it from device memory; 110,592 B of shared memory).
TILE_SIZES = (64, 256)
# The extended-block kernel's cases: (tag, interior, mesh, sweeps per call,
# warm).  A 1x1 block of configs/4.in (the sharded path on one card: ext
# 2080^2, H = 16) and of configs/channel.in (the sharded channel: ext
# 160 x 96, H = 16, its constants), the four blocks of a 2x2 cut of
# configs/4.in's grid, a padded
# 99 x 63 interior over 2x4, and the multigrid use (a warm start from a
# non-zero delta with its ghost ring, omega = 1, H = 2 ns) over 2x2 and as
# the sharded mg path gives it on one card: configs/4.in's finest level
# (ext 2056^2) and its coarsest smoothed one (8^2, ext 16^2), each with
# that level's constants.
EXT_CASES = [("configs/4.in 1x1", (2048, 2048), (1, 1), (1, 8), False),
             ("configs/channel.in 1x1", (128, 64), (1, 1), (1, 8), False),
             ("configs/convection.in 1x1", (64, 64), (1, 1), (1, 8), False),
             ("2048^2 2x2", (2048, 2048), (2, 2), (1, 8), False),
             ("99x63 2x4", (99, 63), (2, 4), (1, 8), False),
             ("mg 130^2 2x2", (130, 130), (2, 2), (MG_SWEEPS,), True),
             ("sharded mg 2048^2 1x1", (2048, 2048), (1, 1), (MG_SWEEPS,),
              True),
             ("sharded mg 8^2 1x1", (8, 8), (1, 1), (MG_SWEEPS,), True)]
# The H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): device
# memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations per cell update of a red-black sweep (csrc/nsp_sor.cuh:
# 7 in the neighbour sum, 4 in the relaxation; self_coef not counted) and
# per interior cell of the momentum pass (csrc/momentum.cu: 57 for F, 57
# for G, 2 for the gamma factors, 6 for rhs).
SWEEP_FLOPS_PER_CELL = 11
MOMENTUM_FLOPS_PER_CELL = 122
# Bytes per interior cell of the f64 outer's fused pass (csrc/defect.cu):
# the master (8), delta (4) and rhs (8) read, the new master (8) and the
# next rhs (4) written.  Its ~12 f64 operations a cell take a 25th of that
# time at the card's 34 TFLOP/s of float64, so bytes bound it.
DEFECT_BYTES_PER_CELL = 32
# The f64 outer's fused pass against its twin: the norm's sum runs in
# another order (per-block partials, then the blocks in order), so it
# agrees to rounding; master and next rhs are bit for bit.
DEFECT_NORM_RTOL = 1e-13


class PhaseFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def contract_err(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    big = (np.abs(a) > 1.0) | (np.abs(b) > 1.0)
    denom = np.maximum(np.abs(a), np.abs(b))
    rel = np.abs(a - b) / np.where(denom == 0, 1.0, denom)
    return float(np.max(np.where(big, rel, np.abs(a - b))))


@contextlib.contextmanager
def barred(module, names, where: str):
    """Replace module.<name> for each name by a function that fails the
    phase, for the duration of the block."""
    saved = {name: getattr(module, name) for name in names}

    def refusal(name):
        def refuse(*_args, **_kw):
            raise PhaseFailed(f"{where} ran {name}")
        return refuse

    for name in names:
        setattr(module, name, refusal(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def timed_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s")
    return out


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call on the card: CUDA events around `reps`
    calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device milliseconds per call: `calls` calls of fn captured in
    one CUDA graph (after a warm-up call on a side stream), the graph
    replayed `reps` times between CUDA events, so the host's cost per call
    is left out (what is left of it: one graph launch per `calls` calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def phase_device(torch) -> str:
    check(torch.cuda.is_available(), "CUDA is not available")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    card = out.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from navierstokes_parallel_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")


def phase_compare(torch) -> dict:
    """Each kernel against its plain version at its paths' shapes and at an
    odd non-square one, every SOR sweep kernel also against the first
    whole-grid kernels (one launch per half-sweep, no tile); returns the
    max abs error per kernel."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    rng = np.random.default_rng(0)
    errs = {"sor": compare_whole_grid(torch, rng), "momentum": 0.0,
            "sor_tiled": 0.0, "sor_compressed": 0.0}
    # The fused momentum kernel at the main path's 258^2, the mg path's
    # 2050^2, at 99 x 63 and at the channel's 130 x 66 and 2050 x 1026,
    # against its twin and its first kernel (momentum_rhs_simple: two
    # launches), dt and gamma as the time step passes them (0-d f32 tensors
    # on the card).
    for i_max, j_max in ((256, 256), (2048, 2048), (97, 61), (128, 64),
                         CHANNEL_WIDE):
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     g_x=0.1, g_y=-0.2, omega=1.7)
        shape = prm.shape
        u = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        u, v = u.cuda(), v.cuda()
        dt = torch.tensor(0.004, device="cuda")
        gamma = torch.tensor(0.7, device="cuda")
        got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
        want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
        first = momentum_kernel.momentum_rhs_simple(u, v, dt, gamma, prm)
        torch.cuda.synchronize()
        for name, g, w, f in zip(("F", "G", "rhs"), got, want, first):
            err = float((g - w).abs().max())
            same = torch.equal(g, f)
            print(f"[compare] momentum {name} {shape}: max abs err "
                  f"{err:.3e} vs the plain twin (expected 0), equals "
                  f"momentum_rhs_simple {same}")
            check(err == 0.0 and same,
                  f"momentum kernel disagrees on {name} at {shape}")
            errs["momentum"] = max(errs["momentum"], err)

    errs["sor_warm"] = compare_warm(torch, rng)
    errs["mg_coarse_cycle"] = compare_coarse_cycle(torch, rng)
    errs["mg_restrict"], errs["mg_prolong"] = compare_transfers(torch, rng)

    # The tiled kernel at the SOR paths' 258^2 and 2050^2 and at 99 x 63,
    # over one sweep, one chunk, the path's 64 and 20 (a short last chunk),
    # at two tile heights; the compressed kernel at 258^2, 98 x 64, 64 x 62
    # and 99 x 64 (odd rows) over no sweep, one, a short chunk and 64.  Both
    # must equal their plain twins and the first whole-grid kernel (no
    # tile) bit for bit, the compressed one also its first kernel
    # (inner_sweeps_compressed_simple: one launch per half-sweep).
    cases = [("sor_tiled", (i_max, j_max), n, tile)
             for i_max, j_max in ((256, 256), (2048, 2048), (97, 61))
             for n in (1, sor_kernel.SWEEPS_PER_CHUNK, SOR_SWEEPS, 20)
             for tile in TILE_SIZES]
    cases += [("sor_compressed", shape, n, None)
              for shape in ((256, 256), (96, 62), (62, 60), (97, 62))
              for n in (0, 1, 7, SOR_SWEEPS)]
    for key, (i_max, j_max), n, tile in cases:
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                     omega=1.7)
        rhs = np.zeros(prm.shape, np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((i_max, j_max))
        rhs_d = torch.from_numpy(rhs).cuda()
        if key == "sor_tiled":
            got = sor_kernel.inner_sweeps_tiled(rhs_d, n, prm, tile_rows=tile)
            want = sor_kernel.inner_sweeps_tiled_plain(rhs_d, n, prm,
                                                       tile_rows=tile)
        else:
            got = sor_kernel.inner_sweeps_compressed(rhs_d, n, prm)
            want = sor_kernel.inner_sweeps_compressed_plain(rhs_d, n, prm)
        whole = sor_kernel.whole_grid_sweeps_simple(rhs_d, n, prm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = torch.equal(got, whole)
        also = ""
        if key == "sor_compressed":
            first = torch.equal(got, sor_kernel.inner_sweeps_compressed_simple(
                rhs_d, n, prm))
            same = same and first
            also = f", sor_compressed_sweeps_simple {first}"
        print(f"[compare] {key} {prm.shape} n={n}"
              f"{'' if tile is None else f' tile={tile}'}: max abs err "
              f"{err:.3e} (expected 0), equals sor_sweeps_simple "
              f"{torch.equal(got, whole)}{also}")
        check(err == 0.0 and same, f"{key} kernel disagrees at {prm.shape}, "
                                   f"n={n}, tile={tile}")
        errs[key] = max(errs[key], err)
    errs["sor_ext"] = compare_ext(torch, rng)
    errs["pressure_defect"] = compare_defect(torch, rng)
    for key, err in compare_batched(torch, rng).items():
        errs[key] = max(errs[key], err)
    return errs


def defect_case(torch, rng, i_max: int, j_max: int):
    """(params, master, delta, rhs interior, threshold) on the card for
    the f64 outer's pass on an i_max x j_max interior: a random master and
    rhs, an f32 delta, the threshold of a solve whose passes go on."""
    from navierstokes_parallel_tpu_torch.config import Params

    prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                 omega=1.7)
    p64 = torch.from_numpy(rng.standard_normal(prm.shape)).cuda()
    delta = torch.from_numpy(rng.standard_normal(prm.shape).astype(
        np.float32)).cuda()
    rhs = torch.from_numpy(rng.standard_normal((i_max, j_max))).cuda()
    return prm, p64, delta, rhs, torch.zeros((), dtype=torch.float64,
                                             device="cuda")


def defect_passes(torch, pass_fn, p64, delta, n_passes: int, on=True):
    """n_passes of pass_fn (a defect_kernel.outer_pass) from p64, `on` the
    go-on flag of one problem or a list of a batch's: (master, on,
    iterations, res_norm) after them."""
    on = torch.tensor(on, device=p64.device)
    iterations = torch.zeros(on.shape, dtype=torch.int64, device=p64.device)
    res_norm = torch.full(on.shape, float("inf"), dtype=torch.float64,
                          device=p64.device)
    for _ in range(n_passes):
        p64 = pass_fn(p64, delta, on, iterations, res_norm, SOR_SWEEPS)
    return p64, on, iterations, res_norm


def compare_defect(torch, rng) -> float:
    """The f64 outer's fused pass (defect_kernel.outer_pass, one launch)
    against its plain twin on the CPU, two passes from one master (the
    kernel's master ping-pongs between two buffers) at the SOR path's
    258^2, the mg path's 2050^2 and the channel's 130 x 66: the masters'
    interiors and the next rhs bit for bit, the flag and the count equal,
    the norm within DEFECT_NORM_RTOL.  Returns the largest abs error of
    master and rhs."""
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel

    worst = 0.0
    for i_max, j_max in ((256, 256), (2048, 2048), (128, 64)):
        prm, p64, delta, rhs, threshold = defect_case(torch, rng, i_max,
                                                      j_max)
        out = {}
        # outer_pass takes the kernel on the card and the twin on the CPU.
        for name, device in (("kernel", "cuda"), ("plain", "cpu")):
            master, d, r, thr = (x.to(device, copy=True)
                                 for x in (p64, delta, rhs, threshold))
            rhs_full = torch.zeros(prm.shape, dtype=torch.float32,
                                   device=device)
            got = defect_passes(torch, defect_kernel.outer_pass(
                master, r, rhs_full, thr, prm), master, d, 2)
            out[name] = tuple(x.cpu() for x in (*got, rhs_full))
        (km, kon, kit, knorm, krhs), (pm, pon, pit, pnorm, prhs) = (
            out["kernel"], out["plain"])
        err = max(float((km - pm)[1:-1, 1:-1].abs().max()),
                  float((krhs - prhs).abs().max()))
        rel = abs(float(knorm) - float(pnorm)) / float(pnorm)
        flags = (bool(kon), int(kit)) == (bool(pon), int(pit))
        print(f"[compare] pressure_defect {prm.shape}, 2 passes: max abs err "
              f"{err:.3e} (expected 0), norm {float(knorm):.17g} vs "
              f"{float(pnorm):.17g} (rel {rel:.2e}), flag and count equal "
              f"{flags}")
        check(err == 0.0 and rel <= DEFECT_NORM_RTOL and flags,
              f"pressure_defect kernel disagrees at {prm.shape}")
        worst = max(worst, err)
    return worst


def compare_batched(torch, rng) -> dict:
    """The kernels the batched ensemble step launches with a member axis,
    at the ensemble phase's shape (8 members of 258^2): the whole-grid
    sweeps (B1) for n = 0, 1, 7 and 64 and the fused momentum kernel (B2)
    with a dt and a gamma per member, each against its plain twin on the
    member axis and against each member's own launch: error 0.0; and two
    passes of the f64 outer's fused pass (compare_batched_defect).
    Returns the max abs error per kernel."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    members = ENSEMBLE_MEMBERS
    prm = Params(i_max=256, j_max=256, a=1.0, b=0.7, Re=1000.0, g_x=0.1,
                 g_y=-0.2, omega=1.7)
    errs = {"sor": 0.0, "momentum": 0.0,
            "pressure_defect": compare_batched_defect(torch, rng, prm)}
    rhs = torch.stack([random_grid(torch, rng, (256, 256), ring=False)
                       for _ in range(members)])
    for n in (0, 1, 7, SOR_SWEEPS):
        got = sor_kernel.whole_grid_sweeps(rhs, n, prm)
        err = float((got - sor_kernel.inner_sweeps_plain(rhs, n, prm))
                    .abs().max())
        solo = all(torch.equal(got[k], sor_kernel.whole_grid_sweeps(
            rhs[k].contiguous(), n, prm)) for k in range(members))
        print(f"[compare] sor {members} x {prm.shape} n={n} (one launch per "
              f"chunk for the batch): max abs err {err:.3e} vs the plain "
              f"twin (expected 0), equals each member's launch {solo}")
        check(err == 0.0 and solo, f"batched sor kernel disagrees, n={n}")
        errs["sor"] = max(errs["sor"], err)
    u, v = (torch.from_numpy(rng.standard_normal((members, *prm.shape))
                             .astype(np.float32)).cuda() for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.002, 0.005, members)
                          .astype(np.float32)).cuda()
    gamma = torch.from_numpy(rng.uniform(0.5, 0.9, members)
                             .astype(np.float32)).cuda()
    got = momentum_kernel.momentum_rhs(u, v, dt, gamma, prm)
    want = momentum_kernel.momentum_rhs_plain(u, v, dt, gamma, prm)
    solos = [momentum_kernel.momentum_rhs(u[k].contiguous(),
                                          v[k].contiguous(), dt[k], gamma[k],
                                          prm) for k in range(members)]
    torch.cuda.synchronize()
    for i, name in enumerate(("F", "G", "rhs")):
        err = float((got[i] - want[i]).abs().max())
        solo = all(torch.equal(got[i][k], solos[k][i])
                   for k in range(members))
        print(f"[compare] momentum {name} {members} x {prm.shape} (one "
              f"launch, a dt and a gamma per member): max abs err "
              f"{err:.3e} vs the plain twin (expected 0), equals each "
              f"member's launch {solo}")
        check(err == 0.0 and solo,
              f"batched momentum kernel disagrees on {name}")
        errs["momentum"] = max(errs["momentum"], err)
    return errs


# The members of compare_batched_defect's batch: going, stopped before the
# first pass, one whose first norm meets its threshold, the rest going.
DEFECT_BATCH_ON = [True, False, True] + [True] * (ENSEMBLE_MEMBERS - 3)
DEFECT_BATCH_THRESHOLD = [0.0, 0.0, 1e300] + [0.0] * (ENSEMBLE_MEMBERS - 3)


def compare_batched_defect(torch, rng, prm) -> float:
    """Two passes of the f64 outer's fused pass (defect_kernel.outer_pass)
    over a batch of ENSEMBLE_MEMBERS members on prm's grid, one launch a
    pass, against the plain twin on the same batch on the CPU: the
    masters' interiors, the next rhs, the flags and the counts bit for
    bit, the norms within DEFECT_NORM_RTOL; and each member against its
    own launch (members = 1): every tensor bit for bit.  Returns the
    largest abs error of masters and rhs against the twin."""
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel
    from navierstokes_parallel_tpu_torch.utils import timing

    members = ENSEMBLE_MEMBERS
    shape = (members, *prm.shape)
    p64 = torch.from_numpy(rng.standard_normal(shape))
    delta = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((members, prm.i_max,
                                                prm.j_max)))

    def run(device, k=None):
        """The two passes on `device`, of the batch or of member k."""
        pick = slice(None) if k is None else k
        master, d, r = (x[pick].to(device, copy=True)
                        for x in (p64, delta, rhs))
        on, thr = ((DEFECT_BATCH_ON, DEFECT_BATCH_THRESHOLD) if k is None
                   else (DEFECT_BATCH_ON[k], DEFECT_BATCH_THRESHOLD[k]))
        rhs_full = torch.zeros(master.shape, dtype=torch.float32,
                               device=device)
        pass_fn = defect_kernel.outer_pass(
            master, r, rhs_full,
            torch.tensor(thr, dtype=torch.float64, device=device), prm)
        got = defect_passes(torch, pass_fn, master, d, 2, on)
        return tuple(x.cpu() for x in (*got, rhs_full))

    start = timing.counts()
    kernel = run("cuda")
    launched = timing.counts().get("launch.pressure_defect", 0) - start.get(
        "launch.pressure_defect", 0)
    plain = run("cpu")
    (km, kon, kit, knorm, krhs), (pm, pon, pit, pnorm, prhs) = kernel, plain
    err = max(float((km - pm)[:, 1:-1, 1:-1].abs().max()),
              float((krhs - prhs).abs().max()))
    flags = torch.equal(kon, pon) and torch.equal(kit, pit)
    rel = max(0.0 if not going else
              abs(float(kn) - float(pn)) / float(pn)
              for kn, pn, going in zip(knorm, pnorm, DEFECT_BATCH_ON))
    held = all(float(kn) == float(pn) == float("inf")
               for kn, pn, going in zip(knorm, pnorm, DEFECT_BATCH_ON)
               if not going)
    solo = all(torch.equal(x[k], y) for k in range(members)
               for x, y in zip(kernel, run("cuda", k)))
    want = ([128, 0, 64] + [128] * (members - 3),
            [True, False, False] + [True] * (members - 3))
    counts = (kit.tolist(), kon.tolist()) == want
    print(f"[compare] pressure_defect {members} x {prm.shape}, 2 passes (one "
          f"launch each for the batch, {launched} launched; a member going, "
          f"one stopped, one that stops): max abs err {err:.3e} vs the "
          f"plain twin (expected 0), norms rel {rel:.2e}, flags and counts "
          f"equal {flags} ({kit.tolist()}), stopped norms kept {held}, "
          f"equals each member's launch {solo}")
    check(err == 0.0 and rel <= DEFECT_NORM_RTOL and flags and held and solo
          and counts and launched == 2,
          "batched pressure_defect kernel disagrees")
    return err


def compare_whole_grid(torch, rng) -> float:
    """sor_sweeps (the temporal tile) against its plain twin and against
    its first kernel sor_sweeps_simple, at the SOR paths' 258^2 and 2050^2,
    at 99 x 63 and 98 x 64, at the channel's 130 x 66 and 2050 x 1026 and
    at configs/convection.in's 66^2 (its own constants), for no sweep, one,
    a short chunk, the
    path's 64 and one outer pass of the benchmark's K = 2048: error 0.0
    (the plain twin is left out where it would take minutes).  Returns the
    max abs error."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    worst = 0.0
    grids = [Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7, Re=1000.0,
                    omega=1.7)
             for i_max, j_max in ((256, 256), (2048, 2048), (97, 61),
                                  (96, 62), (128, 64), CHANNEL_WIDE)]
    grids.append(Params.from_file(str(CONVECTION_CONFIG)))
    for prm in grids:
        rhs = random_grid(torch, rng, (prm.i_max, prm.j_max), ring=False)
        tile = "x".join(map(str, sor_kernel.whole_grid_tile(prm.shape)))
        for n in (0, 1, 7, SOR_SWEEPS, BENCH_REFINE_EVERY):
            got = sor_kernel.whole_grid_sweeps(rhs, n, prm)
            first = sor_kernel.whole_grid_sweeps_simple(rhs, n, prm)
            err = float((got - first).abs().max())
            with_plain = n * rhs.numel() <= SOR_SWEEPS * 2050 * 2050
            if with_plain:
                want = sor_kernel.inner_sweeps_plain(rhs, n, prm)
                err = max(err, float((got - want).abs().max()))
            torch.cuda.synchronize()
            print(f"[compare] sor {prm.shape} n={n} tile={tile}: max abs err "
                  f"{err:.3e} vs sor_sweeps_simple"
                  f"{' and the plain twin' if with_plain else ''} "
                  f"(expected 0)")
            check(err == 0.0, f"sor kernel disagrees at {prm.shape}, n={n}")
            worst = max(worst, err)
    return worst


def mg_levels(config=ROOT / "configs" / "4.in"):
    """The multigrid levels of `config` (configs/4.in) and the depth from
    which the coarse cycle takes them."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels = mg.build_levels(Params.from_file(str(config)))
    return levels, sor_kernel.coarse_cycle_depth(levels)


def sharded_mg_levels():
    """The sharded multigrid levels of configs/4.in on a 1x1 mesh (2048^2
    down to the 4^2 level that is solved replicated), and the levels of
    that replicated solve (one: 4^2, padded 6 x 6), as
    mg._coarse_solve_replicated builds them."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg

    prm = Params.from_file(str(ROOT / "configs" / "4.in"))
    levels = mg.build_levels_sharded(prm, prm.i_max, prm.j_max)
    last = levels[-1]
    return levels, mg._coarsen(*last.g_dims, last.dx2_inv, last.dy2_inv, 8)


def compare_warm(torch, rng) -> float:
    """sor_warm_sweeps at the four levels the mg path gives it (2050^2,
    1026^2, 514^2, 258^2), at levels smaller than a few tiles (130^2, 66^2,
    10^2) and at 99 x 63, against its plain twin and against its first
    kernel sor_warm_sweeps_simple, for omega 1 and 1.7 and 0, 1, 2 and 32
    sweeps (32 sweeps are four launches), from a p0 whose ghost ring is not
    0: error 0.0 and the ring kept.  Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels, _ = mg_levels()
    cases = [(lv.shape, lv.dx2_inv, lv.dy2_inv) for lv in levels
             if lv.shape[0] in (2050, 1026, 514, 258, 130, 66, 10)]
    cases.append(((99, 63), 97.0 ** 2, (61 / 0.7) ** 2))
    worst = 0.0
    for shape, dx2, dy2 in cases:
        for omega in (1.0, 1.7):
            for n in (0, 1, MG_SWEEPS, 32):
                p0, rhs = (random_grid(torch, rng,
                                       (shape[0] - 2, shape[1] - 2),
                                       ring=True) for _ in range(2))
                got = sor_kernel.warm_sweeps(p0, rhs, n, omega, dx2, dy2)
                want = sor_kernel.warm_sweeps_plain(p0, rhs, n, omega, dx2,
                                                    dy2)
                first = sor_kernel.warm_sweeps_simple(p0, rhs, n, omega, dx2,
                                                      dy2)
                torch.cuda.synchronize()
                err = max(float((got - want).abs().max()),
                          float((got - first).abs().max()))
                ring_kept = all(torch.equal(a, b) for a, b in (
                    (got[0], p0[0]), (got[-1], p0[-1]), (got[:, 0], p0[:, 0]),
                    (got[:, -1], p0[:, -1])))
                print(f"[compare] sor_warm {shape} omega={omega} "
                      f"n={n}: max abs err {err:.3e} vs the plain twin and "
                      f"sor_warm_sweeps_simple (expected 0), ghost ring kept "
                      f"{ring_kept}")
                check(err == 0.0 and ring_kept,
                      f"warm-start kernel disagrees at {shape}, "
                      f"omega={omega}, n={n}")
                worst = max(worst, err)
    return worst


def cycle_on_simple(p, rhs, levels):
    """ops/mg.py's V-cycle from levels[0] down with the first smoother
    kernel (sor_warm_sweeps_simple) on every level and no coarse cycle:
    the cycle as it ran before the smoother's redesign."""
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    def smooth(q, rhs_l, lvl, n):
        return sor_kernel.warm_sweeps_simple(q, rhs_l, n, 1.0, lvl.dx2_inv,
                                             lvl.dy2_inv)

    return mg._cycle(p, rhs, levels, 0, 2, 2, 32, smooth, mg._down_plain,
                     mg._up_plain, len(levels))


def transfer_cases(torch, rng):
    """(level, its coarse level, p, rhs, e_c, p's ghost ring) on the card
    for the grid transfers: configs/4.in's four levels above the coarse cycle and a
    non-square 2048 x 1024 level, p's ghost ring random, and the finest
    again with p's ghost ring -0.0 (the add must turn it into +0.0)."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg

    levels, depth = mg_levels()
    wide = mg.build_levels(Params(i_max=CHANNEL_WIDE[0],
                                  j_max=CHANNEL_WIDE[1], a=1.0, b=0.5))
    pairs = [(lv, levels[k + 1]) for k, lv in enumerate(levels[:depth])]
    pairs += [wide[:2], pairs[0]]
    cases = []
    for k, (lvl, coarse) in enumerate(pairs):
        size = (lvl.shape[0] - 2, lvl.shape[1] - 2)
        p = random_grid(torch, rng, size, ring=True) / lvl.dx2_inv
        ring = "random"
        if k == len(pairs) - 1:
            ring = "-0.0"
            for edge in (p[0], p[-1], p[:, 0], p[:, -1]):
                edge.fill_(-0.0)
        rhs = random_grid(torch, rng, size, ring=True)
        e_c = random_grid(torch, rng, (coarse.shape[0] - 2,
                                       coarse.shape[1] - 2), ring=False)
        cases.append((lvl, coarse, p, rhs, e_c, ring))
    return cases


def compare_transfers(torch, rng):
    """mg_restrict and mg_prolong against their plain twins (ops/mg.py's
    _down_plain and _up_plain) at transfer_cases' levels: error 0.0 and
    the same sign bits.  Returns the max abs error of each."""
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    worst = [0.0, 0.0]
    for lvl, coarse, p, rhs, e_c, ring in transfer_cases(torch, rng):
        pairs = (
            (sor_kernel.mg_restrict(p, rhs, lvl.dx2_inv, lvl.dy2_inv),
             mg._down_plain(p, rhs, lvl, coarse)),
            ((sor_kernel.mg_prolong(p, e_c),), (mg._up_plain(p, e_c, lvl),)))
        torch.cuda.synchronize()
        for k, (name, (got, want)) in enumerate(zip(
                ("mg_restrict", "mg_prolong"), pairs)):
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            signs = all(torch.equal(torch.signbit(g), torch.signbit(w))
                        for g, w in zip(got, want))
            print(f"[compare] {name} at {lvl.shape} (ring {ring}): max abs "
                  f"err {err:.3e} vs its plain twin (expected 0), signs "
                  f"equal {signs}")
            check(err == 0.0 and signs,
                  f"{name} disagrees with its twin at {lvl.shape}")
            worst[k] = max(worst[k], err)
    return tuple(worst)


def compare_coarse_cycle(torch, rng) -> float:
    """mg_coarse_cycle on the tail of configs/4.in's hierarchy (from the
    depth the mg path enters it, and one level further down), on the
    one-level 6 x 6 tail of the sharded mg path's replicated coarse solve
    and on configs/convection.in's whole hierarchy from 66^2 (the depth
    its mg path enters it at: every level),
    against its plain twin coarse_cycle_plain and against the same
    recursion on sor_warm_sweeps_simple, from a random p and rhs (ghost
    rings not 0): error 0.0.  Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels, depth = mg_levels()
    hot, hot_depth = mg_levels(CONVECTION_CONFIG)
    worst = 0.0
    for tail in (levels[depth:], levels[depth + 1:], sharded_mg_levels()[1],
                 hot[hot_depth:]):
        size = (tail[0].shape[0] - 2, tail[0].shape[1] - 2)
        p, rhs = (random_grid(torch, rng, size, ring=True) for _ in range(2))
        got = sor_kernel.coarse_cycle(p, rhs, tail)
        want = sor_kernel.coarse_cycle_plain(p, rhs, tail)
        first = cycle_on_simple(p, rhs, tail)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float((got - first).abs().max()))
        print(f"[compare] mg_coarse_cycle {len(tail)} levels from "
              f"{tail[0].shape} ({sor_kernel.cycle_shared_bytes(tail)} B of "
              f"shared memory): max abs err {err:.3e} vs coarse_cycle_plain "
              f"and the recursion on sor_warm_sweeps_simple (expected 0)")
        check(err == 0.0, f"coarse cycle disagrees from {tail[0].shape}")
        worst = max(worst, err)
    return worst


def ext_setup(tag: str, size, mesh, warm: bool):
    """(ext_sweeps' last argument, li, lj, K, the blocks' global origins)
    of an EXT_CASES cut: the Params of the config file its tag names,
    another grid's, or (warm)
    a multigrid level's constants with omega = 1 and K = its sweeps: the
    sharded mg path's own level of that size, else made-up ones."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.parallel import deep_halo, topology

    li, lj = topology.local_block_dims(mesh, *size)
    origins = [(ax * li, ay * lj) for ax in range(mesh[0])
               for ay in range(mesh[1])]
    if tag.startswith("sharded mg"):
        level = next(lvl for lvl in sharded_mg_levels()[0]
                     if lvl.g_dims == size)
        return ((*level.g_dims, 1.0, level.dx2_inv, level.dy2_inv), li, lj,
                MG_SWEEPS, origins)
    if warm:
        return ((*size, 1.0, 0.9 * size[0] ** 2, 1.3 * size[1] ** 2), li, lj,
                MG_SWEEPS, origins)
    if tag.startswith("configs/"):
        prm = Params.from_file(str(ROOT / tag.split()[0]))
        check(prm.shape == (size[0] + 2, size[1] + 2),
              f"{tag}: the case's size is not its config's")
    else:
        prm = Params(i_max=size[0], j_max=size[1], a=1.0, b=0.7, Re=1000.0,
                     omega=1.7)
    return prm, li, lj, deep_halo.comm_depth(prm, li, lj), origins


def random_grid(torch, rng, size, ring: bool):
    """A padded f32 grid on the card, random on the interior (and on the
    ghost ring when `ring`), else 0."""
    shape = (size[0] + 2, size[1] + 2)
    g = rng.standard_normal(shape).astype(np.float32)
    if not ring:
        g[0], g[-1], g[:, 0], g[:, -1] = 0, 0, 0, 0
    return torch.from_numpy(g).cuda()


def compare_ext(torch, rng) -> float:
    """sor_ext_sweeps against its twin ext_sweeps_plain on every block of
    every EXT_CASES cut, on every cell at least 2 ns from the block's edge
    (the twin's rolls wrap around there, the kernel reads zeros): error
    0.0, and the cells outside the global interior keep their input.
    Returns the max abs error."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    worst = 0.0
    for tag, size, mesh, sweeps, warm in EXT_CASES:
        consts, li, lj, K, origins = ext_setup(tag, size, mesh, warm)
        H = 2 * K
        i_max, j_max, (_, _, dx2, dy2) = sor_kernel.ext_constants(consts)
        delta0 = random_grid(torch, rng, size, ring=warm)
        rhs = random_grid(torch, rng, size, ring=warm)
        for ns in sweeps:
            err, kept = 0.0, True
            for origin in origins:
                d_ext = deep_halo.cut_ext_block(delta0, origin, li, lj, H)
                r_ext = deep_halo.cut_ext_block(rhs, origin, li, lj, H)
                got = sor_kernel.ext_sweeps(d_ext, r_ext, ns, origin, H,
                                            consts)
                want = sor_kernel.ext_sweeps_plain(d_ext, r_ext, ns, origin,
                                                   H, consts)
                interior = sor_kernel.ext_masks(got.shape, H, origin, i_max,
                                                j_max, dx2, dy2,
                                                device=got.device)[0]
                torch.cuda.synchronize()
                e = 2 * ns
                inner = (slice(e, got.shape[0] - e),
                         slice(e, got.shape[1] - e))
                err = max(err, float((got[inner] - want[inner]).abs().max()))
                kept = kept and torch.equal(got[~interior], d_ext[~interior])
            print(f"[compare] sor_ext {tag}: {len(origins)} blocks of ext "
                  f"{li + 2 * H}x{lj + 2 * H}, H={H}, ns={ns}: max abs err "
                  f"{err:.3e} on cells >= {2 * ns} from the edge (expected 0)"
                  f", cells outside the interior kept {kept}")
            check(err == 0.0 and kept,
                  f"extended-block kernel disagrees ({tag}, ns={ns})")
            worst = max(worst, err)
    return worst


def phase_decomposition(torch) -> None:
    """For every EXT_CASES cut: n sweeps block by block through
    sor_ext_sweeps in chunks of K (each chunk's blocks cut from the grid
    the chunk before left: the deep exchange), the cores assembled, equal
    the whole-grid kernels on the whole grid bit for bit: sor_sweeps_simple
    (the first kernel, no tile), sor_sweeps and sor_tiled_sweeps from
    delta = 0, sor_warm_sweeps_simple and sor_warm_sweeps for the warm
    start."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    rng = np.random.default_rng(5)
    for tag, size, mesh, sweeps, warm in EXT_CASES:
        consts, li, lj, K, origins = ext_setup(tag, size, mesh, warm)
        H = 2 * K
        rhs = random_grid(torch, rng, size, ring=warm)
        start = (random_grid(torch, rng, size, ring=True) if warm
                 else torch.zeros_like(rhs))
        # A cold start also runs two chunks (K + 5 sweeps).
        for n in sweeps if warm else (*sweeps, K + 5):
            delta, done = start, 0
            while done < n:
                ns = min(K, n - done)
                nxt = delta.clone()
                for ox, oy in origins:
                    ext = sor_kernel.ext_sweeps(
                        deep_halo.cut_ext_block(delta, (ox, oy), li, lj, H),
                        deep_halo.cut_ext_block(rhs, (ox, oy), li, lj, H),
                        ns, (ox, oy), H, consts)
                    ri, rj = min(li, size[0] - ox), min(lj, size[1] - oy)
                    nxt[1 + ox:1 + ox + ri, 1 + oy:1 + oy + rj] = \
                        ext[H:H + ri, H:H + rj]
                delta, done = nxt, done + ns
            if warm:
                refs = {"sor_warm_sweeps_simple":
                        sor_kernel.warm_sweeps_simple(start, rhs, n,
                                                      *consts[2:]),
                        "sor_warm_sweeps": sor_kernel.warm_sweeps(
                            start, rhs, n, *consts[2:])}
            else:
                refs = {"sor_sweeps_simple":
                        sor_kernel.whole_grid_sweeps_simple(rhs, n, consts),
                        "sor_sweeps": sor_kernel.whole_grid_sweeps(
                            rhs, n, consts),
                        "sor_tiled_sweeps": sor_kernel.inner_sweeps_tiled(
                            rhs, n, consts)}
            torch.cuda.synchronize()
            same = {name: torch.equal(delta, ref)
                    for name, ref in refs.items()}
            print(f"[decomposition] {tag}: {len(origins)} blocks, n={n} in "
                  f"chunks of {K}: assembled cores equal {same}")
            check(all(same.values()),
                  f"the decomposition differs from the whole grid ({tag}, "
                  f"n={n})")


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the least time the card could take to move
    n_bytes through device memory and do n_flops f32 operations, the larger
    of the two at the published peaks, and which one it is."""
    t_mem = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_F32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def sweeps_bound(shape, arrays: int, updated_cells: int, n_sweeps: int):
    """bound() of n_sweeps red-black sweeps over `updated_cells` cells of
    an f32 array of `shape`, with `arrays` such arrays read once or written
    once (rhs and delta from delta = 0: 2; delta0, rhs and delta: 3)."""
    return bound(arrays * 4 * shape[0] * shape[1],
                 SWEEP_FLOPS_PER_CELL * updated_cells * n_sweeps)


def cycle_bound(levels, nu1: int = 2, nu2: int = 2, coarse_sweeps: int = 32):
    """bound() of one coarse cycle: p and rhs of the first level read and p
    written once; the sweeps' updates, 12 operations per cell for the
    residual (self_coef not counted), 4 per coarse cell for the restriction
    and 1 per cell for the correction."""
    flops, last = 0, len(levels) - 1
    for k, lvl in enumerate(levels):
        cells = (lvl.shape[0] - 2) * (lvl.shape[1] - 2)
        if k == last:
            flops += SWEEP_FLOPS_PER_CELL * cells * coarse_sweeps
        else:
            flops += (SWEEP_FLOPS_PER_CELL * (nu1 + nu2) + 12 + 1 + 1) * cells
    shape = levels[0].shape
    return bound(3 * 4 * shape[0] * shape[1], flops)


def time_transfers(torch, rng) -> dict:
    """mg_restrict and mg_prolong at configs/4.in's finest level (2050^2)
    beside their plain twins, in turns (plain, kernel, kernel, plain; ms
    per call by CUDA events, the host's cost included), and each kernel's
    device time in a CUDA graph (20 calls on the same arrays, which the
    50 MB L2 partly holds between calls) beside its bound: the bytes of
    its arrays read once or written once (restriction: p, rhs, r_c, e_c;
    prolongation: p, e_c, the new p).  Returns (kernel ms, plain ms, bound
    ms, bound by) per kernel."""
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    levels, _ = mg_levels()
    lvl, coarse = levels[0], levels[1]
    size = (lvl.shape[0] - 2, lvl.shape[1] - 2)
    p = random_grid(torch, rng, size, ring=True) / lvl.dx2_inv
    rhs = random_grid(torch, rng, size, ring=True)
    e_c = random_grid(torch, rng, (coarse.shape[0] - 2, coarse.shape[1] - 2),
                      ring=False)
    fine = lvl.shape[0] * lvl.shape[1]
    cells = coarse.shape[0] * coarse.shape[1]
    # name: (kernel, plain, bound): the residual's 12 operations a fine
    # cell and the restriction's 4 a coarse cell; the add's 1 a fine cell.
    cases = {
        "mg_restrict": (
            lambda: sor_kernel.mg_restrict(p, rhs, lvl.dx2_inv, lvl.dy2_inv),
            lambda: mg._down_plain(p, rhs, lvl, coarse),
            bound(4 * (2 * fine + 2 * cells), 12 * fine + 4 * cells)),
        "mg_prolong": (lambda: sor_kernel.mg_prolong(p, e_c),
                       lambda: mg._up_plain(p, e_c, lvl),
                       bound(4 * (2 * fine + cells), fine)),
    }
    out = {}
    for name, (kernel, plain, (b_ms, b_by)) in cases.items():
        p1 = cuda_ms(torch, plain, 20)
        k1 = cuda_ms(torch, kernel, 200)
        k2 = cuda_ms(torch, kernel, 200)
        p2 = cuda_ms(torch, plain, 20)
        device_ms = graph_ms(torch, kernel)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, b_by)
        print(f"[time] {name} at {lvl.shape}: kernel {k1:.4f} / {k2:.4f} ms "
              f"per call, {device_ms * 1e3:.2f} us of device time in a CUDA "
              f"graph; plain {p1:.4f} / {p2:.4f} ms per call; bound "
              f"{b_ms * 1e3:.2f} us ({b_by})")
    return out


def tile_note(sor_kernel, tile_rows: int, ns: int, halo: int,
              updates: int, k_ms: float) -> str:
    """The tile's geometry on the card, its cell updates per written cell
    and the call's useful cell updates per second (`updates` in k_ms)."""
    g = sor_kernel.tile_report(tile_rows, sor_kernel.TILE_COLS, halo)
    per_cell = sor_kernel.tile_updates_per_cell(tile_rows,
                                                sor_kernel.TILE_COLS, ns)
    return (f"; tile {tile_rows}x{sor_kernel.TILE_COLS} + halo {halo} "
            f"({g['rows']}x{g['cols']} in shared memory), {ns} sweeps per "
            f"launch, {g['threads']} threads, {g['shared_bytes']} B shared, "
            f"{g['blocks_per_sm']} blocks per SM, {g['registers']} registers,"
            f" rows per thread {g['rows_per_thread']}; "
            f"{per_cell:.3f} updates per written cell; "
            f"{updates / (k_ms * 1e-3) / 1e9:.2f} G cell updates/s")


def phase_time(torch) -> dict:
    """Kernel and plain times at the SOR main path's 258^2 padded grid, (the
    smoother) at the mg path's finest 2050^2 level and (the tiled kernel) at
    the tiled path's 2050^2, in turns (plain, kernel, kernel, plain), the
    whole-grid kernel and the smoother with their first kernels
    (sor_sweeps_simple, sor_warm_sweeps_simple) between the turns; the
    smoother at 66^2 for 2 and 32 sweeps and the coarse cycle from 130^2
    and from 66^2 down the same way; the momentum kernel (time_momentum)
    and the compressed kernel (time_compressed) beside their first
    kernels; the tiled kernel with the first whole-grid kernel and the
    current one beside it (plain, kernel, simple, sor_sweeps, kernel,
    plain); the extended-block kernel at the sharded path's 2080^2 block of
    configs/4.in, one call of K = 8 sweeps, with one 8-sweep chunk of the
    tiled kernel at 2050^2 beside it.  Returns (kernel ms, plain ms,
    bound ms, bound by) per kernel: the tiled kernel's and the momentum
    kernel's at 2050^2."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    rng = np.random.default_rng(1)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs).cuda()
    p_fine = torch.from_numpy(
        rng.standard_normal(MG_FINE_SHAPE).astype(np.float32)).cuda()
    rhs_fine = torch.from_numpy(
        rng.standard_normal(MG_FINE_SHAPE).astype(np.float32)).cuda()
    warm_args = (p_fine, rhs_fine, MG_SWEEPS, 1.0, MG_FINE_DX2_INV,
                 MG_FINE_DX2_INV)
    prm4 = Params.from_file(str(ROOT / "configs" / "4.in"))
    rhs4 = np.zeros(prm4.shape, np.float32)
    rhs4[1:-1, 1:-1] = rng.standard_normal((prm4.i_max, prm4.j_max))
    rhs4 = torch.from_numpy(rhs4).cuda()

    levels, depth = mg_levels()
    tail = levels[depth:]
    p_tail, rhs_tail = (torch.from_numpy(rng.standard_normal(
        tail[0].shape).astype(np.float32)).cuda() for _ in range(2))
    # name: (kernel, plain, first kernel or None, kernel reps, plain reps)
    cases = {
        "sor": (lambda: sor_kernel.inner_sweeps(rhs, SOR_SWEEPS, prm),
                lambda: sor_kernel.inner_sweeps_plain(rhs, SOR_SWEEPS, prm),
                lambda: sor_kernel.whole_grid_sweeps_simple(rhs, SOR_SWEEPS,
                                                            prm),
                50, 3),
        "sor_warm": (lambda: sor_kernel.warm_sweeps(*warm_args),
                     lambda: sor_kernel.warm_sweeps_plain(*warm_args),
                     lambda: sor_kernel.warm_sweeps_simple(*warm_args),
                     100, 10),
        "mg_coarse_cycle": (
            lambda: sor_kernel.coarse_cycle(p_tail, rhs_tail, tail),
            lambda: sor_kernel.coarse_cycle_plain(p_tail, rhs_tail, tail),
            lambda: cycle_on_simple(p_tail, rhs_tail, tail), 100, 5),
    }
    interior = prm.i_max * prm.j_max
    bounds = {"sor": sweeps_bound(prm.shape, 2, interior, SOR_SWEEPS),
              "sor_warm": sweeps_bound(MG_FINE_SHAPE, 3,
                                       (MG_FINE_SHAPE[0] - 2)
                                       * (MG_FINE_SHAPE[1] - 2), MG_SWEEPS),
              "mg_coarse_cycle": cycle_bound(tail),
              "sor_tiled": sweeps_bound(prm4.shape, 2,
                                        prm4.i_max * prm4.j_max, SOR_SWEEPS),
              "sor_compressed": sweeps_bound(prm.shape, 2, interior,
                                             SOR_SWEEPS)}
    times = {}
    for name, (kernel, plain, first, k_reps, p_reps) in cases.items():
        p1 = cuda_ms(torch, plain, p_reps)
        k1 = cuda_ms(torch, kernel, k_reps)
        f_ms = cuda_ms(torch, first, k_reps) if first else None
        k2 = cuda_ms(torch, kernel, k_reps)
        p2 = cuda_ms(torch, plain, p_reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *bounds[name])
        shape, per = prm.shape, ""
        if name == "sor":
            per = (f" ({SOR_SWEEPS} sweeps, tile "
                   f"{'x'.join(map(str, sor_kernel.whole_grid_tile(shape)))})")
        elif name == "sor_warm":
            shape, per = MG_FINE_SHAPE, f" ({MG_SWEEPS} sweeps, omega=1)"
        elif name == "mg_coarse_cycle":
            shape, per = tail[0].shape, f" ({len(tail)} levels, V(2,2), 32)"
        simple = ""
        if first:
            what = ("the recursion on the first kernel"
                    if name == "mg_coarse_cycle" else "first kernel")
            simple = f", {what} (one launch per half-sweep) {f_ms:.4f} ms"
        print(f"[time] {name} at {shape}{per}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms{simple} per call")

    # The smoother at 66^2 (two tiles), a V-cycle's 2 sweeps and the coarse
    # solve's 32, and the coarse cycle entered one level further down
    # (66^2), each beside the first kernel.
    lv66 = next(lv for lv in levels if lv.shape[0] == 66)
    p66, rhs66 = (torch.from_numpy(rng.standard_normal(lv66.shape).astype(
        np.float32)).cuda() for _ in range(2))
    for n in (MG_SWEEPS, 32):
        args66 = (p66, rhs66, n, 1.0, lv66.dx2_inv, lv66.dy2_inv)
        k1 = cuda_ms(torch, lambda: sor_kernel.warm_sweeps(*args66), 200)
        f_ms = cuda_ms(torch, lambda: sor_kernel.warm_sweeps_simple(*args66),
                       200)
        k2 = cuda_ms(torch, lambda: sor_kernel.warm_sweeps(*args66), 200)
        b_ms, by = sweeps_bound(lv66.shape, 3, 64 * 64, n)
        print(f"[time] sor_warm at {lv66.shape} ({n} sweeps): kernel "
              f"{k1:.4f} / {k2:.4f} ms, first kernel {f_ms:.4f} ms per call; bound "
              f"{b_ms * 1e3:.4f} us ({by})")
    tail66 = levels[depth + 1:]
    k1 = cuda_ms(torch, lambda: sor_kernel.coarse_cycle(p66, rhs66, tail66),
                 200)
    f_ms = cuda_ms(torch, lambda: cycle_on_simple(p66, rhs66, tail66), 20)
    k2 = cuda_ms(torch, lambda: sor_kernel.coarse_cycle(p66, rhs66, tail66),
                 200)
    print(f"[time] mg_coarse_cycle at {tail66[0].shape} ({len(tail66)} "
          f"levels): kernel {k1:.4f} / {k2:.4f} ms, the recursion on the "
          f"first kernel {f_ms:.4f} ms per call")

    times["momentum"] = time_momentum(torch, rng, prm)
    times["sor_compressed"] = time_compressed(torch, prm, rhs, bounds)
    times["pressure_defect"] = time_defect(torch, rng)
    times.update(time_transfers(torch, rng))

    # The tiled kernel at 258^2 and 2050^2, each beside its plain twin, the
    # first whole-grid kernel and the current one, 64 sweeps.
    side_by_side = [
        ("sor_tiled", prm, rhs, sor_kernel.inner_sweeps_tiled,
         sor_kernel.inner_sweeps_tiled_plain, 10),
        ("sor_tiled", prm4, rhs4, sor_kernel.inner_sweeps_tiled,
         sor_kernel.inner_sweeps_tiled_plain, 2)]
    for name, p_, r_, kernel, plain, p_reps in side_by_side:
        def run(fn, p_=p_, r_=r_):
            return lambda: fn(r_, SOR_SWEEPS, p_)
        p1 = cuda_ms(torch, run(plain), p_reps)
        k1 = cuda_ms(torch, run(kernel), 20)
        b1 = cuda_ms(torch, run(sor_kernel.whole_grid_sweeps_simple), 20)
        b2 = cuda_ms(torch, run(sor_kernel.whole_grid_sweeps), 20)
        k2 = cuda_ms(torch, run(kernel), 20)
        p2 = cuda_ms(torch, run(plain), p_reps)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *bounds[name])
        K = sor_kernel.SWEEPS_PER_CHUNK
        note = tile_note(sor_kernel, sor_kernel.TILE_ROWS, K, 2 * K,
                         p_.i_max * p_.j_max * SOR_SWEEPS, (k1 + k2) / 2)
        print(f"[time] {name} at {p_.shape} ({SOR_SWEEPS} sweeps): kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"sor_sweeps_simple {b1:.4f} ms, sor_sweeps {b2:.4f} ms per "
              f"call; per sweep kernel "
              f"{(k1 + k2) / 2 * 1e3 / SOR_SWEEPS:.3f} us, sor_sweeps "
              f"{b2 * 1e3 / SOR_SWEEPS:.3f} us{note}")
    for tile in TILE_SIZES[1:]:
        def tiled(tile=tile):
            return sor_kernel.inner_sweeps_tiled(rhs4, SOR_SWEEPS, prm4,
                                                 tile_rows=tile)
        t1, t2 = cuda_ms(torch, tiled, 20), cuda_ms(torch, tiled, 20)
        K = sor_kernel.SWEEPS_PER_CHUNK
        note = tile_note(sor_kernel, tile, K, 2 * K,
                         prm4.i_max * prm4.j_max * SOR_SWEEPS, (t1 + t2) / 2)
        print(f"[time] sor_tiled at {prm4.shape} tile={tile} ({SOR_SWEEPS} "
              f"sweeps): kernel {t1:.4f} / {t2:.4f} ms per call{note}")

    # The extended-block kernel on the sharded path's one block of
    # configs/4.in (li = lj = 2048, K = 8, H = 16): one call of K sweeps,
    # beside one K-sweep chunk of the tiled kernel on the whole grid.
    K = deep_halo.comm_depth(prm4, prm4.i_max, prm4.j_max)
    H = 2 * K
    delta4 = np.zeros(prm4.shape, np.float32)
    delta4[1:-1, 1:-1] = rng.standard_normal((prm4.i_max, prm4.j_max))
    d_ext, r_ext = (deep_halo.cut_ext_block(g, (0, 0), prm4.i_max,
                                            prm4.j_max, H)
                    for g in (torch.from_numpy(delta4).cuda(), rhs4))

    def ext(fn):
        return lambda: fn(d_ext, r_ext, K, (0, 0), H, prm4)

    p1 = cuda_ms(torch, ext(sor_kernel.ext_sweeps_plain), 5)
    k1 = cuda_ms(torch, ext(sor_kernel.ext_sweeps), 50)
    b1 = cuda_ms(torch, lambda: sor_kernel.inner_sweeps_tiled(rhs4, K, prm4),
                 50)
    b2 = cuda_ms(torch, lambda: sor_kernel.inner_sweeps_tiled(rhs4, K, prm4),
                 50)
    k2 = cuda_ms(torch, ext(sor_kernel.ext_sweeps), 50)
    p2 = cuda_ms(torch, ext(sor_kernel.ext_sweeps_plain), 5)
    times["sor_ext"] = ((k1 + k2) / 2, (p1 + p2) / 2,
                        *sweeps_bound(d_ext.shape, 3,
                                      prm4.i_max * prm4.j_max, K))
    note = tile_note(sor_kernel, sor_kernel.EXT_TILE_ROWS, K, H,
                     prm4.i_max * prm4.j_max * K, (k1 + k2) / 2)
    print(f"[time] sor_ext at {tuple(d_ext.shape)} ({K} sweeps, H={H}): "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"sor_tiled ({K} sweeps at {prm4.shape}) {b1:.4f} / {b2:.4f} ms "
          f"per call{note}")
    for name, (k_ms, _, b_ms, by) in times.items():
        print(f"[time] {name}: bound {b_ms * 1e3:.3f} us ({by}), kernel "
              f"{k_ms * 1e3:.3f} us, {b_ms / k_ms:.4f} of the bound")
    k_ms, p_ms = times["sor"][:2]
    print(f"[time] sor per sweep: kernel {k_ms * 1e3 / SOR_SWEEPS:.3f} us, "
          f"plain {p_ms * 1e3 / SOR_SWEEPS:.3f} us")
    k_ms, p_ms = times["sor_warm"][:2]
    print(f"[time] sor_warm per sweep at {MG_FINE_SHAPE}: kernel "
          f"{k_ms * 1e3 / MG_SWEEPS:.3f} us, plain "
          f"{p_ms * 1e3 / MG_SWEEPS:.3f} us")
    return times


def time_momentum(torch, rng, prm1):
    """The fused momentum kernel at configs/1.in's 258^2 and at the mg
    path's 2050^2, in turns with its plain twin and its first kernel
    (momentum_rhs_simple, two launches): plain, kernel, first, kernel,
    first, plain.  Returns (kernel ms, plain ms, bound ms, bound by) at
    2050^2, where ~169 of a path's calls run."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import momentum_kernel

    prm4 = Params.from_file(str(ROOT / "configs" / "4.in"))
    out = None
    for prm, reps, p_reps in ((prm1, 200, 20), (prm4, 100, 5)):
        u, v = (torch.from_numpy(rng.standard_normal(prm.shape).astype(
            np.float32)).cuda() for _ in range(2))
        dt = torch.tensor(1e-3, device="cuda")
        gamma = torch.tensor(0.5, device="cuda")

        def run(fn, u=u, v=v, dt=dt, gamma=gamma, prm=prm):
            return lambda: fn(u, v, dt, gamma, prm)

        p1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_plain), p_reps)
        k1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs), reps)
        f1 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_simple), reps)
        k2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs), reps)
        f2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_simple), reps)
        p2 = cuda_ms(torch, run(momentum_kernel.momentum_rhs_plain), p_reps)
        g_k1 = graph_ms(torch, run(momentum_kernel.momentum_rhs))
        g_f = graph_ms(torch, run(momentum_kernel.momentum_rhs_simple))
        g_k2 = graph_ms(torch, run(momentum_kernel.momentum_rhs))
        b_ms, by = bound(5 * 4 * prm.shape[0] * prm.shape[1],
                         MOMENTUM_FLOPS_PER_CELL * prm.i_max * prm.j_max)
        print(f"[time] momentum at {prm.shape}: kernel {k1:.4f} / {k2:.4f} "
              f"ms, first kernel (two launches) {f1:.4f} / {f2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms per call; device time in a "
              f"CUDA graph: kernel {g_k1 * 1e3:.3f} / {g_k2 * 1e3:.3f} us, "
              f"first kernel {g_f * 1e3:.3f} us; bound {b_ms * 1e3:.3f} us "
              f"({by}), kernel call {b_ms / ((k1 + k2) / 2):.4f} of it, "
              f"device time {b_ms / ((g_k1 + g_k2) / 2):.4f}")
        out = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, by)
    return out


def time_defect(torch, rng):
    """The f64 outer's fused pass (one launch) at the SOR path's 258^2 and
    the mg path's 2050^2, in turns with its plain twin on the card (~28
    launches): plain, kernel, kernel, plain, per call, and the kernel's
    device time in a CUDA graph, beside its bytes bound.  Returns (kernel ms, plain ms,
    bound ms, bound by) at 2050^2."""
    from navierstokes_parallel_tpu_torch.ops import sor
    from navierstokes_parallel_tpu_torch.ops.cuda import defect_kernel

    out = None
    for n, reps, p_reps in ((256, 500, 100), (2048, 200, 20)):
        prm, p64, delta, rhs, threshold = defect_case(torch, rng, n, n)
        # Tiny corrections keep the master's scale over every timed pass.
        delta *= 1e-6
        rhs_full = torch.zeros(prm.shape, dtype=torch.float32, device="cuda")
        on = torch.ones((), dtype=torch.bool, device="cuda")
        iterations = torch.zeros((), dtype=torch.int64, device="cuda")
        res_norm = torch.zeros((), dtype=torch.float64, device="cuda")
        kernel = defect_kernel.outer_pass(p64, rhs, rhs_full, threshold, prm)
        master = [p64]

        def run_kernel():
            master[0] = kernel(master[0], delta, on, iterations, res_norm,
                               SOR_SWEEPS)

        p_master = p64.clone()
        plain = functools.partial(
            sor.outer_pass_plain, defect=sor._make_defect(rhs, prm),
            l2_fn=sor._default_l2(prm), threshold=threshold,
            rhs_full=rhs_full)

        def run_plain():
            plain(p_master, delta, on, iterations, res_norm, SOR_SWEEPS)

        p1 = cuda_ms(torch, run_plain, p_reps)
        k1 = cuda_ms(torch, run_kernel, reps)
        k2 = cuda_ms(torch, run_kernel, reps)
        p2 = cuda_ms(torch, run_plain, p_reps)
        g_k = graph_ms(torch, run_kernel)
        b_ms, by = bound(DEFECT_BYTES_PER_CELL * prm.i_max * prm.j_max, 0)
        print(f"[time] pressure_defect at {prm.shape}: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per call; kernel "
              f"device time in a CUDA graph {g_k * 1e3:.3f} us; bound "
              f"{b_ms * 1e3:.3f} us ({by}), the kernel's device time "
              f"{b_ms / g_k:.4f} of it")
        out = ((k1 + k2) / 2, (p1 + p2) / 2, b_ms, by)
    return out


def time_compressed(torch, prm, rhs, bounds):
    """The compressed kernel at configs/1.in's 258^2, 64 sweeps, in turns
    with its plain twin, its first kernel (inner_sweeps_compressed_simple,
    one launch per half-sweep), the whole-grid kernel B1 (the same tile on
    the full grid), B1's first kernel, its kernel part alone (on a
    compacted rhs: no compaction, no expansion) and the compaction and
    expansion alone.  Returns (kernel ms, plain ms, bound ms, bound by)."""
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    colours = sor_kernel._compress_planar(rhs)
    runs = {
        "plain": (lambda: sor_kernel.inner_sweeps_compressed_plain(
            rhs, SOR_SWEEPS, prm), 3),
        "kernel": (lambda: sor_kernel.inner_sweeps_compressed(
            rhs, SOR_SWEEPS, prm), 50),
        "first kernel": (lambda: sor_kernel.inner_sweeps_compressed_simple(
            rhs, SOR_SWEEPS, prm), 20),
        "kernel part": (lambda: sor_kernel.compressed_colour_sweeps(
            colours, SOR_SWEEPS, prm), 50),
        "sor_sweeps": (lambda: sor_kernel.whole_grid_sweeps(
            rhs, SOR_SWEEPS, prm), 50),
        "compaction + expansion": (lambda: sor_kernel._expand_planar(
            sor_kernel._compress_planar(rhs)), 50),
        "sor_sweeps_simple": (lambda: sor_kernel.whole_grid_sweeps_simple(
            rhs, SOR_SWEEPS, prm), 20)}
    order = ["plain", "kernel", "first kernel", "kernel part", "sor_sweeps",
             "compaction + expansion", "sor_sweeps_simple", "sor_sweeps",
             "kernel part", "kernel", "plain"]
    ms = {}
    for name in order:
        fn, reps = runs[name]
        ms.setdefault(name, []).append(cuda_ms(torch, fn, reps))
    print(f"[time] sor_compressed at {prm.shape} ({SOR_SWEEPS} sweeps, tile "
          f"{'x'.join(map(str, sor_kernel.whole_grid_tile(prm.shape)))}), "
          f"ms per call: " + ", ".join(
              f"{name} {' / '.join(f'{t:.4f}' for t in ts)}"
              for name, ts in ms.items()))
    mean = {name: sum(ts) / len(ts) for name, ts in ms.items()}
    # Device time of the kernel part and of B1, the same tile on the full
    # grid: what the compacted loads and stores change.
    g = [graph_ms(torch, runs[name][0])
         for name in ("kernel part", "sor_sweeps", "sor_sweeps",
                      "kernel part")]
    print(f"[time] sor_compressed kernel part / sor_sweeps: "
          f"{mean['kernel part'] / mean['sor_sweeps']:.3f} per call; device "
          f"time in a CUDA graph: kernel part {g[0] * 1e3:.3f} / "
          f"{g[3] * 1e3:.3f} us, sor_sweeps {g[1] * 1e3:.3f} / "
          f"{g[2] * 1e3:.3f} us; kernel / first kernel: "
          f"{mean['kernel'] / mean['first kernel']:.3f}")
    return (mean["kernel"], mean["plain"], *bounds["sor_compressed"])


# The kernel launch counters of utils/timing.py, by the names this file
# gives them.
LAUNCH_COUNTERS = {"sor": "launch.sor_whole_grid",
                   "sor_warm": "launch.sor_warm",
                   "mg_coarse_cycle": "launch.mg_coarse_cycle",
                   "mg_restrict": "launch.mg_restrict",
                   "mg_prolong": "launch.mg_prolong",
                   "momentum": "launch.momentum",
                   "sor_tiled": "launch.sor_tiled",
                   "sor_compressed": "launch.sor_compressed",
                   "sor_ext": "launch.sor_ext",
                   "pressure_defect": "launch.pressure_defect"}
_launch_start: dict = {}


def reset_launches() -> None:
    """Start counting launches from here (read_launches)."""
    from navierstokes_parallel_tpu_torch.utils import timing

    _launch_start.clear()
    _launch_start.update(timing.counts())


def read_launches() -> dict:
    """Each kernel's launches since the last reset_launches."""
    from navierstokes_parallel_tpu_torch.utils import timing

    now = timing.counts()
    return {key: now.get(name, 0) - _launch_start.get(name, 0)
            for key, name in LAUNCH_COUNTERS.items()}


def check_only(launches: dict, kernels, where: str) -> None:
    """Every kernel in `kernels` ran in the path and no other SOR kernel."""
    for name in kernels:
        check(launches[name] > 0, f"{where} launched no {name} kernel")
    for name in ("sor", "sor_warm", "mg_coarse_cycle", "sor_tiled",
                 "sor_compressed", "sor_ext"):
        if name not in kernels:
            check(launches[name] == 0, f"{where} launched the {name} kernel")


# The solve seconds of each run_cli run, by tag (the protocol phase prints
# its runs' beside those of the same runs without the protocol's files).
SOLVE_SECONDS = {}


def run_cli(tag: str, argv: list, u_want: float, v_want: float,
            stats_want: dict, rc_want: int = 0, stderr_needle: str = ""):
    """One CLI run, its answer held to a JAX record; returns its stats line
    as a dict and the kernels' launch counts in that run.  A run stopped by
    --max-steps before T exits with rc_want = 3; stderr_needle must appear
    on its standard error.  u_want = None: a run with no JAX record of its
    centre values (they are printed, and its fields held otherwise)."""
    from navierstokes_parallel_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    launches = read_launches()
    print(f"[{tag}] stdout:", out.getvalue().strip().replace("\n", " | "))
    print(f"[{tag}] stderr:", err.getvalue().strip().replace("\n", " | "))
    check(rc == rc_want, f"cli.main returned {rc}, expected {rc_want}")
    check(stderr_needle in err.getvalue(),
          f"{stderr_needle!r} is not on standard error")
    lines = out.getvalue().splitlines()
    uc = float(lines[0].split()[1])
    vc = float(lines[1].split()[1])
    # The stats line (a library warning may precede it on stderr).
    stats = dict(tok.split("=") for tok in next(
        line for line in err.getvalue().splitlines()
        if line.startswith("steps=")).split())
    for key, want in stats_want.items():
        check(int(stats[key]) == want,
              f"{key}={stats[key]}, JAX recorded {want}")
    if u_want is not None:
        du, dv = contract_err(uc, u_want), contract_err(vc, v_want)
        print(f"[{tag}] U-CENTER {uc:.6f} vs JAX {u_want:.6f} (err "
              f"{du:.2e}), V-CENTER {vc:.6f} vs JAX {v_want:.6f} (err "
              f"{dv:.2e}), contract {CONTRACT:.0e}")
        check(max(du, dv) <= CONTRACT, "centre values outside the contract")
    else:
        print(f"[{tag}] U-CENTER {uc:.6f}, V-CENTER {vc:.6f} (no JAX record)")
    stats["solve_seconds"] = float(err.getvalue().splitlines()[-1])
    SOLVE_SECONDS[tag] = stats["solve_seconds"]
    print(f"[{tag}] solve seconds {stats['solve_seconds']}; "
          f"launches {launches}")
    return stats, launches


def phase_main_path() -> dict:
    """configs/1.in through the CLI at its K = 64 sweeps per outer pass,
    then with the benchmark's --refine-every 2048: the JAX record both
    times (every step runs into max_it, so the counts do not depend on K),
    one sor_sweeps call per outer pass and one for the CLI's warm-up.
    Returns the first run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params

    config = str(ROOT / "configs" / "1.in")
    prm = Params.from_file(config)
    runs = {}
    for tag, K, argv in (
            ("main", prm.sor_refine_every, []),
            (f"main K={BENCH_REFINE_EVERY}", BENCH_REFINE_EVERY,
             ["--refine-every", str(BENCH_REFINE_EVERY)])):
        stats, launches = run_cli(tag, [config, *argv, "--stats"],
                                  JAX_U_CENTER, JAX_V_CENTER, JAX_STATS)
        check_only(launches, ("sor", "momentum"), "the main path")
        calls = JAX_STATS["steps"] * -(-prm.max_it // K) + 1
        check(launches["sor"] == calls,
              f"{launches['sor']} sor_sweeps calls at K={K}, expected {calls}")
        runs[K] = (stats["solve_seconds"], launches)
    for K, (seconds, launches) in runs.items():
        print(f"[main] configs/1.in at K={K}: solve {seconds:.6f} s, "
              f"{launches['sor']} sor_sweeps calls")
    return runs[prm.sor_refine_every][1]


def phase_mg_path() -> dict:
    """configs/4.in with --method mg through the CLI, the plain twins of
    the smoother and of the coarse cycle barred (and the first smoother
    kernel); returns the kernels' launch counts.  With the coarse cycle
    entered at depth t, each V-cycle smooths twice on each of the t levels
    above it and calls the coarse cycle once, and the CLI's warm-up runs
    one cycle."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    config = ROOT / "configs" / "4.in"
    levels = mg.build_levels(Params.from_file(str(config)))
    depth = sor_kernel.coarse_cycle_depth(levels)
    print(f"[mg] {len(levels)} levels: "
          f"{' '.join('x'.join(map(str, lv.shape)) for lv in levels)}; the "
          f"coarse cycle from depth {depth} ({levels[depth].shape}, "
          f"{sor_kernel.cycle_shared_bytes(levels[depth:])} B of shared "
          f"memory)")
    check(0 < depth < len(levels), "the coarse cycle is not on the mg path")

    with barred(sor_kernel, ("warm_sweeps_plain", "coarse_cycle_plain",
                             "warm_sweeps_simple"), "the mg path"), \
            barred(mg, ("_down_plain", "_up_plain"), "the mg path"):
        stats, launches = run_cli(
            "mg", [str(config), "--method", "mg", "--stats"],
            JAX_MG_U_CENTER, JAX_MG_V_CENTER, JAX_MG_STATS)
    cycles = int(stats["sor_iterations"])
    smooths = (cycles + 1) * 2 * depth
    transfers = (cycles + 1) * depth
    print(f"[mg] {cycles} V-cycles in {stats['steps']} steps "
          f"({cycles / int(stats['steps']):.3f} per step); smoother calls "
          f"expected ({cycles} + 1) x 2 x {depth} = {smooths}, launched "
          f"{launches['sor_warm']}; transfers each way expected ({cycles} + "
          f"1) x {depth} = {transfers}, launched {launches['mg_restrict']} "
          f"/ {launches['mg_prolong']}; coarse cycles expected "
          f"{cycles + 1}, launched {launches['mg_coarse_cycle']}")
    check(launches["sor_warm"] == smooths,
          "warm-start kernel launches differ from the smoother calls")
    check(launches["mg_restrict"] == launches["mg_prolong"] == transfers,
          "transfer kernel launches differ from the levels above the tail")
    check(launches["mg_coarse_cycle"] == cycles + 1,
          "coarse-cycle launches differ from the V-cycles")
    check_only(launches, ("sor_warm", "mg_restrict", "mg_prolong",
                          "mg_coarse_cycle", "momentum"), "the mg path")
    return launches


def solve_on_card(torch, tag, prm, first_kernel: bool = False, **kw):
    """solver.solve on the card with the launch counts from 0; returns the
    state, its stats, the counts and the seconds on the host's clock around
    the call (to a synchronize; the time step's first use included).
    first_kernel: with PREFER_TILED off and sor_sweeps_simple, which counts
    no launch, in sor_sweeps' place."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    reset_launches()
    t0 = time.perf_counter()
    saved = (sor_kernel.PREFER_TILED, sor_kernel.whole_grid_sweeps)
    if first_kernel:
        sor_kernel.PREFER_TILED = False
        sor_kernel.whole_grid_sweeps = sor_kernel.whole_grid_sweeps_simple
    try:
        state, stats = solver.solve(prm, device="cuda",
                                    pressure_method="pallas_sor", **kw)
    finally:
        sor_kernel.PREFER_TILED, sor_kernel.whole_grid_sweeps = saved
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] {stats} in {seconds:.3f} s; launches {launches}")
    return state, stats, launches, seconds


def check_same_fields(a, b, what: str) -> None:
    same = {name: bool(getattr(a, name).equal(getattr(b, name)))
            for name in ("u", "v", "p")}
    print(f"[{what}] fields equal bit for bit: {same}")
    check(all(same.values()), f"{what}: the fields differ")


def phase_tiled_path(torch) -> dict:
    """configs/4.in --max-steps 2 through the CLI with the default method:
    the sweeps take the tiled kernel, with the whole-grid kernel and the
    plain sweeps barred.  One inner call per outer pass of K = 64 sweeps
    plus one for the CLI's warm-up.  Then the same steps through
    solver.solve on the tiled route and on the first whole-grid kernel (no
    tile): the same fields, bit for bit.  (sor_sweeps at 2050^2 is the
    tiled kernel with the same tile, so it is no second check.)  Returns
    the CLI run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    config = ROOT / "configs" / "4.in"
    prm = Params.from_file(str(config))
    check(sor_kernel.route(prm) == "tiled",
          f"configs/4.in routes to {sor_kernel.route(prm)}, not tiled")
    plain = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
             "whole_grid_sweeps", "whole_grid_sweeps_simple")
    with barred(sor_kernel, plain, "the tiled path"):
        stats, launches = run_cli(
            "tiled", [str(config), "--max-steps", str(TILED_STEPS), "--stats"],
            JAX_TILED_U_CENTER, JAX_TILED_V_CENTER, JAX_TILED_STATS,
            rc_want=3)
    res = float(stats["last_res_norm"])
    print(f"[tiled] last_res_norm {res:.4e} vs JAX {JAX_TILED_RES_NORM:.4e}")
    check(abs(res - JAX_TILED_RES_NORM) <= RES_NORM_RTOL * JAX_TILED_RES_NORM,
          "last_res_norm differs from the JAX record")
    # Every step ran into max_it: ceil(max_it / K) outer passes each.
    passes = TILED_STEPS * -(-prm.max_it // prm.sor_refine_every)
    print(f"[tiled] tiled kernel calls expected {passes} + 1 warm-up, "
          f"launched {launches['sor_tiled']}")
    check(launches["sor_tiled"] == passes + 1,
          "tiled kernel launches differ from the outer passes")
    check_only(launches, ("sor_tiled", "momentum"), "the tiled path")

    with barred(sor_kernel, plain, "the tiled solve"):
        tiled, tstats, tl, _ = solve_on_card(torch, "tiled", prm,
                                             max_steps=TILED_STEPS)
    first, fstats, fl, _ = solve_on_card(torch, "tiled/sor_sweeps_simple",
                                         prm, first_kernel=True,
                                         max_steps=TILED_STEPS)
    check(tstats == fstats,
          "the tiled and first-kernel solves' stats differ")
    check(tl["sor_tiled"] == passes and fl["sor"] == 0,
          "the solves' kernel calls differ from the outer passes")
    check_same_fields(tiled, first, "tiled vs sor_sweeps_simple")
    return launches


def phase_compressed_path(torch) -> dict:
    """configs/1.in through solver.solve on the colour-compressed kernel,
    the whole-grid kernel and the plain sweeps barred: the JAX record
    exactly, one kernel call per outer pass, and the whole-grid route's
    and the first whole-grid kernel's fields bit for bit.  Returns its
    launch counts."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    sor_kernel.USE_COMPRESSED = True
    try:
        check(sor_kernel.route(prm) == "compressed",
              f"configs/1.in routes to {sor_kernel.route(prm)}")
        with barred(sor_kernel, ("inner_sweeps_plain",
                                 "inner_sweeps_compressed_plain",
                                 "inner_sweeps_compressed_simple",
                                 "whole_grid_sweeps",
                                 "whole_grid_sweeps_simple"),
                    "the compressed path"):
            state, stats, launches, seconds = solve_on_card(
                torch, "compressed", prm)
    finally:
        sor_kernel.USE_COMPRESSED = False
    uc, vc = solver.center_values(state, prm)
    got = (stats.steps, stats.total_sor_iterations, stats.sor_failures,
           f"{uc:.6f}", f"{vc:.6f}")
    want = (*JAX_STATS.values(), f"{JAX_U_CENTER:.6f}", f"{JAX_V_CENTER:.6f}")
    print(f"[compressed] steps, sweeps, failures, U/V-CENTER {got}; JAX "
          f"{want}")
    check(got == want, "the compressed path differs from the JAX record")
    passes = stats.steps * -(-prm.max_it // prm.sor_refine_every)
    check(launches["sor_compressed"] == passes,
          f"compressed kernel calls {launches['sor_compressed']}, expected "
          f"{passes}")
    check_only(launches, ("sor_compressed", "momentum"), "the compressed path")
    whole, wstats, _, w_seconds = solve_on_card(torch, "compressed/sor_sweeps",
                                                prm)
    first, fstats, _, _ = solve_on_card(torch, "compressed/sor_sweeps_simple",
                                        prm, first_kernel=True)
    print(f"[compressed] solve {seconds:.6f} s on sor_compressed_sweeps "
          f"({launches['sor_compressed']} calls), {w_seconds:.6f} s on "
          f"sor_sweeps (host clock around solver.solve)")
    check(stats == wstats == fstats,
          "the compressed, whole-grid and first-kernel solves differ")
    check_same_fields(state, whole, "compressed vs sor_sweeps")
    check_same_fields(state, first, "compressed vs sor_sweeps_simple")
    return launches


def phase_sharded_path(torch) -> dict:
    """configs/4.in --backend sharded --mesh 1x1 --max-steps 2 through the
    CLI (a one-rank NCCL group): the JAX record, every chunk of K sweeps one
    sor_ext_sweeps call, with the whole-grid, tiled and compressed kernels
    and every plain sweep function barred.  Then the same steps through
    solve_sharded beside solver.solve on the tiled route: equal counts,
    fields within the contract.  Returns the CLI run's launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import (deep_halo, sharded,
                                                          topology)
    from navierstokes_parallel_tpu_torch.utils import distributed

    config = ROOT / "configs" / "4.in"
    prm = Params.from_file(str(config))
    # Each step runs into max_it: max_it // R outer passes of R sweeps and
    # one of the rest, each in chunks of K (R = sor_refine_every = 64,
    # K = 8: 312 passes of 8 chunks and one pass of 32 sweeps in 4).
    K = deep_halo.comm_depth(prm, prm.i_max, prm.j_max)
    R = prm.sor_refine_every
    per_step = (prm.max_it // R) * -(-R // K) + -(-(prm.max_it % R) // K)
    barred_fns = ("whole_grid_sweeps", "inner_sweeps_tiled",
                  "inner_sweeps_compressed", "inner_sweeps_plain",
                  "inner_sweeps_tiled_plain", "inner_sweeps_compressed_plain",
                  "warm_sweeps_plain", "ext_sweeps_plain",
                  "whole_grid_sweeps_simple", "warm_sweeps_simple",
                  "coarse_cycle_plain")
    with barred(sor_kernel, barred_fns, "the sharded path"):
        stats, launches = run_cli(
            "sharded", [str(config), *SHARDED_ARGV], JAX_TILED_U_CENTER,
            JAX_TILED_V_CENTER, JAX_TILED_STATS, rc_want=3)
    res = float(stats["last_res_norm"])
    print(f"[sharded] last_res_norm {res:.4e} vs JAX {JAX_TILED_RES_NORM:.4e}")
    check(abs(res - JAX_TILED_RES_NORM) <= RES_NORM_RTOL * JAX_TILED_RES_NORM,
          "last_res_norm differs from the JAX record")
    # The CLI's warm-up step runs one pass of one sweep: one more call.
    want = TILED_STEPS * per_step + 1
    print(f"[sharded] extended-block kernel calls expected {TILED_STEPS} x "
          f"{per_step} + 1 warm-up = {want}, launched {launches['sor_ext']}")
    check(launches["sor_ext"] == want,
          "extended-block kernel launches differ from the chunks")
    check_only(launches, ("sor_ext",), "the sharded path")

    reset_launches()
    t0 = time.perf_counter()
    with barred(sor_kernel, barred_fns, "the sharded solve"), \
            distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        state, sstats = sharded.solve_sharded(prm, mesh=mesh,
                                              max_steps=TILED_STEPS)
        torch.cuda.synchronize()
    ext_calls = read_launches()["sor_ext"]
    print(f"[sharded] solve_sharded {sstats} in {time.perf_counter() - t0:.3f}"
          f" s; extended-block kernel calls {ext_calls}")
    check(ext_calls == TILED_STEPS * per_step,
          "solve_sharded's kernel calls differ from the chunks")
    tiled, tstats, _, _ = solve_on_card(torch, "sharded/tiled", prm,
                                        max_steps=TILED_STEPS)
    check(sstats[:3] == tstats[:3],
          "the sharded and tiled solves' counts differ")
    errs = {name: contract_err(getattr(state, name).cpu().numpy(),
                               getattr(tiled, name).cpu().numpy())
            for name in ("u", "v", "p")}
    same = {name: bool(getattr(state, name).equal(getattr(tiled, name)))
            for name in ("u", "v", "p")}
    print(f"[sharded] vs the tiled route: contract errors {errs} (tol "
          f"{CONTRACT:.0e}), max {max(errs.values()):.3e}; fields equal bit "
          f"for bit: {same}")
    check(max(errs.values()) <= CONTRACT,
          "the sharded and tiled solves differ beyond the contract")
    return launches


def method_launches(tag: str, cycles: int) -> dict:
    """The kernel launches a METHOD_PATHS run must make (every other count
    0): B2 once per step and once for the warm-up, and the f64 outer's
    fused pass once per outer pass and once for the warm-up's, where the
    state is f32 on one device; on the sharded mg path, for each V-cycle and the warm-up's
    one, two sor_ext_sweeps calls on every sharded level above the coarsest
    and one mg_coarse_cycle for the replicated coarse solve."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg

    config, _, _, _, (steps, _, failures), _ = METHOD_PATHS[tag]
    if tag in ("jacobi", "fft"):
        # One problem with the default hooks: the f64 outer's fused pass,
        # one launch a pass, the warm-up's pass too.
        prm = Params.from_file(str(ROOT / "configs" / config))
        K = (max(1, prm.fft_solves_per_outer) if tag == "fft"
             else prm.sor_refine_every)
        return {"momentum": steps + 1, "pressure_defect": outer_passes(
            prm, K, cycles, failures) + 1}
    if tag == "sharded mg":
        prm = Params.from_file(str(ROOT / "configs" / config))
        levels = mg.build_levels_sharded(prm, prm.i_max, prm.j_max)
        return {"sor_ext": (cycles + 1) * 2 * (len(levels) - 1),
                "mg_coarse_cycle": cycles + 1}
    return {}


def phase_methods(torch) -> dict:
    """Every METHOD_PATHS run through the CLI, held to its JAX record, with
    the plain twins of the kernels (and every sweep route the path must not
    take) barred, and its kernel launches held to method_launches; on the
    fft path also one DCT solve on the card against the CPU's.  Returns the
    launch counts summed over the runs."""
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    plain = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
             "inner_sweeps_compressed_plain", "warm_sweeps_plain",
             "coarse_cycle_plain", "ext_sweeps_plain",
             "whole_grid_sweeps_simple", "warm_sweeps_simple",
             "inner_sweeps_compressed_simple")
    routes = ("whole_grid_sweeps", "inner_sweeps_tiled",
              "inner_sweeps_compressed")
    total, seconds = None, {}
    for tag, (config, argv, u, v, stats_want, rc) in METHOD_PATHS.items():
        where = f"the {tag} path"
        with barred(sor_kernel, plain + routes, where), \
                barred(momentum_kernel, ("momentum_rhs_plain",
                                         "momentum_rhs_simple"), where):
            stats, launches = run_cli(
                tag, [str(ROOT / "configs" / config), *argv, "--stats"], u, v,
                dict(zip(("steps", "sor_iterations", "sor_failures"),
                         stats_want)), rc_want=rc,
                stderr_needle="clamping to 0.8" if tag == "jacobi" else "")
        want = method_launches(tag, int(stats["sor_iterations"]))
        got = {k: n for k, n in launches.items() if n}
        print(f"[{tag}] kernel launches {got}, expected {want}")
        check(got == want, f"{where}'s kernel launches differ")
        seconds[tag] = stats["solve_seconds"]
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    compare_dct(torch)
    print("[methods] solve seconds: " + ", ".join(
        f"{tag} {t:.6f}" for tag, t in seconds.items()))
    return total


def compare_dct(torch) -> None:
    """One DCT pressure solve (ops/fft.py, cuFFT on the card) against the
    same solve on the CPU (pocketfft) at the fft path's 2048^2 and at an
    odd size: max |difference| within DCT_RTOL of max|p|."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import fft

    rng = np.random.default_rng(6)
    for i_max, j_max in DCT_SIZES:
        prm = Params(i_max=i_max, j_max=j_max, a=1.0, b=0.7)
        r = rng.standard_normal((i_max, j_max))
        r = torch.from_numpy((r - r.mean()).astype(np.float32))
        cpu = fft.poisson_solve_dct(r, prm)
        card = fft.poisson_solve_dct(r.cuda(), prm).cpu()
        err = float((card - cpu).abs().max() / cpu.abs().max())
        print(f"[fft] poisson_solve_dct at {i_max}x{j_max}: card vs CPU max "
              f"|difference| {err:.3e} of max|p| (tol {DCT_RTOL:.0e})")
        check(err <= DCT_RTOL, f"the DCT solve differs at {i_max}x{j_max}")


def outer_passes(prm, K: int, iterations: int, failures: int) -> int:
    """The outer passes of K inner steps behind a run's `iterations`, of
    which `failures` steps ran into max_it (ceil(max_it / K) passes each)
    and the others converged after whole passes."""
    return ((iterations - failures * prm.max_it) // K
            + failures * -(-prm.max_it // K))


def channel_launches(tag: str, prm, iterations: int) -> dict:
    """The kernel launches a CHANNEL_PATHS run must make (every other count
    0).  On one card one sor_sweeps call per outer pass of K sweeps (max_it
    // K + 1 passes in a step that runs into max_it) and one for the CLI's
    warm-up; B2 once per step and once for the warm-up under Euler, never
    under AB2.  On the 1x1 mesh one sor_ext_sweeps call per chunk of the
    deep-halo depth, K / depth per pass, and one for the warm-up."""
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    _, argv, _, _, (steps, _, failures), _, order, _ = CHANNEL_PATHS[tag]
    K = prm.sor_refine_every
    passes = outer_passes(prm, K, iterations, failures)
    if "sharded" in argv:
        depth = deep_halo.comm_depth(prm, prm.i_max, prm.j_max)
        check(K % depth == 0 and failures == 0,
              f"{tag}: the chunk count needs K a multiple of {depth}")
        return {"sor_ext": passes * (K // depth) + 1}
    want = {"sor": passes + 1}
    if order == 1:
        want["momentum"] = steps + 1
    return want


def stepped_channel(torch, prm, order: int, device: str = "cuda",
                    hooks=None):
    """CHANNEL_STEPS steps of the channel on `device`, one solver.Stepper
    step at a time, each pressure solve's residual norms read through its
    l2 hook (`hooks`, when given, replace the refined solve's others):
    returns the final state, the per-step outer passes and, per step, the
    relative margins (norm - threshold) / threshold of its last pass and
    of the pass before it."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.ops import sor

    norms = []
    refined = sor._solve_pressure_refined

    def recorded(p, rhs, params, **kw):
        kw.update(hooks or {})
        l2_fn = kw.get("l2_fn") or sor._default_l2(params)

        def l2(arr):
            norm = l2_fn(arr)
            norms.append(float(norm))
            return norm
        return refined(p, rhs, params, **{**kw, "l2_fn": l2})

    stepper = solver.Stepper(prm, solver.allocate_state(prm, device),
                             sor.default_method(prm, device), order)
    passes, margins = [], []
    sor._solve_pressure_refined = recorded
    try:
        for _ in range(CHANNEL_STEPS):
            norms.clear()
            diag = stepper.step()
            # The first norm is ||p0||, which sets the threshold.
            threshold = prm.epsilon * (norms[0] + sor.NORM_OFFSET)
            passes.append(diag.sor_iterations // prm.sor_refine_every)
            margins.append([(x - threshold) / threshold
                            for x in (norms[-1], norms[-2] if len(norms) > 2
                                      else float("inf"))])
    finally:
        sor._solve_pressure_refined = refined
    if device == "cuda":
        torch.cuda.synchronize()
    return stepper.state(), passes, margins


def channel_gate(passes, margins, jax_passes):
    """The per-step gate of a stepped channel run: for every step whose
    passes differ from JAX's, (step, passes, JAX's, the margin of the
    deciding pass, within the gate).  A step passes the gate if it moved
    by one pass with the card's residual at the deciding pass within
    NEAR_THRESHOLD of the threshold."""
    rows = []
    for k, (mine, theirs) in enumerate(zip(passes, jax_passes)):
        if mine == theirs:
            continue
        # Fewer passes: the card's last pass stopped where JAX's went on;
        # more: the card's pass before went on where JAX stopped.
        margin = margins[k][0 if mine < theirs else 1]
        rows.append((k, mine, theirs, margin, abs(mine - theirs) == 1 and
                     abs(margin) <= NEAR_THRESHOLD))
    return rows


def phase_channel(torch) -> dict:
    """The channel (CHANNEL_PATHS) through the CLI, each run held to its
    JAX record and its kernel launches to channel_launches, the plain twins
    and every sweep route the path must not take barred; the 50-step Euler
    and AB2 runs again step by step (stepped_channel): their passes held to
    JAX's per step (NEAR_THRESHOLD), the CLI's total to theirs, the profile
    errors to JAX's within the contract; then the Taylor-Green box at
    1024^2 under mg through solve_ab2 (phase_taylor_green).  Returns the
    launch counts summed over the CLI runs and the Taylor-Green run."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import channel
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    base = Params.from_file(str(ROOT / "configs" / "channel.in"))
    # Why ops/stencils.py::div: CUDA divides by a host scalar as a multiply
    # by its reciprocal, so F/G's "/ Re" would round otherwise than the
    # CPU's (and XLA's) true division.
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        1 << 20).astype(np.float32)).cuda()
    moved = int((x / base.Re != x / torch.full((), base.Re,
                                                device="cuda")).sum())
    print(f"[channel] x / {base.Re} by a host scalar and by a 0-d device "
          f"tensor differ in {moved} of {x.numel()} elements")
    wide = base.replace(i_max=CHANNEL_WIDE[0], j_max=CHANNEL_WIDE[1])
    CHANNEL_WIDE_CONFIG.parent.mkdir(parents=True, exist_ok=True)
    wide.to_file(str(CHANNEL_WIDE_CONFIG))
    for prm in (base, wide):
        tile = sor_kernel.whole_grid_tile(prm.shape)
        print(f"[channel] {prm.shape}: route {sor_kernel.route(prm)}, "
              f"tile {tile}")
        check(sor_kernel.route(prm) == "whole" and
              tile in sor_kernel.WHOLE_GRID_TILES,
              f"{prm.shape} does not take B1 on a compiled tile")
    plain = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
             "inner_sweeps_compressed_plain", "warm_sweeps_plain",
             "coarse_cycle_plain", "ext_sweeps_plain",
             "whole_grid_sweeps_simple", "warm_sweeps_simple",
             "inner_sweeps_compressed_simple")
    total, seconds, cli_iterations = None, {}, {}
    for tag, (config, argv, u, v, stats_want, rc, order,
              _) in CHANNEL_PATHS.items():
        where = f"the {tag} path"
        routes = ("inner_sweeps_tiled", "inner_sweeps_compressed")
        if "sharded" in argv:
            routes += ("whole_grid_sweeps",)
        prm = wide if config == CHANNEL_WIDE_CONFIG else base
        keys = ("steps", "sor_iterations", "sor_failures")
        want = dict(zip(keys, stats_want))
        if tag in JAX_CHANNEL_PASSES:  # held step by step below
            del want["sor_iterations"]
        with barred(sor_kernel, plain + routes, where), \
                barred(momentum_kernel, ("momentum_rhs_plain",
                                         "momentum_rhs_simple"), where):
            stats, launches = run_cli(
                tag, [str(ROOT / config), *argv, "--stats"], u, v, want,
                rc_want=rc)
        cli_iterations[tag] = int(stats["sor_iterations"])
        want = channel_launches(tag, prm, cli_iterations[tag])
        got = {k: n for k, n in launches.items() if n}
        print(f"[{tag}] kernel launches {got}, expected {want}")
        check(got == want, f"{where}'s kernel launches differ")
        seconds[tag] = stats["solve_seconds"]
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    print("[channel] solve seconds: " + ", ".join(
        f"{tag} {t:.6f}" for tag, t in seconds.items()))

    for tag, jax_passes in JAX_CHANNEL_PASSES.items():
        _, _, _, _, stats_want, _, order, jax_errors = CHANNEL_PATHS[tag]
        t0 = time.perf_counter()
        state, passes, margins = stepped_channel(torch, base, order)
        iterations = sum(passes) * base.sor_refine_every
        print(f"[{tag}] stepped: {iterations} sweeps in "
              f"{time.perf_counter() - t0:.3f} s (JAX {stats_want[1]}, the "
              f"CLI {cli_iterations[tag]})")
        check(iterations == cli_iterations[tag],
              f"{tag}: the CLI's and the stepped run's counts differ")
        for k, mine, theirs, margin, ok in channel_gate(passes, margins,
                                                        jax_passes):
            print(f"[{tag}] step {k}: {mine} passes, JAX {theirs}; the "
                  f"card's residual at the deciding pass {margin:+.3e} of "
                  f"the threshold (allowed within {NEAR_THRESHOLD:.0e})")
            check(ok, f"{tag}: step {k} moved away from its threshold")
        errors = channel.profile_errors(state.u, base)
        diff = max(abs(a - b) for a, b in zip(errors, jax_errors))
        print(f"[{tag}] profile errors {errors} vs JAX {jax_errors}: max "
              f"difference {diff:.3e} (contract {CONTRACT:.0e})")
        check(diff <= CONTRACT, f"{tag}: profile errors differ from JAX's")
    tg = phase_taylor_green(torch)
    return {k: total[k] + tg[k] for k in total}


def phase_taylor_green(torch) -> dict:
    """TG_STEPS steps of solver.solve_ab2 on the 1024^2 Taylor-Green box
    under mg, after its warm-up: the JAX record (counts, centre values
    within the contract, errors against the exact solution at most JAX's
    times 1 + TG_ERRORS_RTOL), with the smoother and coarse-cycle launches
    of its V-cycles and no other kernel (no B2 under AB2); the plain twins
    barred.  Returns the launch counts."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.models import taylorgreen
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    prm, state = taylorgreen.taylor_green(n=TG_N, device="cuda")
    levels = mg.build_levels(prm)
    depth = sor_kernel.coarse_cycle_depth(levels)
    check(0 < depth < len(levels), "the coarse cycle is not on the TG path")
    where = "the Taylor-Green path"
    with barred(sor_kernel, ("warm_sweeps_plain", "coarse_cycle_plain",
                             "warm_sweeps_simple"), where), \
            barred(momentum_kernel, ("momentum_rhs_plain",
                                     "momentum_rhs_simple"), where):
        solver.warm_up(prm, "cuda", "mg", time_order=2)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, stats = solver.solve_ab2(prm, state, pressure_method="mg",
                                        max_steps=TG_STEPS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    errors = taylorgreen.errors(state, prm)
    uc, vc = solver.center_values(state, prm)
    cycles = stats.total_sor_iterations
    # The free-slip box (problem 4) takes the f64 outer's fused pass.
    want = {"sor_warm": cycles * 2 * depth, "mg_restrict": cycles * depth,
            "mg_prolong": cycles * depth, "mg_coarse_cycle": cycles,
            "pressure_defect": cycles // prm.mg_cycles_per_outer}
    got = {k: n for k, n in launches.items() if n}
    print(f"[taylor-green] {TG_N}^2 mg solve_ab2: {tuple(stats[:3])} vs JAX "
          f"{JAX_TG_STATS} in {seconds:.6f} s; centre {uc:.6f} {vc:.6f} vs "
          f"JAX {JAX_TG_CENTRE}; errors {errors} vs JAX {JAX_TG_ERRORS}; "
          f"launches {got}, expected {want}")
    check(tuple(stats[:3]) == JAX_TG_STATS,
          "Taylor-Green counts differ from the JAX record")
    check(max(contract_err(uc, JAX_TG_CENTRE[0]),
              contract_err(vc, JAX_TG_CENTRE[1])) <= CONTRACT,
          "Taylor-Green centre values outside the contract")
    for key, jax_err in JAX_TG_ERRORS.items():
        check(errors[key] <= jax_err * (1 + TG_ERRORS_RTOL),
              f"Taylor-Green {key} error {errors[key]:.6e} exceeds JAX's "
              f"{jax_err:.6e}")
    check(got == want, f"{where}'s kernel launches differ")
    return launches


# The obstacle runs (A7), each held to the JAX package's CPU record taken by
#   JAX_PLATFORMS=cpu python tests/jax_records.py obstacles \
#       tests/jax_obstacle_records.json
# which also holds each run's definition (model, arguments, method, time
# order, steps, record function): the Schäfer-Turek cylinder at 440 x 82
# (sharp) by mg (Euler and AB2) and rb_sor, 3 steps each, the square
# cylinder at 160 x 64 by mg, 5 steps, the backward-facing step at
# 128 x 32 by rb_sor (Euler and AB2), 3 steps each, and the CLI on
# configs/channel.in --obstacle 17:24:27:34 --max-steps 20.  No kernel
# of another route stands behind an obstacle path: every such kernel and
# plain sweep twin is barred, and its launch count must stay 0.  The masked
# V-cycle's own kernels (MASKED_LAUNCHES) run every cycle of the mg runs
# and nothing of the rb_sor runs.
OBSTACLE_RECORDS = ROOT / "tests" / "jax_obstacle_records.json"
# The masked V-cycle's launch counters (ops/cuda/masked_kernel.py), read
# apart from LAUNCH_COUNTERS, which no_kernel holds at 0.
MASKED_LAUNCHES = ("masked_cycle", "masked_half_sweep", "masked_restrict",
                   "masked_prolong")
# Every kernel wrapper and plain twin an obstacle path must not reach.
SWEEP_ROUTES = ("inner_sweeps", "inner_sweeps_plain", "inner_sweeps_tiled",
                "inner_sweeps_tiled_plain", "inner_sweeps_compressed",
                "inner_sweeps_compressed_plain", "whole_grid_sweeps",
                "whole_grid_sweeps_simple", "warm_sweeps",
                "warm_sweeps_plain", "warm_sweeps_simple", "coarse_cycle",
                "coarse_cycle_plain", "ext_sweeps", "ext_sweeps_plain",
                "inner_sweeps_compressed_simple")
MOMENTUM_ROUTES = ("momentum_rhs", "momentum_rhs_plain",
                   "momentum_rhs_simple")


@contextlib.contextmanager
def masked_norms(module=None, name: str = "solve_pressure_masked"):
    """Record the residual norms of every masked solve in the block (the
    solve `module.name`, ops/masked.py's by default, whose norms are
    ops/masked.py's _l2_fluid): yields a list that gains, per solve, the
    list of its norms (||p0|| on the fluid cells, then one per pass)."""
    from navierstokes_parallel_tpu_torch.ops import masked

    module = masked if module is None else module
    solves = []
    l2, solve = masked._l2_fluid, getattr(module, name)

    def recorded_l2(r, w):
        norm = l2(r, w)
        solves[-1].append(float(norm))
        return norm

    def recorded_solve(*args, **kw):
        solves.append([])
        return solve(*args, **kw)

    masked._l2_fluid = recorded_l2
    setattr(module, name, recorded_solve)
    try:
        yield solves
    finally:
        masked._l2_fluid = l2
        setattr(module, name, solve)


@contextlib.contextmanager
def no_kernel(where: str):
    """Bar every kernel route and plain sweep twin, and count launches."""
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    with barred(sor_kernel, SWEEP_ROUTES, where), \
            barred(momentum_kernel, MOMENTUM_ROUTES, where):
        reset_launches()
        yield
        launches = read_launches()
        print(f"[{where}] kernel launches {launches}")
        check(not any(launches.values()), f"{where} launched a kernel")


def check_masked_launches(tag: str, prm, method: str, start: dict) -> dict:
    """The masked V-cycle's launches since the snapshot `start`: by mg
    every cycle fused, with ``launches_per_cycle`` of its hierarchy each;
    by rb_sor none.  Returns them by counter, with the cycles."""
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel
    from navierstokes_parallel_tpu_torch.utils import timing

    now = timing.counts()

    def since(name):
        return now.get(name, 0) - start.get(name, 0)

    got = {k: since("launch." + k) for k in MASKED_LAUNCHES}
    cycles, fused = since("masked.cycles"), since("masked.fused_cycles")
    print(f"[{tag}] masked launches {got}, {cycles} V-cycles, {fused} "
          f"fused")
    want = dict.fromkeys(MASKED_LAUNCHES, 0)
    if method == "mg":
        shapes = tuple(lvl.weights.fluid.shape
                       for lvl in masked._masked_levels(prm))
        per = masked_kernel.launches_per_cycle(shapes)
        want = {k: per[k] * cycles for k in MASKED_LAUNCHES}
        check(cycles > 0 and fused == cycles,
              f"{tag}: {fused} of {cycles} masked V-cycles took the kernels")
    check(got == want, f"{tag}: masked launches {got}, expected {want}")
    return dict(got, cycles=cycles)


def time_masked_cycle(torch) -> None:
    """One masked V(2,2) cycle at the Schäfer-Turek 440 x 82 (sharp) by the
    kernels and by the plain cycle on the card, in turns (CUDA events, mean
    ms a call of 20 after 2), the two from one p bit for bit; then the
    one-block launch (level 1, 32 sweeps) and one half-sweep launch of
    level 0 alone, each beside its bound (every interior cell counted, 11
    f32 operations an update; each array read once, p written once)."""
    from navierstokes_parallel_tpu_torch.models import karman
    from navierstokes_parallel_tpu_torch.ops import masked
    from navierstokes_parallel_tpu_torch.ops.cuda import masked_kernel

    prm = karman.schafer_turek(n_per_d=20)
    levels = masked.device_levels(prm, torch.float32, torch.device("cuda"))
    plain = tuple(w._replace(packed=None) for w in levels)
    rng = np.random.default_rng(5)
    fluid = masked._weights(prm).fluid
    rhs = torch.from_numpy(np.where(fluid, rng.standard_normal(
        fluid.shape), 0.0).astype(np.float32)).cuda()
    p0 = torch.zeros(prm.shape, device="cuda")
    got = masked._v_cycle_masked(p0.clone(), rhs, levels)
    want = masked._v_cycle_masked(p0.clone(), rhs, plain)
    check(torch.equal(got, want) and torch.equal(torch.signbit(got),
                                                 torch.signbit(want)),
          "the masked kernels' cycle differs from the plain cycle")
    p_k, p_p = p0.clone(), p0.clone()
    times = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "plain", "kernels"):
        lv, p = (levels, p_k) if name == "kernels" else (plain, p_p)
        times[name].append(cuda_ms(torch, lambda: masked._v_cycle_masked(
            p, rhs, lv), 20))
    t = masked_kernel.one_block_depth(tuple(tuple(w.fluid.shape)
                                            for w in levels))
    w1, w0 = levels[t], levels[0]
    (n1, m1), (n0, m0) = w1.fluid.shape, w0.fluid.shape
    e1 = torch.zeros((n1 + 2, m1 + 2), device="cuda")
    r1 = torch.from_numpy(rng.standard_normal((n1, m1)).astype(
        np.float32)).cuda()
    block_ms = cuda_ms(torch, lambda: masked_kernel.cycle(
        e1, r1, [w.packed for w in levels[t:]]), 20)
    half_ms = cuda_ms(torch, lambda: masked_kernel.half_sweeps(
        p_k, rhs, w0.packed, 1), 20) / 2
    pad1, pad0 = (n1 + 2) * (m1 + 2), (n0 + 2) * (m0 + 2)
    block_bound = bound(4 * (4 * pad1 + 2 * n1 * m1) + n1 * m1,
                        11 * 32 * n1 * m1)
    half_bound = bound(4 * (3 * pad0 + 2 * n0 * m0 + n0 * m0 / 2) + n0 * m0,
                       11 * n0 * m0 / 2)
    print(f"[masked cycle] one V-cycle at {prm.shape}: kernels "
          f"{times['kernels']} ms, plain {times['plain']} ms (CUDA events, "
          f"mean of 20, in turns); bits equal")
    print(f"[masked cycle] one-block launch from level {t} "
          f"({n1} x {m1}, 32 sweeps): {block_ms:.4f} ms, bound "
          f"{block_bound[0] * 1e3:.4f} us ({block_bound[1]}); one half-sweep "
          f"launch of level 0 ({n0} x {m0}): {half_ms:.4f} ms, bound "
          f"{half_bound[0] * 1e3:.4f} us ({half_bound[1]})")


def passes_and_margins(solves, prm, K: int):
    """Per masked solve: its outer passes and the relative margins (norm -
    threshold) / threshold of its last pass and of the pass before."""
    passes, margins = [], []
    for norms in solves:
        threshold = prm.epsilon * (norms[0] + 1.5)
        passes.append(len(norms) - 1)
        margins.append([(x - threshold) / threshold for x in (
            norms[-1], norms[-2] if len(norms) > 2 else float("inf"))])
    return passes, margins


def gate_passes(tag, passes, margins, jax_iterations, K: int) -> None:
    """Every step's passes held to JAX's (channel_gate)."""
    jax_passes = [-(-n // K) for n in jax_iterations]
    check(len(passes) == len(jax_passes),
          f"{tag}: {len(passes)} solves, JAX {len(jax_passes)}")
    for k, mine, theirs, margin, ok in channel_gate(passes, margins,
                                                    jax_passes):
        print(f"[{tag}] step {k}: {mine} passes, JAX {theirs}; the "
              f"card's residual at the deciding pass {margin:+.3e} of the "
              f"threshold (allowed within {NEAR_THRESHOLD:.0e})")
        check(ok, f"{tag}: step {k} moved away from its threshold")


def obstacle_setup(run: dict, device: str):
    """(params, initial state, record function or None) of a recorded run,
    built as tests/jax_records.py::obstacle_setup builds it."""
    from navierstokes_parallel_tpu_torch.grid import allocate_state
    from navierstokes_parallel_tpu_torch.models import karman
    from navierstokes_parallel_tpu_torch.models import step as step_model

    if run["model"] == "backward_facing_step":
        prm = step_model.backward_facing_step(**run["kwargs"])
        return prm, allocate_state(prm, device), None
    prm = getattr(karman, run["model"])(**run["kwargs"])
    fn = {"force": karman.force_record_fn,
          "surface_force": karman.surface_force_record_fn}[run["record"]]
    return (prm, karman.initial_state(prm, perturb=0.3, device=device),
            fn(prm, 5, *karman.probe_node(prm)))


def phase_obstacles(torch) -> dict:
    """The obstacle runs of OBSTACLE_RECORDS on the card, each stepped
    through solver.Stepper as recorded: passes per step through the gate,
    failures equal, the per-step records and the final centre values and
    max |u|, |v| within the contract, no other route's kernel launched and
    the masked V-cycle's launches as check_masked_launches holds them;
    then the CLI run (its record, its per-step passes through the gate, no
    launch); then time_masked_cycle.  Returns the (zero) launch counts of
    the other routes."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.utils import timing

    records = json.loads(OBSTACLE_RECORDS.read_text())
    for tag, run in records["runs"].items():
        prm, state, record_fn = obstacle_setup(run, "cuda")
        K = (prm.sor_refine_every if run["method"] == "rb_sor"
             else prm.mg_cycles_per_outer)
        stepper = solver.Stepper(prm, state, run["method"], run["time_order"])
        recs, iterations, failures = {}, 0, 0
        start = timing.counts()
        with no_kernel(tag), masked_norms() as solves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(run["steps"]):
                diag = stepper.step()
                iterations += diag.sor_iterations
                failures += 0 if diag.sor_converged else 1
                for key, val in (record_fn(stepper.state()) if record_fn
                                 else {}).items():
                    recs.setdefault(key, []).append(float(val))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        SOLVE_SECONDS[tag] = seconds
        check_masked_launches(tag, prm, run["method"], start)
        jax_iterations = run["iterations"]
        print(f"[{tag}] {prm.shape}, {run['method']}, order "
              f"{run['time_order']}: {run['steps']} steps, {iterations} "
              f"iterations (JAX {sum(jax_iterations)}), {failures} "
              f"failures, {seconds:.3f} s")
        passes, margins = passes_and_margins(solves, prm, K)
        gate_passes(tag, passes, margins, jax_iterations, K)
        check(failures == run["converged"].count(False),
              f"{tag}: {failures} failures, JAX "
              f"{run['converged'].count(False)}")
        base = stepper.state()
        got = {"centre": solver.center_values(base, prm),
               "max_abs": [float(base.u.abs().max()),
                           float(base.v.abs().max())]}
        errs = {key: contract_err(got[key], run[key]) for key in got}
        errs.update({key: contract_err(recs[key], want)
                     for key, want in run["records"].items()})
        check(sorted(recs) == sorted(run["records"]),
              f"{tag}: records {sorted(recs)}, JAX {sorted(run['records'])}")
        print(f"[{tag}] centre {got['centre']} vs JAX {run['centre']}; "
              f"errors against JAX {errs} (contract {CONTRACT:.0e})")
        check(max(errs.values()) <= CONTRACT,
              f"{tag}: outside the contract")

    cli_run = records["cli"]
    want = {k: int(cli_run["stats"][k]) for k in ("steps", "sor_failures")}
    uc, vc = (float(line.split()[1]) for line in cli_run["stdout"])
    prm = obstacle_cli_params()
    start = timing.counts()
    with no_kernel("obstacle cli"), masked_norms() as solves:
        stats, _ = run_cli("obstacle cli", [
            str(ROOT / cli_run["argv"][0]), *cli_run["argv"][1:]], uc, vc,
            want, rc_want=cli_run["rc"])
    # The first solve is the CLI's warm-up step (max_it = 1).
    passes, margins = passes_and_margins(solves[1:], prm,
                                         prm.sor_refine_every)
    print(f"[obstacle cli] {stats['sor_iterations']} sweeps, JAX "
          f"{cli_run['stats']['sor_iterations']}")
    check(sum(min(n * prm.sor_refine_every, prm.max_it) for n in passes)
          == int(stats["sor_iterations"]),
          "obstacle cli: the passes and the sweeps disagree")
    gate_passes("obstacle cli", passes, margins, cli_run["iterations"],
                prm.sor_refine_every)
    check_masked_launches("obstacle cli", prm, "rb_sor", start)
    print("[obstacles] solve seconds: " + ", ".join(
        f"{tag} {SOLVE_SECONDS[tag]:.6f}" for tag in
        [*records["runs"], "obstacle cli"]))
    time_masked_cycle(torch)
    return {k: 0 for k in read_launches()}


def obstacle_cli_params():
    from navierstokes_parallel_tpu_torch.config import Params

    records = json.loads(OBSTACLE_RECORDS.read_text())
    argv = records["cli"]["argv"]
    spec = argv[argv.index("--obstacle") + 1]
    return Params.from_file(str(ROOT / argv[0]), obstacles=(
        tuple(int(x) for x in spec.split(":")),))


def phase_obstacle_profile(torch) -> None:
    """One outer pass of each masked solve at the Schäfer-Turek 440 x 82
    (sharp) from p = 0 on a seeded rhs: rb_sor (K = 64 masked red-black
    sweeps, f64 defect and norm, one host sync) and mg (one masked V-cycle
    on its 2 levels), CUDA-event time and the kernel launches under the
    profiler; last, as the profiler slows every later launch."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.models import karman
    from navierstokes_parallel_tpu_torch.ops import masked

    prm = karman.schafer_turek(n_per_d=20)
    rng = np.random.default_rng(5)
    fluid = masked._weights(prm).fluid
    inner = np.where(fluid, rng.standard_normal(fluid.shape), 0.0)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = inner
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)
    for method, K in (("rb_sor", prm.sor_refine_every),
                      ("mg", prm.mg_cycles_per_outer)):
        one_pass = prm.replace(max_it=K)

        def outer_pass():
            return masked.solve_pressure_masked(p0, rhs, one_pass, method)

        ms = cuda_ms(torch, outer_pass, 5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            outer_pass()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outer_pass()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        n_launches = sum(e.count for e in kernels)
        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        check(n_launches > 0, "the profiler saw no device kernel")
        print(f"[obstacle profile] masked {method} at {prm.shape}, one "
              f"outer pass ({K} {'sweeps' if method == 'rb_sor' else 'V-cycle'}"
              f"): {ms:.4f} ms (CUDA events, mean of 5), {n_launches} "
              f"launches under the profiler, {busy_ms:.4f} ms of device "
              f"time (busy {busy_ms / ms:.3f})")
        for e in sorted(kernels, key=lambda e: e.count, reverse=True)[:6]:
            print(f"[obstacle profile]   {e.count:6d} x {device_us(e) / 1e3:9.4f}"
                  f" ms  {e.key[:80]}")
    profile_free_pass(torch)


def profile_ensemble_pass(torch) -> None:
    """One outer pass (K = 64 sweeps, the f64 defect and norm) of the
    ensemble phase's pressure solve: the batched solve of its 8 members
    (sor.solve_pressure_batch: the SOR kernel over every member in one
    launch per chunk) beside one member's solo solve on the same kernel
    route, on seeded compatible rhs at 256^2: CUDA-event time, kernel
    launches and device time under the profiler (what batching saves in
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import sor

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    one_pass = prm.replace(max_it=prm.sor_refine_every)
    rng = np.random.default_rng(6)
    rhs = np.zeros((8, *prm.shape), np.float32)
    rhs[:, 1:-1, 1:-1] = rng.standard_normal((8, prm.i_max, prm.j_max))
    rhs[:, 1:-1, 1:-1] -= rhs[:, 1:-1, 1:-1].mean(axis=(1, 2), keepdims=True)
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)
    for tag, members, outer_pass in (
            ("batched, 8 members", 8, lambda: sor.solve_pressure_batch(
                p0, rhs, one_pass, method="rb_sor")),
            ("solo, 1 member", 1, lambda: sor.solve_pressure(
                p0[0], rhs[0], one_pass, method="rb_sor"))):
        ms = cuda_ms(torch, outer_pass, 5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            outer_pass()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        n_launches = sum(e.count for e in kernels)
        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        check(n_launches > 0, "the profiler saw no device kernel")
        print(f"[ensemble profile] rb_sor {tag} at {prm.shape}, one outer "
              f"pass ({one_pass.max_it} sweeps): {ms:.4f} ms (CUDA events, "
              f"mean of 5; {ms / members:.4f} ms a member), {n_launches} "
              f"launches under the profiler ({n_launches / members:.1f} a "
              f"member), {busy_ms:.4f} ms of device time (busy "
              f"{busy_ms / ms:.3f})")


def profile_free_pass(torch) -> None:
    """One outer pass (K = 64 masked red-black sweeps, the f64 SUMMAC
    refresh, defect and norm, one host sync) of the free-surface pressure
    solve on configs/dambreak.in's 160 x 96 at its initial geometry, on a
    seeded rhs: CUDA-event time, kernel launches and device time under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.ops import surface

    prm = Params.from_file(str(ROOT / "configs" / "dambreak.in"))
    fs = FS.initial_free_state(prm, "cuda")
    flags = surface.cell_flags(fs.pset.x, fs.pset.y, fs.pset.active, prm)
    rng = np.random.default_rng(6)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((prm.i_max, prm.j_max))
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)
    one_pass = prm.replace(max_it=prm.sor_refine_every, epsilon=0.0)

    def outer_pass():
        return surface.solve_pressure_free(p0, rhs, flags, one_pass,
                                           interpolated=True)

    ms = cuda_ms(torch, outer_pass, 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        outer_pass()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outer_pass()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    n_launches = sum(e.count for e in kernels)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    check(n_launches > 0, "the profiler saw no device kernel")
    print(f"[free-surface profile] SUMMAC solve at {prm.shape}, "
          f"{int(flags.bulk.sum())} bulk cells, one outer pass "
          f"({prm.sor_refine_every} sweeps): {ms:.4f} ms (CUDA events, "
          f"mean of 5), {n_launches} launches under the profiler, "
          f"{busy_ms:.4f} ms of device time (busy {busy_ms / ms:.3f})")
    for e in sorted(kernels, key=lambda e: e.count, reverse=True)[:6]:
        print(f"[free-surface profile]   {e.count:6d} x "
              f"{device_us(e) / 1e3:9.4f} ms  {e.key[:80]}")


THERMAL_RECORDS = ROOT / "tests" / "jax_thermal_records.json"
CONVECTION_DIR = ROOT / "build" / "convection"
# Every plain sweep twin a kernel path must not fall back to.
PLAIN_SWEEPS = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
                "inner_sweeps_compressed_plain", "warm_sweeps_plain",
                "coarse_cycle_plain", "ext_sweeps_plain",
                "whole_grid_sweeps_simple", "warm_sweeps_simple",
                "inner_sweeps_compressed_simple")


@contextlib.contextmanager
def refined_norms():
    """Record the residual norms of every refined solve
    (ops/sor.py::_solve_pressure_refined: the single-device SOR, mg and the
    sharded backend's solves) in the block: yields a list that gains, per
    solve, the list of its norms (||p0||, then one per outer pass)."""
    from navierstokes_parallel_tpu_torch.ops import sor

    solves = []
    refined = sor._solve_pressure_refined

    def recorded(p, rhs, params, **kw):
        l2_fn = kw.get("l2_fn") or sor._default_l2(params)
        norms = []
        solves.append(norms)

        def l2(arr):
            norm = l2_fn(arr)
            norms.append(float(norm))
            return norm
        return refined(p, rhs, params, **{**kw, "l2_fn": l2})

    sor._solve_pressure_refined = recorded
    try:
        yield solves
    finally:
        sor._solve_pressure_refined = refined


def phase_sharded_obstacles(torch) -> dict:
    """Obstacle domains on the sharded backend over a one-rank NCCL group
    (1x1 mesh), every kernel route and plain sweep twin barred: the runs
    of tests/jax_thermal_records.json's "sharded_obstacles" (the
    backward-facing step at 128 x 32, 3 steps by Euler and AB2, and one
    Schäfer-Turek 440 x 82 step by rb_sor, the immersed-boundary and
    aperture path) stepped through sharded.ShardedStepper, then ``...
    configs/channel.in --obstacle 17:24:27:34 --backend sharded --mesh 1x1
    --max-steps 5 --stats`` through cli.main.  Every step's passes go
    through the gate against the JAX sharded record (one CPU device) and,
    where tests/jax_obstacle_records.json records the run on one
    device, against that record's steps too;
    failures equal, centre values and max |u|, |v| within the contract,
    no kernel launched.  Returns the (zero) launch counts."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.parallel import sharded, topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    records = json.loads(THERMAL_RECORDS.read_text())["sharded_obstacles"]
    single = json.loads(OBSTACLE_RECORDS.read_text())
    # The same runs recorded on one device: (record, steps it shares).
    on_one = {"sharded step": single["runs"]["step rb_sor"],
              "sharded step ab2": single["runs"]["step rb_sor ab2"],
              "sharded schafer_turek": single["runs"]["schafer_turek rb_sor"],
              "cli": single["cli"]}
    seconds = {}
    with distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        for tag, run in records.items():
            if tag == "cli":
                continue
            prm, state, _ = obstacle_setup(
                {**run, "record": "surface_force"}, "cuda")
            stepper = sharded.ShardedStepper(prm, state, mesh, "rb_sor",
                                             run["time_order"])
            failures = 0
            with no_kernel(tag), refined_norms() as solves:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(run["steps"]):
                    failures += 0 if stepper.step().sor_converged else 1
                torch.cuda.synchronize()
                seconds[tag] = time.perf_counter() - t0
            passes, margins = passes_and_margins(solves, prm,
                                                 prm.sor_refine_every)
            print(f"[{tag}] {prm.shape}, order {run['time_order']}: "
                  f"{run['steps']} steps, passes {passes}, {failures} "
                  f"failures, {seconds[tag]:.3f} s")
            gate_passes(tag, passes, margins, run["iterations"],
                        prm.sor_refine_every)
            shared = on_one[tag]["iterations"][:run["steps"]]
            gate_passes(f"{tag} vs one device", passes, margins, shared,
                        prm.sor_refine_every)
            check(failures == run["converged"].count(False),
                  f"{tag}: {failures} failures, JAX "
                  f"{run['converged'].count(False)}")
            base = stepper.state()
            got = {"centre": list(solver.center_values(base, prm)),
                   "max_abs": [float(base.u.abs().max()),
                               float(base.v.abs().max())]}
            errs = {key: contract_err(got[key], run[key]) for key in got}
            if on_one[tag]["steps"] == run["steps"]:
                errs.update({f"{key} (one device)": contract_err(
                    got[key], on_one[tag][key]) for key in got})
            print(f"[{tag}] {got}; errors against JAX {errs} (contract "
                  f"{CONTRACT:.0e})")
            check(max(errs.values()) <= CONTRACT,
                  f"{tag}: outside the contract")
    cli_run = records["cli"]
    want = {k: int(cli_run["stats"][k]) for k in ("steps", "sor_failures")}
    uc, vc = (float(line.split()[1]) for line in cli_run["stdout"])
    prm = obstacle_cli_params()
    with no_kernel("sharded obstacle cli"), refined_norms() as solves:
        stats, _ = run_cli("sharded obstacle cli", [
            str(ROOT / cli_run["argv"][0]), *cli_run["argv"][1:]], uc, vc,
            want, rc_want=cli_run["rc"])
    # The first solve is the CLI's warm-up step (max_it = 1).
    passes, margins = passes_and_margins(solves[1:], prm,
                                         prm.sor_refine_every)
    print(f"[sharded obstacle cli] {stats['sor_iterations']} sweeps, JAX "
          f"{cli_run['stats']['sor_iterations']}")
    gate_passes("sharded obstacle cli", passes, margins,
                cli_run["iterations"], prm.sor_refine_every)
    gate_passes("sharded obstacle cli vs one device", passes, margins,
                on_one["cli"]["iterations"][:len(passes)],
                prm.sor_refine_every)
    seconds["cli"] = SOLVE_SECONDS["sharded obstacle cli"]
    print("[sharded obstacles] seconds: " + ", ".join(
        f"{tag} {t:.6f}" for tag, t in seconds.items()))
    return {k: 0 for k in read_launches()}


def phase_convection(torch) -> dict:
    """Natural convection (problem 5) on the card, each run held to the JAX
    record in tests/jax_thermal_records.json ("thermal"):
    ``configs/convection.in --max-steps 300 --stats`` through cli.main by
    the CLI's default pallas_sor (B1 once per outer pass and once for the
    warm-up, the 32x32 tile at 66^2, no B2: the thermal step takes the
    plain F/G), with --method mg (the coarse cycle takes every level from
    66^2: one launch per V-cycle and one for the warm-up, no B3) and with
    --time-order 2, every plain twin barred; every step's passes through
    the gate (norms read through the refinement's l2 hook), failures and
    centre values as JAX's.  Then the 32^2 heated block stepped through
    convection.ThermalStepper (the masked solve, no kernel), and the
    Euler run stopped after 150 steps and resumed from its checkpoint: the
    state at step 300 bit for bit the straight run's, T included.
    Returns the launch counts summed over the CLI runs."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import convection
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    records = json.loads(THERMAL_RECORDS.read_text())["thermal"]
    config = CONVECTION_CONFIG
    prm = Params.from_file(str(config))
    tile = sor_kernel.whole_grid_tile(prm.shape)
    depth = sor_kernel.coarse_cycle_depth(mg.build_levels(prm))
    print(f"[convection] {prm.shape}: route {sor_kernel.route(prm)}, tile "
          f"{tile}; mg coarse cycle entered at depth {depth}")
    check(sor_kernel.route(prm) == "whole" and
          tile in sor_kernel.WHOLE_GRID_TILES and depth == 0,
          "configs/convection.in does not take B1 on a compiled tile and "
          "the coarse cycle on every level")
    shutil.rmtree(CONVECTION_DIR, ignore_errors=True)
    CONVECTION_DIR.mkdir(parents=True)
    straight = CONVECTION_DIR / "straight.npz"
    total = None
    for tag, run in records.items():
        if not tag.startswith("convection"):
            continue
        argv = [str(ROOT / run["argv"][0]), *run["argv"][1:]]
        mg_run = "mg" in run["argv"]
        kernel = "mg_coarse_cycle" if mg_run else "sor"
        if tag == "convection":
            argv += ["--checkpoint-every", run["argv"][2],
                     "--checkpoint-path", str(straight)]
        want = {k: int(run["stats"][k]) for k in ("steps", "sor_failures")}
        uc, vc = (float(line.split()[1]) for line in run["stdout"])
        with barred(sor_kernel, PLAIN_SWEEPS, f"the {tag} path"), \
                barred(momentum_kernel, MOMENTUM_ROUTES, f"the {tag} path"), \
                refined_norms() as solves:
            stats, launches = run_cli(tag, argv, uc, vc, want,
                                      rc_want=run["rc"])
        K = prm.mg_cycles_per_outer if mg_run else prm.sor_refine_every
        passes, margins = passes_and_margins(solves[1:], prm, K)
        gate_passes(tag, passes, margins, run["iterations"], K)
        print(f"[{tag}] {stats['sor_iterations']} iterations, JAX "
              f"{run['stats']['sor_iterations']}; launches {launches}")
        check(launches[kernel] == sum(passes) + 1,
              f"{tag}: {launches[kernel]} {kernel} launches, expected "
              f"{sum(passes)} passes + 1 warm-up")
        check(launches["momentum"] == 0, f"{tag} launched B2")
        check_only(launches, (kernel,), f"the {tag} path")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}

    # The run in two pieces: the straight run's checkpoint at step 300.
    steps = records["convection"]["argv"][2]
    half = str(int(steps) // 2)
    piece_a, piece_b = (CONVECTION_DIR / f"piece{k}.npz" for k in "ab")
    for tag, extra in (("convection piece 1", [
            "--max-steps", half, "--checkpoint-every", half,
            "--checkpoint-path", str(piece_a)]), ("convection piece 2", [
            "--resume", str(piece_a), "--max-steps", half,
            "--checkpoint-every", half, "--checkpoint-path",
            str(piece_b)])):
        run_cli(tag, [str(config), "--stats", *extra], None, None, {},
                rc_want=3)
    same = same_checkpoints(straight, piece_b)
    with np.load(straight) as ck:
        keys = sorted(ck.files)
    print(f"[convection] resumed at step {half}: the state at step {steps} "
          f"equals the straight run's bit for bit: {same} (keys {keys})")
    check(same and "T" in keys, "the resumed run differs from the straight")

    # The heated block: the masked solve, no kernel.
    block = records["heated block"]
    bprm, bcfg = convection.heated_block_setup(**block["kwargs"])
    stepper = convection.ThermalStepper(
        bprm, bcfg, convection.allocate_thermal(bprm, bcfg, "cuda"),
        "rb_sor")
    failures = 0
    with no_kernel("heated block"), masked_norms() as solves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(block["steps"]):
            failures += 0 if stepper.step().sor_converged else 1
        torch.cuda.synchronize()
        SOLVE_SECONDS["heated block"] = time.perf_counter() - t0
    passes, margins = passes_and_margins(solves, bprm,
                                         bprm.sor_refine_every)
    gate_passes("heated block", passes, margins, block["iterations"],
                bprm.sor_refine_every)
    check(failures == block["failures"], "heated block: failures differ")
    ts = stepper.state()
    got = {"max_abs": [float(ts.u.abs().max()), float(ts.v.abs().max())],
           "max_T": float(ts.T[1:-1, 1:-1].max()),
           "block_flux": convection.block_heat_flux(ts.T, bprm,
                                                    bcfg.t_obstacle)}
    errs = {key: contract_err(got[key], block[key]) for key in got}
    errs["block_flux"] = abs(got["block_flux"] - block["block_flux"]) / abs(
        block["block_flux"])
    print(f"[heated block] {bprm.shape}: {block['steps']} steps in "
          f"{SOLVE_SECONDS['heated block']:.3f} s, {got}; errors against "
          f"JAX {errs} (contract {CONTRACT:.0e}, the flux relative)")
    check(max(errs.values()) <= CONTRACT, "heated block: outside the contract")
    shutil.rmtree(CONVECTION_DIR, ignore_errors=True)
    print("[convection] solve seconds: " + ", ".join(
        f"{tag} {SOLVE_SECONDS[tag]:.6f}" for tag in SOLVE_SECONDS
        if "convection" in tag or tag == "heated block"))
    return total


SHARDED_THERMAL_RECORDS = ROOT / "tests" / "jax_sharded_thermal_records.json"
# The port's two SOR methods take one route (the deep-halo inner), so the
# pallas_sor run is held to JAX's rb_sor record.
SHARDED_CONVECTION_RUNS = {"pallas_sor": "rb_sor", "mg": "mg"}


def phase_sharded_convection(torch) -> dict:
    """configs/convection.in on the sharded backend over a one-rank NCCL
    group (1x1 mesh) through cli.main, SHARDED_CONVECTION_RUNS: by
    pallas_sor every chunk of K = 8 sweeps one sor_ext_sweeps call (8 per
    outer pass of 64, and one for the warm-up's single sweep); by mg, per
    V-cycle and for the warm-up's one, two sor_ext_sweeps calls on every
    sharded level above the coarsest and one mg_coarse_cycle.  Every other
    route and plain twin barred; every step's passes through the gate
    against the JAX sharded record (tests/jax_sharded_thermal_records.json,
    300 steps on one CPU device), failures and centre values as JAX's.
    Returns the launch counts summed over the runs."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)
    from navierstokes_parallel_tpu_torch.parallel import deep_halo

    records = json.loads(SHARDED_THERMAL_RECORDS.read_text())[
        "sharded_thermal"]
    prm = Params.from_file(str(CONVECTION_CONFIG))
    K = deep_halo.comm_depth(prm, prm.i_max, prm.j_max)
    levels = mg.build_levels_sharded(prm, prm.i_max, prm.j_max)
    routes = ("whole_grid_sweeps", "inner_sweeps_tiled",
              "inner_sweeps_compressed", "warm_sweeps")
    total = None
    for method, recorded in SHARDED_CONVECTION_RUNS.items():
        run = records[recorded]
        tag = f"sharded convection {method}"
        argv = [str(CONVECTION_CONFIG), "--backend", "sharded", "--mesh",
                "1x1", "--method", method, "--max-steps", str(run["steps"]),
                "--stats"]
        want = {k: int(run["stats"][k]) for k in ("steps", "sor_failures")}
        uc, vc = (float(line.split()[1]) for line in run["stdout"])
        with barred(sor_kernel, PLAIN_SWEEPS + routes, f"the {tag} path"), \
                barred(momentum_kernel, MOMENTUM_ROUTES, f"the {tag} path"), \
                refined_norms() as solves:
            stats, launches = run_cli(tag, argv, uc, vc, want,
                                      rc_want=run["rc"])
        R = 1 if method == "mg" else prm.sor_refine_every
        passes, margins = passes_and_margins(solves[1:], prm, R)
        gate_passes(tag, passes, margins, run["iterations"], R)
        if method == "mg":
            cycles = sum(passes) + 1
            expect = {"sor_ext": cycles * 2 * (len(levels) - 1),
                      "mg_coarse_cycle": cycles}
        else:
            expect = {"sor_ext": sum(passes) * -(-R // K) + 1}
        got = {k: n for k, n in launches.items() if n}
        print(f"[{tag}] {stats['sor_iterations']} iterations, JAX "
              f"{run['stats']['sor_iterations']}; kernel launches {got}, "
              f"expected {expect}")
        check(got == expect, f"the {tag} path's kernel launches differ")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
    print("[sharded convection] solve seconds: " + ", ".join(
        f"{tag} {SOLVE_SECONDS[tag]:.6f}" for tag in SOLVE_SECONDS
        if tag.startswith("sharded convection")))
    return total


FREE_RECORDS = ROOT / "tests" / "jax_free_records.json"
FREE_DIR = ROOT / "build" / "free"


def free_readings(path: Path, prm) -> dict:
    """The fluid volume, front position and column height of a problem-6
    checkpoint, on the card."""
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    fs = load_checkpoint(str(path), prm, "cuda")
    return {"fluid_volume": FS.fluid_volume(fs, prm),
            "front_position": FS.front_position(fs),
            "column_height": FS.column_height(fs)}


def phase_free_surface(torch) -> dict:
    """The dam break of configs/dambreak.in (160 x 96, ppc 3: about 18,400
    particles, free-slip walls) through cli.main, cut to the JAX record's
    first N steps (tests/jax_free_records.json, "cut"), on one device and
    by --backend sharded --mesh 1x1 (a one-rank NCCL group: the
    partitioned sweeps and their all-reduce), every kernel route and plain
    sweep twin barred and every launch count 0.  Each run: steps and
    failures as JAX's, every step's passes through the gate (masked_norms
    on ops/surface.py's solve), the centre values within the
    contract, and from its checkpoint the fluid volume within 1e-10
    relative of JAX's at that step, front position and column height
    within the contract.  Then the one-device run stopped after N / 2
    steps and resumed from its checkpoint: the state and the particles at
    step N bit for bit the straight run's.  Returns the (zero) launch
    counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import surface

    rec = json.loads(FREE_RECORDS.read_text())["free"]
    steps = rec["cut"]
    config = str(ROOT / rec["argv"][0])
    prm = Params.from_file(config)
    per_step = rec["per_step"]
    uc, vc = (float(line.split()[1]) for line in rec["cut_cli"]["stdout"])
    want = {"steps": steps, "sor_failures": per_step["converged"][
        :steps].count(False)}
    shutil.rmtree(FREE_DIR, ignore_errors=True)
    FREE_DIR.mkdir(parents=True)
    base = [config, *rec["argv"][1:], "--max-steps", str(steps)]
    readings = {}
    for tag, extra in (("free surface", []), ("free surface sharded", [
            "--backend", "sharded", "--mesh", "1x1"])):
        ck = FREE_DIR / f"{tag.replace(' ', '_')}.npz"
        with no_kernel(tag), masked_norms(
                surface, "solve_pressure_free") as solves:
            stats, _ = run_cli(tag, [*base, *extra, "--checkpoint-every",
                                     str(steps), "--checkpoint-path",
                                     str(ck)], uc, vc, want, rc_want=3)
        # The first solve is the CLI's warm-up step (max_it = 1).
        passes, margins = passes_and_margins(solves[1:], prm,
                                             prm.sor_refine_every)
        gate_passes(tag, passes, margins, per_step["iterations"][:steps],
                    prm.sor_refine_every)
        print(f"[{tag}] {stats['sor_iterations']} sweeps, JAX "
              f"{sum(per_step['iterations'][:steps])}")
        got = readings[tag] = free_readings(ck, prm)
        jax = {key: per_step[key][steps - 1] for key in got}
        vol_err = abs(got["fluid_volume"] - jax["fluid_volume"]) / \
            jax["fluid_volume"]
        errs = {key: contract_err(got[key], jax[key])
                for key in ("front_position", "column_height")}
        print(f"[{tag}] at step {steps}: {got}; JAX {jax}; volume rel err "
              f"{vol_err:.2e} (tol 1e-10), errors {errs} (contract "
              f"{CONTRACT:.0e})")
        check(vol_err <= 1e-10, f"{tag}: fluid volume differs from JAX's")
        check(max(errs.values()) <= CONTRACT,
              f"{tag}: front or column outside the contract")
    half = str(steps // 2)
    piece_a, piece_b = (FREE_DIR / f"piece{k}.npz" for k in "ab")
    with no_kernel("free surface pieces"):
        for tag, extra in (("free surface piece 1", [
                "--checkpoint-every", half, "--checkpoint-path",
                str(piece_a)]), ("free surface piece 2", [
                "--resume", str(piece_a), "--checkpoint-every", half,
                "--checkpoint-path", str(piece_b)])):
            run_cli(tag, [config, *rec["argv"][1:], "--max-steps", half,
                          *extra], None, None, {}, rc_want=3)
    straight = FREE_DIR / "free_surface.npz"
    same = same_checkpoints(straight, piece_b)
    with np.load(straight) as ck:
        keys = sorted(ck.files)
    print(f"[free surface] resumed at step {half}: the state and particles "
          f"at step {steps} equal the straight run's bit for bit: {same} "
          f"(keys {keys})")
    check(same and "px" in keys, "the resumed run differs from the straight")
    shutil.rmtree(FREE_DIR, ignore_errors=True)
    print("[free surface] solve seconds: " + ", ".join(
        f"{tag} {SOLVE_SECONDS[tag]:.6f}" for tag in SOLVE_SECONDS
        if tag.startswith("free surface")))
    return {k: 0 for k in read_launches()}


PARTICLE_LATTICE = 16
# The card-against-CPU comparison's steps: one of configs/1.in's three
# (the CPU takes ~33 s a step there).
PARTICLE_CPU_STEPS = 1


def particle_run(prm, device: str, max_steps: int = 0):
    """configs/1.in with particles on `device`: a PARTICLE_LATTICE^2 seed
    lattice with room for a two-point streakline source injected every
    step, by pallas_sor (the CLI's default on the card; rb_sor's plain
    twin on the CPU), to T or `max_steps` steps.  Returns (state, stats,
    set, seconds)."""
    import torch

    from navierstokes_parallel_tpu_torch import particles

    n = PARTICLE_LATTICE * PARTICLE_LATTICE
    seeds = particles.grid_of_particles(prm, PARTICLE_LATTICE,
                                        PARTICLE_LATTICE, capacity=n + 8,
                                        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats, pset, _ = particles.trace_particles(
        prm, seeds, pressure_method="pallas_sor",
        inject_points=[[0.5, 0.95], [0.05, 0.5]], inject_every=1,
        max_steps=max_steps)
    if device == "cuda":
        torch.cuda.synchronize()
    return state, stats, pset, time.perf_counter() - t0


def phase_particles(torch) -> dict:
    """Marker particles on the main path: configs/1.in with particles
    through particles.trace_particles (solver.Stepper's steps, then the
    advection) by pallas_sor, the plain twins barred: the configs/1.in
    record (JAX_STATS, the centre values), sor_sweeps once per outer pass
    and momentum_rhs once per step (no warm-up inside the count); then the
    run's first PARTICLE_CPU_STEPS steps on the card and on the CPU: the
    particle positions within 1e-5, the active masks equal.  Returns the
    launch counts of the card's whole run."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)

    prm = Params.from_file(str(ROOT / "configs" / "1.in"))
    solver.warm_up(prm, "cuda", "pallas_sor")
    with barred(sor_kernel, PLAIN_SWEEPS, "the particles path"), \
            barred(momentum_kernel, ("momentum_rhs_plain",
                                     "momentum_rhs_simple"),
                   "the particles path"):
        reset_launches()
        state, stats, pset, seconds = particle_run(prm, "cuda")
        launches = read_launches()
    uc, vc = solver.center_values(state, prm)
    print(f"[particles] {stats} in {seconds:.3f} s; centre {uc:.6f} / "
          f"{vc:.6f}; {int(pset.active.sum())} of {pset.x.numel()} "
          f"particles active; launches {launches}")
    check(dict(zip(("steps", "sor_iterations", "sor_failures"), stats[:3]))
          == JAX_STATS, "the particles run's stats differ from JAX's")
    check(max(contract_err(uc, JAX_U_CENTER), contract_err(
        vc, JAX_V_CENTER)) <= CONTRACT, "centre values outside the contract")
    calls = JAX_STATS["steps"] * -(-prm.max_it // prm.sor_refine_every)
    check(launches["sor"] == calls and
          launches["momentum"] == JAX_STATS["steps"],
          f"the particles path launched {launches}, expected {calls} "
          f"sor_sweeps and {JAX_STATS['steps']} momentum_rhs calls")
    check_only(launches, ("sor", "momentum"), "the particles path")
    _, gstats, gpset, _ = particle_run(prm, "cuda", PARTICLE_CPU_STEPS)
    _, cstats, cpset, cseconds = particle_run(prm, "cpu", PARTICLE_CPU_STEPS)
    err = max(float((gpset.x.cpu() - cpset.x).abs().max()),
              float((gpset.y.cpu() - cpset.y).abs().max()))
    same_active = torch.equal(gpset.active.cpu(), cpset.active)
    print(f"[particles] {PARTICLE_CPU_STEPS} step(s) on the card {gstats} "
          f"and on the CPU {cstats} in {cseconds:.3f} s; positions max abs "
          f"err {err:.3e} (tol 1e-5), active masks equal {same_active}")
    check(cstats[:3] == gstats[:3] and err <= 1e-5 and same_active,
          "the card's particles differ from the CPU's")
    return launches


A9_RECORDS = ROOT / "tests" / "jax_a9_records.json"
# The differentiable path's relative bounds: against JAX's record (the
# same f64 arithmetic and converged solves), and against central
# differences of the card's own forward (tests/test_diff.py's bounds).
GRAD_JAX_REL = 1e-6
GRAD_FD_REL = {"lid": 1e-5, "dir": 1e-4}
# Steps of the remat memory readings (the record's run is 3 steps).
REMAT_STEPS = (3, 12)


def perturbation(shape, seed: int, scale: float, rng=None) -> np.ndarray:
    """tests/jax_records.py's perturbation: scale * standard normal of
    default_rng(seed) (or of `rng`) on the interior of a padded field."""
    rng = np.random.default_rng(seed) if rng is None else rng
    out = np.zeros(shape)
    out[1:-1, 1:-1] = scale * rng.standard_normal((shape[0] - 2,
                                                   shape[1] - 2))
    return out


def fence(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def launch_delta(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-300)


def cavity_gradient_setup(torch, rec: dict, device: str):
    """The record's cavity: Params, the perturbed start and the direction
    (tests/jax_records.py DIFF_CAVITY), on `device`."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.grid import allocate_state

    prm = Params.from_file(str(ROOT / rec["config"]), dtype=rec["dtype"],
                           epsilon=rec["epsilon"])
    base = allocate_state(prm, device)
    base = base._replace(u=base.u + torch.tensor(perturbation(
        prm.shape, rec["bump_seed"], rec["bump"]), device=device))
    direction = torch.tensor(perturbation(prm.shape, rec["direction_seed"],
                                          1.0), device=device)
    return prm, base, direction


def cavity_loss(torch, prm, base, rec, lid_scale, u0, steps=None,
                method=None, remat=True, mesh=None):
    from navierstokes_parallel_tpu_torch import diff

    c = diff.default_controls(prm, base.u.device)._replace(
        lid_scale=lid_scale)
    final, _ = diff.solve_n_steps(prm, base._replace(u=u0),
                                  steps or rec["steps"], controls=c,
                                  pressure_method=method or rec["method"],
                                  remat=remat, mesh=mesh)
    return (final.u[1:-1, 1:-1] ** 2).sum() + (final.v[1:-1, 1:-1] ** 2).sum()


def gradient_run(torch, prm, base, rec, device, **kw):
    """One loss and its backward pass on `device`: (loss, d/d lid_scale,
    d/d u0, forward launches, backward launches, forward s, backward s)."""
    lid = torch.tensor(1.0, dtype=base.u.dtype, device=device,
                       requires_grad=True)
    u0 = base.u.clone().requires_grad_(True)
    fence(torch, device)
    reset_launches()
    t0 = time.perf_counter()
    loss = cavity_loss(torch, prm, base, rec, lid, u0, **kw)
    fence(torch, device)
    t1 = time.perf_counter()
    fwd = read_launches()
    reset_launches()
    loss.backward()
    fence(torch, device)
    t2 = time.perf_counter()
    return (float(loss.detach()), lid.grad, u0.grad, fwd, read_launches(),
            t1 - t0, t2 - t1)


def phase_gradients(torch, device: str = "cuda") -> dict:
    """The differentiable path (diff.py) at configs/1.in's 256^2 grid, f64
    to epsilon 1e-9, by mg (tests/jax_a9_records.json "diff" "cavity"):
    the loss, d/d(lid_scale) and the directional derivative w.r.t. the
    initial u against JAX's record (GRAD_JAX_REL) and against central
    differences of the card's own forward (GRAD_FD_REL); the smoother and
    coarse-cycle launches of the forward pass, of the backward pass with
    remat (the recomputed forward and the adjoint solves) and without it
    (the adjoint solves alone), printed apart, the plain twins barred;
    the gradient with and without remat equal; a recomputed step equal to
    the first bit for bit; peak device memory with and without remat at
    REMAT_STEPS steps; the seconds of one gradient beside one forward; the
    same gradient by pallas_sor (the SOR sweep kernel in both passes);
    then d(Nu_hot)/d(t_left) on configs/convection.in's 64^2 ("thermal")
    and a masked-adjoint directional derivative on the backward-facing
    step at 128 x 32 ("masked", no kernel), each against its JAX record.
    Returns the launch counts of the mg gradient with remat."""
    from navierstokes_parallel_tpu_torch import diff
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel

    with open(A9_RECORDS) as fh:
        records = json.load(fh)["diff"]
    rec = records["cavity"]
    prm, base, direction = cavity_gradient_setup(torch, rec, device)
    print(f"[gradients] configs/1.in {prm.i_max}x{prm.j_max} {rec['dtype']} "
          f"eps {rec['epsilon']:g}, {rec['steps']} steps by {rec['method']}"
          f" from u + {rec['bump']} N(0,1) (seed {rec['bump_seed']})")
    with barred(sor_kernel, PLAIN_SWEEPS, "the gradients path"):
        gradient_run(torch, prm, base, rec, device, steps=1)  # first use
        loss, g_lid_t, g_u, fwd, bwd, fwd_s, bwd_s = gradient_run(
            torch, prm, base, rec, device)
        _, g_lid0, g_u0, fwd0, adj, _, _ = gradient_run(
            torch, prm, base, rec, device, remat=False)
    recompute = launch_delta(bwd, adj)
    g_lid, g_dir = float(g_lid_t), float(torch.sum(g_u * direction))
    print(f"[gradients] loss {loss!r} (JAX {rec['loss']!r}); d/d lid_scale "
          f"{g_lid!r} (JAX {rec['grad_lid']!r}, rel "
          f"{rel_err(g_lid, rec['grad_lid']):.2e}); directional {g_dir!r} "
          f"(JAX {rec['directional']!r}, rel "
          f"{rel_err(g_dir, rec['directional']):.2e}); bound {GRAD_JAX_REL:g}")
    print(f"[gradients] launches: forward {fwd}; backward with remat {bwd} "
          f"= recomputed forward {recompute} + adjoint solves {adj}")
    print(f"[gradients] one forward + backward with remat: {fwd_s:.3f} + "
          f"{bwd_s:.3f} s")
    check(rel_err(loss, rec["loss"]) <= GRAD_JAX_REL,
          "the loss differs from JAX's record")
    check(rel_err(g_lid, rec["grad_lid"]) <= GRAD_JAX_REL and
          rel_err(g_dir, rec["directional"]) <= GRAD_JAX_REL,
          "the gradients differ from JAX's record")
    same = torch.equal(g_lid0, g_lid_t) and torch.equal(g_u0, g_u)
    print(f"[gradients] with and without remat: equal bit for bit {same}")
    check(same, "remat changed the gradient")
    for name, counts in (("forward", fwd), ("adjoint", adj),
                         ("recompute", recompute)):
        check_only(counts, ("sor_warm", "mg_coarse_cycle"),
                   f"the gradients path's {name} solves")
    check(recompute == fwd, "the recomputed forward launched other kernels "
          "than the forward")
    a, _ = diff.diff_step(base, prm, pressure_method=rec["method"])
    b, _ = diff.diff_step(base, prm, pressure_method=rec["method"])
    check_same_fields(a, b, "gradients: two forwards of one step")

    h, hd = rec["h_lid"], rec["h_dir"]
    one = torch.tensor(1.0, dtype=base.u.dtype, device=device)
    with torch.no_grad():
        fd_lid = (float(cavity_loss(torch, prm, base, rec, one + h, base.u))
                  - float(cavity_loss(torch, prm, base, rec, one - h,
                                      base.u))) / (2 * h)
        fd_dir = (float(cavity_loss(torch, prm, base, rec, one,
                                    base.u + hd * direction))
                  - float(cavity_loss(torch, prm, base, rec, one,
                                      base.u - hd * direction))) / (2 * hd)
        fence(torch, device)
        t0 = time.perf_counter()
        cavity_loss(torch, prm, base, rec, one, base.u)
        fence(torch, device)
        plain_s = time.perf_counter() - t0
    print(f"[gradients] central differences of the card's forward: lid "
          f"{fd_lid!r} (rel {rel_err(g_lid, fd_lid):.2e}, bound "
          f"{GRAD_FD_REL['lid']:g}; JAX's own {rec['fd_lid']!r}), "
          f"directional {fd_dir!r} (rel {rel_err(g_dir, fd_dir):.2e}, bound "
          f"{GRAD_FD_REL['dir']:g}; JAX's own {rec['fd_dir']!r})")
    print(f"[gradients] seconds: one forward without autograd {plain_s:.3f};"
          f" one gradient (forward {fwd_s:.3f} + backward {bwd_s:.3f}) "
          f"{fwd_s + bwd_s:.3f}, {(fwd_s + bwd_s) / plain_s:.2f}x")
    check(rel_err(g_lid, fd_lid) <= GRAD_FD_REL["lid"] and
          rel_err(g_dir, fd_dir) <= GRAD_FD_REL["dir"],
          "the gradients differ from the card's central differences")

    if device == "cuda":
        peaks = {}
        for steps in REMAT_STEPS:
            for remat in (True, False):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                gradient_run(torch, prm, base, rec, device, steps=steps,
                             remat=remat)
                peaks[steps, remat] = (torch.cuda.max_memory_allocated()
                                       - start)
                print(f"[gradients] {steps} steps, remat {remat}: peak device "
                      f"memory {peaks[steps, remat] / 2**20:.1f} MiB over "
                      f"the {start / 2**20:.1f} MiB held before")
        lo, hi = REMAT_STEPS
        print(f"[gradients] peak growth {lo} -> {hi} steps: remat "
              f"{peaks[hi, True] / peaks[lo, True]:.2f}x, without "
              f"{peaks[hi, False] / peaks[lo, False]:.2f}x")
        check(peaks[hi, True] < peaks[hi, False],
              "remat did not lower the peak memory")

    with barred(sor_kernel, PLAIN_SWEEPS, "the pallas_sor gradient"):
        _, p_lid, p_u, pfwd, pbwd, pfwd_s, pbwd_s = gradient_run(
            torch, prm, base, rec, device, method="pallas_sor")
    p_lid = float(p_lid)
    print(f"[gradients] by pallas_sor: d/d lid_scale {p_lid!r} (rel to mg "
          f"{rel_err(p_lid, g_lid):.2e}: its solves stop at max_it "
          f"{prm.max_it}, short of eps {prm.epsilon:g}); launches forward "
          f"{pfwd}, backward {pbwd}; {pfwd_s:.3f} + {pbwd_s:.3f} s")
    check(np.isfinite(p_lid) and bool(torch.isfinite(p_u).all()),
          "the pallas_sor gradient is not finite")
    check_only(pfwd, ("sor",), "the pallas_sor gradient's forward")
    check_only(pbwd, ("sor",), "the pallas_sor gradient's backward")

    thermal_gradient(torch, records["thermal"], device)
    masked_gradient(torch, records["masked"], device)
    return sum_launches([fwd, bwd, fwd0, adj, pfwd, pbwd])


def thermal_gradient(torch, rec: dict, device: str) -> None:
    """d(Nu_hot)/d(t_left) through diff.solve_thermal_n_steps against the
    JAX record (tests/jax_records.py DIFF_THERMAL)."""
    from navierstokes_parallel_tpu_torch import diff
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import convection

    prm = Params.from_file(str(ROOT / rec["config"]), dtype=rec["dtype"],
                           epsilon=rec["epsilon"])
    cfg = convection.config_from_params(prm)
    ts = convection.allocate_thermal(prm, cfg, device)
    rng = np.random.default_rng(rec["bump_seed"])
    bumps = [torch.tensor(perturbation(prm.shape, 0, rec["bump"], rng),
                          device=device) for _ in range(2)]
    ts = ts._replace(u=ts.u + bumps[0], v=ts.v + bumps[1])
    t_left = torch.tensor(rec["t_left"], dtype=ts.T.dtype, device=device,
                          requires_grad=True)
    reset_launches()
    t0 = time.perf_counter()
    final, _ = diff.solve_thermal_n_steps(prm, ts, rec["steps"],
                                          cfg._replace(t_left=t_left),
                                          pressure_method=rec["method"])
    nu = torch.mean(-2.0 * (final.T[1, 1:-1] - t_left) * prm.i_max)
    nu.backward()
    fence(torch, device)
    seconds = time.perf_counter() - t0
    got_nu, got_g = float(nu.detach()), float(t_left.grad)
    print(f"[gradients] thermal {rec['config']} {prm.i_max}^2 "
          f"{rec['steps']} steps by {rec['method']}: Nu_hot {got_nu!r} (JAX "
          f"{rec['nu_hot']!r}), d/d t_left {got_g!r} (JAX "
          f"{rec['grad_t_left']!r}, rel "
          f"{rel_err(got_g, rec['grad_t_left']):.2e}) in {seconds:.3f} s; "
          f"launches {read_launches()}")
    check(rel_err(got_nu, rec["nu_hot"]) <= GRAD_JAX_REL and
          rel_err(got_g, rec["grad_t_left"]) <= GRAD_JAX_REL,
          "the thermal gradient differs from JAX's record")


def masked_gradient(torch, rec: dict, device: str) -> None:
    """The masked adjoint: a directional derivative w.r.t. the initial u on
    the backward-facing step against the JAX record (DIFF_MASKED); no
    sweep kernel of another route is launched (the masked V-cycles take
    their own kernels wherever no gradient flows through them)."""
    from navierstokes_parallel_tpu_torch import diff
    from navierstokes_parallel_tpu_torch.grid import allocate_state
    from navierstokes_parallel_tpu_torch.models import step as bfs

    prm = bfs.backward_facing_step(**rec["kwargs"], dtype=rec["dtype"],
                                   epsilon=rec["epsilon"])
    base = allocate_state(prm, device)
    bump = torch.tensor(perturbation(prm.shape, rec["bump_seed"],
                                     rec["bump"]), device=device)
    base = base._replace(u=base.u + bump, v=base.v + bump)
    direction = torch.tensor(perturbation(prm.shape, rec["direction_seed"],
                                          1.0), device=device)
    u0 = base.u.clone().requires_grad_(True)
    reset_launches()
    t0 = time.perf_counter()
    final, _ = diff.solve_n_steps(prm, base._replace(u=u0), rec["steps"],
                                  pressure_method=rec["method"])
    loss = (final.u[1:-1, 1:-1] ** 2).sum() + (final.v[1:-1, 1:-1] ** 2).sum()
    loss.backward()
    fence(torch, device)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    got = float(torch.sum(u0.grad * direction))
    print(f"[gradients] masked {prm.i_max}x{prm.j_max} backward-facing step "
          f"{rec['steps']} steps by {rec['method']}: loss {float(loss)!r} "
          f"(JAX {rec['loss']!r}), directional {got!r} (JAX "
          f"{rec['directional']!r}, rel "
          f"{rel_err(got, rec['directional']):.2e}) in {seconds:.3f} s; "
          f"launches {launches}")
    check(rel_err(float(loss), rec["loss"]) <= GRAD_JAX_REL and
          rel_err(got, rec["directional"]) <= GRAD_JAX_REL,
          "the masked gradient differs from JAX's record")
    check_only(launches, (), "the masked gradient")


# The compensated residual at configs/4.in's 2050^2 (tests/
# test_compensated.py's field and error model at dx = 1/2048), and the
# random pairs of the error-free transformations.
COMPENSATED_N = 2048
EFT_PAIRS = 1 << 20


def phase_compensated(torch, device: str = "cuda") -> dict:
    """The compensated outer (ops/compensated.py): the error-free
    transformations on EFT_PAIRS random f32 pairs on the card, exact in
    f64 and equal to the CPU's bit for bit; residual_df against the f64
    defect at 2050^2 within tests/test_compensated.py's error bound (the
    plain f32 defect 100x further off); then configs/1.in through the CLI
    with --outer compensated at K = 64 and 2048, and on the sharded 1x1
    mesh by rb_sor and by mg, each against the JAX CLI's record
    (tests/jax_a9_records.json "compensated"): steps and failures exact,
    sweeps within one K-quantum per step, centre values within the
    contract, the path's kernels launched.  Returns the launch counts."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import compensated as comp
    from navierstokes_parallel_tpu_torch.ops import sor

    rng = np.random.default_rng(0)
    a = rng.standard_normal(EFT_PAIRS).astype(np.float32)
    b = (rng.standard_normal(EFT_PAIRS)
         * 10.0 ** rng.integers(-6, 6, EFT_PAIRS)).astype(np.float32)
    wide = a.astype(np.float64), b.astype(np.float64)
    ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    for name, exact in (("two_sum", wide[0] + wide[1]),
                        ("two_prod", wide[0] * wide[1])):
        x, e = (y.cpu().numpy() for y in getattr(comp, name)(ta, tb))
        cx, ce = (y.numpy() for y in getattr(comp, name)(
            torch.from_numpy(a), torch.from_numpy(b)))
        exact_ok = np.array_equal(x.astype(np.float64) + e, exact)
        same = np.array_equal(x, cx) and np.array_equal(e, ce)
        print(f"[compensated] {name} on {EFT_PAIRS} pairs: exact in f64 "
              f"{exact_ok}; equal to the CPU's {same}")
        check(exact_ok and same, f"{name} is not exact on the card")

    n = COMPENSATED_N
    dx = 1.0 / n
    dx2 = np.float32(1.0 / (dx * dx))
    x = (np.arange(n + 2) - 0.5) * dx
    p64 = (np.sin(2 * np.pi * x)[:, None] * np.cos(2 * np.pi * x)[None, :]
           * 3.0)
    hi = np.float32(p64)
    lo = np.float32(p64 - hi)
    pair = torch.from_numpy(hi.astype(np.float64) + lo).to(device)
    zeros = torch.zeros((n, n), dtype=torch.float64, device=device)
    lap = sor.residual(pair, zeros, float(dx2), float(dx2))
    rhs32 = (lap + 1e-4 * torch.from_numpy(rng.standard_normal(
        (n, n))).to(device)).to(torch.float32)
    r64 = sor.residual(pair, rhs32.to(torch.float64), float(dx2), float(dx2))
    t_hi, t_lo = torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(
        device)
    rdf = comp.residual_df(t_hi, t_lo, rhs32, dx2, dx2)
    r32 = sor.residual(t_hi, rhs32, dx2, dx2)
    err = float((rdf.to(torch.float64) - r64).abs().max())
    err32 = float((r32.to(torch.float64) - r64).abs().max())
    eps = float(np.finfo(np.float32).eps)
    bound = (32 * eps ** 2 * float(np.abs(p64).max()) * float(dx2)
             + 8 * eps * float(r64.abs().max()))
    print(f"[compensated] residual_df at {n + 2}^2 against the f64 defect: "
          f"max err {err:.3e} (bound {bound:.3e}); the plain f32 defect "
          f"{err32:.3e} ({err32 / max(err, 1e-300):.0f}x)")
    check(err <= bound and err32 > 100 * err,
          "residual_df misses its error bound")

    with open(A9_RECORDS) as fh:
        records = json.load(fh)["compensated"]
    runs = []
    for tag, rec in records.items():
        want = {k: int(rec["stats"][k]) for k in ("steps", "sor_failures")}
        uc, vc = (float(line.split()[1]) for line in rec["stdout"])
        stats, launches = run_cli(f"compensated {tag}",
                                  [str(ROOT / rec["argv"][0]),
                                   *rec["argv"][1:]], uc, vc, want)
        prm = Params.from_file(str(ROOT / rec["argv"][0]))
        if "--refine-every" in rec["argv"]:
            quantum = int(rec["argv"][rec["argv"].index("--refine-every")
                                      + 1])
        else:
            quantum = 1 if "mg" in rec["argv"] else prm.sor_refine_every
        sweeps, jax_sweeps = (int(stats["sor_iterations"]),
                              int(rec["stats"]["sor_iterations"]))
        print(f"[compensated {tag}] sweeps {sweeps} vs JAX {jax_sweeps} "
              f"(allowed {quantum} per step)")
        check(abs(sweeps - jax_sweeps) <= quantum * want["steps"],
              "the sweeps differ from JAX's by more than a K-quantum a step")
        kernels = {("single", False): ("sor", "momentum"),
                   ("single", True): ("sor_warm", "mg_coarse_cycle",
                                      "momentum"),
                   ("sharded", False): ("sor_ext",),
                   ("sharded", True): ("sor_ext", "mg_coarse_cycle")}[
            "sharded" if "sharded" in rec["argv"] else "single",
            "mg" in rec["argv"]]
        check_only(launches, kernels, f"the compensated {tag} run")
        runs.append(launches)
    return sum_launches(runs)


def ensemble_members(torch, prm, rec: dict, device: str):
    """tests/jax_records.py's ensemble_members on `device`."""
    from navierstokes_parallel_tpu_torch.grid import allocate_state

    rng = np.random.default_rng(rec["seed"])
    members = []
    for k in range(rec["members"]):
        s = allocate_state(prm, device)
        du = perturbation(prm.shape, 0, rec["scale"] * k, rng)
        members.append(s._replace(u=s.u + torch.tensor(du, dtype=s.u.dtype,
                                                       device=device)))
    return members


def phase_ensemble(torch, device: str = "cuda") -> dict:
    """solver.solve_ensemble on the card (tests/jax_a9_records.json
    "ensemble": 8 members of configs/1.in's 256^2 cavity, f32, max_it cut
    to 2000): by rb_sor and fft (batched) and mg (member by member), each
    member's steps, iterations and failures against JAX's ensemble record
    and the member's solo solver.solve on the card, its fields within the
    contract of the solo run's (rb_sor's: equal bit for bit, the batch
    runs the solo route's kernels) and its centre
    values of JAX's; the kernels each batched step must launch
    (ENSEMBLE_KERNELS), and the seconds and launch counts of the batch,
    after one warm-up step of the batched route, beside those of the 8
    solo runs.  Returns the launch counts of the batched runs."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import sor

    with open(A9_RECORDS) as fh:
        rec = json.load(fh)["ensemble"]
    prm = Params.from_file(str(ROOT / rec["config"]), dtype=rec["dtype"],
                           max_it=rec["max_it"])
    check(rec["members"] == ENSEMBLE_MEMBERS,
          f"the ensemble record has {rec['members']} members, the batched "
          f"kernels were compared at {ENSEMBLE_MEMBERS}")
    members = ensemble_members(torch, prm, rec, device)
    runs = []
    i_c, j_c = prm.i_max // 2, prm.j_max // 2
    for method, jax_run in rec["runs"].items():
        route = ("batched" if method in sor.BATCHED_METHODS
                 else "member by member")
        solver.warm_up(prm, device, method)
        # One step of every member (T below any dt), one sweep or cycle: the
        # batched route's first use.
        solver.solve_ensemble(prm.replace(max_it=1, T=1e-9),
                              solver.stack_states(members),
                              pressure_method=method)
        fence(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        out, stats = solver.solve_ensemble(
            prm, solver.stack_states(members), pressure_method=method)
        fence(torch, device)
        seconds = time.perf_counter() - t0
        launches = read_launches()
        for name in ENSEMBLE_KERNELS[method]:
            check(launches[name] > 0,
                  f"the {method} ensemble launched no {name} kernel")
        solo_s, solo_launches, worst = 0.0, [], 0.0
        for k, member in enumerate(members):
            reset_launches()
            t0 = time.perf_counter()
            state, sstats = solver.solve(prm, member, pressure_method=method)
            fence(torch, device)
            solo_s += time.perf_counter() - t0
            solo_launches.append(read_launches())
            check((int(stats.steps[k]), int(stats.total_sor_iterations[k]),
                   int(stats.sor_failures[k])) == tuple(sstats[:3]),
                  f"ensemble member {k} by {method} differs from its solo "
                  f"run {sstats}")
            worst = max([worst] + [contract_err(
                getattr(out, name)[k].cpu().numpy(),
                getattr(state, name).cpu().numpy())
                for name in ("u", "v", "p")])
        for key in ("steps", "iterations", "failures"):
            got = getattr(stats, {"steps": "steps",
                                  "iterations": "total_sor_iterations",
                                  "failures": "sor_failures"}[key]).tolist()
            check(got == jax_run[key], f"ensemble {method} {key} {got}, JAX "
                                       f"recorded {jax_run[key]}")
        centre = max(contract_err([float(out.u[k, i_c, j_c]),
                                   float(out.v[k, i_c, j_c])], c)
                     for k, c in enumerate(jax_run["centre"]))
        solo = sum_launches(solo_launches)
        print(f"[ensemble] {method} ({route}), {rec['members']} members: "
              f"steps {stats.steps.tolist()}, iterations "
              f"{stats.total_sor_iterations.tolist()}, failures "
              f"{stats.sor_failures.tolist()} (JAX's and the solo runs'); "
              f"fields vs solo max contract err {worst:.2e}, centre vs JAX "
              f"{centre:.2e}")
        print(f"[ensemble] {method}: batch {seconds:.3f} s, launches "
              f"{launches}; {rec['members']} solo runs {solo_s:.3f} s, "
              f"launches {solo}")
        check(worst <= CONTRACT and centre <= CONTRACT,
              f"the {method} ensemble's fields are outside the contract")
        check(method != "rb_sor" or worst == 0.0,
              "the batched rb_sor ensemble differs from its solo runs")
        runs.append(launches)
    return sum_launches(runs)


# The launches of one mesh gradient's kernels in each pass, by method: the
# sharded mg's smoother (B6) and its replicated tail (the coarse cycle),
# and the deep-halo inner of pallas_sor (B6).
MESH_GRAD_KERNELS = {"mg": ("sor_ext", "mg_coarse_cycle"),
                     "pallas_sor": ("sor_ext",)}


def peak_gradient(torch, prm, base, rec, **kw):
    """A gradient_run with the peak device memory above what was held
    before it: (gradient_run's tuple, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = gradient_run(torch, prm, base, rec, "cuda", **kw)
    return out, torch.cuda.max_memory_allocated() - start


def phase_mesh_gradients(torch) -> dict:
    """Gradients on a mesh (diff.solve_n_steps(mesh=...)) over a one-rank
    NCCL group on the 1x1 mesh, the plain sweep twins barred: the gradients
    phase's 256^2 f64 cavity (3 steps, eps 1e-9) by mg, its loss and
    gradients within GRAD_JAX_REL of JAX's record; by pallas_sor (the
    deep-halo inner, kernel B6, under the f64 master), within GRAD_JAX_REL
    of the unmeshed pallas_sor gradient of this call (both stop at max_it);
    for each, the launches of the forward, of the backward with remat and
    without it, whose difference is the recomputed forward
    (MESH_GRAD_KERNELS in each, no other SOR kernel), and the seconds and
    peak memory of the mesh gradient beside the unmeshed one's.  Then
    d(Nu_hot)/d(t_left) on configs/convection.in's 64^2 on the mesh
    against JAX's record.  Returns the launch counts of its runs."""
    from navierstokes_parallel_tpu_torch import diff
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import convection
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    with open(A9_RECORDS) as fh:
        records = json.load(fh)["diff"]
    rec = records["cavity"]
    prm, base, direction = cavity_gradient_setup(torch, rec, "cuda")
    runs = []
    with distributed.process_group("cuda") as device, \
            barred(sor_kernel, PLAIN_SWEEPS, "the mesh gradients"):
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        for method in ("mg", "pallas_sor"):
            # First use of the routes.
            gradient_run(torch, prm, base, rec, "cuda", steps=1,
                         method=method, mesh=mesh)
            gradient_run(torch, prm, base, rec, "cuda", steps=1,
                         method=method)
            (loss, g_lid, g_u, fwd, bwd, fwd_s, bwd_s), peak = \
                peak_gradient(torch, prm, base, rec, method=method, mesh=mesh)
            adj = gradient_run(torch, prm, base, rec, "cuda", method=method,
                               mesh=mesh, remat=False)[4]
            (one_loss, one_lid, one_u, *_, one_fwd_s, one_bwd_s), \
                one_peak = peak_gradient(torch, prm, base, rec,
                                         method=method)
            recompute = launch_delta(bwd, adj)
            g_lid, g_dir = float(g_lid), float(torch.sum(g_u * direction))
            if method == "mg":
                want = {"loss": rec["loss"], "lid": rec["grad_lid"],
                        "directional": rec["directional"],
                        "of": "JAX's record"}
            else:
                want = {"loss": one_loss, "lid": float(one_lid),
                        "directional": float(torch.sum(one_u * direction)),
                        "of": "the unmeshed pallas_sor gradient"}
            errs = {"loss": rel_err(loss, want["loss"]),
                    "lid": rel_err(g_lid, want["lid"]),
                    "directional": rel_err(g_dir, want["directional"])}
            print(f"[mesh gradients] {method} on the 1x1 mesh: loss "
                  f"{loss!r}, d/d lid_scale {g_lid!r}, directional "
                  f"{g_dir!r}; rel errors against {want['of']}: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (bound {GRAD_JAX_REL:g})")
            print(f"[mesh gradients] {method} launches: forward {fwd}; "
                  f"backward with remat {bwd} = recomputed forward "
                  f"{recompute} + adjoint solves {adj}")
            print(f"[mesh gradients] {method} seconds: mesh forward "
                  f"{fwd_s:.3f} + backward {bwd_s:.3f} = "
                  f"{fwd_s + bwd_s:.3f}; unmeshed {one_fwd_s:.3f} + "
                  f"{one_bwd_s:.3f} = {one_fwd_s + one_bwd_s:.3f}; peak "
                  f"device memory mesh {peak / 2**20:.1f} MiB, unmeshed "
                  f"{one_peak / 2**20:.1f} MiB")
            check(max(errs.values()) <= GRAD_JAX_REL,
                  f"the {method} mesh gradient differs from {want['of']}")
            for name, counts in (("forward", fwd), ("recompute", recompute),
                                 ("adjoint", adj)):
                check_only(counts, MESH_GRAD_KERNELS[method],
                           f"the {method} mesh gradient's {name}")
            runs += [fwd, bwd, adj]

        trec = records["thermal"]
        tprm = Params.from_file(str(ROOT / trec["config"]),
                                dtype=trec["dtype"], epsilon=trec["epsilon"])
        cfg = convection.config_from_params(tprm)
        ts = convection.allocate_thermal(tprm, cfg, "cuda")
        rng = np.random.default_rng(trec["bump_seed"])
        bumps = [torch.tensor(perturbation(tprm.shape, 0, trec["bump"], rng),
                              device="cuda") for _ in range(2)]
        ts = ts._replace(u=ts.u + bumps[0], v=ts.v + bumps[1])
        t_left = torch.tensor(trec["t_left"], dtype=ts.T.dtype,
                              device="cuda", requires_grad=True)
        reset_launches()
        t0 = time.perf_counter()
        final, _ = diff.solve_thermal_n_steps(
            tprm, ts, trec["steps"], cfg._replace(t_left=t_left),
            pressure_method=trec["method"], mesh=mesh)
        nu = torch.mean(-2.0 * (final.T[1, 1:-1] - t_left) * tprm.i_max)
        nu.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        got_nu, got_g = float(nu.detach()), float(t_left.grad)
        print(f"[mesh gradients] thermal {trec['config']} {tprm.i_max}^2 "
              f"{trec['steps']} steps by {trec['method']} on the 1x1 mesh: "
              f"Nu_hot {got_nu!r} (JAX {trec['nu_hot']!r}), d/d t_left "
              f"{got_g!r} (JAX {trec['grad_t_left']!r}, rel "
              f"{rel_err(got_g, trec['grad_t_left']):.2e}) in "
              f"{seconds:.3f} s; launches {launches}")
        check(rel_err(got_nu, trec["nu_hot"]) <= GRAD_JAX_REL and
              rel_err(got_g, trec["grad_t_left"]) <= GRAD_JAX_REL,
              "the thermal mesh gradient differs from JAX's record")
        check_only(launches, MESH_GRAD_KERNELS["mg"],
                   "the thermal mesh gradient")
        runs.append(launches)
    return sum_launches(runs)


# The mesh ensemble's launches: 3 steps of 8 members, the batched SOR
# sweep kernel (B1) and the f64 outer's fused pass once per refinement
# pass of 64 sweeps (max_it 2000: 32 passes a step) and the fused
# momentum kernel (B2) once a step.
MESH_ENSEMBLE_LAUNCH_COUNTS = {"sor": 96, "pressure_defect": 96,
                               "momentum": 3}


def phase_mesh_ensemble(torch) -> dict:
    """The data-parallel ensemble (solve_ensemble(mesh=...)) on a
    one-device batch mesh over a one-rank NCCL group: the ensemble phase's
    8 members of configs/1.in (max_it 2000) by rb_sor, every field and
    stat equal to the unmeshed batch's of this call bit for bit, the counts
    JAX's record, B1, the fused pass and B2 launched
    MESH_ENSEMBLE_LAUNCH_COUNTS times, and the
    seconds of both.  Returns the mesh run's launch counts."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.parallel import topology
    from navierstokes_parallel_tpu_torch.utils import distributed

    with open(A9_RECORDS) as fh:
        rec = json.load(fh)["ensemble"]
    prm = Params.from_file(str(ROOT / rec["config"]), dtype=rec["dtype"],
                           max_it=rec["max_it"])
    batch = solver.stack_states(ensemble_members(torch, prm, rec, "cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_stats = solver.solve_ensemble(prm, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with distributed.process_group("cuda") as device:
        mesh = topology.make_batch_mesh(device=device)
        reset_launches()
        t0 = time.perf_counter()
        out, stats = solver.solve_ensemble(prm, batch, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    same = all(torch.equal(a, b) for a, b in zip((*out, *stats),
                                                 (*want, *want_stats)))
    jax_run = rec["runs"]["rb_sor"]
    counts = [stats.steps.tolist(), stats.total_sor_iterations.tolist(),
              stats.sor_failures.tolist()]
    want_counts = [jax_run[k] for k in ("steps", "iterations", "failures")]
    print(f"[mesh ensemble] rb_sor, {rec['members']} members on a "
          f"{mesh.shape[0]}-device batch mesh: steps, iterations, failures "
          f"{counts} (JAX's {want_counts}); "
          f"equal to the unmeshed batch bit for bit {same}; {seconds:.3f} s "
          f"(unmeshed {plain_s:.3f} s); launches {launches}")
    check(same, "the mesh ensemble differs from the unmeshed batch")
    check(counts == want_counts,
          "the mesh ensemble's counts differ from JAX's record")
    for name, n in MESH_ENSEMBLE_LAUNCH_COUNTS.items():
        check(launches[name] == n, f"the mesh ensemble launched {name} "
                                   f"{launches[name]} times, not {n}")
    check_only(launches, ("sor",), "the mesh ensemble")
    return launches


GSPMD_RECORDS = ROOT / "tests" / "jax_gspmd_records.json"
# Every route a gspmd path must not take besides its own kernels.
GSPMD_BARRED = PLAIN_SWEEPS + ("inner_sweeps", "inner_sweeps_tiled",
                               "inner_sweeps_compressed", "whole_grid_sweeps",
                               "warm_sweeps")


def gspmd_kernels(prm, method: str):
    """The kernels a gspmd run launches: B6 in rb_sor's deep-halo sweeps;
    under mg B6 on each sharded level (those above one device's
    coarse-cycle depth) and the coarse cycle for the gathered tail;
    nothing for jacobi, cg, fft (cuFFT), the masked solves (whose gathered
    V-cycle tail takes the masked kernels, counted apart) and the free
    surface."""
    from navierstokes_parallel_tpu_torch.ops import mg

    if prm.obstacles or prm.problem == 6 or method not in ("rb_sor", "mg"):
        return ()
    if method == "rb_sor":
        return ("sor_ext",)
    if len(mg.build_levels_gspmd(prm, (1, 1), cuda=True)) > 1:
        return ("sor_ext", "mg_coarse_cycle")
    return ("mg_coarse_cycle",)


def gspmd_run(run: dict, mesh):
    """(params, the stepper, its K, the norms' context) of a recorded gspmd
    run."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.models import convection
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.ops import surface
    from navierstokes_parallel_tpu_torch.parallel import gspmd, sharded_free

    method = run["method"]
    if run["config"] == "square_cylinder":
        prm, state, _ = obstacle_setup({"model": run["config"],
                                        "kwargs": run["kwargs"],
                                        "record": "force"}, "cpu")
    else:
        prm, state = Params.from_file(str(ROOT / run["config"])), None
    if prm.problem == 5:
        cfg = convection.config_from_params(prm)
        stepper = convection.ThermalGspmdStepper(prm, cfg, None, mesh,
                                                 method)
    elif prm.problem == 6:
        gspmd._check_mesh(mesh)
        stepper = sharded_free.make_free_stepper(
            prm, FS.initial_free_state(prm, mesh.device), mesh, wall=method)
    else:
        stepper = gspmd.GspmdStepper(prm, state, mesh, method)
    K = {"mg": prm.mg_cycles_per_outer, "fft": prm.fft_solves_per_outer}.get(
        method, prm.sor_refine_every)
    norms = (masked_norms(surface, "solve_pressure_free")
             if prm.problem == 6 else refined_norms())
    return prm, stepper, max(1, K), norms


def phase_gspmd(torch) -> dict:
    """The gspmd backend (parallel/gspmd.py) over a one-rank NCCL group on
    the 1x1 mesh: each run of GSPMD_RECORDS "chip" stepped as recorded
    (module docstring), the plain sweep twins and every kernel route but
    the run's own (``gspmd_kernels``) barred; every step's passes through
    the gate against JAX's gspmd record, failures, centre values and
    max |u|, |v| within the contract (the dam break: the fluid volume
    within 1e-10 of JAX's).  mg's launches are held to two B6 calls on
    each sharded level per V-cycle and one coarse cycle, no B3.  Prints
    each run's seconds and launches; returns the launch counts summed
    over the runs."""
    from navierstokes_parallel_tpu_torch.models import freesurface as FS
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import (momentum_kernel,
                                                          sor_kernel)
    from navierstokes_parallel_tpu_torch.parallel import topology
    from navierstokes_parallel_tpu_torch.solver import center_values
    from navierstokes_parallel_tpu_torch.utils import distributed

    runs = json.loads(GSPMD_RECORDS.read_text())["chip"]
    total = None
    with distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        for name, run in runs.items():
            tag = f"gspmd {name}"
            prm, stepper, K, norms = gspmd_run(run, mesh)
            kernels = gspmd_kernels(prm, run["method"])
            bar = GSPMD_BARRED + tuple(
                route for route, kernel in (("ext_sweeps", "sor_ext"), (
                    "coarse_cycle", "mg_coarse_cycle"))
                if kernel not in kernels)
            with barred(sor_kernel, bar, f"the {tag} path"), \
                    barred(momentum_kernel, MOMENTUM_ROUTES,
                           f"the {tag} path"):
                stepper.warm()
                with norms as solves:
                    reset_launches()
                    t0 = time.perf_counter()
                    iters, failures = [], 0
                    for _ in range(run["steps"]):
                        diag = stepper.step()
                        iters.append(int(diag.sor_iterations))
                        failures += 0 if diag.sor_converged else 1
                    torch.cuda.synchronize(device)
                    seconds = time.perf_counter() - t0
                    launches = read_launches()
            passes, margins = passes_and_margins(solves, prm, K)
            gate_passes(tag, passes, margins, run["iterations"], K)
            check(failures == run["converged"].count(False),
                  f"{tag}: {failures} failures, JAX "
                  f"{run['converged'].count(False)}")
            state = stepper.state()
            got = [*center_values(state, prm),
                   float(torch.max(torch.abs(state.u))),
                   float(torch.max(torch.abs(state.v)))]
            err = contract_err(got, run["centre"] + run["max_abs"])
            print(f"[{tag}] {run['steps']} steps, {sum(iters)} iterations "
                  f"(JAX {sum(run['iterations'])}), {failures} failures; "
                  f"centre and max |u|, |v| {got}, contract error "
                  f"{err:.2e}; {seconds:.6f} s; launches sor_ext_sweeps "
                  f"{launches['sor_ext']}, sor_warm_sweeps "
                  f"{launches['sor_warm']}, mg_coarse_cycle "
                  f"{launches['mg_coarse_cycle']}")
            check(err <= CONTRACT, f"{tag}: outside the contract")
            if prm.problem == 6:
                vol = FS.fluid_volume(stepper.free_state(), prm)
                rel = abs(vol - run["fluid_volume"]) / run["fluid_volume"]
                print(f"[{tag}] fluid volume {vol} (JAX "
                      f"{run['fluid_volume']}, rel err {rel:.2e})")
                check(rel <= 1e-10, f"{tag}: fluid volume differs")
            check_only(launches, kernels, tag)
            check(launches["momentum"] == 0, f"{tag} launched momentum_rhs")
            if "mg_coarse_cycle" in kernels:
                levels = mg.build_levels_gspmd(prm, (1, 1), cuda=True)
                cycles = sum(iters)
                expect = {"sor_ext": cycles * 2 * (len(levels) - 1),
                          "mg_coarse_cycle": cycles, "sor_warm": 0}
                print(f"[{tag}] {len(levels) - 1} sharded levels of one "
                      f"device's {len(mg.build_levels(prm))}; launches "
                      f"expected {expect}")
                check(all(launches[k] == n for k, n in expect.items()),
                      f"{tag}: launches differ from {expect}")
            total = launches if total is None else {
                k: total[k] + launches[k] for k in total}
        gspmd_heated_block(torch, mesh)
    return total


def gspmd_heated_block(torch, mesh) -> None:
    """The 32^2 heated block of THERMAL_RECORDS "thermal" 20 steps by
    rb_sor through convection.ThermalGspmdStepper on `mesh` (an obstacle
    domain: the four fields all-gathered on the card every step, one
    device's masked thermal step, the block kept) beside
    convection.ThermalStepper in the same process, each warmed, every
    kernel route barred: both give JAX's passes step by step and the
    same fields bit for bit; prints both runs' seconds."""
    from navierstokes_parallel_tpu_torch.models import convection

    block = json.loads(THERMAL_RECORDS.read_text())["thermal"]["heated block"]
    bprm, bcfg = convection.heated_block_setup(**block["kwargs"])
    makers = {
        "one device": lambda: convection.ThermalStepper(
            bprm, bcfg, convection.allocate_thermal(bprm, bcfg, mesh.device),
            "rb_sor"),
        "gspmd 1x1": lambda: convection.ThermalGspmdStepper(
            bprm, bcfg, None, mesh, "rb_sor")}
    states, seconds = {}, {}
    for tag, make in makers.items():
        tag = f"heated block {tag}"
        stepper = make()
        failures = 0
        with no_kernel(tag):
            stepper.warm()
            with masked_norms() as solves:
                torch.cuda.synchronize(mesh.device)
                t0 = time.perf_counter()
                for _ in range(block["steps"]):
                    failures += 0 if stepper.step().sor_converged else 1
                torch.cuda.synchronize(mesh.device)
                seconds[tag] = time.perf_counter() - t0
        passes, margins = passes_and_margins(solves, bprm,
                                             bprm.sor_refine_every)
        gate_passes(tag, passes, margins, block["iterations"],
                    bprm.sor_refine_every)
        check(failures == block["failures"], f"{tag}: failures differ")
        states[tag] = stepper.state()
    one, gs = states.values()
    same = all(torch.equal(a, b) for a, b in zip(one[:4], gs[:4]))
    print(f"[gspmd heated block] {bprm.shape}, {block['steps']} steps: "
          + ", ".join(f"{tag} {sec:.6f} s" for tag, sec in seconds.items())
          + f"; fields equal bit for bit: {same}")
    check(same, "the gspmd heated block differs from one device's")


def sum_launches(runs) -> dict:
    return {k: sum(run[k] for run in runs) for k in runs[0]}


def history_rows(path) -> np.ndarray:
    """The rows of a --history-file CSV (its header checked)."""
    with open(path) as fh:
        check(fh.readline().strip() == PROTOCOL_COLUMNS,
              f"{path} has another header")
    rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    check(np.all(np.isfinite(rows)), f"{path} holds a non-finite value")
    return rows


def same_bytes(a: Path, b: Path) -> bool:
    return a.read_bytes() == b.read_bytes()


def frame_matches_state(torch, ck: Path, frame_prefix: Path, prm) -> bool:
    """The frame's three files are the bytes the writer gives the state of
    checkpoint `ck` (its fields on the card)."""
    from navierstokes_parallel_tpu_torch.utils import io as nsio
    from navierstokes_parallel_tpu_torch.utils.checkpoint import \
        load_checkpoint

    state = load_checkpoint(str(ck), prm, "cuda")
    out = ck.with_suffix("")
    nsio.output(state.u, state.v, state.p, float(state.t), prm.a, prm.b,
                str(out), verbose=False)
    return all(same_bytes(Path(f"{out}_{s}.txt"),
                          Path(f"{frame_prefix}_{s}.txt")) for s in "uvp")


def same_checkpoints(a: Path, b: Path) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)


def protocol_files(tag: str, frames: bool = True, physics: bool = True,
                   every: int = 1) -> list:
    """The CLI's protocol flags, every file under PROTOCOL_DIR/<tag>*."""
    d = PROTOCOL_DIR
    argv = ["--checkpoint-every", str(every), "--checkpoint-path",
            str(d / f"{tag}.npz")] if every else []
    if frames:
        argv += ["--output-dir", str(d / tag)]
    if physics:
        argv += ["--history-file", str(d / f"{tag}.csv"),
                 "--history-physics"]
    return argv


def phase_protocol(torch, paths: dict) -> dict:
    """The reference protocol through the CLI's host loop (frames, final
    output, checkpoint/resume, history with the physics monitors) on every
    kernel path, each run held to the JAX record of the same run without
    the files, with the same kernel launches (`paths`: the launch counts of
    those runs, by phase); returns the launch counts summed over its
    runs."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.utils import io as nsio
    from navierstokes_parallel_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)

    def save_compressed(path, state):
        np.savez_compressed(path, **{k: getattr(state, k).cpu().numpy()
                                     for k in ("u", "v", "p", "t")},
                            n=np.int32(state.n))

    d = PROTOCOL_DIR
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    c1, c4 = str(ROOT / "configs" / "1.in"), str(ROOT / "configs" / "4.in")
    prm1, prm4 = Params.from_file(c1), Params.from_file(c4)
    runs = []
    try:
        # configs/1.in with every file: the main path's record and launches.
        stats, launches = run_cli(
            "protocol 1.in", [c1, *protocol_files("p1"),
                              "--final-output-prefix", str(d / "final1"),
                              "--stats"],
            JAX_U_CENTER, JAX_V_CENTER, JAX_STATS)
        runs.append(launches)
        check(launches == paths["main"], f"the launches {launches} differ "
              f"from the main path's {paths['main']}")
        frames = sorted(f.name for f in (d / "p1").iterdir())
        check(frames == [f"{k}_{s}.txt" for k in range(3) for s in "puv"],
              f"frames {frames}")
        rows = history_rows(d / "p1.csv")
        print(f"[protocol] configs/1.in: frames {frames}; history rows "
              f"(step, sor_iterations) {rows[:, [0, 3]].astype(int).tolist()}"
              f", psi_min {rows[:, 8].tolist()}")
        check(rows[:, 0].tolist() == [1, 2, 3] and
              int(rows[:, 3].sum()) == JAX_STATS["sor_iterations"],
              "the history rows differ from the steps")
        check(frame_matches_state(torch, d / "p1.npz", d / "final1", prm1),
              "the final output is not the final state")

        # Stopped after 2 steps, then resumed: the straight run's frames,
        # history and final state, bit for bit.
        stats, la = run_cli(
            "protocol 1.in --max-steps 2",
            [c1, *protocol_files("p2"), "--max-steps", "2", "--stats"],
            JAX_1IN_2STEPS_U, JAX_1IN_2STEPS_V,
            {"steps": 2, "sor_iterations": 40000, "sor_failures": 2},
            rc_want=3)
        check(frame_matches_state(torch, d / "p2.npz", d / "p1" / "2", prm1),
              "the straight run's last frame is not the state after 2 steps")
        stats, lb = run_cli(
            "protocol 1.in --resume",
            [c1, "--resume", str(d / "p2.npz"), "--output-dir", str(d / "p2"),
             "--history-file", str(d / "p2.csv"), "--history-physics",
             "--checkpoint-every", "1", "--checkpoint-path",
             str(d / "p3.npz"), "--stats"],
            JAX_U_CENTER, JAX_V_CENTER,
            {"steps": 1, "sor_iterations": 20000, "sor_failures": 1})
        runs += [la, lb]
        passes = -(-prm1.max_it // prm1.sor_refine_every)
        check((la["sor"], lb["sor"]) == (2 * passes + 1, passes + 1),
              f"sor_sweeps calls {la['sor']} + {lb['sor']}")
        same = {"frames": all(same_bytes(d / "p1" / f, d / "p2" / f)
                              for f in frames),
                "history": same_bytes(d / "p1.csv", d / "p2.csv"),
                "state": same_checkpoints(d / "p1.npz", d / "p3.npz")}
        print(f"[protocol] configs/1.in in two pieces vs straight, bit for "
              f"bit: {same}")
        check(all(same.values()), "the resumed run differs")

        # configs/4.in --method mg with the monitors: PR 6's launches.
        with barred(sor_kernel, ("warm_sweeps_plain", "coarse_cycle_plain",
                                 "warm_sweeps_simple"), "the protocol's mg"):
            stats, launches = run_cli(
                "protocol mg", [c4, "--method", "mg",
                                *protocol_files("mg", frames=False, every=0),
                                "--stats"],
                JAX_MG_U_CENTER, JAX_MG_V_CENTER, JAX_MG_STATS)
        runs.append(launches)
        rows = history_rows(d / "mg.csv")
        print(f"[protocol] mg: {len(rows)} history rows, "
              f"{int(rows[:, 3].sum())} V-cycles; last row {rows[-1].tolist()}")
        check(len(rows) == JAX_MG_STATS["steps"] and int(rows[:, 3].sum())
              == JAX_MG_STATS["sor_iterations"], "the mg history differs")
        check(launches == paths["mg"], f"the launches {launches} differ "
              f"from the mg path's {paths['mg']}")

        # configs/4.in --max-steps 2 with frames: B4, PR 3's record.
        plain = ("inner_sweeps_plain", "inner_sweeps_tiled_plain",
                 "whole_grid_sweeps", "whole_grid_sweeps_simple")
        with barred(sor_kernel, plain, "the protocol's tiled path"):
            stats, launches = run_cli(
                "protocol tiled", [c4, "--max-steps", str(TILED_STEPS),
                                   "--output-dir", str(d / "tiled"),
                                   "--stats"],
                JAX_TILED_U_CENTER, JAX_TILED_V_CENTER, JAX_TILED_STATS,
                rc_want=3)
        runs.append(launches)
        check(launches == paths["tiled"], f"the launches {launches} differ "
              f"from the tiled path's {paths['tiled']}")
        check(len(list((d / "tiled").iterdir())) == 3 * TILED_STEPS,
              "the tiled run's frames")

        # The sharded backend on one rank: 1 step with a checkpoint, then
        # resumed for a second: PR 4's record, the straight run's bits.
        tag = "protocol sharded"
        stats, ls = run_cli(
            f"{tag} straight", [c4, *SHARDED_ARGV, "--checkpoint-every", "2",
                                "--checkpoint-path", str(d / "s2.npz")],
            JAX_TILED_U_CENTER, JAX_TILED_V_CENTER, JAX_TILED_STATS,
            rc_want=3)
        one = {"steps": 1, "sor_iterations": 20000, "sor_failures": 1}
        stats, la = run_cli(
            f"{tag} --max-steps 1", [c4, *SHARDED_1X1, "--max-steps", "1",
                                     "--checkpoint-every", "1",
                                     "--checkpoint-path", str(d / "s1.npz"),
                                     "--stats"], None, None, one, rc_want=3)
        stats, lb = run_cli(
            f"{tag} --resume", [c4, *SHARDED_1X1, "--max-steps", "1",
                                "--resume", str(d / "s1.npz"),
                                "--checkpoint-every", "1",
                                "--checkpoint-path", str(d / "s3.npz"),
                                "--stats"],
            JAX_TILED_U_CENTER, JAX_TILED_V_CENTER, one, rc_want=3)
        runs += [ls, la, lb]
        res = float(stats["last_res_norm"])
        check(abs(res - JAX_TILED_RES_NORM)
              <= RES_NORM_RTOL * JAX_TILED_RES_NORM,
              f"last_res_norm {res:.4e} differs from the JAX record")
        per_step = (paths["sharded"]["sor_ext"] - 1) // TILED_STEPS
        print(f"[protocol] sharded extended-block kernel calls {la['sor_ext']}"
              f" + {lb['sor_ext']} in the two pieces ({per_step} per step + "
              f"1 warm-up each), {ls['sor_ext']} straight")
        check(ls == paths["sharded"] and la == lb and
              la["sor_ext"] == per_step + 1, "the sharded launches differ")
        same = same_checkpoints(d / "s2.npz", d / "s3.npz")
        print(f"[protocol] sharded in two pieces vs straight, bit for bit: "
              f"{same}")
        check(same, "the resumed sharded run differs")

        # One 2048^2 frame: the fields of the state after 2 steps from the
        # card to the host, formatted and written, on the host's clock.
        state = load_checkpoint(str(d / "s2.npz"), prm4, "cuda")
        frame_s = []
        for k in range(2):
            t0 = time.perf_counter()
            nsio.output(state.u, state.v, state.p, float(state.t), prm4.a,
                        prm4.b, str(d / f"frame2048_{k}"), verbose=False)
            frame_s.append(time.perf_counter() - t0)
        mb = sum((d / f"frame2048_0_{s}.txt").stat().st_size
                 for s in "uvp") / 1e6
        print(f"[protocol] one 2048^2 frame ({mb:.1f} MB in 3 files): "
              f"{frame_s[0]:.6f} s, {frame_s[1]:.6f} s")
        # One checkpoint of it as the port writes it (np.savez) and as the
        # JAX package does (np.savez_compressed), fields from the card.
        for name, save in (("save_checkpoint", save_checkpoint),
                           ("np.savez_compressed", save_compressed)):
            t0 = time.perf_counter()
            save(str(d / f"{name}.npz"), state)
            print(f"[protocol] one 2048^2 checkpoint by {name}: "
                  f"{time.perf_counter() - t0:.6f} s, "
                  f"{(d / f'{name}.npz').stat().st_size / 1e6:.1f} MB")
    finally:
        shutil.rmtree(d, ignore_errors=True)

    for with_files, without in (
            ("protocol 1.in", "main"), ("protocol mg", "mg"),
            ("protocol tiled", "tiled"),
            ("protocol sharded straight", "sharded")):
        print(f"[protocol] solve seconds {SOLVE_SECONDS[with_files]:.6f} "
              f"({with_files}) beside {SOLVE_SECONDS[without]:.6f} "
              f"(the same run without its files, '{without}')")
    print(f"[protocol] solve seconds in two pieces: configs/1.in "
          f"{SOLVE_SECONDS['protocol 1.in --max-steps 2']:.6f} + "
          f"{SOLVE_SECONDS['protocol 1.in --resume']:.6f}; sharded "
          f"{SOLVE_SECONDS['protocol sharded --max-steps 1']:.6f} + "
          f"{SOLVE_SECONDS['protocol sharded --resume']:.6f}")
    return sum_launches(runs)


def device_kernels(prof):
    """The profile's device-side events (kernels and copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def device_us(evt) -> float:
    """A profile event's own device time, microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def phase_cycle(torch) -> None:
    """One V-cycle at configs/4.in's 2048^2 from delta = 0: CUDA-event time
    and kernel launches counted under the profiler, for the cycle as it
    runs (the smoother and the two transfer kernels on the four fine
    levels, the coarse cycle from 130^2), with the plain transfers instead
    (the cycle before the transfer kernels), and as it ran with the first
    smoother kernel on every level and no coarse cycle.  All give the same
    bits."""
    from torch.profiler import ProfilerActivity, profile

    from navierstokes_parallel_tpu_torch.ops import mg

    levels, depth = mg_levels()
    rng = np.random.default_rng(4)
    inner = rng.standard_normal((levels[0].shape[0] - 2,
                                 levels[0].shape[1] - 2))
    rhs = np.zeros(levels[0].shape, np.float32)
    rhs[1:-1, 1:-1] = inner - inner.mean()
    rhs = torch.from_numpy(rhs).cuda()
    p0 = torch.zeros_like(rhs)

    cases = [(f"coarse cycle from {levels[depth].shape}, transfer kernels",
              lambda: mg.v_cycle(p0, rhs, levels)),
             (f"coarse cycle from {levels[depth].shape}, plain transfers",
              lambda: mg._cycle(p0, rhs, levels, 0, 2, 2, 32, mg._smooth,
                                mg._down_plain, mg._up_plain, depth)),
             ("first smoother kernel on every level, no coarse cycle",
              lambda: cycle_on_simple(p0, rhs, levels))]
    # Every time first, in two turns, then the profiles: once the profiler
    # has run, every later launch costs the host more.
    turns = [[cuda_ms(torch, fn, 20) for _, fn in cases] for _ in range(2)]
    # A process's first profile can miss launches while the tracer starts:
    # one throw-away profile before the counted ones.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cases[0][1]()
        torch.cuda.synchronize()
    results = []
    for k, (what, fn) in enumerate(cases):
        ms = [turn[k] for turn in turns]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        n_launches = sum(e.count for e in kernels)
        check(n_launches > 0, "the profiler saw no device kernel")
        results.append(out)
        busy_ms = sum(device_us(e) for e in kernels) / 1e3
        print(f"[cycle] one V-cycle at {levels[0].shape}, {what}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms (CUDA events, mean of 20), "
              f"{n_launches} kernel launches, {busy_ms:.4f} ms of device "
              f"time under the profiler")
        for e in sorted(kernels, key=device_us, reverse=True)[:6]:
            print(f"[cycle]   {device_us(e) / 1e3:9.4f} ms  {e.count:6d} x"
                  f"  {e.key[:90]}")
    same = all(torch.equal(results[0], r) for r in results[1:])
    print(f"[cycle] the two cycles give the same bits: {same}")
    check(same, "the V-cycle differs between its routes")


def phase_cpu_gpu(torch) -> None:
    """A small converging cavity on the GPU and on the CPU through the
    port: equal iteration counts, fields within the contract."""
    from navierstokes_parallel_tpu_torch import solver
    from navierstokes_parallel_tpu_torch.config import Params

    prm = Params(problem=1, i_max=64, j_max=64, T=0.06, Re=100.0, tau=0.5,
                 omega=1.7, epsilon=1e-4, max_it=20000, dtype="float32")
    for method in ("pallas_sor", "mg"):
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            state, stats = solver.solve(prm, device=device,
                                        pressure_method=method)
            runs[device] = (state, stats)
            print(f"[cpu-gpu] {method} {device}: {stats} in "
                  f"{time.perf_counter() - t0:.3f} s")
        (sg, tg), (sc, tc) = runs["cuda"], runs["cpu"]
        check(tg.sor_failures == 0, f"the converging {method} cavity hit "
                                    f"max_it")
        check((tg.steps, tg.total_sor_iterations, tg.sor_failures)
              == (tc.steps, tc.total_sor_iterations, tc.sor_failures),
              f"GPU and CPU iteration counts differ ({method})")
        errs = {name: contract_err(getattr(sg, name).cpu().numpy(),
                                   getattr(sc, name).numpy())
                for name in ("u", "v", "p")}
        print(f"[cpu-gpu] {method} contract errors {errs} "
              f"(tol {CONTRACT:.0e})")
        check(max(errs.values()) <= CONTRACT,
              f"GPU and CPU fields differ ({method})")


def phase_profile(torch, trace_prefix) -> None:
    """One outer pass of the pressure solve at configs/4.in's 2048^2, for
    mg (f64 defect, one V-cycle, f64 defect and norm, one host sync), for
    the SOR route (the same around K = 64 sweeps of the tiled kernel) and
    for the sharded backend on one rank (the same around 8 chunks of a deep
    exchange and 8 sweeps of the extended-block kernel) and for its mg (one
    V-cycle of the sharded hierarchy), and one of the SOR
    route at configs/1.in's 256^2 (K = 64 sweeps of the whole-grid kernel),
    each through profile_pass."""
    from navierstokes_parallel_tpu_torch.config import Params
    from navierstokes_parallel_tpu_torch.ops import mg, sor
    from navierstokes_parallel_tpu_torch.ops.cuda import sor_kernel
    from navierstokes_parallel_tpu_torch.parallel import (deep_halo, sharded,
                                                          topology)
    from navierstokes_parallel_tpu_torch.utils import distributed

    rng = np.random.default_rng(3)

    def inputs(prm):
        """(p0, a zero-mean rhs) on the card."""
        rhs = np.zeros(prm.shape, np.float32)
        inner = rng.standard_normal((prm.i_max, prm.j_max))
        rhs[1:-1, 1:-1] = inner - inner.mean()
        return (torch.zeros(prm.shape, device="cuda"),
                torch.from_numpy(rhs).cuda())

    prm = Params.from_file(str(ROOT / "configs" / "4.in"))
    p0, rhs = inputs(prm)
    K = prm.sor_refine_every
    prm1 = Params.from_file(str(ROOT / "configs" / "1.in"))
    p1, rhs1 = inputs(prm1)
    li, lj = prm.i_max, prm.j_max
    one_pass = prm.replace(max_it=K)
    with distributed.process_group("cuda") as device:
        mesh = topology.make_grid_mesh(shape=(1, 1), device=device)
        deep = deep_halo.make_deep_inner(prm, li, lj, mesh)
        sharded_mg = mg.make_sharded_inner(prm, li, lj, mesh)
        # (name, grid, what the inner stage is, the inner stage, one outer
        # pass)
        cases = [("mg", "2048^2",
                  f"one V-cycle on {len(mg.build_levels(prm))} levels",
                  lambda: mg.inner_v_cycle(rhs, 1, prm),
                  lambda: sor.solve_pressure(p0, rhs, prm.replace(max_it=1),
                                             method="mg")),
                 ("pallas_sor", "2048^2",
                  f"{K} sweeps on the {sor_kernel.route(prm)} route",
                  lambda: sor_kernel.inner_sweeps(rhs, K, prm),
                  lambda: sor.solve_pressure(p0, rhs, one_pass,
                                             method="pallas_sor")),
                 ("sharded", "2048^2",
                  f"{K} sweeps of the deep-halo inner (1x1 mesh)",
                  lambda: deep(rhs, K),
                  lambda: sharded._sharded_pressure_solve(
                      p0, rhs, one_pass, "rb_sor", li, lj, None, mesh)),
                 ("sharded_mg", "2048^2",
                  f"one V-cycle of the sharded hierarchy on "
                  f"{len(mg.build_levels_sharded(prm, li, lj))} levels "
                  f"(1x1 mesh)",
                  lambda: sharded_mg(rhs, 1),
                  lambda: sharded._sharded_pressure_solve(
                      p0, rhs, prm.replace(max_it=1), "mg", li, lj, None,
                      mesh)),
                 ("pallas_sor_256", "256^2",
                  f"{prm1.sor_refine_every} sweeps on the "
                  f"{sor_kernel.route(prm1)} route",
                  lambda: sor_kernel.inner_sweeps(
                      rhs1, prm1.sor_refine_every, prm1),
                  lambda: sor.solve_pressure(
                      p1, rhs1, prm1.replace(max_it=prm1.sor_refine_every),
                      method="pallas_sor"))]
        for case in cases:
            profile_pass(torch, *case, trace_prefix)


def profile_pass(torch, method: str, grid: str, what: str, inner_stage,
                 outer_pass, trace_prefix) -> None:
    """CUDA event times of one outer pass and of its inner stage, then a
    torch.profiler split of one pass by device kernel."""
    from torch.profiler import ProfilerActivity, profile

    inner_ms = cuda_ms(torch, inner_stage, 20)
    pass_ms = cuda_ms(torch, outer_pass, 20)
    print(f"[profile] {method} at {grid}: {what} {inner_ms:.4f} ms, one "
          f"outer pass (inner + f64 outer) {pass_ms:.4f} ms (CUDA "
          f"events, mean of 20)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outer_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_prefix:
        path = f"{trace_prefix}.{method}.json"
        prof.export_chrome_trace(path)
        print(f"[profile] chrome trace: {path}")
    kernels = device_kernels(prof)
    busy_us = sum(device_us(e) for e in kernels)
    n_launches = sum(e.count for e in kernels)
    print(f"[profile] {method}: one outer pass under the profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms (share "
          f"{busy_us / 1e3 / wall_ms:.3f}) over {n_launches} kernel "
          f"launches")
    check(n_launches > 0, "the profiler saw no device kernel")
    for e in sorted(kernels, key=device_us, reverse=True)[:15]:
        print(f"[profile]   {device_us(e) / 1e3:9.4f} ms  {e.count:6d} x"
              f"  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one 2048^2 outer pass of mg, of "
                         "the SOR route, of the sharded backend and of its "
                         "mg, and one 256^2 outer pass of the SOR route")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="with --profile, write the chrome traces to "
                         "PREFIX.mg.json, PREFIX.pallas_sor.json, "
                         "PREFIX.sharded.json, PREFIX.sharded_mg.json and "
                         "PREFIX.pallas_sor_256.json")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available")
        return 1
    try:
        import navierstokes_parallel_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable here ({e}); run from the "
              f"root of a checkout")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_device(torch)
        timed_phase("build", phase_build)
        errs = timed_phase("compare", phase_compare, torch)
        timed_phase("decomposition", phase_decomposition, torch)
        times = timed_phase("time", phase_time, torch)
        paths = {"main": timed_phase("main path", phase_main_path),
                 "mg": timed_phase("mg path", phase_mg_path),
                 "tiled": timed_phase("tiled path", phase_tiled_path, torch),
                 "compressed": timed_phase("compressed path",
                                           phase_compressed_path, torch),
                 "sharded": timed_phase("sharded path", phase_sharded_path,
                                        torch),
                 "methods": timed_phase("other methods", phase_methods,
                                        torch)}
        paths["protocol"] = timed_phase("protocol", phase_protocol, torch,
                                        dict(paths))
        paths["channel"] = timed_phase("channel and taylor-green",
                                       phase_channel, torch)
        paths["obstacles"] = timed_phase("obstacles", phase_obstacles, torch)
        paths["sharded obstacles"] = timed_phase(
            "sharded obstacles", phase_sharded_obstacles, torch)
        paths["convection"] = timed_phase("convection", phase_convection,
                                          torch)
        paths["sharded convection"] = timed_phase(
            "sharded convection", phase_sharded_convection, torch)
        paths["free surface"] = timed_phase("free surface",
                                            phase_free_surface, torch)
        paths["particles"] = timed_phase("particles", phase_particles, torch)
        paths["gradients"] = timed_phase("gradients", phase_gradients, torch)
        paths["compensated"] = timed_phase("compensated", phase_compensated,
                                           torch)
        paths["ensemble"] = timed_phase("ensemble", phase_ensemble, torch)
        paths["mesh gradients"] = timed_phase(
            "mesh gradients", phase_mesh_gradients, torch)
        paths["mesh ensemble"] = timed_phase("mesh ensemble",
                                             phase_mesh_ensemble, torch)
        paths["gspmd"] = timed_phase("gspmd", phase_gspmd, torch)
        timed_phase("cpu-gpu", phase_cpu_gpu, torch)
        # After the paths: once the profiler has run in a process, every
        # later launch costs the host more.
        timed_phase("cycle", phase_cycle, torch)
        timed_phase("obstacle profile", phase_obstacle_profile, torch)
        timed_phase("ensemble profile", profile_ensemble_pass, torch)
        if args.profile:
            phase_profile(torch, args.trace)
    except PhaseFailed as e:
        print(f"FAIL: {e}")
        return 1

    launches = sum_launches(list(paths.values()))
    tpu = "navierstokes_parallel_tpu/ops/pallas/"
    sources = {"sor": ("sor_sweeps", "sor_tiled.cu",
                       f"{tpu}sor_kernel.py:67"),
               "sor_warm": ("sor_warm_sweeps", "sor.cu",
                            f"{tpu}sor_kernel.py:67 (warm_start=True)"),
               "mg_coarse_cycle": ("mg_coarse_cycle", "mg_cycle.cu",
                                   f"{tpu}sor_kernel.py:67 (warm_start=True,"
                                   f" the smoother of the V-cycle's coarse "
                                   f"levels)"),
               "mg_restrict": ("mg_restrict", "mg_cycle.cu",
                               "none (the V-cycle's residual and 2x2 "
                               "restriction, jnp in navierstokes_parallel_"
                               "tpu/ops/mg.py)"),
               "mg_prolong": ("mg_prolong", "mg_cycle.cu",
                              "none (the V-cycle's injection and add, jnp "
                              "in navierstokes_parallel_tpu/ops/mg.py)"),
               "momentum": ("momentum_rhs", "momentum.cu",
                            f"{tpu}momentum_kernel.py:36"),
               "sor_tiled": ("sor_tiled_sweeps", "sor_tiled.cu",
                             f"{tpu}sor_kernel.py:207 (and :293, "
                             f"double-buffered)"),
               "sor_compressed": ("sor_compressed_sweeps", "sor_compressed.cu",
                                  f"{tpu}sor_kernel.py:782"),
               "sor_ext": ("sor_ext_sweeps", "sor_ext.cu",
                           "navierstokes_parallel_tpu/parallel/"
                           "deep_halo.py:226"),
               "pressure_defect": ("pressure_defect", "defect.cu",
                                   "none (the f64 outer's pass after the "
                                   "inner, jnp in navierstokes_parallel_tpu/"
                                   "ops/sor.py::_solve_pressure_refined)")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"navierstokes_parallel_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": times[key][2],
                "bound_by": times[key][3], "library_ms": None}
               for key, (name, src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
