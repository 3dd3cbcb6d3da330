"""The masked pressure solvers of obstacle domains (ops/masked.py) and
their dispatch in ops/sor.py vs the JAX package, on the CPU.

  * The weights and the multigrid levels are the JAX module's numpy code,
    copied: equal bit for bit (``np.array_equal``), staircase and cut-cell.
  * One masked residual, one masked red-black iteration and one masked
    V-cycle on seeded inputs within OP_TOL of max|x| (XLA's CPU contracts
    the neighbour sums into FMAs).
  * ``solve_pressure_masked`` by rb_sor and mg, problems 1 and 3: equal
    iterations and convergence, p within the 1e-4 contract.
  * The JAX package's domain-equivalence test: a cavity whose lower half
    is one obstacle gives the half-height cavity.
  * The masked solve runs ops/sor.py's one f64 outer: a pass reads one
    flag and stays within two device ops of the masked solve's own loop
    before the two outers were one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from navierstokes_parallel_tpu.config import Params as JaxParams
from navierstokes_parallel_tpu.models import karman as jkarman
from navierstokes_parallel_tpu.models import step as jstep
from navierstokes_parallel_tpu.ops import masked as jmasked
from navierstokes_parallel_tpu.ops import sor as jsor
from navierstokes_parallel_tpu_torch import solver
from navierstokes_parallel_tpu_torch.config import Params
from navierstokes_parallel_tpu_torch.ops import masked, obstacles, sor
from navierstokes_parallel_tpu_torch.utils import timing

from conftest import assert_close_reference_contract

# One operator application or sweep against XLA's (FMA contraction),
# relative to max|x| of the result.
OP_TOL = 1e-6
# One V-cycle: 36 red-black iterations of such differences.
CYCLE_TOL = 2e-5


def _cases():
    """name -> (port Params, JAX Params): staircase and cut-cell."""
    out = {}
    for name, (ref, kw) in {
            "step": (jstep.backward_facing_step, dict(nx=32, ny=16)),
            "square": (jkarman.square_cylinder, dict(n_per_d=4)),
            "schafer_turek 10": (jkarman.schafer_turek, dict(n_per_d=10)),
            "schafer_turek 20": (jkarman.schafer_turek, dict(n_per_d=20)),
            "cavity": (JaxParams, dict(i_max=32, j_max=32,
                                       obstacles=((9, 16, 5, 20),)))}.items():
        jprm = ref(**kw)
        out[name] = (Params.from_mapping(dataclasses.asdict(jprm)), jprm)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_weights_and_levels_bit_for_bit(name):
    prm, jprm = CASES[name]
    want, got = jmasked._weights(jprm), masked._weights(prm)
    for field in want._fields:
        assert np.array_equal(getattr(got, field), getattr(want, field))
    levels, jlevels = masked._masked_levels(prm), jmasked._masked_levels(jprm)
    assert len(levels) == len(jlevels)
    for lvl, jlvl in zip(levels, jlevels):
        assert lvl.shape == jlvl.shape
        for arr, jarr in ((lvl.red, jlvl.red), (lvl.black, jlvl.black)):
            assert np.array_equal(arr, jarr)
        for field in jlvl.weights._fields:
            assert np.array_equal(getattr(lvl.weights, field),
                                  getattr(jlvl.weights, field))


def test_level_counts():
    """The levels stop at the first odd dimension or at 8 cells: the
    Schäfer-Turek 220 x 41 grid has one, 440 x 82 two."""
    assert len(masked._masked_levels(CASES["schafer_turek 10"][0])) == 1
    assert len(masked._masked_levels(CASES["schafer_turek 20"][0])) == 2


def _inputs(prm, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(prm.shape).astype(np.float32)
    rhs = rng.standard_normal((prm.i_max, prm.j_max)).astype(np.float32)
    return p, rhs


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", ["step", "schafer_turek 10"])
def test_residual_and_iteration(name):
    prm, jprm = CASES[name]
    p, rhs = _inputs(prm, seed=1)
    w = masked.device_weights(prm, torch.float32, torch.device("cpu"))
    jw = jmasked._weights(jprm)
    _close(masked.masked_residual(torch.from_numpy(p), torch.from_numpy(rhs),
                                  w),
           jmasked.masked_residual(jnp.asarray(p), jnp.asarray(rhs), jw),
           OP_TOL)
    red, black = jmasked._color_masks(jprm, jw)
    omega = np.float32(prm.omega)
    got = masked.masked_rb_iteration(torch.from_numpy(p.copy()),
                                     torch.from_numpy(rhs),
                                     torch.tensor(omega), w)
    want = jmasked.masked_rb_iteration(jnp.asarray(p), jnp.asarray(rhs),
                                       jnp.asarray(omega), jw, red, black)
    _close(got, want, OP_TOL)


@pytest.mark.parametrize("name", ["step", "schafer_turek 20"])
def test_v_cycle(name):
    prm, jprm = CASES[name]
    _, rhs = _inputs(prm, seed=2)
    levels = masked.device_levels(prm, torch.float32, torch.device("cpu"))
    got = masked._v_cycle_masked(torch.zeros(prm.shape), torch.from_numpy(rhs),
                                 levels)
    want = jmasked._v_cycle_masked(jnp.zeros(jprm.shape, jnp.float32),
                                   jnp.asarray(rhs),
                                   jmasked._masked_levels(jprm))
    _close(got, want, CYCLE_TOL)


def _rhs(prm, seed, fluid_mean_zero):
    """A seeded rhs, zero on solid cells, of zero mean over the fluid
    cells for a cavity (problem 1 has no deflation)."""
    rng = np.random.default_rng(seed)
    fluid = masked._weights(prm).fluid
    inner = np.where(fluid, rng.standard_normal(fluid.shape), 0.0)
    if fluid_mean_zero:
        inner = np.where(fluid, inner - inner[fluid].mean(), 0.0)
    rhs = np.zeros(prm.shape, np.float32)
    rhs[1:-1, 1:-1] = inner
    return rhs


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
@pytest.mark.parametrize("name", ["step", "square", "cavity"])
def test_solve_pressure_masked(name, method):
    """Through sor.solve_pressure (problem 3 deflates its defects over the
    fluid cells): equal iterations and convergence, p within the
    contract."""
    prm, jprm = CASES[name]
    rhs = _rhs(prm, seed=3, fluid_mean_zero=prm.problem != 3)
    p0 = np.random.default_rng(4).standard_normal(prm.shape).astype(
        np.float32) * 0.1
    got = sor.solve_pressure(torch.from_numpy(p0), torch.from_numpy(rhs), prm,
                             method=method)
    want = jsor.solve_pressure(jnp.asarray(p0), jnp.asarray(rhs), jprm,
                               method=method)
    assert got.iterations == int(want.iterations) > 0
    assert got.converged == bool(want.converged)
    assert_close_reference_contract(got.p.numpy(), np.asarray(want.p))


def test_dispatch_and_refusals():
    """Obstacles default to rb_sor on every device; every other method is
    JAX's ValueError, and so are shard hooks."""
    prm, jprm = CASES["cavity"]
    z = torch.zeros(prm.shape)
    assert sor.default_method(prm, "cpu") == sor.default_method(
        prm, "cuda") == jsor.default_method(jprm) == "rb_sor"
    for method in ("pallas_sor", "jacobi", "cg", "fft"):
        with pytest.raises(ValueError) as got:
            sor.solve_pressure(z, z, prm, method=method)
        with pytest.raises(ValueError) as want:
            jsor.solve_pressure(jnp.zeros(jprm.shape), jnp.zeros(jprm.shape),
                                jprm, method=method)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="single-chip"):
        sor.solve_pressure(z, z, prm, ghost_fn=sor.ghost_fill)


# The JAX package's tests/test_obstacles.py::test_half_blocked_cavity_...
_COMMON = dict(Re=100.0, T=0.1, tau=0.5, omega=1.7, epsilon=1e-8,
               max_it=20000, dtype="float64")


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_half_blocked_cavity_equals_half_cavity(method):
    """A cavity whose bottom half is one obstacle reproduces the
    half-height cavity through the masked path (JAX measured ~1e-11 in
    f64 and asserts 1e-9)."""
    n = 32
    full = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0,
                  obstacles=((1, n, 1, n // 2),), **_COMMON)
    half = Params(problem=1, i_max=n, j_max=n // 2, a=1.0, b=0.5, **_COMMON)
    stf, sf = solver.solve(full, device="cpu", pressure_method=method)
    sth, sh = solver.solve(half, device="cpu", pressure_method="rb_sor")
    assert sf.sor_failures == 0 and sh.sor_failures == 0
    assert sf.steps == sh.steps
    uf = stf.u.numpy()[:, n // 2 + 1: n + 1]
    uh = sth.u.numpy()[:, 1: n // 2 + 1]
    vf = stf.v.numpy()[:, n // 2 + 1: n + 1]
    vh = sth.v.numpy()[:, 1: n // 2 + 1]
    np.testing.assert_allclose(uf, uh, atol=1e-9)
    np.testing.assert_allclose(vf, vh, atol=1e-9)


# A 40 x 16 channel (problem 3: the fluid-mean deflation) with a 4 x 4
# block, the tracing tests' masked case.
PASS_CASE = Params(problem=3, i_max=40, j_max=16, a=5.0, b=2.0, Re=100.0,
                   tau=0.5, sor_refine_every=16, obstacles=((8, 11, 7, 10),))
# Device ops (every ATen op but views) of one pass of the masked solve's
# own loop, which it had before it ran ops/sor.py's outer, measured on
# that code at PASS_CASE: K = 16 masked sweeps, or one masked V-cycle on
# its two levels, then the f64 update, defect, deflation and norm and one
# host read of the norm.
LOOP_OPS_PER_PASS = {"rb_sor": 445, "mg": 995}


class _DeviceOps(TorchDispatchMode):
    """Counts the ATen ops dispatched under it, views left out (they
    launch nothing on a device)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _pass_ops(method, passes):
    """(device ops, flag reads) of one CPU masked solve of `passes` passes
    into max_it from a seeded rhs."""
    K = {"rb_sor": PASS_CASE.sor_refine_every,
         "mg": PASS_CASE.mg_cycles_per_outer}[method]
    prm = PASS_CASE.replace(max_it=passes * K, epsilon=1e-14)
    g = torch.Generator().manual_seed(5)
    rhs = torch.zeros(prm.shape)
    rhs[1:-1, 1:-1] = torch.randn((prm.i_max, prm.j_max), generator=g)
    rhs = obstacles.mask_rhs(rhs, prm)
    p = torch.zeros(prm.shape)
    masked.solve_pressure_masked(p, rhs, prm, method)  # the caches
    start = timing.counts().get("sync.pressure_flag", 0)
    with _DeviceOps() as ops:
        got = masked.solve_pressure_masked(p, rhs, prm, method)
    assert got.iterations == passes * K and not got.converged
    return ops.n, timing.counts().get("sync.pressure_flag", 0) - start


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_masked_pass_ops(method):
    """A pass of the masked solve, the difference of a two- and a
    one-pass solve (the last pass reads no flag: max_it ends the loop):
    one flag read, and device ops at most two above the masked loop's own
    (the rhs of the inner now goes through the outer's padded f32 array)."""
    (one, one_reads), (two, two_reads) = (_pass_ops(method, n)
                                          for n in (1, 2))
    assert (one_reads, two_reads) == (0, 1)
    assert 0 < two - one <= LOOP_OPS_PER_PASS[method] + 2
