"""The port must run without JAX: the machine with the GPU has none.

A subprocess blocks every ``jax`` import with a ``sys.meta_path`` finder
that raises, imports every module of the port and runs one CPU time step.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is blocked: {name}")
            return None

    sys.meta_path.insert(0, BlockJax())
    import navierstokes_parallel_tpu_torch as port
    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        if not mod.name.endswith("__main__"):  # that one runs the CLI
            importlib.import_module(mod.name)
    from navierstokes_parallel_tpu_torch import Params, allocate_state, step
    prm = Params(i_max=8, j_max=8, T=0.01, Re=100.0, tau=0.5, max_it=200)
    state, diag = step(allocate_state(prm, "cpu"), prm)
    assert state.n == 1 and diag.sor_iterations > 0, diag
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("OK", diag.sor_iterations)
""")


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_no_jax_import_in_sources():
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    pkg = os.path.join(ROOT, "navierstokes_parallel_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    banned = ("import jax", "from jax", "import navierstokes_parallel_tpu\n",
              "from navierstokes_parallel_tpu ",
              "from navierstokes_parallel_tpu.")
    offenders = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                if line.strip().startswith(banned) or \
                        line.strip() + "\n" in banned:
                    offenders.append(f"{path}: {line.strip()}")
    assert len(paths) > 10 and not offenders, offenders
