"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
import textwrap
import types

import pytest

from nsbench import harness

from conftest import BENCH_DIR, CHECKOUT

PROGRAM = "navierstokes_parallel_tpu_torch"


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(subdir=""):
    return [p for p in (BENCH_DIR / subdir).rglob("*.py")
            if "tests" not in p.relative_to(BENCH_DIR).parts]


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in sources("reference"):
        found = imported_top_levels(path)
        assert not found & {PROGRAM, *harness.FORBIDDEN}, (path, found)
        assert found <= {"__future__", "math", "typing", "torch"}, found


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_top_levels(path) & set(harness.FORBIDDEN), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, PROGRAM + "_shadow",
                        types.ModuleType(PROGRAM + "_shadow"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "navierstokes_parallel_tpu.solver",
                        types.ModuleType("navierstokes_parallel_tpu.solver"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert set(harness.forbidden_modules()) - before == {
        "navierstokes_parallel_tpu", "flax"}


def test_a_run_refuses_to_report_after_jax_was_loaded(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.ForbiddenImport, match="jax"):
        harness.run_cell("tiny.fft", 1, 0.05, False, "cpu", tiny)


def test_a_run_loads_no_jax(tiny):
    """A whole traced run in a fresh process that blocks every JAX
    import, then the harness's own check."""
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {harness.FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        from nsbench import harness
        from nsbench.registry import Registry
        result, _ = harness.run_cell("tiny.mg", 4, 0.05, True, "cpu",
                                     Registry({str(tiny.root)!r}))
        assert harness.forbidden_modules() == []
        print("ok", sorted(result))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("ok")
