"""Nothing the benchmark runs imports JAX or the JAX package, and its
plain reference imports nothing of the program either: top-level module
names compared whole (helios_tpu_torch is not helios_tpu)."""

import ast

from benchmark.core import cell as cell_mod

BENCH = cell_mod.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "helios_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_is_plain():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert not top_level_imports(path) & (FORBIDDEN
                                              | {"helios_tpu_torch"}), path
        assert top_level_imports(path) <= {"__future__", "math", "numpy",
                                           "torch"}, path


def test_a_run_loads_no_jax(tiny_runs):
    from benchmark import run
    assert tiny_runs["flagship.single"]["correct"]
    assert run.forbidden_modules() == []
