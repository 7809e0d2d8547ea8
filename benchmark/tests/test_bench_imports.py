"""No file of the benchmark imports the JAX side; the references import
nothing of the program either. Top-level module names are compared whole,
so `equiadapt_tpu_torch` is not `equiadapt_tpu`."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "equiadapt_tpu"}
PROGRAM = {"equiadapt_tpu_torch"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    found = top_level_imports(path)
    assert not found & (JAX_SIDE | PROGRAM)
    # within the benchmark, a reference reads only other references
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark."):
            assert node.module.startswith("benchmark.reference"), node.module


def test_checker_compares_whole_names():
    assert "equiadapt_tpu_torch".split(".")[0] not in JAX_SIDE
    assert top_level_imports(BENCH / "harness" / "program.py") & PROGRAM
