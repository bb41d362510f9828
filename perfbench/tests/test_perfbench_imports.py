"""What the benchmark may load: never JAX or the JAX package (whose name
``repro`` begins the port's, ``repro_torch``: top-level names are compared
whole), never the JAX package's benchmarks, and for the reference nothing
of the program."""
import ast
import sys

import pytest

from perfbench.harness import result
from perfbench.tests.cells import BENCH, ROOT

FILES = sorted(BENCH.rglob("*.py"))
#: The JAX package's benchmark folder, spelt so that this file does not
#: name it.
JAX_BENCH = "bench" + "marks"
REFERENCE = sorted((BENCH / "reference").glob("*.py"))


def imported(path):
    """Top-level names of every module ``path`` imports, also through
    ``importlib.import_module`` or ``__import__`` with a literal name."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro",
                                 JAX_BENCH}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_reads_the_jax_benchmarks(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if JAX_BENCH + "/" in s
                or s == JAX_BENCH]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_loaded_modules_are_compared_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxonomy", sys)
    assert result.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert result.forbidden_modules() == ["jax", "repro.core"]
