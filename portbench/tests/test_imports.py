"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` is not ``repro``); the reference
imports nothing of the program; nothing reads ``benchmarks/``."""
import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


def test_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "weights.py", "check.py", "roofline.py",
                                  "traffic.py", "trace.py", "window.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports(PKG / name)


def test_only_the_adapter_imports_the_program():
    users = [p.name for p in SOURCES if "repro_torch" in top_level_imports(p)]
    assert users == ["program.py"]
