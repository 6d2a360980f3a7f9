"""Nothing the benchmark can load imports JAX or the JAX package, by the
whole top-level name (``repro_torch`` begins with ``repro`` and is
allowed); the reference imports nothing of the program."""
import ast
import sys

import pytest
from bench_testutil import ROOT, harness

FILES = sorted(p for p in (ROOT / "bench").rglob("*.py")
               if "tests" not in p.relative_to(ROOT / "bench").parts)


def _top_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_files_scanned():
    names = {p.name for p in FILES}
    assert {"run.py", "harness.py", "reference.py", "inputs.py",
            "tracing.py", "workmodel.py", "solve_ms.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_by_whole_name(path):
    found = set(_top_imports(path)) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("name", ["reference.py", "inputs.py",
                                  "workmodel.py", "tracing.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in set(_top_imports(ROOT / "bench" / name))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()
