"""The port stands alone: nothing under ``src/repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the reference package, and importing
the port's CLI loads neither."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
            "wilson_dhat_fused.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_cli_loads_neither_jax_nor_repro():
    code = ("import repro_torch.launch.solve, repro_torch.launch.serve, "
            "sys; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
