"""TR1 — the port stands alone: no JAX, no reference package.

R1's slot.  The reference's R1 keeps JAX's version-drifted APIs behind
its ``compat`` module; the port's counterpart keeps JAX out entirely:
nothing under ``src/repro_torch/`` and nothing in ``chip_smoke.py``
imports ``jax``, ``jaxlib`` or ``repro`` (the package this one ports),
so that the port runs where neither is installed.  Relative imports
resolve inside the port and never trip the rule.  The port's tests are
out of scope: they import the reference on purpose, to hold the port
against it.
"""
from __future__ import annotations

import ast
from typing import Iterable

RULE_ID = "TR1"
DESCRIPTION = ("the port stands alone: no jax, jaxlib or repro import "
               "under src/repro_torch/ or in chip_smoke.py")

SCOPE = ("src/repro_torch/", "chip_smoke.py")

FORBIDDEN_ROOTS = frozenset({"jax", "jaxlib", "repro"})


def _in_scope(path: str) -> bool:
    return path == SCOPE[1] or path.startswith(SCOPE[0])


def check(ctx) -> Iterable:
    if not _in_scope(ctx.path):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        for mod, _ in ctx.imported(node):
            root = mod.split(".")[0]
            if root in FORBIDDEN_ROOTS:
                yield ctx.finding(
                    RULE_ID, node,
                    f"import of {mod!r}: the port imports neither JAX nor "
                    "the reference package (keep a copy of what it needs)")
                break
