"""TR3 — the removed ``solve_wilson_eo`` shim stays removed.

R3's slot.  ``solve_wilson_eo`` was the reference's deprecation shim
over the bind-once API, deleted at its removal horizon; the port never
had it.  The rule keeps it so: the name must not exist in the port's
files as a definition, an import, or a reference.  Callers bind once
with :class:`repro_torch.api.WilsonMatrix` and solve through
:class:`repro_torch.api.SolveSession`.

It is AST-based: docstrings and string constants do not trip it.
"""
from __future__ import annotations

import ast
from typing import Iterable

RULE_ID = "TR3"
DESCRIPTION = ("the removed solve_wilson_eo shim must not exist or be "
               "referenced in the port; everyone goes through "
               "repro_torch.api")

SHIM_NAME = "solve_wilson_eo"

_USE = ("bind once with repro_torch.api.WilsonMatrix and solve through "
        "SolveSession")


def check(ctx) -> Iterable:
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name == SHIM_NAME:
                yield ctx.finding(
                    RULE_ID, node,
                    f"definition of removed {SHIM_NAME!r}: {_USE}")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                if SHIM_NAME in (a.name.split(".")[-1], a.asname):
                    yield ctx.finding(
                        RULE_ID, node,
                        f"import of removed {SHIM_NAME!r}: {_USE}")
        elif isinstance(node, ast.Attribute) and node.attr == SHIM_NAME:
            yield ctx.finding(
                RULE_ID, node,
                f"use of removed {SHIM_NAME!r}: {_USE}")
        elif isinstance(node, ast.Name) and node.id == SHIM_NAME:
            yield ctx.finding(
                RULE_ID, node,
                f"reference to removed {SHIM_NAME!r}: use repro_torch.api")
