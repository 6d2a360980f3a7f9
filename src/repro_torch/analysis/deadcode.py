"""Dead-code audit: which ``repro_torch`` modules the port's surface
reaches.

The port's copy of the reference's audit.  It walks the static import
graph from the *product surface* — the public :mod:`repro_torch.api`
package, the :mod:`repro_torch.launch.solve` and
:mod:`repro_torch.launch.serve` CLIs and this gate's runner — and
reports every ``repro_torch`` module the surface never reaches, so that
a module nothing runs is an explicit, reviewed list instead of silent
weight.

**Report-only by design**: the runner never fails the gate on this
report.

Import edges are collected syntactically (``import x`` / ``from x
import y``, absolute and relative, resolved against the importer's
package: the port imports itself relatively), so conditional and
function-local imports count as edges — this is a reachability audit,
not a tree shaker.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Set, Tuple

from .lint import module_of, resolve_import_from

#: Modules the port serves: the public API, the ``python -m``-able
#: CLIs (solver, serving daemon), and this gate's runner.
ROOTS = ("repro_torch.api", "repro_torch.launch.solve",
         "repro_torch.launch.serve", "repro_torch.analysis.__main__")

#: Unreached-on-purpose prefixes -> why.  These still appear in the
#: report, annotated, so the list stays reviewed rather than forgotten.
#: ``repro_torch.launch.train`` is deliberately not a root, as in the
#: reference's audit: it is a harvest target, so it and what only it
#: reaches (the language-model stack) show up here.
INTENTIONAL = {
    "repro_torch.convert": "the tests' bridge to the reference package's "
                           "arrays (numpy in, torch out)",
    "repro_torch.configs": "the ten architecture configs, loaded by name "
                           "through configs.get (importlib, no static "
                           "edge)",
    "repro_torch.models": "the language-model stack: run by "
                          "launch.train, traced by launch.dryrun",
    "repro_torch.optim": "AdamW of the language-model stack (launch.train, "
                         "launch.dryrun)",
    "repro_torch.data": "token pipelines of the language-model stack "
                        "(launch.train)",
    "repro_torch.launch.train": "harvest target, as in the reference's "
                                "audit: the LM training loop, kept for "
                                "multi-solve QCD campaigns",
    "repro_torch.launch.dryrun": "entry point (python -m), as launch.train: "
                                 "the multi-device dry run on a fake "
                                 "process group",
    "repro_torch.launch.roofline": "entry point (python -m), as "
                                   "launch.train: the H100 roofline over "
                                   "the dry run's records",
    "repro_torch.launch.mesh": "device meshes of launch.train and "
                               "launch.dryrun",
    "repro_torch.launch.sharding": "the sharding policy of launch.train and "
                                   "launch.dryrun",
    "repro_torch.launch.specs": "the dry run's fake inputs (launch.dryrun)",
}

PACKAGE = "repro_torch"


def collect_modules(root: str) -> Dict[str, str]:
    """name -> repo-relative path for every module under
    src/repro_torch."""
    modules: Dict[str, str] = {}
    base = os.path.join(root, "src", PACKAGE)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, fn), root)
            modules[module_of(rel.replace(os.sep, "/"))] = rel
    return modules


def import_edges(root: str, modules: Dict[str, str]
                 ) -> Dict[str, Set[str]]:
    """Static package-internal import graph over ``modules``."""
    edges: Dict[str, Set[str]] = {name: set() for name in modules}
    for name, rel in modules.items():
        is_pkg = rel.endswith("__init__.py")
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            continue
        targets: List[str] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                targets.extend(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                base = resolve_import_from(node, name, is_pkg)
                if base is None:
                    continue
                targets.append(base)
                targets.extend(f"{base}.{a.name}" for a in node.names
                               if a.name != "*")
        for tgt in targets:
            # Longest known prefix: "repro_torch.core.solver" matches
            # the module; "repro_torch.core" alone pulls in the package
            # __init__.
            while tgt and tgt not in modules:
                tgt = tgt.rpartition(".")[0]
            if tgt and tgt != name:
                edges[name].add(tgt)
    return edges


def reachable(edges: Dict[str, Set[str]],
              roots: Iterable[str]) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in edges]
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # Importing a.b implicitly executes a's __init__.
        parent = mod.rpartition(".")[0]
        if parent in edges and parent not in seen:
            stack.append(parent)
        stack.extend(edges[mod] - seen)
    return seen


def _annotation(name: str) -> Tuple[bool, str]:
    for prefix, why in INTENTIONAL.items():
        if name == prefix or name.startswith(prefix + "."):
            return True, why
    return False, ""


def dead_code_report(root: str) -> dict:
    """The audit as plain data (also what ``--json`` serializes)."""
    modules = collect_modules(root)
    edges = import_edges(root, modules)
    live = reachable(edges, ROOTS)
    dormant = []
    for name in sorted(set(modules) - live):
        intentional, why = _annotation(name)
        dormant.append({"module": name, "path": modules[name],
                        "intentional": intentional, "note": why})
    return {
        "roots": list(ROOTS),
        "modules_total": len(modules),
        "modules_live": len(live),
        "dormant": dormant,
    }


def format_dead_code(report: dict) -> str:
    lines = [
        f"dead-code audit (report-only): "
        f"{report['modules_live']}/{report['modules_total']} modules "
        f"reachable from {', '.join(report['roots'])}",
    ]
    intentional = [d for d in report["dormant"] if d["intentional"]]
    dormant = [d for d in report["dormant"] if not d["intentional"]]
    if dormant:
        lines.append("")
        lines.append("unreached modules (candidates for removal):")
        lines.extend(f"  {d['path']}  [{d['module']}]" for d in dormant)
    if intentional:
        lines.append("")
        lines.append("unreached on purpose (annotated):")
        lines.extend(f"  {d['path']}  [{d['module']}] — {d['note']}"
                     for d in intentional)
    if not report["dormant"]:
        lines.append("no unreached modules.")
    return "\n".join(lines)
