"""TR4 — Krylov loop bodies stay placement- and conversion-free.

R4's slot.  The solvers encode once at solve entry, iterate entirely in
the backend's native vector domain on tensors already on their device,
and decode once at exit.  A ``to_domain`` / ``from_domain`` / planar
codec call or a ``.to(device)`` *syntactically inside* a Krylov loop of
``core/solver.py`` would add a per-iteration layout conversion or
device copy that no test tolerance would notice.

The port's loops are Python ``while`` statements (the reference's are
``lax.while_loop`` calls, whose matcher does not carry over): every
``while`` of the Krylov functions (:data:`KRYLOV_FUNCTIONS`) has its
test and body scanned, and with them every local ``def`` of the same
function that the loop calls by name (``chol_qr``, ``replace``),
transitively.  The refined solve's escalation loop and its outer
``for`` loop are no Krylov loops: their codec calls are the point of
refinement.

Flagged inside a loop: calls named in :data:`FORBIDDEN_CALLS`, and
placement calls — ``.cuda()``, ``.cpu()``, or ``.to(...)`` given a
device (a ``device=`` keyword, a string, ``torch.device(...)``, or a
name or attribute called ``device``/``dev``).  ``.to(x.dtype)`` is a
dtype cast and stays free (the batched scalars need it).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

RULE_ID = "TR4"
DESCRIPTION = ("no to_domain/from_domain/layout-codec calls or "
               ".to(device) placements inside the Krylov while loops of "
               "core/solver.py")

TARGET_PATH = "src/repro_torch/core/solver.py"

KRYLOV_FUNCTIONS = ("cg", "bicgstab", "cg_batched", "bicgstab_batched",
                    "blockcg_batched")

FORBIDDEN_CALLS = frozenset({
    "to_domain", "from_domain",
    "to_domain_batched", "from_domain_batched",
    "spinor_to_planar", "spinor_from_planar",
    "gauge_to_planar", "gauge_from_planar",
    "gauge_compress_planar", "gauge_expand_planar",
    "encode", "decode",
})

_PLACEMENT_METHODS = frozenset({"cuda", "cpu"})
_DEVICE_NAMES = frozenset({"device", "dev"})


def _call_name(node: ast.Call) -> str:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_device(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return True
    if isinstance(arg, ast.Name):
        return arg.id in _DEVICE_NAMES or arg.id.endswith("device")
    if isinstance(arg, ast.Attribute):
        return arg.attr in _DEVICE_NAMES
    if isinstance(arg, ast.Call):
        return _call_name(arg) == "device"
    return False


def _placement(node: ast.Call) -> str:
    """The placement a call makes (``".to(device)"``, ``".cuda()"``), or
    ``""``."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return ""
    if fn.attr in _PLACEMENT_METHODS:
        return f".{fn.attr}()"
    if fn.attr == "to" and (
            any(k.arg == "device" for k in node.keywords)
            or any(_is_device(a) for a in node.args)):
        return ".to(device)"
    return ""


def _local_defs(fn: ast.AST) -> Dict[str, ast.AST]:
    return {n.name: n for n in ast.walk(fn)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not fn}


def _loop_nodes(loop: ast.While, defs: Dict[str, ast.AST]) -> List[ast.AST]:
    """The loop's test and body, and every local def it calls by name,
    transitively."""
    roots: List[ast.AST] = [loop.test, *loop.body]
    seen: Set[str] = set()
    out: List[ast.AST] = []
    while roots:
        node = roots.pop()
        out.append(node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                name = sub.func.id
                if name in defs and name not in seen:
                    seen.add(name)
                    roots.append(defs[name])
    return out


def check(ctx) -> Iterable:
    if ctx.path != TARGET_PATH:
        return
    for fn in ast.walk(ctx.tree):
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in KRYLOV_FUNCTIONS):
            continue
        defs = _local_defs(fn)
        seen: Set[int] = set()      # a def inside the loop is met twice
        for loop in ast.walk(fn):
            if not isinstance(loop, ast.While):
                continue
            for node in _loop_nodes(loop, defs):
                for call in ast.walk(node):
                    if not isinstance(call, ast.Call) or id(call) in seen:
                        continue
                    seen.add(id(call))
                    name = _call_name(call)
                    what = (f"{name}()" if name in FORBIDDEN_CALLS
                            else _placement(call))
                    if what:
                        yield ctx.finding(
                            RULE_ID, call,
                            f"{what} inside the Krylov loop of {fn.name}() "
                            "— the iteration must stay in the native "
                            "domain on tensors already on their device "
                            "(encode/decode/placement happen once, at "
                            "the solve boundary)")
