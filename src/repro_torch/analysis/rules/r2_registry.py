"""TR2 — operator implementations are reached through the registry.

R2's slot.  Inside ``src/repro_torch``, Wilson-operator implementations
(the complex even-odd reference, the planar CUDA kernels and their
plain versions, the distributed operator) register under
:func:`repro_torch.backends.register_backend` and are bound by name;
hand-wiring their callables across module boundaries bypasses the
bind-once contract the solvers and the serving pool depend on.

Scope: ``src/repro_torch`` modules *outside* the implementation zone
(the ``kernels``/``backends``/``distributed``/``core`` packages, which
ARE the implementations, and this ``analysis`` package, whose job is
to inspect them).  Tests and ``chip_smoke.py`` are out of scope:
measuring a kernel in isolation is their job.

Flagged: importing an operator entry-point module
(``repro_torch.kernels.ops`` / ``wilson_stencil`` / ``ref``), importing
an operator function by name, or calling one through a module alias
(``evenodd.apply_dhat(...)``).  Imports resolve relative to the file's
package, so ``from ..kernels import ops`` in ``api/`` is the same
finding as ``from repro_torch.kernels import ops``.  Layout codecs and
the kernel counters (:mod:`repro_torch.kernels.counters`) are not
operators and stay free.
"""
from __future__ import annotations

import ast
from typing import Iterable

RULE_ID = "TR2"
DESCRIPTION = ("operator implementations only via the backend registry "
               "(register_backend/make_wilson_ops), no cross-boundary "
               "hand-wiring inside src/repro_torch (relative imports "
               "resolved)")

SCOPE_PREFIX = "src/repro_torch/"
IMPL_ZONE = ("src/repro_torch/kernels/", "src/repro_torch/backends/",
             "src/repro_torch/distributed/", "src/repro_torch/core/",
             "src/repro_torch/analysis/")

# Operator entry-point modules: importing these at all (from outside the
# implementation zone) is hand-wiring.
IMPL_MODULES = frozenset({
    "repro_torch.kernels.ops",
    "repro_torch.kernels.wilson_stencil",
    "repro_torch.kernels.ref",
})

# Modules whose *operator functions* are flagged but whose codec/helper
# functions (pack, unpack, pack_gauge, QCDPartition, ...) are fine.
MIXED_MODULES = frozenset({
    "repro_torch.core.evenodd",
    "repro_torch.core.wilson",
    "repro_torch.distributed.qcd",
}) | IMPL_MODULES

# The reference's operator names that the port defines.
OPERATOR_NAMES = frozenset({
    "apply_dhat", "apply_dhat_dagger", "hop_oe", "hop_eo",
    "apply_wilson", "apply_dhat_planar", "apply_dhat_planar_fused",
    "apply_dhat_planar_stream", "apply_dhat_planar_any",
    "dhat_planar_fused", "dhat_planar_fused_stream",
    "hop_block", "hop_block_planar", "make_hop_fn", "make_dhat_fn",
})


def _in_scope(path: str) -> bool:
    if not path.startswith(SCOPE_PREFIX):
        return False
    return not any(path.startswith(zone) for zone in IMPL_ZONE)


def check(ctx) -> Iterable:
    if not _in_scope(ctx.path):
        return

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in IMPL_MODULES:
                    yield ctx.finding(
                        RULE_ID, node,
                        f"import of operator module {a.name!r} outside "
                        "the implementation packages: bind operators by "
                        "name via repro_torch.backends (or repro_torch."
                        "api)")
        elif isinstance(node, ast.ImportFrom):
            for mod, name in ctx.imported(node):
                full = f"{mod}.{name}"
                if full in IMPL_MODULES or (
                        mod in MIXED_MODULES and name in OPERATOR_NAMES):
                    yield ctx.finding(
                        RULE_ID, node,
                        f"hand-wired operator import {full!r}: bind "
                        "operators by name via repro_torch.backends (or "
                        "repro_torch.api)")
        elif isinstance(node, ast.Attribute):
            if node.attr not in OPERATOR_NAMES:
                continue
            base = ctx.resolve(node.value) if isinstance(
                node.value, (ast.Name, ast.Attribute)) else None
            if base in MIXED_MODULES:
                yield ctx.finding(
                    RULE_ID, node,
                    f"hand-wired operator call "
                    f"{base}.{node.attr}: operators cross module "
                    "boundaries only through the backend registry")
