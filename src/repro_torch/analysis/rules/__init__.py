"""Per-rule lint modules of the port's gate.

Each rule module exposes ``RULE_ID``, ``DESCRIPTION`` and
``check(ctx) -> Iterable[Finding | None]`` (``None`` entries are
waived findings and are dropped by the engine).  The modules keep the
reference gate's names; each rule takes its counterpart's slot under a
``T`` id.  The runner, the tests and ``--list-rules`` all derive from
:data:`ALL_RULES`.
"""
from __future__ import annotations

from . import r1_compat, r2_registry, r3_api, r4_loop_hygiene

ALL_RULES = (r1_compat, r2_registry, r3_api, r4_loop_hygiene)

__all__ = ["ALL_RULES", "r1_compat", "r2_registry", "r3_api",
           "r4_loop_hygiene"]
