"""Finding records, grouped reporting, and the grandfather baseline
(the port's copy of the reference gate's, same shape and file format).

A :class:`Finding` is one violation: rule id, repo-relative path, line,
message.  The baseline file is a JSON list of finding keys — findings
whose key appears there are *grandfathered* (reported, but they don't
fail the gate).  The key includes the line number on purpose: when code
moves, a grandfathered finding goes stale and resurfaces, which is the
gentle pressure to fix instead of accumulate.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence, Tuple

__all__ = ["Finding", "load_baseline", "write_baseline",
           "split_baselined", "format_findings"]


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source (or traced-entry-point) location."""

    rule: str        # "TR1".."TR4" (lint), "TJ1".."TJ6" (runtime checks)
    path: str        # repo-relative file, or a symbolic entry-point name
    line: int        # 1-based; 0 for non-source findings
    message: str

    def key(self) -> str:
        """Stable identity used by the baseline file."""
        return f"{self.rule}:{self.path}:{self.line}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def load_baseline(path) -> List[str]:
    """Read a baseline file -> list of finding keys.  Accepts both the
    key-list form and the full finding-object form (``--write-baseline``
    emits the latter, for humans)."""
    with open(path) as f:
        data = json.load(f)
    keys = []
    for entry in data:
        if isinstance(entry, str):
            keys.append(entry)
        else:
            keys.append(Finding(**entry).key())
    return keys


def write_baseline(path, findings: Iterable[Finding]) -> None:
    with open(path, "w") as f:
        json.dump([fi.to_json() for fi in sorted(findings)], f, indent=2)
        f.write("\n")


def split_baselined(findings: Sequence[Finding],
                    baseline_keys: Sequence[str]
                    ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """-> (fresh, grandfathered, stale_baseline_keys)."""
    keys = set(baseline_keys)
    fresh = [f for f in findings if f.key() not in keys]
    old = [f for f in findings if f.key() in keys]
    stale = sorted(keys - {f.key() for f in findings})
    return fresh, old, stale


def format_findings(findings: Sequence[Finding], *,
                    title: str = "findings") -> str:
    """Grouped, file:line-sorted report (rule groups in id order)."""
    if not findings:
        return f"{title}: none"
    lines = [f"{title}: {len(findings)}"]
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    for rule in sorted(by_rule):
        group = sorted(by_rule[rule])
        lines.append(f"  {rule} ({len(group)}):")
        for f in group:
            lines.append(f"    {f.render()}")
    return "\n".join(lines)
