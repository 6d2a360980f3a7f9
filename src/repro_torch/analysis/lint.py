"""AST convention linter of the port: engine + shared per-file context.

The engine walks the port's Python files, parses each once, builds a
:class:`LintContext` (import-alias map, inline waivers, repo-relative
path), and hands it to each rule module under
:mod:`repro_torch.analysis.rules`.  Rules are pure syntax: no scanned
code is imported.

The port imports itself relatively (``from ..kernels import ops``), so
the alias map resolves relative imports against the file's package
(``src/repro_torch/api/x.py`` is module ``repro_torch.api.x``); a rule
sees ``repro_torch.kernels.ops`` either way.

Inline waivers: a line containing ``# repro-torch-lint: allow[TR2]
<reason>`` waives that rule on that line and the next (so the
annotation can sit on its own line above a long statement).  The
reference gate's marker (``repro-lint``) is not this one, so neither
gate reads the other's waivers.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from .findings import Finding

__all__ = ["LintContext", "run_lint", "iter_source_files", "ALL_RULES",
           "module_of", "resolve_import_from", "SCAN_GLOBS"]

# The port's files, as globs relative to the repo root.
SCAN_GLOBS = ("src/repro_torch/**/*.py", "tests/test_torch_*.py",
              "tests/torch_*.py", "examples/torch_*.py", "chip_smoke.py")

SKIP_DIR_NAMES = {"__pycache__", ".git"}

_ALLOW_RE = re.compile(
    r"#\s*repro-torch-lint:\s*allow\[([A-Za-z0-9,\s]+)\]")


def module_of(path: str) -> Optional[str]:
    """The dotted module of a repo-relative ``src/...`` path
    (``src/a/b.py`` -> ``a.b``, ``src/a/__init__.py`` -> ``a``); None
    outside ``src/``."""
    parts = path.split("/")
    if len(parts) < 2 or parts[0] != "src" or not parts[-1].endswith(".py"):
        return None
    parts = parts[1:]
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


def resolve_import_from(node: ast.ImportFrom, module: Optional[str],
                        is_pkg: bool) -> Optional[str]:
    """The absolute module an ``ImportFrom`` names: itself when
    absolute, resolved against the importer's package when relative;
    None where the importer's package is unknown or the import climbs
    above it."""
    if node.level == 0:
        return node.module or ""
    if module is None:
        return None
    parts = module.split(".")
    if not is_pkg:
        parts = parts[:-1]
    if node.level > 1:
        if node.level - 1 >= len(parts):
            return None
        parts = parts[:-(node.level - 1)]
    return ".".join(parts + ([node.module] if node.module else []))


class LintContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, source: str,
                 tree: Optional[ast.AST] = None):
        self.path = path              # repo-relative, posix separators
        self.source = source
        self.tree = tree if tree is not None else ast.parse(source)
        self.lines = source.splitlines()
        self.module = module_of(path)
        self.is_pkg = path.endswith("__init__.py")
        self.aliases = _collect_aliases(self.tree, self.module, self.is_pkg)
        self.waivers = _collect_waivers(self.lines)

    # --- imports --------------------------------------------------------

    def imported(self, node: ast.AST):
        """``(module, name)`` pairs an import statement binds, absolute:
        ``import a.b`` gives ``("a.b", None)``, ``from a import b``
        ``("a", "b")``; a relative import resolved against this file's
        package (skipped where it cannot be)."""
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None
        elif isinstance(node, ast.ImportFrom):
            base = resolve_import_from(node, self.module, self.is_pkg)
            if base is None:
                return
            for a in node.names:
                yield base, (None if a.name == "*" else a.name)

    # --- alias resolution -----------------------------------------------

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a dotted path through this
        file's import aliases (``ops.hop_block`` ->
        ``repro_torch.kernels.ops.hop_block``).  Returns None for chains
        not rooted in an imported name."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        return ".".join([base] + list(reversed(parts)))

    # --- waivers --------------------------------------------------------

    def waived(self, rule: str, line: int) -> bool:
        return rule in self.waivers.get(line, ())

    def finding(self, rule: str, node: ast.AST, message: str
                ) -> Optional[Finding]:
        """Build a finding unless an inline waiver covers it."""
        line = getattr(node, "lineno", 0)
        if self.waived(rule, line):
            return None
        return Finding(rule=rule, path=self.path, line=line,
                       message=message)


def _collect_aliases(tree: ast.AST, module: Optional[str] = None,
                     is_pkg: bool = False) -> Dict[str, str]:
    """Local name -> dotted module/object path, from top-level AND
    function-local imports, absolute and relative (a relative import of
    a file outside ``src/`` binds nothing)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = resolve_import_from(node, module, is_pkg)
            if mod is None:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = (f"{mod}.{a.name}" if mod
                                               else a.name)
    return aliases


def _collect_waivers(lines: Sequence[str]) -> Dict[int, tuple]:
    """Line number -> tuple of waived rule ids (the annotated line and
    the line below it, so the comment can precede the statement)."""
    waivers: Dict[int, tuple] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        for line in (i, i + 1):
            waivers[line] = tuple(set(waivers.get(line, ()) + rules))
    return waivers


def iter_source_files(root) -> Iterable[Path]:
    """The port's files under ``root`` (:data:`SCAN_GLOBS`), sorted."""
    root = Path(root)
    seen = set()
    for pattern in SCAN_GLOBS:
        for path in sorted(root.glob(pattern)):
            if (path in seen or not path.is_file()
                    or any(part in SKIP_DIR_NAMES for part in path.parts)):
                continue
            seen.add(path)
            yield path


def _load_rules():
    from .rules import ALL_RULES as rules
    return rules


def run_lint(root, files: Optional[Sequence] = None,
             rules=None) -> List[Finding]:
    """Lint the port (or an explicit file list) with every rule.

    ``files`` entries may be absolute or root-relative paths; findings
    always report root-relative posix paths.
    """
    root = Path(root)
    rules = list(rules) if rules is not None else _load_rules()
    if files is None:
        paths = list(iter_source_files(root))
    else:
        paths = [Path(f) if Path(f).is_absolute() else root / f
                 for f in files]
    findings: List[Finding] = []
    for path in paths:
        try:
            source = path.read_text()
            rel = path.relative_to(root).as_posix() \
                if path.is_relative_to(root) else path.as_posix()
            ctx = LintContext(rel, source)
        except SyntaxError as e:
            findings.append(Finding(
                rule="PARSE", path=str(path), line=e.lineno or 0,
                message=f"syntax error: {e.msg}"))
            continue
        for rule in rules:
            for f in rule.check(ctx):
                if f is not None:
                    findings.append(f)
    return sorted(findings)


# Re-exported for the runner's --list-rules output.
def ALL_RULES():
    return _load_rules()
