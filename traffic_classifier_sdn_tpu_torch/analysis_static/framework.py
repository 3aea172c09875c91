"""Rule framework: findings, suppressions, and the lint runner.

Kept deliberately dependency-free (``ast`` + ``tokenize`` only) so the
linter can run in any environment the package itself runs in — including
the tier-1 self-enforcement test — with no extra tooling installed.

Suppression contract
--------------------
A finding on line N is suppressed by a comment ON THAT LINE::

    lib.fn()  # graftlint: disable=ctypes-abi -- prototype set in _load

The ``-- reason`` clause is mandatory: a disable comment without a
non-empty reason raises a ``bad-suppression`` finding at the comment,
and ``bad-suppression`` itself cannot be suppressed (otherwise the
escape hatch would be its own escape hatch). Unknown rule ids in a
disable list are also ``bad-suppression`` findings — a typo'd id would
silently stop suppressing after a rule rename.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import asdict, dataclass
from collections.abc import Iterable, Iterator, Sequence

BAD_SUPPRESSION = "bad-suppression"
PARSE_ERROR = "parse-error"

_DISABLE_RE = re.compile(
    r"graftlint:\s*disable=(?P<ids>[A-Za-z0-9_,\s-]+?)"
    r"(?:\s+--\s*(?P<reason>.*\S)?)?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class Suppression:
    line: int
    ids: tuple[str, ...]
    reason: str | None


class ModuleInfo:
    """One parsed source file plus everything rules need from it."""

    def __init__(self, path: str, display_path: str, source: str):
        self.path = path
        self.display_path = display_path
        self.source = source
        self.tree: ast.Module | None = None
        self.parse_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            self.parse_error = e
        self.suppressions: dict[int, Suppression] = {}
        self.bad_suppressions: list[tuple[int, str]] = []
        self._scan_comments()
        # Line → end line of the enclosing SIMPLE statement, so a
        # trailing disable comment on the closing line of a multi-line
        # call still suppresses the finding anchored at the first line.
        # Compound statements (def/if/with/...) are excluded: a comment
        # inside their body must never blanket-suppress the header.
        self._stmt_end: dict[int, int] = {}
        if self.tree is not None:
            simple = (ast.Expr, ast.Assign, ast.AugAssign,
                      ast.AnnAssign, ast.Return, ast.Raise, ast.Assert,
                      ast.Delete)
            for node in ast.walk(self.tree):
                if (
                    isinstance(node, simple)
                    and node.end_lineno is not None
                    and node.end_lineno > node.lineno
                ):
                    for ln in range(node.lineno, node.end_lineno + 1):
                        self._stmt_end[ln] = max(
                            self._stmt_end.get(ln, 0), node.end_lineno
                        )

    def _scan_comments(self) -> None:
        # tokenize (not a raw-line regex) so the directive is only
        # honored in real comments, never inside string literals
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline
            )
            comments = [
                (t.start[0], t.string)
                for t in tokens
                if t.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return
        for line, text in comments:
            m = _DISABLE_RE.search(text)
            if m is None:
                if "graftlint:" in text:
                    self.bad_suppressions.append(
                        (line, "malformed graftlint directive "
                               "(expected 'graftlint: disable=<ids> "
                               "-- <reason>')")
                    )
                continue
            ids = tuple(
                s.strip() for s in m.group("ids").split(",") if s.strip()
            )
            reason = m.group("reason")
            if not reason:
                self.bad_suppressions.append(
                    (line, "suppression without a reason: append "
                           "' -- <why this is safe>'")
                )
                # keep the suppression inactive: an unjustified disable
                # must not hide the underlying finding either
                continue
            self.suppressions[line] = Suppression(line, ids, reason)

    def suppressed(self, finding: Finding) -> bool:
        if finding.rule == BAD_SUPPRESSION:
            return False
        end = self._stmt_end.get(finding.line, finding.line)
        for ln in range(finding.line, end + 1):
            s = self.suppressions.get(ln)
            if s is not None and finding.rule in s.ids:
                return True
        return False


class Rule:
    """Base class: one invariant, one stable id, per-module findings.

    Subclasses override ``check_module``. Rules that need the whole
    scanned tree at once (cross-file registries) instead override
    ``check_project``, which runs after every module has been parsed.
    """

    id: str = ""
    severity: str = "error"
    description: str = ""

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        return iter(())

    def finding(self, mod: ModuleInfo, line: int, message: str) -> Finding:
        return Finding(self.id, mod.display_path, line, message,
                       self.severity)


def _iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif p.endswith(".py"):
            yield p


def collect_modules(
    paths: Iterable[str], relative_to: str | None = None
) -> tuple[list[ModuleInfo], list[Finding]]:
    """Parse every .py under ``paths`` exactly once (overlapping inputs
    deduped by realpath). Returns the parsed modules plus parse-error
    findings for the rest. ``relative_to`` pins display paths against a
    fixed root (the lock-graph artifact must not depend on the caller's
    cwd); default is cwd-relative, same as before."""
    modules: list[ModuleInfo] = []
    findings: list[Finding] = []
    visited: set[str] = set()
    for path in _iter_py_files(paths):
        # overlapping inputs (`pkg pkg/sub`) must not parse
        # a file twice: duplicate findings, duplicate registries
        real = os.path.realpath(path)
        if real in visited:
            continue
        visited.add(real)
        display = os.path.relpath(path, relative_to)
        if display.startswith(".."):
            display = path
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(Finding(PARSE_ERROR, display, 1, str(e)))
            continue
        mod = ModuleInfo(path, display, source)
        if mod.parse_error is not None:
            findings.append(Finding(
                PARSE_ERROR, display,
                mod.parse_error.lineno or 1,
                f"syntax error: {mod.parse_error.msg}",
            ))
            continue
        modules.append(mod)
    return modules, findings


class LintRunner:
    """Parse once, run every rule, apply suppressions."""

    def __init__(self, rules: Sequence[Rule],
                 known_ids: Iterable[str] | None = None):
        ids = [r.id for r in rules]
        assert len(ids) == len(set(ids)), f"duplicate rule ids: {ids}"
        self.rules = list(rules)
        # known_ids may be wider than the rules being RUN (a --select
        # scoped run): a suppression naming a real-but-unselected rule
        # is valid, not a bad-suppression
        self.known_ids = (
            set(known_ids if known_ids is not None else ids)
            | {BAD_SUPPRESSION, PARSE_ERROR}
        )

    def run(self, paths: Iterable[str]) -> list[Finding]:
        modules, findings = collect_modules(paths)
        by_path = {m.display_path: m for m in modules}
        raw: list[Finding] = []
        for mod in modules:
            for line, msg in mod.bad_suppressions:
                raw.append(Finding(BAD_SUPPRESSION, mod.display_path,
                                   line, msg))
            for s in mod.suppressions.values():
                unknown = [i for i in s.ids if i not in self.known_ids]
                if unknown:
                    raw.append(Finding(
                        BAD_SUPPRESSION, mod.display_path, s.line,
                        f"unknown rule id(s) in disable list: "
                        f"{', '.join(unknown)}",
                    ))
            for rule in self.rules:
                raw.extend(rule.check_module(mod))
        for rule in self.rules:
            raw.extend(rule.check_project(modules))

        emitted = set()
        for f in raw:
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f):
                continue
            if f not in emitted:  # e.g. a def nested in a module-level
                emitted.add(f)    # `if` is walked by two scope passes
                findings.append(f)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings


def lint_paths(paths: Iterable[str],
               rules: Sequence[Rule] | None = None) -> list[Finding]:
    """Convenience wrapper: lint ``paths`` with ``rules`` (default: all
    project rules) and return the surviving findings."""
    if rules is None:
        from .rules import ALL_RULES

        rules = [cls() for cls in ALL_RULES]
    return LintRunner(rules).run(paths)


# the --json report schema: 2 added schema_version itself (the field
# consumers key migrations on) — the findings array is unchanged
JSON_SCHEMA_VERSION = 2


def render_report(findings: Sequence[Finding], as_json: bool) -> str:
    if as_json:
        return json.dumps(
            {"schema_version": JSON_SCHEMA_VERSION,
             "findings": [f.to_dict() for f in findings],
             "count": len(findings)},
            indent=2,
        )
    if not findings:
        return "graftlint: clean"
    lines = [f.render() for f in findings]
    lines.append(f"graftlint: {len(findings)} finding(s)")
    return "\n".join(lines)


def render_sarif(findings: Sequence[Finding],
                 rules: Sequence[Rule]) -> str:
    """SARIF 2.1.0 — the interchange format CI annotators consume
    (GitHub code scanning et al.), so a graftlint finding lands as an
    inline annotation on the offending line instead of a log grep.
    ``--sarif PATH`` writes it."""
    rule_meta = [
        {
            "id": r.id,
            "shortDescription": {"text": r.description or r.id},
            "defaultConfiguration": {
                "level": "error" if r.severity == "error" else "warning"
            },
        }
        for r in rules
    ]
    known = {r.id for r in rules}
    extra = sorted(
        {f.rule for f in findings} - known
    )  # bad-suppression / parse-error
    rule_meta.extend(
        {"id": rid, "shortDescription": {"text": rid}} for rid in extra
    )
    results = [
        {
            "ruleId": f.rule,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/")
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }
        for f in findings
    ]
    doc = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "graftlint",
                    "informationUri": "docs/TORCH_STATIC_ANALYSIS.md",
                    "rules": rule_meta,
                },
            },
            "results": results,
        }],
    }
    return json.dumps(doc, indent=2)
