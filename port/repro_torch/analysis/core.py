"""bourbonlint core: findings, suppressions, baselines, and the runner.

A copy of ``repro.analysis.core``, which is pure Python: the port keeps
its own so that it imports nothing of the JAX package, and keeps the
same suppression syntax and baseline format (version 1, fingerprints
without line numbers), so that the two packages' baselines read alike.

The framework is deliberately small: a :class:`Rule` is an object with an
``id`` and a ``check(SourceFile) -> list[Finding]`` method over the
parsed ``ast``; everything else here is the plumbing every rule shares —

* **suppressions** — ``# bourbonlint: allow[RULE] -- justification`` on
  (or immediately above) the offending line.  The justification text is
  mandatory: an allow without one does not suppress anything and instead
  raises a ``SUPPRESS`` finding, so "silenced because annoying" can't
  land without review seeing why.
* **baseline** — a checked-in JSON file of grandfathered findings keyed
  by (rule, path, symbol, message) with a count, never by line number,
  so unrelated edits don't churn it.  New findings fail the lint; fixed
  ones show up as *expired* entries to prune with ``--update-baseline``.
* **runner** — walks ``.py`` files, parses once, fans out to the rules,
  and applies suppression/baseline state to the combined findings.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import json
import os
import re
import tokenize

__all__ = ["Finding", "SourceFile", "Rule", "run_lint", "iter_py_files",
           "load_baseline", "save_baseline", "make_baseline",
           "apply_baseline", "dotted", "walk_functions", "SUPPRESS"]

SUPPRESS = "SUPPRESS"   # pseudo-rule for malformed allow comments

_ALLOW_RE = re.compile(
    r"bourbonlint:\s*allow\[([^\]]*)\]\s*(?:--\s*(\S.*))?$")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location.

    ``symbol`` is the enclosing function's qualname (or "" at module
    scope); the baseline identity is (rule, path, symbol, message) so a
    grandfathered finding survives the file shifting under it."""
    rule: str
    path: str                 # root-relative, posix separators
    line: int
    col: int
    message: str
    symbol: str = ""
    suppressed: bool = False
    baselined: bool = False

    def key(self) -> tuple:
        return (self.rule, self.path, self.symbol, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message, "suppressed": self.suppressed,
                "baselined": self.baselined}

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.message}{sym}")


@dataclasses.dataclass
class _Allow:
    line: int
    rules: tuple
    justification: str | None


class SourceFile:
    """A parsed source file plus its suppression comments."""

    def __init__(self, path: str, relpath: str, text: str) -> None:
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.allows, self.bad_allows = self._parse_allows(text)

    @classmethod
    def load(cls, path: str, root: str) -> "SourceFile":
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return cls(path, os.path.relpath(path, root), text)

    def _parse_allows(self, text: str):
        allows: dict[int, list[_Allow]] = {}
        bad: list[Finding] = []
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
        except tokenize.TokenError:
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ALLOW_RE.search(tok.string)
            if m is None:
                if "bourbonlint" in tok.string:
                    bad.append(Finding(
                        SUPPRESS, self.relpath, tok.start[0], tok.start[1],
                        "unrecognized bourbonlint comment (expected "
                        "'bourbonlint: allow[RULE] -- justification')"))
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            just = m.group(2)
            if not rules:
                bad.append(Finding(
                    SUPPRESS, self.relpath, tok.start[0], tok.start[1],
                    "allow[] names no rule"))
                continue
            if not (just and just.strip()):
                # a justification-free allow suppresses NOTHING
                bad.append(Finding(
                    SUPPRESS, self.relpath, tok.start[0], tok.start[1],
                    f"allow[{','.join(rules)}] is missing its justification "
                    f"('-- why this is safe')"))
                continue
            allows.setdefault(tok.start[0], []).append(
                _Allow(tok.start[0], rules, just.strip()))
        return allows, bad

    def allowed(self, rule: str, line: int) -> bool:
        """True when a justified allow for ``rule`` sits on ``line`` or
        the line directly above it (the standalone-comment idiom)."""
        for ln in (line, line - 1):
            for al in self.allows.get(ln, ()):
                if rule in al.rules:
                    return True
        return False


class Rule:
    """Base class: subclasses set ``id``/``description`` and implement
    ``check``.  A rule returning findings for code it cannot prove safe
    should say so in the message — suppressions exist for the remainder."""

    id = "RULE"
    description = ""

    def check(self, sf: SourceFile) -> list:
        raise NotImplementedError


# ---------------------------------------------------------------- ast helpers

def dotted(node) -> str:
    """Dotted name of an expression ("os.replace", "self.cache.fill"),
    or "" when it isn't a plain Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_functions(tree):
    """Yield (qualname, classname, funcdef) for every function in the
    module, depth-first, tracking the enclosing class."""
    def visit(node, classname, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                yield from visit(child, child.name,
                                 f"{prefix}{child.name}.")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield f"{prefix}{child.name}", classname, child
                yield from visit(child, classname,
                                 f"{prefix}{child.name}.")
            else:
                yield from visit(child, classname, prefix)
    yield from visit(tree, "", "")


def match_hot(patterns, classname: str, funcname: str) -> bool:
    """fnmatch (class_glob, func_glob) pairs; module-level functions have
    classname "" and are matched by class_glob "*" or ""."""
    for cg, fg in patterns:
        if fnmatch.fnmatch(classname or "", cg or "*") \
                and fnmatch.fnmatch(funcname, fg):
            return True
    return False


# -------------------------------------------------------------------- runner

def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def run_lint(paths, rules, root: str | None = None) -> list:
    """Run ``rules`` over every .py file under ``paths``.  Returns all
    findings with ``suppressed`` already applied (the caller filters);
    malformed suppressions surface as SUPPRESS findings."""
    root = root or os.getcwd()
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        try:
            sf = SourceFile.load(path, root)
        except SyntaxError as e:
            findings.append(Finding("PARSE", os.path.relpath(path, root),
                                    e.lineno or 1, 0,
                                    f"file does not parse: {e.msg}"))
            continue
        file_findings: list[Finding] = []
        for rule in rules:
            file_findings.extend(rule.check(sf))
        for f in file_findings:
            # SUPPRESS findings are not themselves suppressible
            if f.rule != SUPPRESS and sf.allowed(f.rule, f.line):
                f.suppressed = True
        findings.extend(file_findings)
        findings.extend(sf.bad_allows)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ------------------------------------------------------------------ baseline

BASELINE_VERSION = 1


def load_baseline(path: str) -> dict:
    if not os.path.exists(path):
        return {"version": BASELINE_VERSION, "findings": []}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{data.get('version')!r}")
    return data


def save_baseline(path: str, baseline: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(baseline, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def make_baseline(findings) -> dict:
    """Baseline covering every live (non-suppressed) finding, counted per
    (rule, path, symbol, message) identity."""
    counts: dict[tuple, int] = {}
    for f in findings:
        if f.suppressed or f.rule == SUPPRESS:
            continue
        counts[f.key()] = counts.get(f.key(), 0) + 1
    entries = [{"rule": r, "path": p, "symbol": s, "message": m, "count": c}
               for (r, p, s, m), c in sorted(counts.items())]
    return {"version": BASELINE_VERSION, "findings": entries}


def apply_baseline(findings, baseline: dict) -> list:
    """Mark findings covered by the baseline as ``baselined`` (first
    ``count`` matches per identity).  Returns the *expired* baseline
    entries — grandfathered findings that no longer occur and should be
    pruned (``--update-baseline``)."""
    budget = {(e["rule"], e["path"], e["symbol"], e["message"]): e["count"]
              for e in baseline.get("findings", [])}
    used: dict[tuple, int] = {}
    for f in findings:
        if f.suppressed or f.rule == SUPPRESS:
            continue
        k = f.key()
        if used.get(k, 0) < budget.get(k, 0):
            used[k] = used.get(k, 0) + 1
            f.baselined = True
    expired = []
    for e in baseline.get("findings", []):
        k = (e["rule"], e["path"], e["symbol"], e["message"])
        if used.get(k, 0) < e["count"]:
            expired.append({**e, "count": e["count"] - used.get(k, 0)})
    return expired
