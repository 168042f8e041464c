"""OBSDRIFT — metric call sites must match the obs plane's declarations.

`repro_torch.obs` centralizes naming (obs/README.md): layer prefixes, the
``_total`` counter suffix, a closed label vocabulary, and the canonical
``READ_STAGES`` tuple.  Nothing enforces any of it — a typo'd stage name
or an off-vocabulary label silently forks a new series and every
dashboard aggregation quietly misses it.  This rule parses the *actual*
declarations (the ``READ_STAGES`` tuple from
``repro_torch/obs/__init__.py`` and the prefix/label tables from
``obs/README.md``) at construction and
checks every literal-named metric call site against them:

* ``counter/gauge/histogram`` first-arg literals (including through
  function-local aliases like ``c = reg.counter``) must be snake_case
  with a declared layer prefix; counters must end ``_total``; gauges and
  histograms must not.
* literal keyword labels must be in the declared label vocabulary.
* ``.stage("...")`` literals must be members of ``READ_STAGES``.
* ``publish_stats(reg, "<prefix>", ...)`` literal prefixes must be
  declared prefixes.
* the README's stage table and the code's ``READ_STAGES`` must agree
  (checked once, reported against the obs ``__init__``).
* causal-tracing call sites (``repro_torch.obs.trace``): literal
  ``begin_span("...")`` / ``_new_span("...")`` first args must be
  members of ``SPAN_NAMES``, literal ``end_span(..., stage="...")``
  kwargs must be members of ``CRITICAL_STAGES``, and the README's
  "Causal tracing" span/segment tables must agree with the tuples in
  ``obs/trace.py`` (reported once, against ``trace.py``).

Dynamic name arguments are skipped — the registry's own plumbing and the
tracer's ``self._registry.histogram(self._family, stage=name)`` are not
call sites this rule can or should judge.

A copy of ``repro.analysis.obsdrift`` whose :meth:`ObsDriftRule.from_root`
reads the port's own declarations: ``port/repro_torch/obs/__init__.py``,
``port/repro_torch/obs/README.md`` and ``port/repro_torch/obs/trace.py``.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Finding, Rule, SourceFile, dotted, walk_functions

# fallbacks when the obs sources are unavailable (fixture tests)
FALLBACK_PREFIXES = ("server", "cache", "store", "engine", "fleet", "obs")
FALLBACK_LABELS = ("shard", "level", "stage", "path", "key", "index")
FALLBACK_STAGES = ("admission", "coalesce", "cache_probe", "dispatch",
                   "compute", "resolve", "value_fetch")
FALLBACK_SPANS = ("request", "queue_wait", "batch", "dispatch",
                  "shard_probe", "device_compute", "io_task",
                  "value_fetch", "write_apply", "wal_append",
                  "wal_commit", "wal_sync", "maintenance")
FALLBACK_CRITICAL = ("queue_wait", "dispatch", "device_compute",
                     "value_fetch", "wal_fsync")

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")
_METHODS = ("counter", "gauge", "histogram")
_SPAN_METHODS = ("begin_span", "_new_span")


def _tuple_from_source(path: str, name: str):
    """Parse a module-level tuple-of-str assignment out of a source
    file via ast (``READ_STAGES``, ``SPAN_NAMES``, ``CRITICAL_STAGES``)."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    vals = [el.value for el in node.value.elts
                            if isinstance(el, ast.Constant)
                            and isinstance(el.value, str)]
                    return tuple(vals)
    return None


def _read_stages_from_init(path: str):
    """Parse the READ_STAGES tuple out of repro_torch/obs/__init__.py via
    ast."""
    return _tuple_from_source(path, "READ_STAGES")


def _marked_table_from_readme(path: str, marker: str):
    """First-column backticked entries of the markdown table that
    follows the first line mentioning ``marker`` (at most one blank
    line between them)."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None
    m = re.search(marker + r"[^\n]*\n(?:\s*\n)?((?:\|.*\n)+)", text)
    if not m:
        return None
    rows = re.findall(r"^\|\s*`([a-z_]+)`\s*\|", m.group(1), re.M)
    return tuple(rows) or None


def _tables_from_readme(path: str):
    """Prefixes (`server_*` style), label names (`| \\`shard=\\` |` rows)
    and stage-table entries from obs/README.md."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return None, None, None
    prefixes = tuple(dict.fromkeys(re.findall(r"`([a-z][a-z0-9]*)_\*`",
                                              text)))
    labels = tuple(dict.fromkeys(re.findall(r"\|\s*`([a-z_]+)=`\s*\|",
                                            text)))
    stages = None
    # the table may follow its heading after one blank line, as the
    # marked tables do (the reference's pattern allows none, so its
    # README's stage table, which has one, is never read)
    m = re.search(r"READ_STAGES[^\n]*\n(?:\s*\n)?((?:\|.*\n)+)", text)
    if m:
        rows = re.findall(r"^\|\s*`([a-z_]+)`\s*\|", m.group(1), re.M)
        if rows:
            stages = tuple(rows)
    return prefixes or None, labels or None, stages


class ObsDriftRule(Rule):
    id = "OBSDRIFT"
    description = ("metric name/label/stage literal drifts from the obs "
                   "plane's declared conventions")

    def __init__(self, obs_init: str | None = None,
                 obs_readme: str | None = None,
                 obs_trace: str | None = None,
                 prefixes=None, labels=None, stages=None,
                 spans=None, critical=None) -> None:
        readme_prefixes = readme_labels = readme_stages = None
        readme_spans = readme_critical = None
        if obs_readme:
            readme_prefixes, readme_labels, readme_stages = \
                _tables_from_readme(obs_readme)
            readme_spans = _marked_table_from_readme(obs_readme,
                                                     "SPAN_NAMES")
            readme_critical = _marked_table_from_readme(obs_readme,
                                                        "CRITICAL_STAGES")
        init_stages = _read_stages_from_init(obs_init) if obs_init else None
        trace_spans = trace_critical = None
        if obs_trace:
            trace_spans = _tuple_from_source(obs_trace, "SPAN_NAMES")
            trace_critical = _tuple_from_source(obs_trace,
                                                "CRITICAL_STAGES")
        self.prefixes = tuple(prefixes or readme_prefixes
                              or FALLBACK_PREFIXES)
        self.labels = tuple(labels or readme_labels or FALLBACK_LABELS)
        self.stages = tuple(stages or init_stages or FALLBACK_STAGES)
        self.spans = tuple(spans or trace_spans or FALLBACK_SPANS)
        self.critical = tuple(critical or trace_critical
                              or FALLBACK_CRITICAL)
        # code-vs-README stage agreement, reported once against __init__
        self._stage_drift = None
        if init_stages is not None and readme_stages is not None \
                and tuple(init_stages) != tuple(readme_stages):
            self._stage_drift = (obs_init, init_stages, readme_stages)
        self._obs_init = obs_init
        # code-vs-README span/segment agreement, reported against trace.py
        self._trace_drift = []
        if trace_spans is not None and readme_spans is not None \
                and tuple(trace_spans) != tuple(readme_spans):
            self._trace_drift.append(
                ("SPAN_NAMES", trace_spans, readme_spans))
        if trace_critical is not None and readme_critical is not None \
                and tuple(trace_critical) != tuple(readme_critical):
            self._trace_drift.append(
                ("CRITICAL_STAGES", trace_critical, readme_critical))
        self._obs_trace = obs_trace

    @classmethod
    def from_root(cls, root: str) -> "ObsDriftRule":
        return cls(
            obs_init=os.path.join(root, "port/repro_torch/obs/__init__.py"),
            obs_readme=os.path.join(root, "port/repro_torch/obs/README.md"),
            obs_trace=os.path.join(root, "port/repro_torch/obs/trace.py"))

    # ------------------------------------------------------------------

    def check(self, sf: SourceFile) -> list:
        findings: list[Finding] = []
        if self._stage_drift is not None and self._obs_init \
                and os.path.abspath(sf.path) == \
                os.path.abspath(self._obs_init):
            _, code, readme = self._stage_drift
            findings.append(Finding(
                self.id, sf.relpath, 1, 0,
                f"READ_STAGES in code {list(code)} disagrees with the "
                f"obs README stage table {list(readme)}"))
        if self._trace_drift and self._obs_trace \
                and os.path.abspath(sf.path) == \
                os.path.abspath(self._obs_trace):
            for name, code, readme in self._trace_drift:
                findings.append(Finding(
                    self.id, sf.relpath, 1, 0,
                    f"{name} in code {list(code)} disagrees with the "
                    f"obs README causal-tracing table {list(readme)}"))
        for qual, _cls, fn in walk_functions(sf.tree):
            findings.extend(self._check_fn(sf, qual, fn))
        return findings

    def _check_fn(self, sf, qual, fn):
        findings: list[Finding] = []

        def note(node, msg):
            findings.append(Finding(self.id, sf.relpath, node.lineno,
                                    node.col_offset, msg, symbol=qual))

        # function-local aliases:  c = reg.counter
        aliases: dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in _METHODS:
                aliases[node.targets[0].id] = node.value.attr

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            kind = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _METHODS:
                kind = node.func.attr
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in aliases:
                kind = aliases[node.func.id]
            if kind is not None:
                self._check_metric(note, node, kind)
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SPAN_METHODS:
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and node.args[0].value not in self.spans:
                    note(node, f"span {node.args[0].value!r} is not in "
                               f"SPAN_NAMES {list(self.spans)}")
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "end_span":
                for kw in node.keywords:
                    if kw.arg == "stage" \
                            and isinstance(kw.value, ast.Constant) \
                            and isinstance(kw.value.value, str) \
                            and kw.value.value not in self.critical:
                        note(node, f"critical-path stage "
                                   f"{kw.value.value!r} is not in "
                                   f"CRITICAL_STAGES "
                                   f"{list(self.critical)}")
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "stage" and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                name = node.args[0].value
                if name not in self.stages:
                    note(node, f"stage {name!r} is not in READ_STAGES "
                               f"{list(self.stages)}")
                continue
            fname = dotted(node.func).rsplit(".", 1)[-1]
            if fname == "publish_stats" and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                prefix = node.args[1].value
                if prefix not in self.prefixes:
                    note(node, f"publish_stats prefix {prefix!r} is not a "
                               f"declared layer prefix "
                               f"{list(self.prefixes)}")
        return findings

    def _check_metric(self, note, node, kind):
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            return      # dynamic name: registry plumbing, skip
        name = node.args[0].value
        if not _SNAKE.match(name):
            note(node, f"metric name {name!r} is not snake_case")
        elif name.split("_", 1)[0] not in self.prefixes:
            note(node, f"metric {name!r} lacks a declared layer prefix "
                       f"({'/'.join(p + '_' for p in self.prefixes)})")
        if kind == "counter" and not name.endswith("_total"):
            note(node, f"counter {name!r} must end in '_total'")
        if kind in ("gauge", "histogram") and name.endswith("_total"):
            note(node, f"{kind} {name!r} must not end in '_total' "
                       f"(reserved for counters)")
        for kw in node.keywords:
            if kw.arg is None:     # **labels: dynamic, skip
                continue
            if kw.arg not in self.labels:
                note(node, f"label {kw.arg!r} on {name!r} is not in the "
                           f"declared label vocabulary {list(self.labels)}")
