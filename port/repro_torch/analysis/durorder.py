"""DURORDER — durability ordering in the storage layer.

The storage engine's crash-safety argument (storage/README) rests on a
strict publish protocol: write to a temp file, ``flush`` + ``fsync`` the
data, ``os.replace`` into place, then ``fsync_dir`` the directory so the
rename itself is durable; the WAL appends frame → flush → fsync; and
CURRENT flips via ``set_current`` only after the manifest is durable.
A missing step is invisible until a crash at exactly the wrong moment.

A copy of ``repro.analysis.durorder`` whose default scopes are the port's
storage and sharded-store packages (``repro_torch/storage``,
``repro_torch/distributed``): the reference's ``repro/storage`` does not
match a path under ``repro_torch/``, so with its scopes the rule would
check nothing here.

This rule is a per-function *line-ordering* check — intentionally
coarser than a real dataflow pass, tuned to this repo's idioms:

* **TMPRENAME** — a function calling ``os.replace``/``os.rename`` that
  also opens a file for writing must ``.flush()`` and ``os.fsync(`` at
  earlier lines (under fsync mode the data must be durable before it is
  published).
* **CREATENOSYNC** — an ``open()`` in a creating mode (``w``/``a``/
  ``x``/``+``) inside an fsync-aware function (its source mentions
  ``fsync``) must be followed by ``fsync_dir(`` or ``set_current(`` so
  the new directory entry survives a crash.  Temp files that are later
  ``os.replace``d are exempt (the rename target's durability is the
  replace's job), as are paths matching ``ignore_path_substrings``.
* **REPLACENODIR** — ``os.replace`` in an fsync-aware function must be
  followed by ``fsync_dir(``/``set_current(`` at an equal-or-later line.
* **FSYNCNOFLUSH** — ``os.fsync(x.fileno())`` needs a ``.flush()`` at an
  earlier line: fsyncing an unflushed buffered file persists nothing.
  (The ``os.open`` fd form used by ``fsync_dir`` itself has no buffer
  and is exempt.)
"""

from __future__ import annotations

import ast

from .core import Finding, Rule, SourceFile, dotted, walk_functions

DEFAULT_SCOPES = ("repro_torch/storage", "repro_torch/distributed")
DEFAULT_IGNORE_PATH_SUBSTRINGS = ("LOCK",)


def _call_lines(fn):
    """Map of interesting call kinds -> sorted line numbers within fn."""
    lines = {"replace": [], "flush": [], "fsync": [], "fsync_dir": [],
             "set_current": [], "fsync_fileno": []}
    opens = []   # (node, mode, path_expr)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        last = name.rsplit(".", 1)[-1] if name else ""
        if name in ("os.replace", "os.rename"):
            lines["replace"].append((node.lineno, node))
        elif last == "flush":
            lines["flush"].append((node.lineno, node))
        elif name == "os.fsync":
            lines["fsync"].append((node.lineno, node))
            if node.args and isinstance(node.args[0], ast.Call) \
                    and isinstance(node.args[0].func, ast.Attribute) \
                    and node.args[0].func.attr == "fileno":
                lines["fsync_fileno"].append((node.lineno, node))
        elif last == "fsync_dir":
            lines["fsync_dir"].append((node.lineno, node))
        elif last == "set_current":
            lines["set_current"].append((node.lineno, node))
        elif name == "open" and node.args:
            mode = ""
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                mode = str(node.args[1].value)
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = str(kw.value.value)
            # "r+" updates in place — no new directory entry to sync
            if any(c in mode for c in "wax"):
                opens.append((node, mode, node.args[0]))
    return lines, opens


def _expr_names(node) -> str:
    """Flat text of names/attrs/constants in an expression, for matching
    a path variable against os.replace sources."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            out.append(sub.value)
    return " ".join(out)


class DurabilityOrderRule(Rule):
    id = "DURORDER"
    description = ("storage publish/append ordering: flush+fsync before "
                   "rename, fsync_dir after create/replace")

    def __init__(self, scopes=DEFAULT_SCOPES,
                 ignore_path_substrings=DEFAULT_IGNORE_PATH_SUBSTRINGS):
        self.scopes = tuple(scopes)
        self.ignore_path_substrings = tuple(ignore_path_substrings)

    def check(self, sf: SourceFile) -> list:
        if not any(s in sf.relpath for s in self.scopes):
            return []
        findings: list[Finding] = []
        for qual, _cls, fn in walk_functions(sf.tree):
            findings.extend(self._check_fn(sf, qual, fn))
        return findings

    def _check_fn(self, sf, qual, fn):
        findings: list[Finding] = []
        lines, opens = _call_lines(fn)
        src_segment = ast.get_source_segment(sf.text, fn) or ""
        fsync_aware = "fsync" in src_segment

        def note(node, msg):
            findings.append(Finding(self.id, sf.relpath, node.lineno,
                                    node.col_offset, msg, symbol=qual))

        replace_lines = [ln for ln, _ in lines["replace"]]
        durdir_lines = [ln for ln, _ in lines["fsync_dir"]] + \
                       [ln for ln, _ in lines["set_current"]]

        # TMPRENAME: data durable before publish
        if replace_lines and opens and fsync_aware:
            first_replace = min(replace_lines)
            has_flush = any(ln <= first_replace for ln, _ in lines["flush"])
            has_fsync = any(ln <= first_replace for ln, _ in lines["fsync"])
            if not (has_flush and has_fsync):
                _, node = min(lines["replace"])
                note(node, "os.replace publishes a file written in this "
                           "function without a preceding flush+os.fsync "
                           "(torn data can be renamed into place)")

        # REPLACENODIR: rename durable in the directory
        if fsync_aware:
            for ln, node in lines["replace"]:
                if not any(d >= ln for d in durdir_lines):
                    note(node, "os.replace without a following fsync_dir/"
                               "set_current: the rename itself is not "
                               "durable after a crash")

        # CREATENOSYNC: new directory entries need fsync_dir
        if fsync_aware:
            # path exprs fed to os.replace as the *source* (tmp files)
            replace_srcs = [_expr_names(n.args[0])
                            for _, n in lines["replace"]
                            if isinstance(n, ast.Call) and n.args]
            for node, mode, path_expr in opens:
                names = _expr_names(path_expr)
                if any(s in names for s in self.ignore_path_substrings):
                    continue
                if any(names and names == src for src in replace_srcs):
                    continue    # tmp file: replace owns its durability
                if not any(d >= node.lineno for d in durdir_lines):
                    note(node, f"open(mode={mode!r}) creates/extends a "
                               f"file in an fsync-aware function with no "
                               f"following fsync_dir/set_current")

        # FSYNCNOFLUSH: buffered fsync without flush
        for ln, node in lines["fsync_fileno"]:
            if not any(fl <= ln for fl, _ in lines["flush"]):
                note(node, "os.fsync(f.fileno()) without an earlier "
                           "f.flush(): buffered data is not persisted")
        return findings
