"""PAIRING — every dispatch has a resolve; every cache fill is epoch-stamped.

The read path is split into ``dispatch_get`` (enqueue device work,
return a pending handle) and ``resolve_get`` (the single blocking sync).
A dispatched handle that is dropped on some control-flow path leaks the
in-flight batch: the device work still runs, the value-log readers hold
their segments, and the epoch-barrier logic in the pipelined server
counts an in-flight entry that will never retire.  Separately, the
epoch-invalidated ``HotKeyCache`` is only correct if every ``fill``
carries the owning shard epochs — a fill without the stamp resurrects
stale values after a write barrier.

Checks:

* every handle-returning call site must *consume* its result on all
  control-flow paths before the function returns: pass it onward
  (``resolve_get(pb)``, ``wait_all(futs)``, any call argument, a
  constructor), store it (``self._inflight.append``, subscript/attribute
  store), or return it.  An ``if`` consumes only when both branches
  consume; merely *testing* the handle (``pb.epochs != ...``) does not.
  A bare handle-returning expression statement is always a leak.  The
  tracked producers are ``*.dispatch_get(...)`` (pending device batch),
  ``*.resolve_get_async(...)`` (in-flight :class:`ValueFetch` — dropping
  it silently skips the value materialization), and ``<pool-ish
  receiver>.submit(...)`` (an :class:`~repro_torch.io.IOFuture` that parks its
  task's exception until ``result()`` — dropped, the failure vanishes).
  ``submit`` is only tracked when the receiver name contains ``pool`` or
  ``io``, so the request queue's and engine's unrelated ``submit``
  methods stay out of scope.
* ``.fill(...)`` on a cache-like receiver (name contains ``cache``) must
  pass ≥ 4 positional args or an ``epochs=`` keyword — the epoch stamp
  is the 4th parameter of ``HotKeyCache.fill``.

A copy of ``repro.analysis.pairing``: the port's server, sharded store
and I/O pool keep the reference's names (``dispatch_get``,
``resolve_get_async``, ``IOPool.submit``, ``HotKeyCache.fill``), so the
checks carry over unchanged.
"""

from __future__ import annotations

import ast

from .core import Finding, Rule, SourceFile, dotted, walk_functions


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class PairingRule(Rule):
    id = "PAIRING"
    description = ("dispatch_get result must reach resolve_get/escape on "
                   "all paths; cache fills must carry epoch stamps")

    def check(self, sf: SourceFile) -> list:
        findings: list[Finding] = []
        for qual, _cls, fn in walk_functions(sf.tree):
            findings.extend(self._check_dispatch(sf, qual, fn))
            findings.extend(self._check_fill(sf, qual, fn))
        return findings

    # ------------------------------------------------------ dispatch_get

    def _check_dispatch(self, sf, qual, fn):
        findings: list[Finding] = []
        self._scan_stmts(sf, qual, fn.body, findings)
        return findings

    def _scan_stmts(self, sf, qual, stmts, findings, tail=()):
        for i, st in enumerate(stmts):
            rest = stmts[i + 1:] + list(tail)
            self._check_stmt(sf, qual, st, rest, findings)
            # recurse into nested blocks; code after the block is still a
            # place the handle can be consumed, so thread it through
            for blk in self._blocks(st):
                self._scan_stmts(sf, qual, blk, findings, tail=rest)

    @staticmethod
    def _blocks(st):
        blocks = []
        for attr in ("body", "orelse", "finalbody"):
            b = getattr(st, attr, None)
            if isinstance(b, list) and b and isinstance(b[0], ast.stmt):
                blocks.append(b)
        for h in getattr(st, "handlers", ()):
            blocks.append(h.body)
        return blocks

    def _dispatch_calls(self, node):
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)):
                continue
            attr = sub.func.attr
            if attr in ("dispatch_get", "resolve_get_async"):
                yield sub
            elif attr == "submit":
                # only I/O-pool submits return trackable futures; the
                # request queue's / engine's submit methods do not
                recv = dotted(sub.func.value).lower()
                if "pool" in recv or "io" in recv:
                    yield sub

    def _check_stmt(self, sf, qual, st, rest, findings):
        # 1. discarded:  store.dispatch_get(...)  as a bare statement
        if isinstance(st, ast.Expr):
            for call in self._dispatch_calls(st.value):
                if not self._nested_in_consumer(st.value, call):
                    findings.append(Finding(
                        self.id, sf.relpath, call.lineno, call.col_offset,
                        f"{call.func.attr} result discarded: the pending "
                        f"handle is never resolved/joined", symbol=qual))
            return
        # 2. assigned:  pb = store.dispatch_get(...)
        if isinstance(st, (ast.Assign, ast.AnnAssign)):
            value = st.value
            if value is None:
                return
            calls = list(self._dispatch_calls(value))
            if not calls:
                return
            targets = st.targets if isinstance(st, ast.Assign) else [st.target]
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in targets):
                return   # stored into an object/container: escaped
            names = set()
            for t in targets:
                names |= _names_in(t)
            if not names:
                return
            if not self._consumed(names, rest):
                call = calls[0]
                findings.append(Finding(
                    self.id, sf.relpath, call.lineno, call.col_offset,
                    f"{call.func.attr} result "
                    f"{'/'.join(sorted(names))} does not reach a "
                    f"resolve/join/escape on every following path",
                    symbol=qual))

    @staticmethod
    def _nested_in_consumer(root, call):
        """dispatch_get directly nested in another call's arguments —
        ``resolve_get(store.dispatch_get(...))`` — is consumed."""
        for sub in ast.walk(root):
            if isinstance(sub, ast.Call) and sub is not call:
                for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                    for inner in ast.walk(arg):
                        if inner is call:
                            return True
        return False

    # -------------------------------------- definite-consumption analysis

    def _consumed(self, names: set, stmts) -> bool:
        """True if every path through ``stmts`` consumes one of ``names``.

        Consumption = the name used as a call argument / receiver of a
        method call, returned, yielded, stored into a container/attr, or
        re-assigned wholesale to something else (ownership moved).  A
        reference inside an ``if`` *test* is not consumption."""
        for i, st in enumerate(stmts):
            rest = stmts[i + 1:]
            if isinstance(st, (ast.Return, ast.Raise)):
                return self._expr_consumes(getattr(st, "value", None) or
                                           getattr(st, "exc", None), names)
            if isinstance(st, ast.If):
                then_ok = self._consumed(names, list(st.body) + rest)
                else_ok = self._consumed(names, list(st.orelse) + rest)
                return then_ok and else_ok
            if isinstance(st, ast.Try):
                # the happy path must consume; handlers are error paths
                return self._consumed(names, list(st.body)
                                      + list(st.orelse) + rest)
            if isinstance(st, ast.With):
                return self._consumed(names, list(st.body) + rest)
            if isinstance(st, (ast.For, ast.While)):
                # loops may run zero times: only the code after the loop
                # (or an unconditional consume inside we can't prove)
                continue
            if isinstance(st, ast.Expr):
                if self._expr_consumes(st.value, names):
                    return True
            elif isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if st.value is not None \
                        and self._expr_consumes(st.value, names):
                    return True
                # wholesale re-assignment of the name drops the old
                # handle — that's a *new* handle, old one leaked; keep
                # scanning (conservative: not consumption)
        return False

    def _expr_consumes(self, node, names: set) -> bool:
        if node is None:
            return False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                # receiver:  pb.resolve()  /  name in any arg position
                recv = sub.func
                if isinstance(recv, ast.Attribute):
                    for inner in ast.walk(recv.value):
                        if isinstance(inner, ast.Name) and inner.id in names:
                            return True
                for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                    for inner in ast.walk(arg):
                        if isinstance(inner, ast.Name) and inner.id in names:
                            return True
            elif isinstance(sub, (ast.Tuple, ast.List, ast.Dict)):
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Name) and inner.id in names:
                        return True
            elif isinstance(sub, ast.Name) and sub.id in names \
                    and isinstance(node, (ast.Name, ast.Attribute,
                                          ast.Await)):
                # bare `return pb` / `return pb.x`
                return True
        return False

    # ------------------------------------------------------------- fills

    def _check_fill(self, sf, qual, fn):
        findings: list[Finding] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fill"):
                continue
            recv = dotted(node.func.value).lower()
            if "cache" not in recv:
                continue
            has_epoch_kw = any(kw.arg == "epochs" for kw in node.keywords)
            if len(node.args) < 4 and not has_epoch_kw:
                findings.append(Finding(
                    self.id, sf.relpath, node.lineno, node.col_offset,
                    "cache fill without an epoch stamp: stale values can "
                    "survive a write barrier (pass epochs as the 4th arg)",
                    symbol=qual))
        return findings
