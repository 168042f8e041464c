"""Null causal tracer of ``repro.obs.trace``.

The WAL writers, the I/O pool's value fetches and the sharded store hold a
causal tracer and call it unconditionally (``begin_span``, ``end_span``,
``wal_append``, ``wal_commit``); with tracing off that is this null
object, so the call sites never branch on "is tracing on".  The sampling
tracer, its span ring and exporters come with ``obs/`` in a later slice.
"""

from __future__ import annotations

__all__ = ["NullCausalTracer", "NULL_CTRACE"]


class NullCausalTracer:
    """Tracing-off null object: one method call, no state, no branches
    at the call site."""

    __slots__ = ()

    def begin_span(self, name, parent, link=None, **args):
        return None

    def end_span(self, span, stage=None, retrack=False) -> None:
        pass

    def wal_append(self):
        return None

    def wal_commit(self, appends, t0: float) -> None:
        pass


NULL_CTRACE = NullCausalTracer()
