"""Null stage handle of ``repro.obs.tracer``.

The stores' value-fetch and filter-probe call sites (and the I/O pool's
value fetches) hold a pre-bound stage handle and call
``t0 = h.begin(); ...; h.end(t0)`` without branching on "is obs enabled".
Only the null object is ported; the sampling tracer, registry and
exporters come with ``obs/`` in a later slice.
"""

from __future__ import annotations

__all__ = ["NULL_HANDLE"]


class _NullHandle:
    __slots__ = ()

    def begin(self) -> float:
        return 0.0

    def end(self, t0: float) -> None:
        pass


NULL_HANDLE = _NullHandle()
