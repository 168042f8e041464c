"""Null stage handle of ``repro.obs.tracer``.

The store's value-fetch and filter-probe call sites hold a pre-bound stage
handle and call ``t0 = h.begin(); ...; h.end(t0)`` without branching on
"is obs enabled".  Slice 1 ports only the null object; the sampling tracer,
registry and exporters come with ``obs/`` in a later slice.
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
