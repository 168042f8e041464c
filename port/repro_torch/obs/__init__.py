"""Observability: only the null objects the store, the WAL, the I/O pool
and the sharded store hold (a null stage handle and a null causal
tracer); the registry, tracers and exporters come in a later slice."""

from .trace import NULL_CTRACE
from .tracer import NULL_HANDLE

__all__ = ["NULL_CTRACE", "NULL_HANDLE"]
