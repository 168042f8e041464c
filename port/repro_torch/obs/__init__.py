"""Observability: only the null stage handle the store holds in slice 1."""

from .tracer import NULL_HANDLE

__all__ = ["NULL_HANDLE"]
