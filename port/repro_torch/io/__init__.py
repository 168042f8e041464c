"""The host I/O plane (a copy of ``repro.io``).

A bounded worker pool (:class:`IOPool`) plus the future/handle types the
storage and serving layers use to take file and arena I/O off the tick
loop: value-log fetches become :class:`ValueFetch` handles that overlap
device compute, and (together with ``storage.wal.GroupCommitWAL``)
WAL appends coalesce into group commits.  See ``src/repro/server`` and
``src/repro/storage`` READMEs for how the planes compose.
"""

from .pool import IOFuture, IOPool, ValueFetch, wait_all

__all__ = ["IOFuture", "IOPool", "ValueFetch", "wait_all"]
