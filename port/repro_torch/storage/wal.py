"""Write-ahead log: memtable contents survive a crash.

One frame per ingested sub-batch: ``[op u8][count u32]`` followed by the
raw ``keys/seqs/vptrs`` int64 arrays.  Tombstones ride as ordinary records
with ``vptr == -1``, so a single record type covers puts and deletes.

The WAL is rotated at every flush: once the drained memtable is durable as
an SSTable (and the MANIFEST edit recording it is on disk), a fresh
``wal-<n+1>.log`` starts and the old file is deleted.  Replay therefore
only ever concerns records newer than the last flush.

Two writers share the frame format:

* :class:`WALWriter` — per-append durability: every ``append`` flushes
  (and fsyncs when enabled) before returning.
* :class:`GroupCommitWAL` — group commit: ``append`` only *enqueues* the
  frame (acknowledged-but-not-yet-durable); when ``sync()`` sets the
  durability barrier, a background committer thread writes every queued
  frame in append order under ONE flush+fsync, so N producer batches
  amortize into one disk sync.  ``sync()`` is the durability point; the
  commit contract is documented in ``src/repro/storage/README.md``.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np

from repro_torch.obs import NULL_CTRACE

from .format import fsync_dir, read_frames, write_frame

__all__ = ["GroupCommitWAL", "WALWriter", "replay_wal"]

_REC_HDR = struct.Struct("<BI")
_OP_PUT = 1


def _pack_frame(keys: np.ndarray, seqs: np.ndarray,
                vptrs: np.ndarray) -> bytes:
    return (_REC_HDR.pack(_OP_PUT, keys.shape[0])
            + np.ascontiguousarray(keys, np.int64).tobytes()
            + np.ascontiguousarray(seqs, np.int64).tobytes()
            + np.ascontiguousarray(vptrs, np.int64).tobytes())


class WALWriter:
    def __init__(self, path: str, fsync: bool = False) -> None:
        self.path = path
        self.fsync = fsync
        self.appends = 0
        self.fsyncs = 0
        self.commits = 0     # disk syncs (flush groups); == appends here
        # causal tracer (repro.obs.trace): set by the engine when the
        # store attaches an obs plane; one attribute read per append
        # while no traced write is in flight
        self.tracer = NULL_CTRACE
        created = not os.path.exists(path)
        self._f = open(path, "ab")
        if fsync and created:
            fsync_dir(os.path.dirname(path))  # the new entry must persist

    def append(self, keys: np.ndarray, seqs: np.ndarray,
               vptrs: np.ndarray) -> None:
        # per-append durability: the append span covers its own commit
        tsp = self.tracer.wal_append()
        write_frame(self._f, _pack_frame(keys, seqs, vptrs))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
            self.fsyncs += 1
        self.appends += 1
        self.commits += 1
        self.tracer.end_span(tsp, stage="wal_fsync")

    def sync(self) -> None:
        """Per-append durability means there is nothing left to wait for
        — kept so callers hold one WAL interface across both writers."""

    def drain_batch_sizes(self) -> list[int]:
        return []

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class GroupCommitWAL:
    """Group-commit WAL writer (leader/follower collapsed into one
    dedicated committer thread).

    ``append`` packs the frame and enqueues it — the write is then
    *acknowledged* (ordered, will be replayed after any crash that
    happens once it is synced) but not yet durable.  The committer is
    **sync-driven**: it stays idle until a ``sync()`` barrier arrives
    (or ``group_cap`` frames pile up — the memory bound), then drains
    **everything** queued, writes the frames in append order, and issues
    one ``flush`` (+``fsync`` when enabled) for the whole group.  Every
    append between two sync barriers therefore lands in the same commit
    — the coalesce factor equals the producer's batching, not scheduler
    luck.  ``sync()`` blocks until every frame enqueued before the call
    is durable.

    A crash loses at most the un-synced suffix: frames hit the file
    strictly in append order, so the on-disk WAL is always a clean
    prefix of the acknowledged stream (``replay_wal`` already tolerates
    a torn trailing frame).  ``crash()`` simulates exactly that for the
    recovery tests — queued frames are dropped, the file is abandoned
    as-is.
    """

    def __init__(self, path: str, fsync: bool = False,
                 group_cap: int = 256) -> None:
        self.path = path
        self.fsync = fsync
        self.group_cap = group_cap        # commit early past this many frames
        self.appends = 0
        self.fsyncs = 0
        self.commits = 0                  # commit groups written
        # causal tracer (repro.obs.trace): set by the engine at obs
        # attach; wal_append() is one attribute read when untraced
        self.tracer = NULL_CTRACE
        created = not os.path.exists(path)
        self._f = open(path, "ab")
        if fsync and created:
            fsync_dir(os.path.dirname(path))
        self._cv = threading.Condition()
        self._pending: list[bytes] = []
        # wal_append spans of the frames in _pending (traced writes only;
        # drained with the batch so each commit group ends exactly the
        # appends it made durable)
        self._trace_appends: list = []
        self._enqueued = 0
        self._durable = 0
        self._sync_upto = 0               # highest sync barrier requested
        self._closing = False
        self._crashed = False
        self._hold = False                # test hook: freeze the committer
        self._batch_sizes: list[int] = []  # drained by the obs collector
        self._exc: BaseException | None = None
        self._thread = threading.Thread(target=self._run,
                                        name="wal-commit", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- producers
    def append(self, keys: np.ndarray, seqs: np.ndarray,
               vptrs: np.ndarray) -> None:
        payload = _pack_frame(keys, seqs, vptrs)
        tsp = self.tracer.wal_append()    # enqueue->durable span, or None
        with self._cv:
            if self._exc is not None:
                raise self._exc
            if self._closing:
                raise RuntimeError("append on a closed GroupCommitWAL")
            self._pending.append(payload)
            if tsp is not None:
                self._trace_appends.append(tsp)
            self._enqueued += 1
            self.appends += 1
            self._cv.notify_all()

    def sync(self) -> None:
        """Block until everything enqueued so far is durable.  A commit
        I/O error surfaces here (and on the next append) instead of
        vanishing in the committer thread."""
        with self._cv:
            target = self._enqueued
            self._sync_upto = max(self._sync_upto, target)
            self._cv.notify_all()          # wake the committer: barrier set
            while self._durable < target and self._exc is None:
                self._cv.wait()
            if self._exc is not None:
                raise self._exc

    # ------------------------------------------------------------- committer
    def _run(self) -> None:
        while True:
            with self._cv:
                # sync-driven: sleep until a sync barrier wants frames
                # committed, or the pending group hits the memory cap, or
                # lifecycle (close drains, crash stops)
                while not self._closing and not self._crashed and (
                        self._hold
                        or not self._pending
                        or (self._sync_upto <= self._durable
                            and len(self._pending) < self.group_cap)):
                    self._cv.wait()
                if self._crashed:
                    return
                if self._closing and not self._pending:
                    return
                batch = self._pending
                self._pending = []
                tspans = self._trace_appends
                self._trace_appends = []
            t_commit = time.perf_counter()
            try:
                for payload in batch:
                    write_frame(self._f, payload)
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())
            except BaseException as exc:   # park it; sync/append re-raise
                with self._cv:
                    self._exc = exc
                    self._cv.notify_all()
                return
            if tspans:
                # fan-in: M appends -> one commit group.  Ends each append
                # span at durability (crediting wal_fsync) BEFORE _durable
                # moves, so a sync()ing producer reads quiesced segments
                self.tracer.wal_commit(tspans, t_commit)
            with self._cv:
                self._durable += len(batch)
                self.commits += 1
                if self.fsync:
                    self.fsyncs += 1
                if len(self._batch_sizes) < 4096:  # bounded: obs drains it
                    self._batch_sizes.append(len(batch))
                self._cv.notify_all()

    # ------------------------------------------------------------- lifecycle
    def drain_batch_sizes(self) -> list[int]:
        """Hand the accumulated per-commit group sizes to the caller (the
        obs collector's fsync-batch-size histogram) and reset the list."""
        with self._cv:
            out = self._batch_sizes
            self._batch_sizes = []
        return out

    def close(self) -> None:
        """Quiesce: drain every queued frame (one final group commit),
        stop the committer, close the file.  Rotation and clean shutdown
        go through here, so a rotated-away WAL never strands frames."""
        with self._cv:
            if self._closing or self._crashed:
                return
            self._hold = False
            self._closing = True
            self._cv.notify_all()
        self._thread.join()
        if self._exc is None:
            self._durable = self._enqueued
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def crash(self) -> None:
        """Crash injection (tests): drop the queued un-synced frames and
        abandon the file exactly as a power loss mid-coalesce would —
        the on-disk WAL keeps only the already-committed prefix."""
        with self._cv:
            self._crashed = True
            self._pending = []
            self._trace_appends = []
            self._cv.notify_all()
        self._thread.join()
        if not self._f.closed:
            # nothing un-committed is buffered in the file object (frames
            # wait in _pending until a commit group writes AND flushes
            # them), so closing here leaks no extra bytes to disk
            self._f.close()


def replay_wal(path: str) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Return the complete (keys, seqs, vptrs) batches in append order.

    Torn tails (partial frame / bad crc) end the log silently — those
    records were never acknowledged.
    """
    out = []
    for payload in read_frames(path):
        op, count = _REC_HDR.unpack_from(payload, 0)
        if op != _OP_PUT:
            break  # unknown record type: treat as corruption, stop replay
        body = payload[_REC_HDR.size:]
        if len(body) != 3 * 8 * count:
            break
        arr = np.frombuffer(body, np.int64)
        out.append((arr[:count].copy(), arr[count:2 * count].copy(),
                    arr[2 * count:].copy()))
    return out
