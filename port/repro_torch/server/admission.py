"""Request admission: bounded queue + coalescing batcher.

Many concurrent clients each submit small GET/PUT/DELETE requests; the
lookup kernels want few large batches.  The :class:`RequestQueue`
is the bounded front door (a full queue rejects the submit — closed-loop
clients retry next tick, which is the backpressure), and the
:class:`Batcher` turns the queue's front run of same-op requests into one
fixed-size key batch:

* GET runs are **deduplicated** — a key requested by five clients is
  probed once and fanned back to all five via per-request scatter maps;
* write runs are concatenated **in submission order** (the store's seq
  numbers make the last write win, exactly as if the clients had called
  the store back-to-back);
* a batch is dispatched when it reaches ``max_batch_keys``, when the
  oldest member has waited ``max_wait_ticks`` server ticks, or when a
  different-op request is queued behind the run (ops never reorder
  around each other, so GETs always see every earlier write).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

__all__ = ["ServerRequest", "RequestQueue", "Batch", "Batcher"]

OPS = ("get", "put", "delete")


@dataclasses.dataclass
class ServerRequest:
    """One client request.  The server fills the result fields and flips
    ``done``; closed-loop clients poll it."""
    rid: int
    op: str                            # get | put | delete
    keys: np.ndarray                   # (K,) int64
    values: np.ndarray | None = None   # (K, value_size) uint8, puts only
    done: bool = False
    found: np.ndarray | None = None    # (K,) bool, GETs only
    result: np.ndarray | None = None   # (K, value_size) uint8, GETs only
    submitted_tick: int = -1
    completed_tick: int = -1
    # the single per-shard epoch vector the GET was answered under (set by
    # the pipelined server; None when the cache answered every key — cache
    # entries are themselves epoch-stamped)
    epochs_served: tuple | None = None
    # causal-tracing context minted at admission for sampled requests
    # (a repro_torch.obs.trace.TraceContext); None for the unsampled many
    trace: object | None = None

    def __post_init__(self) -> None:
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        self.keys = np.asarray(self.keys, np.int64)
        if self.values is not None:
            self.values = np.asarray(self.values, np.uint8)
            if self.values.shape[0] != self.keys.shape[0]:
                raise ValueError("values must align with keys")

    @property
    def latency_ticks(self) -> int:
        return self.completed_tick - self.submitted_tick


class RequestQueue:
    """Bounded FIFO.  ``submit`` returns False (and counts the rejection)
    when the queue is at capacity — the server never buffers unboundedly,
    clients feel the backpressure immediately."""

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self._q: deque[ServerRequest] = deque()
        self.submitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def submit(self, req: ServerRequest, tick: int) -> bool:
        if len(self._q) >= self.capacity:
            self.rejected += 1
            return False
        req.submitted_tick = tick
        self._q.append(req)
        self.submitted += 1
        return True

    def head(self) -> ServerRequest | None:
        return self._q[0] if self._q else None

    def pop_n(self, n: int) -> list[ServerRequest]:
        return [self._q.popleft() for _ in range(n)]


@dataclasses.dataclass
class Batch:
    op: str
    requests: list
    keys: np.ndarray                # GETs: deduped; writes: concatenated
    values: np.ndarray | None       # puts only
    scatter: list | None            # GETs: per-request indices into keys


class Batcher:
    def __init__(self, max_batch_keys: int = 1024,
                 max_wait_ticks: int = 2) -> None:
        self.max_batch_keys = int(max_batch_keys)
        self.max_wait_ticks = int(max_wait_ticks)
        self.batches = 0
        self.coalesced_requests = 0
        self.request_keys = 0       # keys before dedup
        self.batch_keys = 0         # keys actually dispatched
        self.held = 0               # ticks spent waiting for a fuller batch

    def next_batch(self, queue: RequestQueue, tick: int) -> Batch | None:
        """Form (or hold) one batch from the queue front.  Returns None
        when the queue is empty or the front run is worth waiting on."""
        head = queue.head()
        if head is None:
            return None
        run: list[ServerRequest] = []
        total = 0
        for req in queue:
            if req.op != head.op:
                break
            # puts with and without explicit values cannot share one
            # store call — cut the run at the boundary (order preserved)
            if (head.op == "put"
                    and (req.values is None) != (head.values is None)):
                break
            if run and total + req.keys.shape[0] > self.max_batch_keys:
                break   # an oversized single request still forms a batch
            run.append(req)
            total += req.keys.shape[0]
            if total >= self.max_batch_keys:
                break
        whole_queue = len(run) == len(queue)
        waited = tick - head.submitted_tick
        if (whole_queue and total < self.max_batch_keys
                and waited < self.max_wait_ticks):
            self.held += 1
            return None
        queue.pop_n(len(run))
        self.batches += 1
        self.coalesced_requests += len(run)
        self.request_keys += total
        if head.op == "get":
            concat = np.concatenate([r.keys for r in run])
            uniq, inverse = np.unique(concat, return_inverse=True)
            scatter = []
            off = 0
            for r in run:
                scatter.append(inverse[off: off + r.keys.shape[0]])
                off += r.keys.shape[0]
            self.batch_keys += int(uniq.shape[0])
            return Batch("get", run, uniq, None, scatter)
        keys = np.concatenate([r.keys for r in run])
        values = None
        if head.op == "put" and head.values is not None:
            values = np.concatenate([r.values for r in run])
        self.batch_keys += int(keys.shape[0])
        return Batch(head.op, run, keys, values, None)
