"""IOPool — bounded host worker pool for the serving/storage I/O plane.

The tick loop must never block on file or arena I/O it could overlap
with device compute (the paper's §6 point: once the learned index
collapses indexing CPU, I/O dominates — so I/O must run beside the
accelerator, not in front of it).  This pool is the one place host
threads are created:

* **bounded** — a fixed worker count and an unbounded-but-accounted
  queue; ``depth()`` is exported as the ``io_pool_queue_depth`` gauge so
  saturation is visible instead of silent.
* **deterministic composition** — the pool itself promises nothing about
  completion order; callers that need request-order results use
  :class:`ValueFetch`, which scatters every task's output into a
  preallocated array at indices fixed *at submit time*.  Tasks write
  disjoint rows, so any completion order (and any pool size, 1..N)
  yields bit-identical results — the CI determinism gate relies on it.
* **no new dependencies** — plain ``threading`` + ``queue``; daemon
  workers die with the process.

Futures must be consumed: a submitted task whose :class:`IOFuture` is
dropped can fail silently (the exception is parked in the future).
bourbonlint's PAIRING rule flags unconsumed ``pool.submit`` /
``resolve_get_async`` handles statically, and HOTSYNC keeps blocking
device transfers out of ``submit``/``wait`` bodies.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Sequence

from repro_torch.obs import NULL_HANDLE

__all__ = ["IOFuture", "IOPool", "ValueFetch", "wait_all"]

_now = time.perf_counter


class IOFuture:
    """Result slot for one submitted task.  ``result()`` blocks until the
    task ran and re-raises its exception in the caller's thread — errors
    surface at the join point, never in a worker's stderr."""

    __slots__ = ("_ev", "_value", "_exc")

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._value: Any = None
        self._exc: BaseException | None = None

    def _finish(self, value: Any, exc: BaseException | None) -> None:
        self._value = value
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self) -> Any:
        self._ev.wait()
        if self._exc is not None:
            raise self._exc
        return self._value


def wait_all(futs: Sequence[IOFuture]) -> None:
    """Join a batch of futures (re-raising the first failure) — the
    consumption point PAIRING expects every submitted handle to reach."""
    for f in futs:
        f.result()


class IOPool:
    """Fixed-size daemon worker pool.  ``submit`` enqueues ``fn(*args)``
    and returns an :class:`IOFuture`; ``close`` drains and stops the
    workers (idempotent — a closed pool runs submitted work inline, so a
    shut-down server still completes stragglers deterministically)."""

    def __init__(self, workers: int = 2, name: str = "io") -> None:
        if workers < 1:
            raise ValueError("IOPool needs at least one worker")
        self.workers = int(workers)
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # accounting (exported through the server's io_pool_* metrics)
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.max_depth = 0
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}",
                             daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------------- submit
    def submit(self, fn: Callable, *args: Any) -> IOFuture:
        fut = IOFuture()
        if self._closed:
            # inline fallback keeps late stragglers correct (and ordered
            # by the caller's own join) instead of silently dropped
            try:
                fut._finish(fn(*args), None)
            except BaseException as exc:  # parked; re-raised at result()
                fut._finish(None, exc)
            return fut
        with self._lock:
            self.submitted += 1
            depth = self.submitted - self.completed
            if depth > self.max_depth:
                self.max_depth = depth
        self._q.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            try:
                fut._finish(fn(*args), None)
            except BaseException as exc:
                fut._finish(None, exc)
            with self._lock:
                self.completed += 1

    # ------------------------------------------------------------- lifecycle
    def depth(self) -> int:
        """Tasks submitted but not yet completed (queued + running)."""
        with self._lock:
            return self.submitted - self.completed

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers,
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "depth": self.submitted - self.completed,
                    "max_depth": self.max_depth}


class ValueFetch:
    """Handle for an in-flight batched value materialization.

    ``tasks`` are closures that each scatter one chunk's values into a
    caller-owned preallocated array at indices fixed before submission
    (disjoint rows per task), so results land in request order no matter
    which worker finishes first — pool size 1 and N are bit-identical.
    With a pool the tasks start immediately and ``wait()`` joins them;
    without one (``pool=None``) the tasks run inside ``wait()``, which
    is exactly the old synchronous resolve path.

    ``wait()`` is idempotent, times the *exposed* wait under the
    ``value_fetch`` stage handle, and reports (hidden_us, exposed_us) to
    ``on_done`` — the raw material for the fleet's value-fetch overlap
    ratio (hidden = fetch time that ran concurrently with other host or
    device work before the caller blocked)."""

    __slots__ = ("_result", "_tasks", "_futs", "_stage", "_on_done",
                 "_t0", "_done", "span")

    def __init__(self, result: Any, tasks: Sequence[Callable],
                 pool: IOPool | None = None, stage=NULL_HANDLE,
                 on_done: Callable | None = None, span=None) -> None:
        self._result = result
        self._stage = stage
        self._on_done = on_done
        # causal-tracing span of the blocking half (repro.obs.trace): the
        # producer parks it here so the join site can flow-link its
        # exposed wait back to the worker-side io_task span
        self.span = span
        self._done = False
        self._t0 = _now()
        if pool is not None and tasks:
            self._tasks: Sequence[Callable] = ()
            self._futs = [pool.submit(t) for t in tasks]
        else:
            self._tasks = tuple(tasks)
            self._futs = []

    def done(self) -> bool:
        return self._done

    def wait(self) -> Any:
        """Block until every chunk landed; returns the result object the
        fetch was created with (e.g. the (found, vals) pair)."""
        if self._done:
            return self._result
        self._done = True
        t_wait = _now()
        t0 = self._stage.begin()
        if self._futs:
            wait_all(self._futs)
        else:
            for t in self._tasks:
                t()
        self._stage.end(t0)
        if self._on_done is not None:
            # hidden time is only real when workers actually ran the
            # tasks concurrently; the inline path exposes everything
            hidden = (t_wait - self._t0) if self._futs else 0.0
            self._on_done(hidden * 1e6, (_now() - t_wait) * 1e6)
        return self._result
