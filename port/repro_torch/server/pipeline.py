"""PipelinedServer — multi-batch in-flight request serving.

The synchronous :class:`~repro_torch.server.frontend.BourbonServer` runs
admission -> multi-get -> host sync -> maintenance strictly in sequence:
every coalesced batch blocks the host (the device-to-host copy) before
the next one can even be formed, and every tick pays a full maintenance
round.  This server splits the read path into the store's
*dispatch*/*resolve* halves (``ShardedStore.dispatch_get`` /
``resolve_get``, asynchronous CUDA launches underneath) and keeps up to ``max_inflight`` read batches
outstanding, so the host admits, dedups, and cache-probes batch N+1
while the device computes batch N.

Pipeline rules (the invariants the tests assert):

* **one epoch per pipeline** — every in-flight batch is pinned to the
  single epoch-versioned device state that was current at its dispatch,
  and nothing between two barriers may move the epochs: writes drain the
  pipeline first, and maintenance (which can roll memtables through GC
  relocation) runs only in the bubble after a drain.  Each batch is
  answered under exactly one epoch vector — snapshot consistency per
  batch is preserved by construction, and ``epoch_violations`` counts
  (and a drain repairs) any dispatch that would break it.
* **writes are barriers** — a write run at the queue front retires every
  in-flight read (those were admitted earlier, so they legitimately see
  the pre-write snapshot), then applies, then invalidates the cache.  A
  GET submitted after a PUT can therefore never see the pre-PUT value:
  the batcher never reorders ops, and the read dispatches only after the
  write applied.
* **maintenance rides the bubble** — coordinator rounds and store
  learning ticks run when the pipeline is drained (after a write
  barrier, on idle, or at most every ``bubble_every_ticks`` ticks), not
  on every tick.  ``force_drain_ticks`` bounds maintenance staleness
  under sustained read load by forcing a drain when no bubble happened
  for that long.
* **backpressure** — a full pipeline admits no more read batches; the
  bounded queue then fills and rejects, exactly the closed-loop contract
  of the synchronous server.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from .admission import Batch, ServerRequest
from .frontend import BourbonServer, ServerConfig

__all__ = ["PipelineConfig", "PipelinedServer"]


@dataclasses.dataclass
class PipelineConfig(ServerConfig):
    # read batches allowed in flight at once; 1 degenerates to the
    # synchronous dispatch-then-resolve order (still async inside a tick)
    max_inflight: int = 4
    # batches carried in flight across the tick boundary (capped at
    # max_inflight - 1): a carried batch overlaps device compute with the
    # clients' submit phase and the next tick's admission, so its resolve
    # wait is ~zero.  0 = retire everything dispatched within its tick
    carry: int = 2
    # run the bubble work (store ticks + coordinator round) at most once
    # per this many ticks when drain points are frequent — the sync
    # server pays it every tick
    bubble_every_ticks: int = 8
    # under sustained read load the pipeline may never drain on its own;
    # force a drain (and a maintenance bubble) after this many ticks
    # without one, so GC/checkpointing is delayed, never starved
    force_drain_ticks: int = 64


@dataclasses.dataclass
class _InflightRead:
    """One read batch between dispatch and retire."""
    batch: Batch
    found: np.ndarray          # (U,) over the batch's deduped keys
    vals: np.ndarray           # (U, value_size), cache hits prefilled
    miss: np.ndarray           # (U,) keys the store is answering
    pending: object            # ShardPendingBatch (store dispatch handle)
    dispatch_tick: int
    # obs: wall stamp from the compute stage handle at dispatch (0.0 when
    # the tick is unsampled) — "compute" is the in-flight span, the time
    # the device had to finish the batch before resolve blocked on it
    t_dispatch: float = 0.0
    # ValueFetch handle between _begin_retire and _finish_retire: the
    # batch's value-log reads running on the I/O pool while later batches
    # begin their own retire (or the next dispatch proceeds)
    fetch: object = None
    # causal-tracing spans (None when no member request is sampled): the
    # fan-in batch span, and the open device_compute span that crosses
    # tick boundaries with the in-flight batch
    tr_batch: object = None
    tr_compute: object = None


class PipelinedServer(BourbonServer):
    """Drop-in sibling of ``BourbonServer`` with a pipelined read path.
    Same admission/batching/cache/coordinator machinery (inherited),
    same request objects — only the tick loop overlaps instead of
    serializing.  Submits feel backpressure one layer out: with the
    pipeline at ``max_inflight`` the queue stops draining and rejects."""

    def __init__(self, store, cfg: PipelineConfig | None = None) -> None:
        cfg = cfg if cfg is not None else PipelineConfig()
        if cfg.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        super().__init__(store, cfg)
        self._inflight: deque[_InflightRead] = deque()
        self._last_bubble = 0
        # pipeline accounting
        self.batches_dispatched = 0
        self.batches_retired = 0
        self.cache_only_batches = 0     # answered without a store dispatch
        self.write_barriers = 0
        self.bubbles = 0
        self.forced_drains = 0
        self.max_depth_seen = 0
        self.epoch_violations = 0       # dispatches that saw a moved epoch

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # ----------------------------------------------------------------- tick
    def tick(self) -> list[ServerRequest]:
        """One pipelined iteration: fill the pipeline (dispatches are
        non-blocking), honor write barriers, then retire what the device
        finished — resolving only after all of this tick's admission work
        has been overlapped with the device compute.  Returns the
        requests completed this tick."""
        done: list[ServerRequest] = []
        tick_no = self._tr.begin_tick()
        # prefetch the blocking halves: every batch already in flight had
        # its device work dispatched on an earlier tick, so start each
        # one's resolve (device sync + merge + value fetch) on the I/O
        # pool now — the workers chew on batch N while this tick admits
        # and dispatches batch N+1.  Without a pool the ValueFetch defers
        # its task to wait(), reproducing the old serial order, and the
        # results are bit-identical either way.
        for fl in self._inflight:
            self._begin_retire(fl)
        admitted = 0
        wrote = False
        while admitted < self.cfg.max_batches_per_tick:
            head = self.queue.head()
            if head is None:
                break
            if head.op == "get" and len(self._inflight) >= self.cfg.max_inflight:
                break                       # pipeline full: backpressure
            t0 = self._st_coalesce.begin()
            batch = self.batcher.next_batch(self.queue, self.ticks)
            self._st_coalesce.end(t0)
            if batch is None:
                break                       # batcher holding a partial run
            if batch.op == "get":
                done.extend(self._dispatch_reads(batch))
            else:
                # write barrier: every in-flight read resolves under the
                # pre-write snapshot it was pinned to, then the write
                # applies, then the cache drops the superseded keys
                done.extend(self._drain())
                self._apply_writes(batch)
                done.extend(batch.requests)
                self.write_barriers += 1
                wrote = True
            admitted += 1
        # retire: keep up to ``carry`` batches in flight across the tick
        # boundary — a carried batch computes through the clients' next
        # submit phase and the following admission, so by the time it is
        # retired the resolve wait is ~zero (the whole device latency is
        # hidden).  When this tick neither admitted nor has queued work,
        # there is no overlap partner left — drain so results are not
        # held back from idle clients
        if admitted == 0 and len(self.queue) == 0:
            done.extend(self._drain())
        else:
            target = max(0, min(self.cfg.carry, self.cfg.max_inflight - 1))
            to_retire: list[_InflightRead] = []
            while len(self._inflight) > target:
                to_retire.append(self._inflight.popleft())
            done.extend(self._retire_many(to_retire))
        if (self._inflight
                and self.ticks - self._last_bubble
                >= self.cfg.force_drain_ticks):
            done.extend(self._drain())      # bounded maintenance staleness
            self.forced_drains += 1
        if not done and not self._inflight:
            # an idle tick is still the passage of (virtual) time
            for sh in self.store.shards:
                sh.clock.advance(self.cfg.idle_tick_us)
        self._maybe_bubble(idle=not done and len(self.queue) == 0)
        m = self.store.maintenance_us()
        self.max_maintenance_tick_us = max(self.max_maintenance_tick_us,
                                           m - self._maint_us_seen)
        self._maint_us_seen = m
        if wrote:
            # durability barrier before acknowledging: every write batch
            # this tick applied becomes durable under ONE coalesced
            # group-commit sync per shard (a no-op per-append writer makes
            # this free) — the WAL commit contract's sync point
            wsp = self._ct.begin_span("wal_sync", self._wal_parent)
            self.store.wal_sync()
            self._ct.end_span(wsp)
            self._wal_parent = None
        for r in done:
            r.completed_tick = self.ticks
            r.done = True
            self._ct.complete(r.trace, tick=self.ticks)
        self.completed += len(done)
        self._tr.end_tick(tick_no)
        self.ticks += 1
        return done

    def run_until_drained(self, max_ticks: int = 100000
                          ) -> list[ServerRequest]:
        out: list[ServerRequest] = []
        for _ in range(max_ticks):
            if not len(self.queue) and not self._inflight:
                break
            out.extend(self.tick())
        return out

    # ----------------------------------------------------------------- reads
    def _dispatch_reads(self, batch: Batch) -> list[ServerRequest]:
        """Probe the cache and launch the store lookup for the misses —
        non-blocking.  Returns completed requests only when the cache
        answered the whole batch (no store work to wait on)."""
        uniq = batch.keys
        bt = self._ct.join_batch(batch.requests)
        vals = np.zeros((uniq.shape[0], self._value_size), np.uint8)
        found = np.zeros(uniq.shape[0], bool)
        if self.cache is not None:
            t0 = self._st_cache.begin()
            hit = self.cache.lookup(uniq, self.store.shard_epochs(), vals)
            self._st_cache.end(t0)
            found |= hit
            self.served_from_cache += int(hit.sum())
        else:
            hit = np.zeros(uniq.shape[0], bool)
        miss = ~hit
        if not miss.any():
            self.cache_only_batches += 1
            self._ct.end_span(bt)
            return self._scatter(batch, found, vals, epochs=None)
        t0 = self._st_dispatch.begin()
        dsp = self._ct.begin_span("dispatch", bt)
        pb = self.store.dispatch_get(uniq[miss], with_values=True,
                                     trace=dsp)
        self._ct.end_span(dsp, stage="dispatch")
        self._st_dispatch.end(t0)
        completed: list[ServerRequest] = []
        if (self._inflight
                and pb.epochs != self._inflight[0].pending.epochs):
            # should be unreachable (writes barrier, maintenance runs in
            # bubbles): an epoch moved mid-pipeline.  Count it and repair
            # by retiring the old-epoch batches now — each batch still
            # resolves under the single state it was pinned to
            self.epoch_violations += 1
            completed = self._drain()
        self._inflight.append(_InflightRead(batch, found, vals, miss, pb,
                                            self.ticks,
                                            self._st_compute.begin(),
                                            tr_batch=bt,
                                            tr_compute=self._ct.begin_span(
                                                "device_compute", bt)))
        self.batches_dispatched += 1
        self.max_depth_seen = max(self.max_depth_seen, len(self._inflight))
        return completed

    def _begin_retire(self, fl: _InflightRead) -> _InflightRead:
        """Non-blocking first half of a retire: hand the batch's blocking
        half (device sync + merge + value fetch) to the I/O pool.  With a
        pool attached, beginning several retires before finishing any
        overlaps their resolves with each other and with the next batch's
        device dispatch; without one the work runs inside
        :meth:`_finish_retire`, the original serial order.  Idempotent —
        the tick-start prefetch may begin a batch that a drain later this
        tick begins again."""
        if fl.fetch is not None:
            return fl
        t0 = self._st_resolve.begin()
        fl.fetch = self.store.resolve_get_async(fl.pending)
        self._st_resolve.end(t0)
        # compute = dispatch->retire in-flight span: how long the device
        # had before the host blocked on this batch (crosses ticks; the
        # handle no-ops when the dispatch tick was unsampled)
        self._st_compute.end(fl.t_dispatch)
        self._ct.end_span(fl.tr_compute, stage="device_compute")
        return fl

    def _finish_retire(self, fl: _InflightRead) -> list[ServerRequest]:
        """Blocking second half: join the value fetch and fan the results
        back out."""
        # the exposed join: flow-linked from the io_task span that ran
        # the blocking half on the pool (fan-in back onto the tick loop)
        vsp = self._ct.begin_span("value_fetch", fl.tr_batch,
                                  link=fl.fetch.span)
        f, v = fl.fetch.wait()
        self._ct.end_span(vsp, stage="value_fetch")
        fl.found[fl.miss] = f
        fl.vals[fl.miss] = v
        self.store_probe_keys += int(fl.miss.sum())
        self._charge_read_clocks(fl.pending.owner)
        pos = np.nonzero(fl.miss)[0][f]
        # fill under the batch's pinned epoch vector — equal to the live
        # one (writes barrier; maintenance runs in bubbles)
        self._fill_cache(fl.batch.keys[pos], fl.vals[pos],
                         fl.pending.epochs)
        self.batches_retired += 1
        self._ct.end_span(fl.tr_batch)
        return self._scatter(fl.batch, fl.found, fl.vals,
                             epochs=fl.pending.epochs)

    def _retire(self, fl: _InflightRead) -> list[ServerRequest]:
        """Resolve one in-flight batch and fan the results back out."""
        return self._finish_retire(self._begin_retire(fl))

    def _retire_many(self, fls: list[_InflightRead]) -> list[ServerRequest]:
        """Retire a group: begin every batch's value fetch before joining
        any, so the fetches run side by side on the I/O pool.  Requests
        still complete in pipeline (dispatch) order — the joins are
        ordered, only the I/O underneath is concurrent."""
        out: list[ServerRequest] = []
        for fl in fls:
            self._begin_retire(fl)
        for fl in fls:
            out.extend(self._finish_retire(fl))
        return out

    def _scatter(self, batch: Batch, found, vals, epochs) -> list:
        for req, idx in zip(batch.requests, batch.scatter):
            req.found = found[idx]
            req.result = vals[idx]
            # the single epoch vector this request was answered under —
            # None when the cache answered everything (cache entries are
            # themselves epoch-stamped); tests assert on it
            req.epochs_served = epochs
        return batch.requests

    def _drain(self) -> list[ServerRequest]:
        """Retire every in-flight batch (pipeline barrier)."""
        fls = list(self._inflight)
        self._inflight.clear()
        return self._retire_many(fls)

    # ----------------------------------------------------------- maintenance
    def _maybe_bubble(self, idle: bool) -> None:
        """Run the bubble work — store learning ticks plus one
        coordinator round — only at a drain point, and (unless idle or
        just past a barrier) at most every ``bubble_every_ticks``."""
        if self._inflight:
            return                          # not a drain point
        due = (idle
               or self.ticks - self._last_bubble
               >= self.cfg.bubble_every_ticks)
        if not due:
            return
        msp = self._ct.begin_maintenance(self.ticks, kind="bubble")
        for sh in self.store.shards:
            sh._tick()
        if self.coordinator is not None:
            self.coordinator.tick()
        self._ct.end_maintenance(msp)
        self._last_bubble = self.ticks
        self.bubbles += 1

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        out = super().stats()
        out["pipeline"] = {
            "max_inflight": self.cfg.max_inflight,
            "inflight": len(self._inflight),
            "dispatched": self.batches_dispatched,
            "retired": self.batches_retired,
            "cache_only_batches": self.cache_only_batches,
            "write_barriers": self.write_barriers,
            "bubbles": self.bubbles,
            "forced_drains": self.forced_drains,
            "max_depth_seen": self.max_depth_seen,
            "epoch_violations": self.epoch_violations,
        }
        return out
