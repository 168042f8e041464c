"""BourbonServer — the batched request-serving front end (a copy of
``repro.server.frontend``, over the port's ``ShardedStore``).

The tick loop:

    clients --submit--> RequestQueue --Batcher--> coalesced batch
        GET:  HotKeyCache probe -> ShardedStore.get_batch (one
              snapshot-consistent multi-get per batch) -> cache fill
              -> scatter results back to each request
        PUT/DELETE: ShardedStore write batch -> cache invalidation
    then one FleetMaintenanceCoordinator round (budgeted, staggered)

Snapshot consistency: a read batch is answered by exactly one
epoch-versioned device state — ``ShardedStore.get_batch`` resolves the
whole coalesced key set against one ``device_state()`` (plus the
per-shard memtable overlays), so two requests coalesced into the same
batch can never observe different snapshots of the same shard.  Cache
hits are values read under the *current* epoch vector (stale epochs
miss), so they are consistent with what the store would answer now.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.io import IOPool
from repro_torch.obs import NULL_CTRACE, NULL_TRACER, Obs, ObsConfig, publish_stats

from .admission import Batch, Batcher, RequestQueue, ServerRequest
from .cache import HotKeyCache
from .coordinator import CoordinatorConfig, FleetMaintenanceCoordinator

__all__ = ["ServerConfig", "BourbonServer"]


@dataclasses.dataclass
class ServerConfig:
    max_batch_keys: int = 1024      # coalesced keys per store batch
    max_wait_ticks: int = 2         # ticks a partial batch may wait
    queue_capacity: int = 256       # requests; full queue = backpressure
    max_batches_per_tick: int = 4   # queue drains per tick (reads+writes)
    # virtual μs an *idle* tick represents: with no requests to serve,
    # shard clocks still move, so ski-rental T_waits (learning and GC
    # candidacy) expire instead of freezing with the workload
    idle_tick_us: float = 64.0
    cache_slots: int = 4096         # 0 disables the HotKeyCache
    # host I/O pool workers (repro_torch.io.IOPool): 0 keeps every fetch,
    # write fan-out, and WAL sync inline; N > 0 overlaps value-log reads
    # with device compute and runs per-shard dispatch concurrently.
    # Results are bit-identical for any value
    # (tests/test_torch_pipeline.py holds them to it)
    io_workers: int = 0
    coordinate_maintenance: bool = True
    coordinator: CoordinatorConfig = dataclasses.field(
        default_factory=CoordinatorConfig)
    # observability plane (repro_torch.obs): the server owns one Obs bundle,
    # attaches the whole store fleet to it, and times the read-path
    # stages through pre-bound handles.  enabled=False skips everything
    # (null objects on the hot path — the obs-off bench arm)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)


class BourbonServer:
    def __init__(self, store, cfg: ServerConfig | None = None) -> None:
        self.store = store
        self.cfg = cfg if cfg is not None else ServerConfig()
        self.queue = RequestQueue(self.cfg.queue_capacity)
        self.batcher = Batcher(self.cfg.max_batch_keys,
                               self.cfg.max_wait_ticks)
        self.cache = (HotKeyCache(self.cfg.cache_slots)
                      if self.cfg.cache_slots else None)
        self.coordinator = (
            FleetMaintenanceCoordinator(store, self.cfg.coordinator)
            if self.cfg.coordinate_maintenance else None)
        self.ticks = 0
        self.completed = 0
        self.served_from_cache = 0   # keys answered without a store probe
        self.store_probe_keys = 0    # keys that did reach the store
        # fleet-stall metric, valid with OR without the coordinator: the
        # largest maintenance charge observed within one server tick
        self.max_maintenance_tick_us = 0.0
        self._maint_us_seen = store.maintenance_us()
        self._value_size = store.shards[0].cfg.value_size
        # host I/O plane: the server owns the pool (like the Obs bundle)
        # and joins the whole store fleet to it; shutdown() closes it
        self.io = IOPool(self.cfg.io_workers) if self.cfg.io_workers else None
        if self.io is not None:
            store.attach_io(self.io)
        else:
            store.detach_io()   # a pool a previous server attached
        # observability: one Obs bundle per server; stage handles are
        # pre-bound here so the per-batch cost is attribute reads only.
        # Obs-off servers hold the null tracer — same call sites, no
        # branches, (near-)zero cost: the bench's obs-off arm
        self.obs = Obs(self.cfg.obs) if self.cfg.obs.enabled else None
        tr = self.obs.tracer if self.obs is not None else NULL_TRACER
        self._tr = tr
        # causal tracer: one identity test per call site when tracing is
        # off (NULL_CTRACE) or the request is unsampled (trace is None)
        self._ct = self.obs.ctrace if self.obs is not None else NULL_CTRACE
        self._wal_parent = None    # last traced write batch span this tick
        self._st_admission = tr.stage("admission")
        self._st_coalesce = tr.stage("coalesce")
        self._st_cache = tr.stage("cache_probe")
        self._st_dispatch = tr.stage("dispatch")
        self._st_compute = tr.stage("compute")
        self._st_resolve = tr.stage("resolve")
        if self.obs is not None:
            store.attach_obs(self.obs)
            self.obs.registry.register_collector("server",
                                                 self._collect_obs)
            if self.io is not None:
                self.obs.registry.register_collector("io_pool",
                                                     self._collect_io_obs)
        else:
            # an obs-off server must serve a truly uninstrumented store,
            # even one a previous (obs-on) server attached: the overhead
            # bench compares clean arms
            store.detach_obs()

    def shutdown(self) -> None:
        """Release the host I/O plane: detach the fleet and stop the pool
        workers.  Idempotent; the store itself stays open (a closed pool
        would run any straggler inline, so this is always safe)."""
        if self.io is not None:
            self.store.detach_io()
            self.io.close()

    # ------------------------------------------------------------ admission
    def submit(self, req: ServerRequest) -> bool:
        """Enqueue a request; False means the queue is full (backpressure —
        retry after a tick)."""
        t0 = self._st_admission.begin()
        ok = self.queue.submit(req, self.ticks)
        if ok and req.trace is None:
            # mint the causal trace at admission (countdown-sampled; a
            # backpressured retry keeps its original trace)
            req.trace = self._ct.admit(self.ticks)
        self._st_admission.end(t0)
        return ok

    # ----------------------------------------------------------------- tick
    def tick(self) -> list[ServerRequest]:
        """One server iteration: drain up to ``max_batches_per_tick``
        coalesced batches, then run one maintenance-coordination round.
        Returns the requests completed this tick."""
        done: list[ServerRequest] = []
        tick_no = self._tr.begin_tick()
        wrote = False
        for _ in range(self.cfg.max_batches_per_tick):
            t0 = self._st_coalesce.begin()
            batch = self.batcher.next_batch(self.queue, self.ticks)
            self._st_coalesce.end(t0)
            if batch is None:
                break
            if batch.op == "get":
                self._serve_reads(batch)
            else:
                self._apply_writes(batch)
                wrote = True
            done.extend(batch.requests)
        if wrote:
            # durability barrier before acknowledging: all write batches
            # applied this tick coalesce into ONE group-commit sync per
            # shard (no-op under the per-append writer) — the WAL commit
            # contract's sync point
            wsp = self._ct.begin_span("wal_sync", self._wal_parent)
            self.store.wal_sync()
            self._ct.end_span(wsp)
            self._wal_parent = None
        if not done:
            # an idle tick is still the passage of (virtual) time: advance
            # the shard clocks so T_waits (learning and GC candidacy)
            # expire instead of freezing with the workload
            for sh in self.store.shards:
                sh.clock.advance(self.cfg.idle_tick_us)
        # every tick gives the stores their own tick: the learning
        # executor progresses (and, when no coordinator owns maintenance,
        # the shards self-drive GC/checkpointing) under any load shape —
        # _maintenance_tick no-ops on deferred shards, so this never
        # bypasses the coordinator's budget
        msp = self._ct.begin_maintenance(self.ticks, kind="tick")
        for sh in self.store.shards:
            sh._tick()
        if self.coordinator is not None:
            self.coordinator.tick()
        self._ct.end_maintenance(msp)
        m = self.store.maintenance_us()
        self.max_maintenance_tick_us = max(self.max_maintenance_tick_us,
                                           m - self._maint_us_seen)
        self._maint_us_seen = m
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
            if not len(self.queue):
                break
            out.extend(self.tick())
        return out

    # ----------------------------------------------------------------- reads
    def _serve_reads(self, batch: Batch) -> None:
        uniq = batch.keys
        bt = self._ct.join_batch(batch.requests)
        vals = np.zeros((uniq.shape[0], self._value_size), np.uint8)
        found = np.zeros(uniq.shape[0], bool)
        if self.cache is not None:
            # the epoch vector is stable across the whole read path (only
            # writes flush/compact), so one capture stamps both the cache
            # probe and the fill below
            epochs = self.store.shard_epochs()
            t0 = self._st_cache.begin()
            hit = self.cache.lookup(uniq, epochs, vals)
            self._st_cache.end(t0)
            found |= hit
            self.served_from_cache += int(hit.sum())
        else:
            hit = np.zeros(uniq.shape[0], bool)
            epochs = None                  # no cache: _fill_cache no-ops
        miss = ~hit
        if miss.any():
            # the synchronous path still splits dispatch from resolve so
            # the stage breakdown is comparable with the pipelined
            # server's; "compute" here is the whole dispatch->resolve
            # span (nothing overlaps it)
            tc = self._st_compute.begin()
            csp = self._ct.begin_span("device_compute", bt)
            t0 = self._st_dispatch.begin()
            dsp = self._ct.begin_span("dispatch", bt)
            pb = self.store.dispatch_get(uniq[miss], with_values=True,
                                         trace=dsp)
            self._ct.end_span(dsp, stage="dispatch")
            self._st_dispatch.end(t0)
            t0 = self._st_resolve.begin()
            vsp = self._ct.begin_span("value_fetch", bt)
            f, v = self.store.resolve_get(pb)
            self._ct.end_span(vsp, stage="value_fetch")
            self._st_resolve.end(t0)
            self._ct.end_span(csp, stage="device_compute")
            self._st_compute.end(tc)
            found[miss] = f
            vals[miss] = v
            self.store_probe_keys += int(miss.sum())
            self._charge_read_clocks(self.store.shard_of(uniq[miss]))
            pos = np.nonzero(miss)[0][f]
            self._fill_cache(uniq[pos], vals[pos], epochs)
        for req, idx in zip(batch.requests, batch.scatter):
            req.found = found[idx]
            req.result = vals[idx]
        self._ct.end_span(bt)

    def _charge_read_clocks(self, owners_probed: np.ndarray) -> None:
        """Charge read service time to the owning shards' virtual clocks
        (ShardedStore.get_batch itself charges nothing), so sustained
        read-only load still moves time forward and maintenance/learning
        deadlines keep becoming due."""
        for i, sh in enumerate(self.store.shards):
            n_i = int((owners_probed == i).sum())
            if n_i:
                sh.clock.advance(n_i * sh.cfg.costs.t_pm)

    def _fill_cache(self, keys: np.ndarray, vals: np.ndarray,
                    epochs: tuple) -> None:
        """Admit found keys read under ``epochs`` into the HotKeyCache."""
        if self.cache is not None and keys.shape[0]:
            self.cache.fill(keys, vals, self.store.shard_of(keys), epochs)

    # ---------------------------------------------------------------- writes
    def _apply_writes(self, batch: Batch) -> None:
        bt = self._ct.join_batch(batch.requests, kind="write")
        # arm the ambient write span: WAL appends issued while applying
        # this batch parent under it (ended by the commit group's fsync)
        self._ct.set_write(bt)
        if batch.op == "put":
            self.store.put_batch(batch.keys, batch.values)
        else:
            self.store.delete_batch(batch.keys)
        self._ct.set_write(None)
        if self.cache is not None:
            self.cache.invalidate(batch.keys)
        self._ct.end_span(bt)
        if bt is not None:
            self._wal_parent = bt

    # ------------------------------------------------------------------- obs
    def _collect_obs(self, reg) -> None:
        """Snapshot-time collector: curated monotonic counters for the
        serving totals, then the whole layered ``stats()`` dict (minus
        the store subtree, which the store/fleet collectors already
        publish under their own shard labels) flattened into gauges."""
        c = reg.counter
        c("server_submitted_total").observe_total(self.queue.submitted)
        c("server_rejected_total").observe_total(self.queue.rejected)
        c("server_completed_total").observe_total(self.completed)
        c("server_ticks_total").observe_total(self.ticks)
        c("server_batches_total").observe_total(self.batcher.batches)
        c("server_served_from_cache_total").observe_total(
            self.served_from_cache)
        c("server_store_probe_keys_total").observe_total(
            self.store_probe_keys)
        if self.cache is not None:
            cs = self.cache.stats()
            for k in ("hits", "misses", "fills", "evictions",
                      "inval_epoch", "inval_write"):
                c(f"cache_{k}_total").observe_total(cs[k])
        s = {k: v for k, v in self.stats().items() if k != "store"}
        publish_stats(reg, "server", s)

    def _collect_io_obs(self, reg) -> None:
        """Host I/O pool health: queue depth says whether the workers keep
        up (a persistently deep queue means fetches are backing up behind
        too few workers); tasks_total is the lifetime submit count."""
        ps = self.io.stats()
        g = reg.gauge
        g("io_pool_workers").set(ps["workers"])
        g("io_pool_queue_depth").set(ps["depth"])
        g("io_pool_max_depth").set(ps["max_depth"])
        reg.counter("io_pool_tasks_total").observe_total(ps["submitted"])

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        b = self.batcher
        return {
            "ticks": self.ticks,
            "submitted": self.queue.submitted,
            "rejected": self.queue.rejected,
            "completed": self.completed,
            "queued": len(self.queue),
            "batches": b.batches,
            "coalesced_requests": b.coalesced_requests,
            "request_keys": b.request_keys,
            "batch_keys": b.batch_keys,
            "held": b.held,
            "served_from_cache": self.served_from_cache,
            "store_probe_keys": self.store_probe_keys,
            "max_maintenance_tick_us": self.max_maintenance_tick_us,
            "cache": self.cache.stats() if self.cache is not None else None,
            "io": self.io.stats() if self.io is not None else None,
            "coordinator": (self.coordinator.stats()
                            if self.coordinator is not None else None),
            "store": self.store.stats(),
        }
