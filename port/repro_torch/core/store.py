"""BourbonStore — the public facade tying the pieces together.

Modes
-----
* ``mode="wisckey"``      — baseline (no learning, binary-search path).
* ``mode="bourbon"``      — file-granularity learning with a policy:
    - ``policy="cba"``     cost-benefit analyzer (the paper's default)
    - ``policy="always"``  learn every file (Bourbon-always)
    - ``policy="offline"`` only the initially loaded data is learned
    - ``policy="never"``   never learn (= wisckey but keeps CBA accounting)
* ``granularity="level"`` — level models (read-only friendly, §4.3).

Writes go memtable -> L0 -> compaction (host, numpy); reads are batched
lookups through :class:`LookupEngine`, whose descent runs the CUDA kernels
on the card.  A virtual microsecond clock (clock.py) drives T_wait /
lifetimes / Fig-13-style accounting exactly as in ``repro.core.store``.

A store opened on a directory (``BourbonStore.open``) is durable through
``repro_torch.storage``, which writes the same bytes as ``repro.storage``:
a directory written by either package opens in the other.  The obs plane
is not ported yet (``attach_obs`` raises).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from repro_torch.obs import NULL_HANDLE

from .cba import (CBAConfig, LearningExecutor, MaintenanceConfig,
                  MaintenanceScheduler)
from .clock import CostModel, VirtualClock
from .engine import EngineConfig, LookupEngine, LookupResult, PendingLookup
from .filters import FilterConfig, build_level_filter, filter_maybe_np
from .lsm import LSMConfig, LSMTree, N_LEVELS
from .memtable import MemTable
from .valuelog import ValueLog

__all__ = ["StoreConfig", "BourbonStore", "PendingBatch"]

_PAD_PROBE = -(1 << 62)

# below this batch size a pooled value fetch costs more in hand-off than
# the arena read itself; resolve stays inline
_IO_FETCH_CHUNK = 4096


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class StoreConfig:
    mode: str = "bourbon"             # wisckey | bourbon
    granularity: str = "file"         # file | level
    policy: str = "cba"               # cba | always | offline | never
    lsm: LSMConfig = dataclasses.field(default_factory=LSMConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    cba: CBAConfig = dataclasses.field(default_factory=CBAConfig)
    costs: CostModel = dataclasses.field(default_factory=CostModel)
    maintenance: MaintenanceConfig = dataclasses.field(
        default_factory=MaintenanceConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    value_size: int = 64
    fetch_values: bool = False
    # durability (repro_torch.storage): None = in-memory store
    storage_dir: str | None = None
    vlog_seg_slots: int = 1 << 12     # value-log entries per segment file
    fsync: bool = False               # fsync every append (power-loss safe)
    # group-commit WAL (storage.wal.GroupCommitWAL): put_batch
    # acknowledges once the frame is queued and ordered; durability is at
    # the next wal_sync() — many batches coalesce into one fsync.  False
    # keeps the per-append writer (durable before put_batch returns)
    wal_group_commit: bool = False
    device: str = "cuda"              # the engine's device ("cpu": plain ops)

    def __post_init__(self):
        self.engine.plr_delta = self.lsm.plr_delta
        self.engine.bloom_k = self.lsm.bloom_k
        self.engine.fetch_values = self.fetch_values
        self.engine.device = self.device
        self.cba.policy = self.policy


class _HostLookupRes:
    """Shape-compatible stand-in for LookupResult when a small remainder
    was answered host-side: only the per-file counters _account_lookup
    reads."""

    __slots__ = ("pos_counts", "neg_counts")

    def __init__(self, pos_counts, neg_counts):
        self.pos_counts = pos_counts
        self.neg_counts = neg_counts


@dataclasses.dataclass
class PendingBatch:
    """Dispatch half of a batched GET: the memtable overlay is already
    answered host-side, the engine part is in flight on the device
    (`PendingLookup`), and the whole handle is pinned to the device-state
    snapshot that was current at dispatch.  `BourbonStore.resolve_get`
    is the synchronization point — accounting, learning ticks, and value
    fetches all happen there, so dispatching N+1 never blocks on N."""
    probes: np.ndarray                 # (B,) int64, as submitted
    found: np.ndarray                  # (B,) bool, memtable hits prefilled
    vptr: np.ndarray                   # (B,) int64, memtable hits prefilled
    miss: np.ndarray                   # (B,) bool, keys the engine answers
    n_miss: int
    pending: PendingLookup | None      # None when the memtable answered all
    resolved: bool = False


class BourbonStore:
    def __init__(self, cfg: StoreConfig) -> None:
        if cfg.granularity not in ("file", "level"):
            raise ValueError(f"unknown granularity {cfg.granularity!r}")
        self.cfg = cfg
        # the engine first: it raises when the device is missing
        self.engine = LookupEngine(cfg.engine)
        self.clock = VirtualClock()
        self.tree = LSMTree(cfg.lsm)
        self.memtable = MemTable(cfg.lsm.memtable_cap)
        # durable stores get a DurableValueLog from _attach_storage below —
        # don't allocate a throwaway in-memory arena for them
        self.vlog = (ValueLog(cfg.value_size, device=cfg.engine.device)
                     if cfg.storage_dir is None else None)
        self.cba = MaintenanceScheduler(cfg.cba, cfg.costs, cfg.maintenance)
        self.executor = LearningExecutor(self.cba, cfg.costs,
                                         cfg.cba.learner_slots,
                                         cfg.lsm.plr_delta, cfg.engine.seg_cap)
        self.level_models: list = [None] * N_LEVELS
        self._level_model_versions = [-1] * N_LEVELS
        # filter plane: per-level bloom filters ahead of the PLR descent
        # (core.filters).  Rebuilt lazily at dispatch when a level's
        # version moved; CBA picks bits-per-key from observed miss traffic
        self.level_filters: list = [None] * N_LEVELS
        self._filter_versions = [-1] * N_LEVELS
        self._filter_sized_at: dict[int, int] = {}  # level -> stat files seen
        self._flt_persisted: dict[int, int] = {}    # level -> epoch on disk
        self.filters_recovered = 0
        self.filters_built = 0
        self.filter_screened = 0       # keys answered "absent" pre-dispatch
        self.filter_screen_total = 0   # keys the host screen examined
        self.filter_host_answered = 0  # post-screen keys answered host-side
        self._pending_wait: list = []
        self._seq = 0
        self._dead_seen = 0
        # accounting (Fig 13)
        self.foreground_us = 0.0
        self.lookups_model_path = 0
        self.lookups_baseline_path = 0
        self.n_gets = 0
        self.n_puts = 0
        # durability (repro_torch.storage)
        self._storage = None
        self._closed = False
        self._events_persisted = 0
        self._models_swept_at = 0
        self.models_recovered = 0
        self.level_models_recovered = 0
        self._lm_persisted: dict[int, int] = {}  # level -> epoch on disk
        # CBA-scheduled maintenance (auto value-log GC + checkpointing)
        self._in_maintenance = False
        # True = a fleet coordinator owns the maintenance ticks: _tick()
        # stops self-driving and run_maintenance() is called externally
        # with a per-tick budget (the serving plane's fleet coordinator)
        self.maintenance_deferred = False
        self.last_maintenance_us = 0.0   # virtual cost of the last round
        # observability: null objects so the hot paths never branch on
        # "obs on?" (the obs plane itself is a later slice)
        self._vf = NULL_HANDLE           # value-fetch stage handle
        self._fp = NULL_HANDLE           # filter-probe stage handle
        # host I/O plane (repro_torch.io): attach_io wires a worker pool so
        # large value fetches chunk across threads; None = inline fetch
        self._io = None
        self.auto_gc_stats = {"runs": 0, "segments_removed": 0,
                              "bytes_reclaimed": 0, "entries_moved": 0}
        if cfg.storage_dir is not None:
            self._attach_storage(cfg.storage_dir)

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def open(cls, path, cfg: StoreConfig | None = None) -> "BourbonStore":
        """Open (or create) a durable store at ``path``.

        An existing directory is recovered: MANIFEST replay rebuilds the
        levels from mmap'd sstables (persisted PLR models reload without
        retraining), the value log is reloaded, and the WAL is replayed
        into the memtable.
        """
        cfg = cfg if cfg is not None else StoreConfig()
        # deep copy: the caller's config (and its nested lsm/engine/cba)
        # must not be shared with or mutated through this store
        cfg = copy.deepcopy(cfg)
        cfg.storage_dir = str(path)
        return cls(cfg)

    def _attach_storage(self, path: str) -> None:
        # imported lazily: storage depends on core submodules
        from repro_torch.storage import (DurableValueLog, StorageEngine,
                                         load_tables)
        self._storage = StorageEngine(
            path, fsync=self.cfg.fsync,
            group_commit=self.cfg.wal_group_commit)
        try:
            # validate (or record, on a fresh dir) the store geometry
            # before any segment file is parsed with a possibly-wrong
            # entry size or models served with a smaller search window
            self._storage.ensure_format(self.cfg.value_size,
                                        self.cfg.vlog_seg_slots,
                                        self.cfg.lsm.plr_delta)
            if self._storage.recovered:
                self._recover(load_tables, DurableValueLog)
            else:
                self.vlog = DurableValueLog(self.cfg.value_size, path,
                                            seg_slots=self.cfg.vlog_seg_slots,
                                            fsync=self.cfg.fsync,
                                            device=self.cfg.engine.device)
        except BaseException:
            # release the directory lock: a failed open must not wedge the
            # next (correctly configured) one
            self._storage.abort()
            self._storage = None
            raise

    def _recover(self, load_tables, durable_vlog_cls) -> None:
        eng = self._storage
        state = eng.state
        self.tree.levels = load_tables(eng.dir, state)
        for t in self.tree.all_files():
            if t.model is not None:
                eng.persisted_models.add(t.file_id)
        self.models_recovered = len(eng.persisted_models)
        # epochs must stay unique across reopens: resume past the largest
        # persisted one even when the models/filters themselves aren't
        # loaded (e.g. a file-granularity open of a level-granularity dir)
        epochs = list(state.level_models.values()) + list(
            state.filters.values())
        if epochs:
            self.executor.next_model_epoch = max(epochs) + 1
        # persisted level models (§4.3): reload them BEFORE WAL replay and
        # pin the version baseline, so a replay-triggered flush invalidates
        # exactly the levels it touches — mirroring the manifest, whose
        # add/del edits drop the lmodel records of touched levels
        if self.cfg.granularity == "level" and self.cfg.mode == "bourbon":
            from repro_torch.storage import load_level_model
            from repro_torch.storage.format import lmodel_path
            for level, epoch in state.level_models.items():
                m = load_level_model(lmodel_path(eng.dir, level, epoch))
                if m is None:
                    continue   # torn sidecar: fall back to relearning
                m.epoch = epoch
                self.level_models[level] = m
                self._lm_persisted[level] = epoch
                self.level_models_recovered += 1
        # persisted filters reload the same way (before WAL replay, version
        # baseline pinned): a reopened store serves the filtered path with
        # zero rebuild.  A filter built under a different hash count is
        # useless to this engine — treat it like a torn sidecar
        if self.cfg.filters.enabled and state.filters:
            from repro_torch.storage import load_level_filter
            from repro_torch.storage.format import filter_path
            for level, epoch in state.filters.items():
                lf = load_level_filter(filter_path(eng.dir, level, epoch))
                if lf is None or lf.k_hashes != self.cfg.lsm.bloom_k:
                    continue   # torn/mismatched sidecar: rebuild lazily
                lf.epoch = epoch
                self.level_filters[level] = lf
                self._flt_persisted[level] = epoch
                self.filters_recovered += 1
        self._level_model_versions = list(self.tree.level_version)
        self._filter_versions = list(self.tree.level_version)
        self.vlog = durable_vlog_cls.open(
            eng.dir, self.cfg.value_size, self.cfg.vlog_seg_slots,
            state.vlog_removed, state.vhead, fsync=self.cfg.fsync,
            dead_by_seg=state.vlog_dead, device=self.cfg.engine.device)
        self.clock.advance(state.clock)
        self._seq = state.seq
        for keys, seqs, vptrs in eng.replay_old_wal():
            if seqs.shape[0]:
                self._seq = max(self._seq, int(seqs.max()) + 1)
            self._ingest(keys, seqs, vptrs)
        # if replay flushed, flush the remainder too so the recovery WAL
        # (whose records would otherwise re-flush into duplicate tables on
        # every reopen) can be rotated away empty
        if self._events_persisted and len(self.memtable):
            self._flush()
        eng.finish_recovery(self._seq, self.clock.now, len(self.vlog),
                            rotate=bool(self._events_persisted))
        # recovered-but-unlearned files re-enter the learning pipeline
        self._pending_wait.extend(
            t for t in self.tree.all_files() if t.model is None)
        # levels whose persisted model was missing, torn, or invalidated by
        # a replay flush resubmit their learning jobs — the rest serve the
        # model path immediately with an empty learn queue
        if (self.cfg.granularity == "level" and self.cfg.mode == "bourbon"
                and self.cfg.policy != "offline"):
            queued = {j.level for j in self.executor.queue if j.is_level}
            queued |= {j.level for _, j in self.executor.running
                       if j.is_level}
            for i in range(1, N_LEVELS):
                if (self.tree.levels[i] and self.level_models[i] is None
                        and i not in queued):
                    self.executor.submit_level(self.tree, i, self.clock.now)

    def close(self) -> None:
        """Release durable resources.  The memtable is NOT flushed — the
        WAL re-derives it on the next open (exercising the recovery path
        even on clean shutdown)."""
        if self._storage is None:
            return
        self._sweep_level_models()
        self._sweep_filters()
        self.vlog.close()
        self._storage.close(self._seq, self.clock.now, len(self.vlog),
                            vdead=self.vlog.dead_delta())
        self._storage = None
        self._closed = True  # a closed durable store must not accept writes

    def _check_writable(self) -> None:
        if self._closed:
            raise RuntimeError("store is closed — writes would be silently "
                               "non-durable; reopen with BourbonStore.open()")

    def wal_sync(self) -> None:
        """Durability barrier for acknowledged writes: under the
        group-commit WAL this waits for (at most) one coalesced
        flush+fsync covering everything ``put_batch`` acknowledged so
        far; with the per-append writer (or no storage) it is a no-op
        — every append was already durable when it returned."""
        if self._storage is not None:
            self._storage.wal_sync()

    # -------------------------------------------------------------- io plane
    def attach_io(self, pool) -> None:
        """Join a :class:`repro_torch.io.IOPool`: value fetches for large
        batches are chunked across the pool's workers (fixed-slice
        scatter into one preallocated array, so results are identical to
        the inline path for any pool size)."""
        self._io = pool

    def detach_io(self) -> None:
        self._io = None

    def _fetch_values(self, vptr: np.ndarray) -> np.ndarray:
        """Materialize values for a batch of resolved pointers.  Small
        batches stay inline (a pool round-trip costs more than the arena
        read); large ones fan out in fixed slices."""
        pool = self._io
        b = vptr.shape[0]
        if pool is None or b <= _IO_FETCH_CHUNK:
            return self.vlog.get_batch_np(vptr)
        from repro_torch.io import wait_all
        out = np.empty((b, self.cfg.value_size), np.uint8)

        def fetch(lo: int, hi: int) -> None:
            out[lo:hi] = self.vlog.get_batch_np(vptr[lo:hi])

        futs = [pool.submit(fetch, lo, min(lo + _IO_FETCH_CHUNK, b))
                for lo in range(0, b, _IO_FETCH_CHUNK)]
        wait_all(futs)
        return out

    # ------------------------------------------------------------------ write
    def put_batch(self, keys: np.ndarray, values: np.ndarray | None = None) -> None:
        self._check_writable()
        keys = np.asarray(keys, np.int64)
        b = keys.shape[0]
        if values is None:
            values = np.zeros((b, self.cfg.value_size), np.uint8)
            values[:, 0] = (keys & 0xFF).astype(np.uint8)
        seqs = np.arange(self._seq, self._seq + b, dtype=np.int64)
        self._seq += b
        vptrs = self.vlog.append_kv(keys, seqs, values)
        if self._storage is not None and self.cfg.maintenance.track_dead:
            self._note_superseded(keys, vptrs)   # before ingest: pre-write
        self._ingest(keys, seqs, vptrs)
        self.n_puts += b
        self.foreground_us += self.cfg.costs.t_put * b
        self.clock.advance(self.cfg.costs.t_put * b)
        self._tick()

    def delete_batch(self, keys: np.ndarray) -> None:
        self._check_writable()
        keys = np.asarray(keys, np.int64)
        b = keys.shape[0]
        seqs = np.arange(self._seq, self._seq + b, dtype=np.int64)
        self._seq += b
        vptrs = np.full(b, -1, np.int64)  # tombstones
        if self._storage is not None and self.cfg.maintenance.track_dead:
            self._note_superseded(keys, None)
        self._ingest(keys, seqs, vptrs)
        self.clock.advance(self.cfg.costs.t_put * b)
        self._tick()

    def _note_superseded(self, keys: np.ndarray,
                         new_vptrs: np.ndarray | None) -> None:
        """Write-path half of the dead-entry estimate: every overwrite or
        delete retires the key's previous value-log slot, and duplicate
        keys within one batch retire all but the batch's last slot.  The
        per-segment counters this feeds (ValueLog.note_dead) are what lets
        GC candidacy skip the full-log scan."""
        uniq = np.unique(keys)
        old = self._host_get_vptrs(uniq)
        self.vlog.note_dead(old[old >= 0])
        if new_vptrs is not None and uniq.shape[0] < keys.shape[0]:
            order = np.lexsort((np.arange(keys.shape[0]), keys))
            ks = keys[order]
            dup = np.r_[ks[1:] == ks[:-1], False]  # non-last occurrences
            self.vlog.note_dead(new_vptrs[order][dup])

    def _ingest(self, keys: np.ndarray, seqs: np.ndarray,
                vptrs: np.ndarray) -> None:
        """Memtable insertion in WAL-aligned chunks: each chunk is logged
        durably before it enters the memtable, and a flush only ever runs
        with the WAL covering exactly the drained records (so rotation at
        flush time cannot drop acknowledged writes)."""
        b = keys.shape[0]
        off = 0
        while off < b:
            take = min(self.memtable.capacity - len(self.memtable), b - off)
            sl = slice(off, off + take)
            if self._storage is not None:
                self._storage.wal_append(keys[sl], seqs[sl], vptrs[sl])
            took = self.memtable.put_batch(keys[sl], seqs[sl], vptrs[sl])
            assert took == take
            off += take
            if self.memtable.full:
                self._flush()

    def _flush(self) -> None:
        k, s, v = self.memtable.drain_sorted()
        created = self.tree.flush(k, s, v, self.clock.now)
        self._pending_wait.extend(created)
        while (ev := self.tree.compact_once(self.clock.now)) is not None:
            self._pending_wait.extend(
                t for lvl in self.tree.levels for t in lvl
                if t.file_id in ev.created)
        if self._storage is not None:
            self._persist_structure()
        self._after_structure_change()

    def _persist_structure(self) -> None:
        """Durably commit the flush/compaction batch that just settled:
        net-new files are written, net deletions recorded, and the WAL
        rotated (the memtable is empty here, so the old WAL is covered)."""
        events = self.tree.events[self._events_persisted:]
        if not events:
            return
        created: list[int] = []
        deleted: set[int] = set()
        for ev in events:
            created.extend(ev.created)
            deleted.update(ev.deleted)
        live_by_id = {t.file_id: t for t in self.tree.all_files()}
        add_tables = [live_by_id[fid] for fid in created
                      if fid in live_by_id]
        self._storage.persist_flush(add_tables, sorted(deleted), self._seq,
                                    self.clock.now, len(self.vlog),
                                    vdead=self.vlog.dead_delta())
        # only after the commit landed: a transient I/O error above must
        # leave these events pending, not silently dropped
        self._events_persisted = len(self.tree.events)
        self.vlog.clear_dead_dirty()

    def _after_structure_change(self) -> None:
        # drain dead files into CBA stats
        for t in self.tree.dead_files[self._dead_seen:]:
            self.cba.observe_dead_file(t, self.clock.now)
        self._dead_seen = len(self.tree.dead_files)
        # invalidate level models on change; resubmit level learning
        if self.cfg.granularity == "level" and self.cfg.mode == "bourbon":
            for i in range(1, N_LEVELS):
                if self.tree.level_version[i] != self._level_model_versions[i]:
                    self.level_models[i] = None
                    # the manifest's add/del edit (already appended by
                    # _persist_structure) dropped this level's lmodel
                    # record; mirror that here and reap the sidecar
                    stale = self._lm_persisted.pop(i, None)
                    if stale is not None and self._storage is not None:
                        self._storage.drop_level_model(i, stale)
                    self._level_model_versions[i] = self.tree.level_version[i]
                    if self.cfg.policy != "offline":
                        self.executor.submit_level(self.tree, i, self.clock.now)
        else:
            for i in range(N_LEVELS):
                if self.tree.level_version[i] != self._level_model_versions[i]:
                    self._level_model_versions[i] = self.tree.level_version[i]
        # filters invalidate on any structure change, independent of model
        # granularity: compaction churn rewrites a level's key set, so its
        # filter (and the persisted sidecar record, already dropped from
        # the MANIFEST by the add/del edit) is stale.  The rebuild happens
        # lazily at the next dispatch (_ensure_filters)
        if self.cfg.filters.enabled:
            for i in range(N_LEVELS):
                if self.tree.level_version[i] != self._filter_versions[i]:
                    self.level_filters[i] = None
                    stale = self._flt_persisted.pop(i, None)
                    if stale is not None and self._storage is not None:
                        self._storage.drop_level_filter(i, stale)

    def _tick(self) -> None:
        if self.cfg.mode != "bourbon" or self.cfg.policy in ("offline", "never"):
            # offline/never: no online learning
            self.executor.tick(self.tree, self.clock.now, self.level_models)
            self._sweep_level_models()
            self._sweep_filters()
            self._maintenance_tick()
            return
        if self.cfg.granularity == "file":
            t_wait = self.cba.t_wait(self.cfg.lsm.file_cap)
            still = []
            for t in self._pending_wait:
                if t.deleted_at is not None or t.model is not None:
                    continue
                if self.clock.now >= t.created_at + t_wait:
                    self.executor.maybe_submit_file(t, self.clock.now)
                else:
                    still.append(t)
            self._pending_wait = still
        self.executor.tick(self.tree, self.clock.now, self.level_models)
        if (self._storage is not None
                and self.executor.files_learned != self._models_swept_at):
            self._models_swept_at = self.executor.files_learned
            self._persist_new_models()
        self._sweep_level_models()
        self._sweep_filters()
        self._maintenance_tick()

    def _maintenance_tick(self) -> None:
        if self.maintenance_deferred:
            return   # an external coordinator owns the ticks
        self.run_maintenance()

    def run_maintenance(self, budget_us: float | None = None) -> float:
        """One round of CBA-scheduled maintenance (§4.4 extended): run
        value-log GC on segments whose estimated reclaim benefit exceeds
        the relocation cost, and fold the MANIFEST once its edit log is
        worth rewriting.  Both charge the virtual clock like any other
        background work.

        ``budget_us`` makes the round budget-bounded: GC candidates are
        picked only while their (conservative) estimated cost fits, and
        the checkpoint is skipped when its cost would overrun — so the
        virtual time charged never exceeds the budget.  Returns the
        virtual microseconds actually charged (also exposed as
        ``last_maintenance_us``), 0.0 when nothing was worth doing."""
        if self._storage is None or self._in_maintenance or self._closed:
            return 0.0
        m = self.cfg.maintenance
        t0 = self.clock.now
        self._in_maintenance = True
        try:
            if m.auto_gc:
                segs = self.cba.gc_candidates(self.vlog, self.clock.now,
                                              budget_us=budget_us)
                if segs:
                    res = self.gc_value_log(min_dead_ratio=0.0,
                                            segments=segs)
                    self.cba.gc_runs += 1
                    self.auto_gc_stats["runs"] += 1
                    for k in ("segments_removed", "bytes_reclaimed",
                              "entries_moved"):
                        self.auto_gc_stats[k] += res[k]
            if (not self._storage.in_recovery and self.cba.should_checkpoint(
                    self._storage.manifest_tail_bytes())):
                # the fold rewrites the whole live state, so its cost is
                # known up front — defer it when over budget.  But the
                # fold is atomic and its cost only grows with the store:
                # when it exceeds even an otherwise-unspent budget it
                # would be deferred forever while the edit log grows, so
                # run it anyway and count the overrun
                est = (self.cfg.costs.checkpoint_per_byte
                       * self._storage.manifest_bytes())
                spent = self.clock.now - t0
                never_fits = (budget_us is not None and spent == 0.0
                              and est > budget_us)
                if budget_us is None or spent + est <= budget_us \
                        or never_fits:
                    if never_fits:
                        self.cba.checkpoint_overruns += 1
                    folded = self._storage.checkpoint()
                    cost = self.cfg.costs.checkpoint_per_byte * folded
                    self.cba.checkpoints += 1
                    self.cba.checkpoint_us += cost
                    self.clock.advance(cost)
        finally:
            self._in_maintenance = False
        self.last_maintenance_us = self.clock.now - t0
        return self.last_maintenance_us

    def _persist_new_models(self) -> None:
        """Append just-learned PLR models into their sstable files."""
        for t in self.tree.all_files():
            if t.model is not None:
                self._storage.persist_model(t)

    def _sweep_level_models(self) -> None:
        """Durably publish level models whose epoch the MANIFEST doesn't
        reference yet.  Every fit stamps a fresh monotonic epoch (the
        executor's counter, seeded past the persisted maximum on
        recovery), so "new" is simply epoch-not-yet-persisted."""
        if self._storage is None or self.cfg.granularity != "level":
            return
        for i, m in enumerate(self.level_models):
            if m is None or getattr(m, "epoch", -1) < 0:
                continue
            if self._lm_persisted.get(i) == m.epoch:
                continue
            self._storage.persist_level_model(i, m)
            self._lm_persisted[i] = m.epoch

    def _sweep_filters(self) -> None:
        """Durably publish level filters the MANIFEST doesn't reference yet
        (same epoch-not-yet-persisted discipline as _sweep_level_models)."""
        if self._storage is None or not self.cfg.filters.enabled:
            return
        for i, f in enumerate(self.level_filters):
            if f is None or f.epoch < 0:
                continue
            if self._flt_persisted.get(i) == f.epoch:
                continue
            self._storage.persist_level_filter(i, f)
            self._flt_persisted[i] = f.epoch

    # --------------------------------------------------------------- filters
    def _ensure_filters(self) -> None:
        """(Re)build level filters whose level changed since the last
        build, plus CBA-triggered resizes when fresh miss-traffic stats
        move the optimal bits-per-key far enough from what's built.  Build
        is host-side numpy over the level's full key set (tombstones
        included — a tombstone must pass its filter so the engine finds it
        and reports the delete); cost is charged to the virtual clock like
        a learning job."""
        fc = self.cfg.filters
        for li in range(N_LEVELS):
            tables = self.tree.levels[li]
            fresh = self.tree.level_version[li] != self._filter_versions[li]
            if not tables:
                if fresh:
                    self.level_filters[li] = None
                    self._filter_versions[li] = self.tree.level_version[li]
                continue
            cur = self.level_filters[li]
            rebuilt = False
            if not fresh and cur is not None:
                # FPR drift: compaction churn changed the observed miss
                # traffic — re-size only when the completed-file stats
                # actually moved (cheap gate, not per-dispatch math)
                st = self.cba.level_stats.get(li)
                nf = st.n_files if st is not None else 0
                # nf == 0 means no stats (e.g. right after reopen): sizing
                # would just return the bootstrap base, so a recovered
                # CBA-sized filter must not be churned against it
                if nf and nf != self._filter_sized_at.get(li, -1):
                    self._filter_sized_at[li] = nf
                    n_keys = sum(t.n for t in tables)
                    want = self.cba.filter_bits_per_key(
                        li, n_keys, fc.bits_per_key, fc.min_bits_per_key,
                        fc.max_bits_per_key, self.cfg.lsm.bloom_k)
                    if abs(want - cur.bits_per_key) >= fc.rebuild_delta_bpk:
                        rebuilt = True
                        self.cba.filter_decisions["rebuilt"] += 1
            if cur is not None and not fresh and not rebuilt:
                continue
            n_keys = sum(t.n for t in tables)
            bpk = self.cba.filter_bits_per_key(
                li, n_keys, fc.bits_per_key, fc.min_bits_per_key,
                fc.max_bits_per_key, self.cfg.lsm.bloom_k)
            keys = (tables[0].keys if len(tables) == 1 else
                    np.concatenate([t.keys for t in tables]))
            f = build_level_filter(keys, bpk, self.cfg.lsm.bloom_k)
            f.epoch = self.executor.alloc_model_epoch()
            self.level_filters[li] = f
            self._filter_versions[li] = self.tree.level_version[li]
            self.filters_built += 1
            self.cba.filter_builds += 1
            cost = self.cfg.costs.t_filter_build(n_keys)
            self.cba.filter_us += cost
            self.clock.advance(cost)

    # ------------------------------------------------------------------ read
    def _engine_mode(self) -> str:
        if self.cfg.mode == "wisckey":
            return "baseline"
        if self.cfg.granularity == "level":
            return "level"
        files = list(self.tree.all_files())
        # an empty tree must not claim model_pure (vacuous all()): the
        # mixed path stays correct for whatever flushes next
        if files and all(t.model is not None for t in files):
            return "model_pure"   # skip the dead baseline arm
        return "model"

    def _host_answer(self, keys: np.ndarray, fmaybe_keep: np.ndarray,
                     live_idx: list) -> tuple:
        """Answer a small post-screen remainder without a device round
        trip: numpy binary search over the host sstable key arrays,
        mirroring the engine's descent exactly (newest-first L0 slots,
        then the candidate file per sorted level, per-level filter mask
        applied the same way) so results stay byte-identical with the
        device path.  An absent sweep collapses to a handful of bloom
        false positives — not worth the fixed device-dispatch cost."""
        B = keys.shape[0]
        found = np.zeros(B, bool)
        vptr = np.full(B, -1, np.int64)
        pos = [np.zeros(len(self.tree.levels[li]), np.int64)
               for li in range(N_LEVELS)]
        neg = [np.zeros_like(p) for p in pos]
        mrow = {li: fmaybe_keep[r] for r, li in enumerate(live_idx)}
        maxk = {li: np.array([t.keys[-1] for t in self.tree.levels[li]],
                             np.int64)
                for li in live_idx if li > 0}
        for bi in range(B):
            k = int(keys[bi])
            for li in live_idx:
                row = mrow[li]
                if not row[bi]:
                    continue                  # filter-pruned level
                tables = self.tree.levels[li]
                hit = False
                if li == 0:
                    for si, t in enumerate(tables):
                        if t.keys[0] <= k <= t.keys[-1]:
                            j = int(np.searchsorted(t.keys, k))
                            if j < t.n and int(t.keys[j]) == k:
                                pos[0][si] += 1
                                vptr[bi] = int(t.vptrs[j])
                                hit = True
                                break
                            neg[0][si] += 1
                else:
                    # candidate = first file with max_key >= k (engine's
                    # FindFiles), valid if the file's range covers k
                    si = int(np.searchsorted(maxk[li], k))
                    if si < len(tables) and int(tables[si].keys[0]) <= k:
                        t = tables[si]
                        j = int(np.searchsorted(t.keys, k))
                        if j < t.n and int(t.keys[j]) == k:
                            pos[li][si] += 1
                            vptr[bi] = int(t.vptrs[j])
                            hit = True
                        else:
                            neg[li][si] += 1
                if hit:
                    found[bi] = True
                    break
        return found, vptr, pos, neg

    def dispatch_get(self, probes: np.ndarray) -> PendingBatch:
        """Non-blocking half of :meth:`get_batch`: answer the memtable
        overlay host-side and launch the device lookup for the misses,
        returning a :class:`PendingBatch` without waiting for the device.
        The handle is pinned to the device state current at dispatch —
        writes applied afterwards are invisible to it, which is exactly
        the snapshot-per-batch contract the serving plane wants."""
        probes = np.asarray(probes, np.int64)
        mt_found, mt_vptr = self.memtable.get_batch(probes)
        mt_found = mt_found.copy()
        mt_vptr = mt_vptr.copy()
        miss = ~mt_found
        n_miss = int(miss.sum())
        fstate = None
        fmaybe_keep = live_idx = None
        if self.cfg.filters.enabled and n_miss:
            # host screen: keys the filters rule out at *every* level never
            # dispatch — they resolve as misses with zero device probes
            self._ensure_filters()
            t0 = self._fp.begin()
            # only populated levels can hold the key; an empty level must
            # not contribute an all-maybe row or nothing ever screens
            live_idx = [li for li in range(N_LEVELS) if self.tree.levels[li]]
            live_filters = [self.level_filters[li] for li in live_idx]
            fmaybe = filter_maybe_np(live_filters, probes[miss])
            screened = ~fmaybe.any(axis=0)
            self._fp.end(t0)
            n_scr = int(screened.sum())
            self.filter_screen_total += n_miss
            if n_scr:
                self.filter_screened += n_scr
                miss_idx = np.flatnonzero(miss)
                miss[miss_idx[screened]] = False
                mt_vptr[miss_idx[screened]] = -1   # engine miss convention
                n_miss -= n_scr
            fmaybe_keep = fmaybe[:, ~screened]
            fstate = self.engine.build_filter_state(self.level_filters)
            if 0 < n_miss <= self.cfg.filters.host_answer_max:
                # remainder too small to be worth a device round trip:
                # binary-search the host sstable arrays instead
                idx = np.flatnonzero(miss)
                hf, hv, hpos, hneg = self._host_answer(
                    probes[miss], fmaybe_keep, live_idx)
                mt_found[idx] = hf
                mt_vptr[idx] = hv
                miss[idx] = False
                self.filter_host_answered += n_miss
                n_miss = 0
                self._account_lookup(_HostLookupRes(hpos, hneg))
        pending = None
        if n_miss:
            # quarter-pow2 buckets, not pow2: the filter screen shrinks
            # n_miss to arbitrary sizes, and rounding 2100 all the way back
            # up to 4096 would hand the screening win straight back to the
            # kernel width.  Still a small, bounded set of jit cache keys.
            n = max(n_miss, 64)
            step = max(64, _next_pow2(n) // 4)
            pad = -(-n // step) * step
            eng_probes = np.full(pad, _PAD_PROBE, np.int64)
            eng_probes[:n_miss] = probes[miss]
            fm_host = level_hint = None
            if fstate is not None:
                # reuse the host screen's hashes for the dispatched keys —
                # all-True rows for filterless levels match the device
                # probe; pad lanes stay all-True (results are discarded)
                fm_host = np.ones((N_LEVELS, pad), bool)
                hint = [True] * N_LEVELS
                for row, li in enumerate(live_idx):
                    fm_host[li, :n_miss] = fmaybe_keep[row]
                    # no dispatched key can live at a level whose mask row
                    # is all-False — the engine drops it from the program
                    hint[li] = bool(fmaybe_keep[row].any())
                level_hint = tuple(hint)
            state = self.engine.build_state(self.tree, self.level_models)
            pending = self.engine.lookup_async(
                state, eng_probes, self._engine_mode(), self.vlog,
                l0_live=len(self.tree.levels[0]), fstate=fstate,
                fmaybe_host=fm_host, level_maybe=level_hint)
        return PendingBatch(probes, mt_found, mt_vptr,
                            miss, n_miss, pending)

    def resolve_get(self, pb: PendingBatch) -> tuple[np.ndarray, np.ndarray]:
        """Blocking half: materialize the device results, merge them under
        the memtable overlay, account the lookup, and tick the store."""
        if pb.resolved:
            raise RuntimeError("PendingBatch already resolved")
        pb.resolved = True
        found, vptr = pb.found, pb.vptr
        if pb.pending is not None:
            res = pb.pending.resolve()
            found[pb.miss] = res.found[:pb.n_miss]
            vptr[pb.miss] = res.vptr[:pb.n_miss]
            self._account_lookup(res)
        # a located tombstone (vptr -1) shadows older versions but the GET
        # reports not-found
        found &= vptr >= 0
        self.n_gets += pb.probes.shape[0]
        self.clock.advance(0.0)  # time added in _account_lookup
        self._tick()
        if self.cfg.fetch_values:
            t0 = self._vf.begin()
            vals = self._fetch_values(vptr)
            self._vf.end(t0)
            return found, vals
        return found, vptr

    def get_batch(self, probes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (found bool (B,), values (B, value_size) or vptrs)."""
        return self.resolve_get(self.dispatch_get(probes))

    def _account_lookup(self, res: LookupResult) -> None:
        """Attribute per-file internal lookups; advance virtual time by
        per-path costs (model path where the file had a model)."""
        c = self.cfg.costs
        us = 0.0
        for li in range(N_LEVELS):
            tables = self.tree.levels[li]
            pos_c, neg_c = res.pos_counts[li], res.neg_counts[li]
            for i, t in enumerate(tables):
                p = int(pos_c[i]) if i < pos_c.shape[0] else 0
                n = int(neg_c[i]) if i < neg_c.shape[0] else 0
                if p == 0 and n == 0:
                    continue
                t.stats.n_pos += p
                t.stats.n_neg += n
                has_model = (t.model is not None or
                             (self.cfg.granularity == "level" and
                              self.level_models[li] is not None))
                if has_model:
                    us += p * c.t_pm + n * c.t_nm
                    self.lookups_model_path += p + n
                else:
                    us += p * c.t_pb + n * c.t_nb
                    self.lookups_baseline_path += p + n
        self.foreground_us += us
        self.clock.advance(us)

    def range_query(self, start_keys: np.ndarray, length: int) -> np.ndarray:
        """Batched short scans: locate each start key (indexed path), then
        merge-scan `length` live items host-side.  Returns (B, length)
        keys, -1 padded.  Versions shadow by seq: a key whose newest
        flushed version is a tombstone is skipped, not emitted.  Scans the
        flushed tree only — flush before ranging over fresh writes."""
        start_keys = np.asarray(start_keys, np.int64)
        out = np.full((start_keys.shape[0], length), -1, np.int64)
        tables = list(self.tree.all_files())
        for bi, sk in enumerate(start_keys):
            heads = [[t, int(np.searchsorted(t.keys, sk))] for t in tables]
            heads = [h for h in heads if h[1] < h[0].n]
            cursor = int(sk)
            j = 0
            # k-way: repeatedly take the global min key >= cursor, then
            # let its newest version decide liveness
            while j < length and heads:
                best = None
                for h in heads:
                    t, idx = h
                    while idx < t.n and t.keys[idx] < cursor:
                        idx += 1
                    h[1] = idx
                    if idx < t.n:
                        v = int(t.keys[idx])
                        if best is None or v < best:
                            best = v
                heads = [h for h in heads if h[1] < h[0].n]
                if best is None:
                    break
                seq = -1
                vptr = -1
                for t, idx in heads:
                    if (t.keys[idx] == best and int(t.seqs[idx]) > seq):
                        seq = int(t.seqs[idx])
                        vptr = int(t.vptrs[idx])
                if vptr >= 0:               # tombstones shadow silently
                    out[bi, j] = best
                    j += 1
                cursor = best + 1
        return out

    # --------------------------------------------------------------- control
    def learn_all(self) -> int:
        """Synchronously learn every live file (or level) — used to set up
        read-only experiments and ``offline`` mode initial models."""
        self._check_writable()   # a closed store could not persist models
        n = 0
        n_file_models = 0
        if self.cfg.granularity == "level":
            from .plr import greedy_plr_np
            for i in range(1, N_LEVELS):
                if self.tree.levels[i]:
                    keys = np.concatenate([t.keys for t in self.tree.levels[i]])
                    self.level_models[i] = greedy_plr_np(
                        keys, delta=self.cfg.lsm.plr_delta)
                    self.level_models[i].epoch = \
                        self.executor.alloc_model_epoch()
                    self._level_model_versions[i] = self.tree.level_version[i]
                    n += 1
            # L0 cannot be level-learned (overlapping ranges) -> file models
            for t in self.tree.levels[0]:
                if t.model is None:
                    t.learn(self.cfg.lsm.plr_delta,
                            pad_to=self.cfg.engine.seg_cap)
                    n_file_models += 1
        else:
            for lvl in self.tree.levels:
                for t in lvl:
                    if t.model is None:
                        t.learn(self.cfg.lsm.plr_delta,
                                pad_to=self.cfg.engine.seg_cap)
                        n_file_models += 1
        n += n_file_models
        self.executor.files_learned += n_file_models
        if self._storage is not None:
            self._models_swept_at = self.executor.files_learned
            self._persist_new_models()
            self._sweep_level_models()
        return n

    def flush_all(self) -> None:
        """Flush memtable + settle compactions (load-phase end)."""
        self._check_writable()
        if len(self.memtable):
            self._flush()
        self._tick()

    # --------------------------------------------------------------- vlog GC
    def _host_get_vptrs(self, keys: np.ndarray) -> np.ndarray:
        """Authoritative host-side lookup: current vptr per key, -2 when the
        key is absent (tombstones return -1).  Newest seq wins across the
        memtable and every level — the liveness oracle for value-log GC."""
        n = keys.shape[0]
        best_vp = np.full(n, -2, np.int64)
        best_seq = np.full(n, -1, np.int64)
        mt_found, mt_vp = self.memtable.get_batch(keys)
        best_vp[mt_found] = mt_vp[mt_found]
        # memtable versions are strictly newer than anything flushed
        best_seq[mt_found] = np.iinfo(np.int64).max
        for t in self.tree.all_files():
            idx = np.searchsorted(t.keys, keys)
            idx_c = np.minimum(idx, t.n - 1)
            hit = t.keys[idx_c] == keys
            newer = hit & (t.seqs[idx_c] > best_seq)
            best_vp[newer] = t.vptrs[idx_c[newer]]
            best_seq[newer] = t.seqs[idx_c[newer]]
        return best_vp

    def gc_value_log(self, min_dead_ratio: float = 0.3,
                     max_segments: int | None = None,
                     segments: list[int] | None = None) -> dict:
        """WiscKey value-log GC (§2.2): scan sealed segments, relocate live
        entries to the head (updating their pointers through the LSM via a
        fresh-seq put), and delete segments whose dead ratio exceeds the
        threshold.  Returns reclamation stats.

        ``segments`` restricts the scan to an explicit candidate list (the
        MaintenanceScheduler passes the segments its dead-entry estimates
        deemed profitable, so the auto path never scans the whole log);
        liveness is still verified per entry before anything is dropped."""
        self._check_writable()
        if self._storage is None:
            raise RuntimeError("value-log GC requires a durable store "
                               "(BourbonStore.open(path))")
        removed: list[int] = []
        moved = 0
        reclaimed = 0
        scanned = 0
        # Liveness is checked in chunks of segments with one batched
        # full-LSM scan per chunk (a per-segment scan would make GC
        # quadratic in store size), and chunking keeps max_segments from
        # scanning the whole sealed log.  A chunk's snapshot stays valid
        # through its loop: a key's sealed entry only changes liveness when
        # its own segment is relocated, and relocated entries land in
        # unsealed head segments.
        if segments is None:
            sealed = self.vlog.sealed_segments()
        else:
            ok = set(self.vlog.sealed_segments())
            sealed = [s for s in segments if s in ok]
        chunk_size = 64
        done = False
        for start in range(0, len(sealed), chunk_size):
            if done:
                break
            seg_meta = []
            for seg in sealed[start: start + chunk_size]:
                ptrs, keys, _seqs, _ = self.vlog.read_segment(
                    seg, with_values=False)
                seg_meta.append((seg, ptrs, keys))
            cur = self._host_get_vptrs(
                np.concatenate([m[2] for m in seg_meta]))
            scanned += int(cur.shape[0])
            off = 0
            for seg, ptrs, keys in seg_meta:
                live = cur[off: off + ptrs.shape[0]] == ptrs
                off += ptrs.shape[0]
                if max_segments is not None and len(removed) >= max_segments:
                    done = True
                    break
                dead_ratio = (1.0 - float(live.mean())
                              if ptrs.shape[0] else 1.0)
                if dead_ratio < min_dead_ratio:
                    continue
                # victim re-read with payloads (page-cache warm from the
                # liveness pass)
                _p, _k, _s, values = self.vlog.read_segment(seg)
                lk, lv = keys[live], values[live]
                if lk.shape[0]:
                    new_seqs = np.arange(self._seq, self._seq + lk.shape[0],
                                         dtype=np.int64)
                    self._seq += lk.shape[0]
                    new_ptrs = self.vlog.append_kv(lk, new_seqs, lv)
                    self._ingest(lk, new_seqs, new_ptrs)
                    moved += lk.shape[0]
                # manifest edit BEFORE the unlink: a crash in between leaves
                # a removed-but-present file, which recovery cleans up; the
                # other order would leave a missing file the log references
                self._storage.persist_gc([seg], self._seq, self.clock.now,
                                         len(self.vlog),
                                         vdead=self.vlog.dead_delta())
                self.vlog.clear_dead_dirty()
                reclaimed += self.vlog.drop_segment(seg)
                self.cba.forget_segment(seg)
                removed.append(seg)
        # charge the collection to the virtual clock (background work,
        # same accounting discipline as learning)
        gc_us = (self.cfg.costs.gc_scan_per_entry * scanned
                 + self.cfg.costs.gc_move_per_entry * moved)
        self.cba.gc_us += gc_us
        self.clock.advance(gc_us)
        return {"segments_removed": len(removed),
                "bytes_reclaimed": reclaimed,
                "entries_moved": moved}

    def drain_learning(self, max_us: float = 1e12) -> int:
        """Advance virtual time until the learning queue is empty; returns
        the number of jobs drained.  Raises instead of giving up silently:
        a caller that proceeds with jobs still queued would silently
        benchmark the baseline path."""
        done0 = self.executor.jobs_done
        start = self.clock.now
        while self.executor.queue or self.executor.running:
            if self.executor.running:
                # event-driven: jump straight to the next job completion
                # (a fixed step would need ~duration/step iterations)
                nxt = min(finish for finish, _ in self.executor.running)
                step = max(nxt - self.clock.now, 0.0)
            else:
                step = 1000.0   # queued-only: let the next tick start them
            if (self.clock.now + step) - start > max_us:
                outstanding = (len(self.executor.queue)
                               + len(self.executor.running))
                raise RuntimeError(
                    f"drain_learning: {outstanding} jobs still outstanding; "
                    f"draining needs more than max_us={max_us:.0f} virtual "
                    f"us")
            self.clock.advance(step)
            self._tick()
        return self.executor.jobs_done - done0

    # -------------------------------------------------------------------- obs
    def attach_obs(self, obs, labels: dict | None = None) -> None:
        raise NotImplementedError("the obs plane (metrics registry, stage "
                                  "and causal tracers) is ported in a later "
                                  "slice")

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        files = list(self.tree.all_files())
        n_learned = sum(1 for t in files if t.model is not None)
        model_bytes = sum(t.model.nbytes for t in files if t.model is not None)
        # honest per-record width: whatever the key/seq/vptr arrays hold
        # (not a hardcoded 24), so space_overhead tracks format changes
        data_bytes = sum(
            t.n * (t.keys.dtype.itemsize + t.seqs.dtype.itemsize
                   + t.vptrs.dtype.itemsize) for t in files)
        segs = [int(t.model.n_segments) for t in files if t.model is not None]
        out = {
            "n_files": len(files),
            "n_records": self.tree.total_records(),
            "n_gets": self.n_gets,
            "n_puts": self.n_puts,
            "n_learned": n_learned,
            "model_bytes": model_bytes,
            "data_bytes": data_bytes,
            "space_overhead": model_bytes / max(data_bytes, 1),
            "avg_segments": float(np.mean(segs)) if segs else 0.0,
            "total_segments": int(np.sum(segs)) if segs else 0,
            "foreground_us": self.foreground_us,
            "learn_us": self.executor.learn_time_us,
            "compact_us": self.tree.compacted_records * self.cfg.costs.compact_per_key,
            "files_learned": self.executor.files_learned,
            "model_path_frac": self.lookups_model_path /
                max(self.lookups_model_path + self.lookups_baseline_path, 1),
            "level_attempts": self.executor.level_attempts,
            "level_failures": self.executor.level_failures,
            "cba_decisions": dict(self.cba.decisions),
            "filters_built": self.filters_built,
            "filter_screened": self.filter_screened,
            "filter_host_answered": self.filter_host_answered,
            "filter_screen_total": self.filter_screen_total,
            "filter_us": self.cba.filter_us,
            "filter_decisions": dict(self.cba.filter_decisions),
            "filter_bits": sum(f.n_words * 64 for f in self.level_filters
                               if f is not None),
        }
        if self._storage is not None:
            out.update(
                models_recovered=self.models_recovered,
                level_models_recovered=self.level_models_recovered,
                level_models_persisted=dict(self._lm_persisted),
                filters_recovered=self.filters_recovered,
                filters_persisted=dict(self._flt_persisted),
                vlog_disk_bytes=self.vlog.disk_bytes(),
                vlog_segments_removed=len(self.vlog.removed),
                vlog_dead_entries=self.vlog.dead_entries,
                gc_us=self.cba.gc_us,
                gc_decisions=dict(self.cba.gc_decisions),
                auto_gc=dict(self.auto_gc_stats),
                manifest_bytes=self._storage.manifest_bytes(),
                manifest_checkpoints=self.cba.checkpoints,
                checkpoint_overruns=self.cba.checkpoint_overruns,
                wal=self._storage.wal_stats(),
            )
        return out
