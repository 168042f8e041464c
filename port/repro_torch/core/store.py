"""BourbonStore — the public facade tying the pieces together.

Modes
-----
* ``mode="wisckey"``      — baseline (no learning, binary-search path).
* ``mode="bourbon"``      — file-granularity learning with a policy:
    - ``policy="cba"``     cost-benefit analyzer (the paper's default)
    - ``policy="always"``  learn every file (Bourbon-always)
    - ``policy="offline"`` only the initially loaded data is learned
    - ``policy="never"``   never learn (= wisckey but keeps CBA accounting)

Writes go memtable -> L0 -> compaction (host, numpy); reads are batched
lookups through :class:`LookupEngine`, whose descent runs the CUDA kernels
on the card.  A virtual microsecond clock (clock.py) drives T_wait /
lifetimes / Fig-13-style accounting exactly as in ``repro.core.store``.

This slice ports the in-memory store on the main path (batched GET with
file-granularity learning and the filter plane).  Durable storage, the I/O
pool, observability and level-granularity models come in later slices and
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

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


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class StoreConfig:
    mode: str = "bourbon"             # wisckey | bourbon
    granularity: str = "file"         # file (level: a later slice)
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
    storage_dir: str | None = None    # durable storage: a later slice
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
    is the synchronization point."""
    probes: np.ndarray                 # (B,) int64, as submitted
    found: np.ndarray                  # (B,) bool, memtable hits prefilled
    vptr: np.ndarray                   # (B,) int64, memtable hits prefilled
    miss: np.ndarray                   # (B,) bool, keys the engine answers
    n_miss: int
    pending: PendingLookup | None      # None when the host answered all
    resolved: bool = False


class BourbonStore:
    def __init__(self, cfg: StoreConfig) -> None:
        if cfg.storage_dir is not None:
            raise NotImplementedError("durable storage (storage_dir) is "
                                      "ported in a later slice")
        if cfg.granularity != "file":
            raise NotImplementedError(f"granularity={cfg.granularity!r} is "
                                      "ported in slice 2")
        self.cfg = cfg
        # the engine first: it raises when the device is missing
        self.engine = LookupEngine(cfg.engine)
        self.clock = VirtualClock()
        self.tree = LSMTree(cfg.lsm)
        self.memtable = MemTable(cfg.lsm.memtable_cap)
        self.vlog = ValueLog(cfg.value_size, device=cfg.engine.device)
        self.cba = MaintenanceScheduler(cfg.cba, cfg.costs, cfg.maintenance)
        self.executor = LearningExecutor(self.cba, cfg.costs,
                                         cfg.cba.learner_slots,
                                         cfg.lsm.plr_delta, cfg.engine.seg_cap)
        self.level_models: list = [None] * N_LEVELS   # file granularity only
        # filter plane: per-level bloom filters ahead of the PLR descent,
        # rebuilt lazily at dispatch when a level's version moved; CBA picks
        # bits-per-key from observed miss traffic
        self.level_filters: list = [None] * N_LEVELS
        self._filter_versions = [-1] * N_LEVELS
        self._filter_sized_at: dict[int, int] = {}  # level -> stat files seen
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
        self._vf = NULL_HANDLE           # value-fetch stage handle
        self._fp = NULL_HANDLE           # filter-probe stage handle

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def open(cls, path, cfg: StoreConfig | None = None) -> "BourbonStore":
        raise NotImplementedError("durable stores (BourbonStore.open) are "
                                  "ported in a later slice")

    def attach_io(self, pool) -> None:
        raise NotImplementedError("the host I/O pool is ported in a later "
                                  "slice")

    def attach_obs(self, obs, labels: dict | None = None) -> None:
        raise NotImplementedError("obs is ported in a later slice")

    # ------------------------------------------------------------------ write
    def put_batch(self, keys: np.ndarray, values: np.ndarray | None = None) -> None:
        keys = np.asarray(keys, np.int64)
        b = keys.shape[0]
        if values is None:
            values = np.zeros((b, self.cfg.value_size), np.uint8)
            values[:, 0] = (keys & 0xFF).astype(np.uint8)
        seqs = np.arange(self._seq, self._seq + b, dtype=np.int64)
        self._seq += b
        vptrs = self.vlog.append_batch(values)
        self._ingest(keys, seqs, vptrs)
        self.n_puts += b
        self.foreground_us += self.cfg.costs.t_put * b
        self.clock.advance(self.cfg.costs.t_put * b)
        self._tick()

    def delete_batch(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.int64)
        b = keys.shape[0]
        seqs = np.arange(self._seq, self._seq + b, dtype=np.int64)
        self._seq += b
        vptrs = np.full(b, -1, np.int64)  # tombstones
        self._ingest(keys, seqs, vptrs)
        self.clock.advance(self.cfg.costs.t_put * b)
        self._tick()

    def _ingest(self, keys: np.ndarray, seqs: np.ndarray,
                vptrs: np.ndarray) -> None:
        """Memtable insertion in capacity-sized chunks, flushing whenever
        the memtable fills."""
        b = keys.shape[0]
        off = 0
        while off < b:
            take = min(self.memtable.capacity - len(self.memtable), b - off)
            sl = slice(off, off + take)
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
        self._after_structure_change()

    def _after_structure_change(self) -> None:
        # drain dead files into CBA stats
        for t in self.tree.dead_files[self._dead_seen:]:
            self.cba.observe_dead_file(t, self.clock.now)
        self._dead_seen = len(self.tree.dead_files)
        # filters invalidate on any structure change: compaction churn
        # rewrites a level's key set.  The rebuild happens lazily at the
        # next dispatch (_ensure_filters)
        if self.cfg.filters.enabled:
            for i in range(N_LEVELS):
                if self.tree.level_version[i] != self._filter_versions[i]:
                    self.level_filters[i] = None

    def _tick(self) -> None:
        if self.cfg.mode != "bourbon" or self.cfg.policy in ("offline", "never"):
            # offline/never: no online learning
            self.executor.tick(self.tree, self.clock.now, self.level_models)
            return
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
                # FPR drift: re-size only when the completed-file stats
                # actually moved (cheap gate, not per-dispatch math)
                st = self.cba.level_stats.get(li)
                nf = st.n_files if st is not None else 0
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
        device path."""
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
        returning a :class:`PendingBatch` without waiting for the device."""
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
            # quarter-pow2 buckets of at least 64 probes, as the reference
            # pads them (its jit cache keys on the padded size)
            n = max(n_miss, 64)
            step = max(64, _next_pow2(n) // 4)
            pad = -(-n // step) * step
            eng_probes = np.full(pad, _PAD_PROBE, np.int64)
            eng_probes[:n_miss] = probes[miss]
            fm_host = level_hint = None
            if fstate is not None:
                # reuse the host screen's hashes for the dispatched keys —
                # all-True rows for filterless levels; pad lanes stay
                # all-True (results are discarded)
                fm_host = np.ones((N_LEVELS, pad), bool)
                hint = [True] * N_LEVELS
                for row, li in enumerate(live_idx):
                    fm_host[li, :n_miss] = fmaybe_keep[row]
                    # no dispatched key can live at a level whose mask row
                    # is all-False — the engine skips it
                    hint[li] = bool(fmaybe_keep[row].any())
                level_hint = tuple(hint)
            state = self.engine.build_state(self.tree)
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
        self._tick()
        if self.cfg.fetch_values:
            t0 = self._vf.begin()
            vals = self.vlog.get_batch_np(vptr)
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
                if t.model is not None:
                    us += p * c.t_pm + n * c.t_nm
                    self.lookups_model_path += p + n
                else:
                    us += p * c.t_pb + n * c.t_nb
                    self.lookups_baseline_path += p + n
        self.foreground_us += us
        self.clock.advance(us)

    def range_query(self, start_keys: np.ndarray, length: int) -> np.ndarray:
        """Batched short scans: locate each start key, then merge-scan
        `length` live items host-side.  Returns (B, length) keys, -1
        padded.  Versions shadow by seq: a key whose newest flushed version
        is a tombstone is skipped, not emitted.  Scans the flushed tree
        only — flush before ranging over fresh writes."""
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
        """Synchronously learn every live file — used to set up read-only
        experiments and ``offline`` mode initial models."""
        n = 0
        for lvl in self.tree.levels:
            for t in lvl:
                if t.model is None:
                    t.learn(self.cfg.lsm.plr_delta,
                            pad_to=self.cfg.engine.seg_cap)
                    n += 1
        self.executor.files_learned += n
        return n

    def flush_all(self) -> None:
        """Flush memtable + settle compactions (load-phase end)."""
        if len(self.memtable):
            self._flush()
        self._tick()

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        files = list(self.tree.all_files())
        n_learned = sum(1 for t in files if t.model is not None)
        model_bytes = sum(t.model.nbytes for t in files if t.model is not None)
        data_bytes = sum(
            t.n * (t.keys.dtype.itemsize + t.seqs.dtype.itemsize
                   + t.vptrs.dtype.itemsize) for t in files)
        segs = [int(t.model.n_segments) for t in files if t.model is not None]
        return {
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
