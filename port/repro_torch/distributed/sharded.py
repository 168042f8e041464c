"""ShardedStore — the durable, range-partitioned cluster plane.

One lifecycle ties the three layers together (the multi-layer refactor of
the old demo plane, which rebuilt transient in-memory arrays on every
process start):

* **storage** — every range partition is a full :class:`BourbonStore`
  backed by its own ``shard-<i>/`` directory (WAL, MANIFEST, sstables
  with persisted PLR models, value log).  Killing the process loses
  nothing: each shard recovers independently through the engine's normal
  protocol, and the topology itself (shard count + split keys) lives in
  an atomically-written ``SHARDS.json`` next to the shard directories.
* **snapshot** — the distributed GET runs against stacked per-shard
  snapshots derived from the shards' *durable* sstables (newest-seq-wins
  merge, tombstones dropped), not from a side copy of the data.
  :func:`load_shard_snapshot` builds the same snapshot straight from a
  shard directory with nothing but ``storage.sstable_io`` — no store
  open, no WAL replay — which is what the ``dist_recovery`` benchmark
  times against a full rebuild.
* **epoch** — the device state is versioned by each shard's structural
  epoch (its tree's flush/compaction event count).  Writes land in
  per-shard memtables (host overlay on reads); when a memtable rolls
  into a new snapshot the owning shard's row is rebuilt and the global
  ``state_epoch`` bumps, so the ``shard_map`` GET always sees a
  consistent immutable "level" per shard, exactly the paper's read-path
  contract (§4.3 applied cluster-wide).

GETs check the owning shard's memtable first (newest data wins,
tombstones shadow), then answer the rest through
``core.distributed.build_dist_get`` when the store has a mesh of one
device a shard, or otherwise on the engine's device: one filter-plane
probe of every shard's bloom row (``ops.bloom_probe_stack``, an (S, B)
mask) and the shard descent ``core.distributed.dist_get_local`` with each
probe's owning shard row — the reference's host-fallback GET.  Both paths
share the masked-ownership semantics, so results are identical.

This is the port of ``repro.distributed.sharded``; ``SHARDS.json`` and
every shard directory are the reference's format, so a sharded store
written by either package opens in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core.cba import CBAConfig, MaintenanceConfig
from repro_torch.core.clock import CostModel
from repro_torch.core.distributed import (DistStoreConfig, build_dist_get,
                                          build_dist_state_from_shards,
                                          dist_get_local, next_pow2,
                                          place_dist_state)
from repro_torch.core.engine import EngineConfig, upload
from repro_torch.core.filters import FilterConfig, build_level_filter
from repro_torch.core.lsm import LSMConfig
from repro_torch.core.mesh import Mesh, make_mesh
from repro_torch.core.plr import greedy_plr_np
from repro_torch.core.store import BourbonStore, StoreConfig
from repro_torch.io import ValueFetch, wait_all
from repro_torch.kernels import ops
from repro_torch.obs import NULL_CTRACE, NULL_HANDLE, publish_stats
from repro_torch.storage.format import fsync_dir, sst_path
from repro_torch.storage.manifest import read_manifest
from repro_torch.storage.sstable_io import load_sstable

__all__ = ["ShardedConfig", "ShardedStore", "ShardPendingBatch",
           "load_shard_snapshot", "merge_live"]

TOPOLOGY = "SHARDS.json"
_PAD_PROBE = -(1 << 62)


@dataclasses.dataclass
class ShardedConfig:
    """Topology of a sharded store — fixed at creation and persisted, so
    a reopen routes every key exactly as the writer did."""
    n_shards: int = 2
    # n_shards-1 ascending split keys; shard i owns [splits[i-1], splits[i])
    boundaries: tuple | None = None
    key_lo: int = 0               # uniform-split fallback domain
    key_hi: int = 1 << 62
    delta: int = 8                # dist-plane PLR error bound

    def splits(self) -> tuple:
        if self.boundaries is not None:
            b = tuple(int(x) for x in self.boundaries)
            if (len(b) != self.n_shards - 1
                    or any(x >= y for x, y in zip(b, b[1:]))):
                raise ValueError(
                    f"boundaries must be {self.n_shards - 1} strictly "
                    f"ascending split keys, got {b}")
            return b
        span = self.key_hi - self.key_lo
        return tuple(self.key_lo + span * (i + 1) // self.n_shards
                     for i in range(self.n_shards - 1))


def _store_cfg_to_dict(cfg: StoreConfig) -> dict:
    """The reference's field set: the device is a property of the process
    that opens the store, not of the store, so it is not persisted."""
    d = dataclasses.asdict(cfg)
    d.pop("storage_dir", None)   # assigned per shard directory
    d.pop("device", None)
    d["engine"].pop("device", None)
    return d


def _store_cfg_from_dict(d: dict, device: str) -> StoreConfig:
    d = dict(d)
    nested = {"lsm": LSMConfig, "engine": EngineConfig, "cba": CBAConfig,
              "costs": CostModel, "maintenance": MaintenanceConfig,
              "filters": FilterConfig}
    for key, cls in nested.items():
        if key in d:   # topologies persisted before a field existed
            d[key] = cls(**d[key])
    return StoreConfig(**d, device=device)


def merge_live(tables) -> tuple[np.ndarray, np.ndarray]:
    """Newest-seq-wins merge of a shard's live sstables into one sorted
    (keys, vptrs) snapshot, shadowed versions and tombstones dropped —
    the immutable "level" the distributed read path serves."""
    if not tables:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    keys = np.concatenate([t.keys for t in tables])
    seqs = np.concatenate([t.seqs for t in tables])
    vptrs = np.concatenate([t.vptrs for t in tables])
    order = np.lexsort((seqs, keys))
    k, v = keys[order], vptrs[order]
    last = np.r_[k[1:] != k[:-1], True]   # newest version of each key
    k, v = k[last], v[last]
    live = v >= 0
    return np.ascontiguousarray(k[live]), np.ascontiguousarray(v[live])


def load_shard_snapshot(shard_dir: str,
                        verify: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Shard snapshot straight from disk: MANIFEST replay names the live
    sstables, ``sstable_io`` mmaps them, and the merge yields the same
    (keys, vptrs) arrays a live store's tree would.  Read-only — no lock,
    no WAL replay (unflushed records are the memtable's business), no
    garbage sweep — so it is safe to point at a directory mid-crash."""
    got = read_manifest(shard_dir)
    if got is None:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    state, _ = got
    tables = [load_sstable(sst_path(shard_dir, fid), verify=verify)
              for fid in sorted(state.live)]
    return merge_live(tables)


@dataclasses.dataclass
class ShardPendingBatch:
    """Dispatch half of a distributed GET, pinned to ONE epoch-versioned
    device state.  The memtable overlay is already answered host-side;
    ``f_dev``/``v_dev`` are device tensors of the snapshot path whose
    kernels may still be running (nothing blocked yet).  ``epochs``
    records the exact per-shard epoch vector the batch is answered under:
    every key in the batch resolves against that one snapshot, which is the
    snapshot-consistency invariant the pipelined server asserts."""
    probes: np.ndarray             # (B,) int64
    owner: np.ndarray              # (B,) int32 owning shard per key
    found: np.ndarray              # (B,) bool, memtable hits prefilled
    vptr: np.ndarray               # (B,) int64, memtable hits prefilled
    miss: np.ndarray               # (B,) bool — answered by the snapshot
    n_miss: int
    # device (pad,) bool / int64 tensors, their per-device pieces in mesh
    # order (a tuple) with a mesh, or None
    f_dev: object
    v_dev: object
    epochs: tuple                  # pinned per-shard epoch vector
    state_epoch: int               # device-state generation at dispatch
    with_values: bool
    resolved: bool = False
    # causal-tracing span the batch was dispatched under (the server's
    # "dispatch" span); None for the unsampled many
    trace: object = None


class ShardedStore:
    """Range-partitioned Bourbon store: durable shards, GETs through the
    filter-plane and descent kernels — over a mesh of one device a shard,
    or on the engine's device with the shards stacked."""

    def __init__(self, path: str, splits: tuple, shards: list,
                 delta: int, mesh: Mesh | None = None) -> None:
        self.path = path
        self.shards = shards
        self.delta = delta
        self._splits = np.asarray(splits, np.int64)
        self.device = shards[0].engine.device
        self._mesh = mesh
        self._get_fn = None
        self._snaps = [None] * len(shards)
        self._snap_models = [None] * len(shards)
        self._snap_filters = [None] * len(shards)
        self._snap_epochs = [-1] * len(shards)
        self._state = None
        self._state_epochs = None
        self.state_epoch = 0          # bumps whenever the device state refreshes
        self.n_gets = 0
        # observability (repro_torch.obs) — attach_obs wires these; null
        # objects keep the resolve hot path branch-free when obs is off
        self._obs = None
        self._vf = NULL_HANDLE
        self._fp = NULL_HANDLE
        self._ct = NULL_CTRACE
        # host I/O plane (repro_torch.io) — attach_io wires it; None keeps
        # every path on the original inline code
        self._io = None
        self._vf_hidden_us = 0.0     # fetch time overlapped away
        self._vf_exposed_us = 0.0    # fetch time the caller waited out

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def open(cls, path, scfg: ShardedConfig | None = None,
             store_cfg: StoreConfig | None = None,
             mesh="auto", device: str | None = None) -> "ShardedStore":
        """Open (or create) a sharded store rooted at ``path``.

        A fresh directory records the topology AND the per-shard store
        config in ``SHARDS.json`` (atomic write) and creates
        ``shard-<i>/`` per partition; an existing one reopens from its
        directories alone — the persisted config restores the store
        geometry, every shard recovers through the engine's normal
        protocol (WAL into memtable, sstables with their persisted file
        models, level models via the MANIFEST) — rejecting a mismatched
        shard count.  ``mesh`` is a :class:`Mesh` of one device a shard
        for the mesh GET, None for the stacked GET on the engine's device,
        or "auto": a mesh of distinct devices when the engine device's
        type offers at least ``n_shards`` of them (the CPU offers one),
        else none; its first device is the engine's, and the cards after
        it follow in index order, wrapping to cuda:0.  ``device`` names the engine device and overrides
        ``store_cfg.device``; a config read back from ``SHARDS.json``
        (which does not store the device) takes the default, the card."""
        if not (mesh is None or isinstance(mesh, Mesh)
                or (isinstance(mesh, str) and mesh == "auto")):
            raise TypeError(f"mesh must be a Mesh, None or 'auto', got "
                            f"{type(mesh).__name__}")
        path = str(path)
        os.makedirs(path, exist_ok=True)
        topo_path = os.path.join(path, TOPOLOGY)
        if os.path.exists(topo_path):
            with open(topo_path) as f:
                topo = json.load(f)
            n_shards = topo["n_shards"]
            splits = tuple(topo["splits"])
            delta = topo["delta"]
            if scfg is not None:
                # the topology is fixed at creation: reject any mismatch
                # instead of silently routing by the persisted values
                if scfg.n_shards != n_shards:
                    raise ValueError(
                        f"store at {path!r} has {n_shards} shards; "
                        f"refusing to open with n_shards={scfg.n_shards}")
                if (scfg.boundaries is not None
                        and tuple(int(b) for b in scfg.boundaries) != splits):
                    raise ValueError(
                        f"store at {path!r} was partitioned at {splits}; "
                        f"refusing to open with different boundaries")
                if scfg.delta != delta:
                    raise ValueError(
                        f"store at {path!r} uses dist-plane delta={delta}; "
                        f"refusing to open with delta={scfg.delta}")
            if store_cfg is None:
                store_cfg = _store_cfg_from_dict(
                    topo["store_cfg"],
                    device if device is not None else StoreConfig.device)
                device = None
        else:
            if os.path.exists(os.path.join(path, "shard-0")):
                # shard directories without their topology (lost or
                # never-durable SHARDS.json): re-creating with defaults
                # would silently orphan shards and re-route live keys
                raise RuntimeError(
                    f"{path!r} holds shard directories but no {TOPOLOGY}; "
                    f"refusing to re-create the topology over live data")
            scfg = scfg if scfg is not None else ShardedConfig()
            n_shards, delta = scfg.n_shards, scfg.delta
            splits = scfg.splits()
            store_cfg = store_cfg if store_cfg is not None else StoreConfig(
                device=device if device is not None else StoreConfig.device)
            tmp = topo_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"n_shards": n_shards, "splits": list(splits),
                           "delta": delta,
                           "store_cfg": _store_cfg_to_dict(store_cfg)}, f)
                if store_cfg.fsync:   # routing must survive power loss too
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, topo_path)
            if store_cfg.fsync:
                fsync_dir(path)
        if device is not None and device != store_cfg.device:
            store_cfg = dataclasses.replace(store_cfg, device=device)
        if isinstance(mesh, Mesh) and mesh.size != n_shards:
            raise ValueError(f"a mesh of {mesh.size} devices for "
                             f"{n_shards} shards (one device a shard)")
        shards: list[BourbonStore] = []
        try:
            for i in range(n_shards):
                shards.append(BourbonStore.open(
                    os.path.join(path, f"shard-{i}"), store_cfg))
        except BaseException:
            for st in shards:   # release the directory locks already taken
                st.close()
            raise
        if isinstance(mesh, str):      # "auto"
            dev = shards[0].engine.device
            have = torch.cuda.device_count() if dev.type == "cuda" else 1
            mesh = None
            if have >= n_shards:
                devs = [dev] * n_shards
                if dev.type == "cuda":     # from the engine's card, wrapping
                    first = (dev.index if dev.index is not None
                             else torch.cuda.current_device())
                    devs = [torch.device("cuda", (first + i) % have)
                            for i in range(n_shards)]
                mesh = make_mesh((n_shards,), ("shard",), devs)
        return cls(path, splits, shards, delta, mesh)

    def close(self) -> None:
        for st in self.shards:
            st.close()

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def uses_shard_map(self) -> bool:
        return self._mesh is not None

    # ----------------------------------------------------------------- write
    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Owning shard per key — total (out-of-range keys clamp to the
        first/last partition), so every key is always routable."""
        return np.searchsorted(self._splits, np.asarray(keys, np.int64),
                               side="right").astype(np.int32)

    def _fan_out_write(self, keys: np.ndarray, apply) -> None:
        """Route a write batch to its owning shards and run the per-shard
        slices — concurrently when an I/O pool is attached.  Shards are
        fully independent stores (own memtable, WAL, value log), and each
        key has exactly one owner, so concurrent per-shard application is
        order-free: results are identical to the sequential loop."""
        owner = self.shard_of(keys)
        work = []
        for i, st in enumerate(self.shards):
            mask = owner == i
            if mask.any():
                work.append((st, mask))
        if self._io is not None and len(work) > 1:
            wait_all([self._io.submit(apply, st, mask) for st, mask in work])
        else:
            for st, mask in work:
                apply(st, mask)

    def put_batch(self, keys: np.ndarray,
                  values: np.ndarray | None = None) -> None:
        keys = np.asarray(keys, np.int64)

        def apply(st, mask):
            st.put_batch(keys[mask], None if values is None else values[mask])

        self._fan_out_write(keys, apply)

    def delete_batch(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.int64)
        self._fan_out_write(keys,
                            lambda st, mask: st.delete_batch(keys[mask]))

    def wal_sync(self) -> None:
        """Fleet durability barrier: every shard's acknowledged WAL
        appends are on disk when this returns.  Under group commit each
        shard waits one coalesced fsync; with a pool the per-shard waits
        run concurrently, so the barrier costs ~one sync, not n_shards."""
        if self._io is not None and self.n_shards > 1:
            wait_all([self._io.submit(st.wal_sync) for st in self.shards])
        else:
            for st in self.shards:
                st.wal_sync()

    def flush_all(self) -> None:
        for st in self.shards:
            st.flush_all()

    def learn_all(self) -> int:
        return sum(st.learn_all() for st in self.shards)

    def drain_learning(self, max_us: float = 1e12) -> int:
        return sum(st.drain_learning(max_us) for st in self.shards)

    def gc_value_log(self, **kw) -> dict:
        out = {"segments_removed": 0, "bytes_reclaimed": 0,
               "entries_moved": 0}
        for st in self.shards:
            res = st.gc_value_log(**kw)
            for k in out:
                out[k] += res[k]
        return out

    # ----------------------------------------------------------- maintenance
    def set_maintenance_deferred(self, deferred: bool) -> None:
        """Hand the per-shard maintenance ticks to an external owner (the
        server's FleetMaintenanceCoordinator): deferred shards stop
        self-driving GC/checkpointing from their own write ticks and only
        do maintenance when :meth:`run_shard_maintenance` is called."""
        for st in self.shards:
            st.maintenance_deferred = deferred

    def run_shard_maintenance(self, shard_id: int,
                              budget_us: float | None = None) -> float:
        """One budget-bounded maintenance round on one shard; returns the
        virtual microseconds actually charged."""
        return self.shards[shard_id].run_maintenance(budget_us)

    def maintenance_us(self) -> float:
        """Total virtual time the fleet has spent on maintenance (value-log
        GC + MANIFEST checkpointing).  The server deltas this per tick to
        measure fleet stalls."""
        return sum(st.cba.gc_us + st.cba.checkpoint_us
                   for st in self.shards)

    # -------------------------------------------------------------- snapshot
    def shard_epochs(self) -> tuple:
        """Per-shard structural epoch (flush/compaction event count) — the
        same counter that versions the device state, exposed so the
        server's HotKeyCache can stamp entries with the epoch they were
        read under and lazily drop them when it moves."""
        return self._shard_epochs()

    def _shard_epochs(self) -> tuple:
        # one flush/compaction event = one structural change: the exact
        # moments a shard's memtable rolls into a new immutable snapshot
        return tuple(len(st.tree.events) for st in self.shards)

    def device_state(self):
        """The stacked (n_shards, ...) device state, or with a mesh its
        rows placed one a mesh device (``place_dist_state``: a list in
        mesh order).  Snapshots AND their fitted PLR models are cached per
        shard epoch, so a refresh merges and refits only the shards whose
        memtable actually rolled.  The restack/upload still copies every
        row (O(total records) bytes per refresh); updating only the
        changed device row is the next optimization if flush-heavy
        workloads make it show up."""
        epochs = self._shard_epochs()
        if self._state is None or epochs != self._state_epochs:
            fc = self.shards[0].cfg.filters
            bloom_k = self.shards[0].cfg.lsm.bloom_k
            for i, st in enumerate(self.shards):
                if self._snap_epochs[i] != epochs[i]:
                    self._snaps[i] = merge_live(list(st.tree.all_files()))
                    self._snap_models[i] = (
                        greedy_plr_np(self._snaps[i][0], delta=self.delta)
                        if self._snaps[i][0].shape[0] else None)
                    # per-shard bloom row, cached under the same epoch:
                    # the fused GET prunes shards that definitely lack
                    # the probe before any PLR work
                    self._snap_filters[i] = (
                        build_level_filter(self._snaps[i][0],
                                           fc.bits_per_key, bloom_k)
                        if fc.enabled and self._snaps[i][0].shape[0]
                        else None)
                    self._snap_epochs[i] = epochs[i]
            state_np = build_dist_state_from_shards(
                self._snaps, self.delta, models=self._snap_models,
                filters=self._snap_filters if fc.enabled else None)
            if self._mesh is not None:
                self._state = place_dist_state(state_np, self._mesh)
            else:
                if "fbits" in state_np:   # the uint64 words as int64 bits
                    state_np["fbits"] = state_np["fbits"].view(np.int64)
                self._state = {k: upload(v, self.device)
                               for k, v in state_np.items()}
            self._state_epochs = epochs
            self.state_epoch += 1
        return self._state

    # ------------------------------------------------------------------ read
    def _dist_dispatch(self, probes: np.ndarray):
        """Launch the snapshot-path lookup on the device and return the raw
        (found, vptr) tensors WITHOUT synchronizing, so the caller overlaps
        admission of the next batch with this one's compute.  The probe
        count is padded to a power of two (>= 64) with pad lanes no shard
        holds; slice ``[:n]`` at resolve.  With a mesh, the pad is rounded
        up to a multiple of the shard count and the mesh GET returns its
        per-device pieces in mesh order (the filter probe runs inside it,
        untimed, as in the reference).  Without one, one filter-plane
        probe covers every shard row, then the descent runs on each
        probe's owning row (misses carry vptr 0, merged to -1 at
        resolve)."""
        state = self.device_state()
        n = probes.shape[0]
        pad = next_pow2(max(n, 64))
        if self._mesh is not None:
            pad = -(-pad // self.n_shards) * self.n_shards
        buf = np.full(pad, _PAD_PROBE, np.int64)
        buf[:n] = probes
        if self._mesh is not None:
            if self._get_fn is None:
                cfg = DistStoreConfig(n_keys=0, probe_batch=0,
                                      delta=self.delta)
                # state layout pinned to what device_state() built: with
                # filters enabled it carries fbits/fnw rows the mesh GET
                # probes on each device before its descent
                self._get_fn = build_dist_get(
                    self._mesh, cfg, state_keys=tuple(sorted(state[0])),
                    k_hashes=self.shards[0].cfg.lsm.bloom_k)
            return self._get_fn(state, torch.from_numpy(buf))
        buf_dev = upload(buf, self.device)
        rows = upload(self.shard_of(buf), self.device)
        maybe = None
        if "fbits" in state:
            # one batched stack-probe for every shard row, async like the
            # lookup itself; the handle is timed as its own read stage
            t0 = self._fp.begin()
            maybe = ops.bloom_probe_stack(state["fbits"], state["fnw"],
                                          buf_dev,
                                          self.shards[0].cfg.lsm.bloom_k)
            self._fp.end(t0)
        return dist_get_local(state, buf_dev, rows, self.delta, maybe)

    def dispatch_get(self, probes: np.ndarray, with_values: bool = False,
                     trace=None) -> ShardPendingBatch:
        """Non-blocking half of :meth:`get_batch`: memtable overlays are
        answered host-side, the snapshot path is launched on device, and
        the returned handle is pinned to the single epoch-versioned
        device state current at dispatch.  Resolve with
        :meth:`resolve_get`; multiple dispatched batches may be in flight
        at once and (absent interleaved writes) share one state epoch.
        ``trace`` is the caller's causal dispatch span (or None): each
        shard's overlay probe becomes a fan-out ``shard_probe`` child."""
        probes = np.asarray(probes, np.int64)
        B = probes.shape[0]
        owner = self.shard_of(probes)
        vptr = np.full(B, -1, np.int64)
        mt_hit = np.zeros(B, bool)
        for i, st in enumerate(self.shards):
            idx = np.nonzero(owner == i)[0]
            if idx.shape[0] == 0:
                continue
            ssp = self._ct.begin_span("shard_probe", trace, link=trace,
                                      shard=i, keys=int(idx.shape[0]))
            f, v = st.memtable.get_batch(probes[idx])
            mt_hit[idx[f]] = True
            vptr[idx[f]] = v[f]
            self._ct.end_span(ssp)
        miss = ~mt_hit
        n_miss = int(miss.sum())
        f_dev = v_dev = None
        if n_miss:
            f_dev, v_dev = self._dist_dispatch(probes[miss])
            epochs = self._state_epochs     # vector the state was built on
        else:
            epochs = self._shard_epochs()
        return ShardPendingBatch(probes, owner, mt_hit.copy(), vptr, miss,
                                 n_miss, f_dev, v_dev, tuple(epochs),
                                 self.state_epoch, with_values,
                                 trace=trace)

    def resolve_get_async(self, pb: ShardPendingBatch) -> ValueFetch:
        """Hand the batch's entire blocking half — the device→host sync,
        the overlay merge, and the per-shard value-log reads — to the I/O
        pool as ONE :class:`ValueFetch` task.  The caller gets the handle
        back immediately and can admit/dispatch its next batch while this
        one materializes on a worker; ``.wait()`` is the join.  Without a
        pool the task runs inside ``wait()``, reproducing the old
        synchronous resolve exactly.

        Determinism: the task is self-contained — it reads only the
        batch's own pinned handle (``pb``) and the immutable snapshot/
        value-log state the pipeline's barriers guarantee is quiescent
        while reads are in flight, and scatters into arrays owned by this
        batch.  Worker count and completion order cannot change any
        result bit (the CI determinism gate holds us to it)."""
        if pb.resolved:
            raise RuntimeError("ShardPendingBatch already resolved")
        pb.resolved = True
        B = pb.probes.shape[0]
        self.n_gets += B               # caller thread: no racing counters
        found, vptr = pb.found, pb.vptr
        vals = (np.zeros((B, self.shards[0].cfg.value_size), np.uint8)
                if pb.with_values else None)
        # the blocking half's causal span: begun here on the caller, ended
        # inside the task — which may run on an IOPool worker thread
        # (retrack re-stamps the track) or inline at wait()
        iosp = self._ct.begin_span("io_task", pb.trace, link=pb.trace,
                                   keys=B)
        ct = self._ct

        def task():
            if isinstance(pb.v_dev, tuple):
                # the mesh GET's pieces in mesh order, one device-to-host
                # copy a device: a miss carries vptr -1, and the tombstone
                # mask below keeps exactly vptr >= 0, so the vptrs alone
                # give both answers
                v2 = np.concatenate([v.cpu().numpy()
                                     for v in pb.v_dev])[:pb.n_miss]
                found[pb.miss] = v2 >= 0
                vptr[pb.miss] = v2
            elif pb.f_dev is not None:
                f2 = pb.f_dev.cpu().numpy()[:pb.n_miss]
                v2 = pb.v_dev.cpu().numpy()[:pb.n_miss]
                found[pb.miss] = f2
                vptr[pb.miss] = np.where(f2, v2, -1)
            # located tombstones report not-found (in place: `found` IS
            # pb.found, so the returned result sees the update)
            np.logical_and(found, vptr >= 0, out=found)
            if vals is not None:
                for i, st in enumerate(self.shards):
                    sel = found & (pb.owner == i)
                    if sel.any():
                        vals[sel] = st.vlog.get_batch_np(vptr[sel])
            ct.end_span(iosp, retrack=True)

        result = (found, vals) if pb.with_values else (found, vptr)
        return ValueFetch(result, (task,), pool=self._io,
                          stage=self._vf, on_done=self._vf_overlap,
                          span=iosp)

    def _vf_overlap(self, hidden_us: float, exposed_us: float) -> None:
        self._vf_hidden_us += hidden_us
        self._vf_exposed_us += exposed_us

    def resolve_get(self, pb: ShardPendingBatch):
        """Blocking half: resolve and join the value fetch in one call."""
        return self.resolve_get_async(pb).wait()

    def get_batch(self, probes: np.ndarray, with_values: bool = False):
        """Batched GET: per-shard memtable overlay (newest data wins,
        tombstones shadow), then the snapshot path for the rest.  Returns
        (found, shard-local vptrs) or (found, values)."""
        return self.resolve_get(self.dispatch_get(probes, with_values))

    def range_query(self, start_keys: np.ndarray, length: int) -> np.ndarray:
        """Batched short scans across the partition map: each start key is
        answered by its owning shard, and a scan that runs off the end of
        a shard's key range continues into the next shard from its split
        boundary — so results are identical to a single unpartitioned
        store's.  Returns (B, length) keys, -1 padded.  (Delegates to the
        per-shard :meth:`BourbonStore.range_query`, which scans the
        flushed tree — flush before ranging over fresh writes.)"""
        start_keys = np.asarray(start_keys, np.int64)
        out = np.full((start_keys.shape[0], length), -1, np.int64)
        owner = self.shard_of(start_keys)
        for bi in range(start_keys.shape[0]):
            s = int(owner[bi])
            cur = int(start_keys[bi])
            got = 0
            while got < length:
                res = self.shards[s].range_query(
                    np.array([cur], np.int64), length - got)[0]
                valid = res[res >= 0]
                out[bi, got: got + valid.shape[0]] = valid
                got += int(valid.shape[0])
                if s == self.n_shards - 1:
                    break
                cur = int(self._splits[s])   # next shard's first owned key
                s += 1
        return out

    # -------------------------------------------------------------- io plane
    def attach_io(self, pool) -> None:
        """Join the fleet to one host I/O pool: value fetches resolve as
        overlappable :class:`ValueFetch` handles, per-shard writes and
        ``wal_sync`` barriers fan out concurrently, and each shard's own
        large-batch fetches chunk across the same workers."""
        self._io = pool
        for st in self.shards:
            st.attach_io(pool)

    def detach_io(self) -> None:
        self._io = None
        for st in self.shards:
            st.detach_io()

    # ------------------------------------------------------------------- obs
    def attach_obs(self, obs) -> None:
        """Join the fleet to one observability plane: every shard reports
        into the shared registry under its own ``shard=<i>`` label (so
        the per-shard breakdown survives aggregation), the distributed
        value-fetch is timed under the same ``value_fetch`` stage the
        single-store path uses, and a fleet-level collector publishes the
        cross-shard aggregates."""
        self._obs = obs
        self._vf = obs.tracer.stage("value_fetch")
        self._fp = obs.tracer.stage("filter_probe")
        self._ct = obs.ctrace
        for i, st in enumerate(self.shards):
            st.attach_obs(obs, labels={"shard": str(i)})
        obs.registry.register_collector(("fleet", self.path),
                                        self._collect_obs)

    def detach_obs(self) -> None:
        """Undo :meth:`attach_obs` fleet-wide (a fresh server with its
        own obs plane — or none — can then take over cleanly)."""
        if self._obs is not None:
            self._obs.registry.unregister_collector(("fleet", self.path))
        self._obs = None
        self._vf = NULL_HANDLE
        self._fp = NULL_HANDLE
        self._ct = NULL_CTRACE
        for st in self.shards:
            st.detach_obs()

    def _collect_obs(self, reg) -> None:
        reg.counter("fleet_gets_total").observe_total(self.n_gets)
        reg.gauge("fleet_state_epoch").set(self.state_epoch)
        # value-fetch overlap: fraction of total fetch time that ran
        # concurrently with other work instead of stalling the caller
        # (0.0 when inline; → 1.0 as the pool fully hides the fetch)
        c = reg.counter
        c("fleet_value_fetch_hidden_us_total").observe_total(
            self._vf_hidden_us)
        c("fleet_value_fetch_exposed_us_total").observe_total(
            self._vf_exposed_us)
        total_vf = self._vf_hidden_us + self._vf_exposed_us
        reg.gauge("fleet_value_fetch_overlap_ratio").set(
            self._vf_hidden_us / total_vf if total_vf else 0.0)
        for i, ep in enumerate(self._shard_epochs()):
            reg.gauge("fleet_shard_epoch", shard=str(i)).set(ep)
        # fleet aggregates; the per-shard dicts are already published by
        # each shard's own labeled collector — don't double-report them
        publish_stats(reg, "fleet", self.stats(),
                      skip=("shards", "per_shard"))

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        per = [st.stats() for st in self.shards]
        auto_gc = {"runs": 0, "segments_removed": 0, "bytes_reclaimed": 0,
                   "entries_moved": 0}
        for p in per:
            for k in auto_gc:
                auto_gc[k] += p.get("auto_gc", {}).get(k, 0)
        agg = {
            "n_shards": self.n_shards,
            "state_epoch": self.state_epoch,
            "uses_shard_map": self.uses_shard_map,
            "n_gets": self.n_gets,
            "n_records": sum(p["n_records"] for p in per),
            "n_files": sum(p["n_files"] for p in per),
            "files_learned": sum(p["files_learned"] for p in per),
            "models_recovered": sum(p.get("models_recovered", 0)
                                    for p in per),
            "level_models_recovered": sum(
                p.get("level_models_recovered", 0) for p in per),
            # fleet maintenance totals (previously dropped on the floor):
            # value-log GC reclamation and MANIFEST checkpoint counts
            # summed across shards, plus the virtual time they charged
            "vlog_segments_removed": sum(
                p.get("vlog_segments_removed", 0) for p in per),
            "vlog_disk_bytes": sum(p.get("vlog_disk_bytes", 0) for p in per),
            "auto_gc": auto_gc,
            "gc_us": sum(p.get("gc_us", 0.0) for p in per),
            "manifest_checkpoints": sum(
                p.get("manifest_checkpoints", 0) for p in per),
            "checkpoint_us": sum(st.cba.checkpoint_us for st in self.shards),
            "maintenance_us": self.maintenance_us(),
            # fleet WAL accounting: appends/commits is the group-commit
            # coalesce factor the write-heavy benchmark reports
            "wal": {
                "appends": sum(p.get("wal", {}).get("appends", 0)
                               for p in per),
                "fsyncs": sum(p.get("wal", {}).get("fsyncs", 0)
                              for p in per),
                "commits": sum(p.get("wal", {}).get("commits", 0)
                               for p in per),
            },
            # resolve overlap: hidden = resolve time spent while the
            # caller was off doing other work, exposed = time it actually
            # blocked in wait().  hidden/(hidden+exposed) is the overlap
            # ratio the threaded serving arm reports
            "value_fetch": {
                "hidden_us": self._vf_hidden_us,
                "exposed_us": self._vf_exposed_us,
            },
            "shards": per,
            # labeled per-shard breakdown: the aggregate sums above erase
            # which shard did the work; this keyed view preserves it (and
            # flattens into `key="shard-<i>"`-labeled gauges through the
            # obs registry)
            "per_shard": {
                f"shard-{i}": {
                    "n_records": p["n_records"],
                    "n_files": p["n_files"],
                    "files_learned": p["files_learned"],
                    "gc_us": p.get("gc_us", 0.0),
                    "checkpoint_us": self.shards[i].cba.checkpoint_us,
                    "maintenance_us": (self.shards[i].cba.gc_us
                                       + self.shards[i].cba.checkpoint_us),
                    "auto_gc": dict(p.get("auto_gc", {})),
                    "vlog_disk_bytes": p.get("vlog_disk_bytes", 0),
                    "vlog_segments_removed": p.get(
                        "vlog_segments_removed", 0),
                    "manifest_checkpoints": p.get("manifest_checkpoints", 0),
                    "epoch": len(self.shards[i].tree.events),
                }
                for i, p in enumerate(per)
            },
        }
        return agg
