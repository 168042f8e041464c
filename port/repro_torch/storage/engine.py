"""StorageEngine: directory layout + durability orchestration.

Owns the WAL writer, the MANIFEST writer, and the SSTable files for one
store directory::

    <dir>/CURRENT           name of the live MANIFEST
    <dir>/MANIFEST-000001   crc-framed JSON version edits
    <dir>/wal-0000NN.log    crc-framed memtable records (rotated per flush)
    <dir>/0000NN.sst        sstables (keys/seqs/vptrs/bloom/fences/model)
    <dir>/vlog-0000NN.seg   value-log segments (owned by DurableValueLog)

Commit ordering per flush: table files first (atomic ``os.replace``), then
the MANIFEST edit that references them together with the post-rotation WAL
number, then the new WAL is opened and the old one deleted.  A crash
between any two steps leaves either unreferenced files (garbage, cleaned
lazily) or a WAL that fully re-derives the memtable — never a referenced
file that doesn't exist.
"""

from __future__ import annotations

import fcntl
import os

import numpy as np

from .format import (filter_path, fsync_dir, lmodel_path, manifest_name,
                     sst_path, wal_path)
from .manifest import (ManifestState, ManifestWriter, checkpoint_edit,
                       read_manifest, set_current)
from .sstable_io import (append_model, write_level_filter, write_level_model,
                         write_sstable)
from .wal import GroupCommitWAL, WALWriter, replay_wal

__all__ = ["StorageEngine"]


class StorageEngine:
    def __init__(self, dirpath: str, fsync: bool = False,
                 group_commit: bool = False) -> None:
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.fsync = fsync
        # group_commit swaps the WAL writer for the coalescing one: puts
        # acknowledge before they are durable and wal_sync() is the
        # durability point (storage README, "WAL commit contract")
        self.group_commit = group_commit
        self.persisted_models: set[int] = set()
        # WAL accounting survives rotation: writer instances are recreated
        # per flush, so their counters are folded in here before hand-off
        self._wal_appends = 0
        self._wal_fsyncs = 0
        self._wal_commits = 0
        self._wal_batch_tail: list[int] = []
        # one writer per directory: flock dies with the process, so a
        # crashed holder never wedges the store
        self._lock_f = open(os.path.join(dirpath, "LOCK"), "w")
        try:
            fcntl.flock(self._lock_f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self._lock_f.close()
            raise RuntimeError(
                f"store at {dirpath!r} is already open in another process")
        try:
            self._init_logs(dirpath, fsync)
        except BaseException:
            # release the flock: a failed construction (e.g. corrupt
            # CURRENT) must not wedge the next open in this process
            fcntl.flock(self._lock_f, fcntl.LOCK_UN)
            self._lock_f.close()
            raise

    def _init_logs(self, dirpath: str, fsync: bool) -> None:
        existing = read_manifest(dirpath)
        if existing is None:
            self.state = ManifestState(live={})
            self.manifest = ManifestWriter(dirpath, 1, fsync)
            self.wal_no = 1
            self.old_wal_no = self.wal_no
            edit = {"wal": self.wal_no}
            self.manifest.append(edit)
            self.state.apply(edit)
            self.recovered = False
        else:
            self.state, manifest_no = existing
            # sweep manifests CURRENT doesn't name: a crash mid-checkpoint
            # leaves either an unpublished new file or an unretired old one
            live_manifest = manifest_name(manifest_no)
            for name in os.listdir(dirpath):
                if name.startswith("MANIFEST-") and name != live_manifest:
                    os.unlink(os.path.join(dirpath, name))
            self.manifest = ManifestWriter(dirpath, manifest_no, fsync)
            # open is a fold point: tail bytes count from here, else a
            # manifest whose folded state exceeds the threshold would
            # re-checkpoint on the first tick of every session
            self.manifest.base = self.manifest.size()
            self.recovered = True
            # Recovery WAL protocol: never append to the pre-crash WAL.
            # Its records are re-ingested into a fresh wal-<n+1>; only after
            # that does a manifest edit acknowledge the new number and the
            # old file get deleted (finish_recovery).  Stray WALs from a
            # crashed recovery hold duplicates of acknowledged records —
            # remove them before they can be appended to.
            self.old_wal_no = self.state.wal_no
            for name in os.listdir(dirpath):
                if (name.startswith("wal-") and
                        name != os.path.basename(
                            wal_path(dirpath, self.old_wal_no))):
                    os.unlink(os.path.join(dirpath, name))
            self.wal_no = self.old_wal_no + 1
        # while True, the WAL is neither rotated nor acknowledged in the
        # manifest: a crash mid-recovery must re-derive everything from the
        # still-referenced pre-crash WAL
        self.in_recovery = self.recovered
        self.wal = self._new_wal(wal_path(dirpath, self.wal_no))

    def _new_wal(self, path: str):
        w = (GroupCommitWAL(path, self.fsync) if self.group_commit
             else WALWriter(path, self.fsync))
        # carry the causal tracer across rotation: a traced write must be
        # able to land in whichever writer is current
        ct = getattr(self, "_tracer", None)
        if ct is not None:
            w.tracer = ct
        return w

    def set_tracer(self, ct) -> None:
        """Wire the causal tracer (repro.obs.trace) into the WAL writer —
        and every writer a future rotation creates."""
        self._tracer = ct
        self.wal.tracer = ct

    def ensure_format(self, value_size: int, seg_slots: int,
                      plr_delta: int) -> None:
        """Record the store geometry at creation; refuse to open with a
        different one.  Wrong entry size would destroy the segment files;
        wrong plr_delta would silently shrink the model-path search window
        below the persisted models' error bound and lose reads."""
        if self.state.value_size is None:
            edit = {"vsize": value_size, "vslots": seg_slots,
                    "pdelta": plr_delta}
            self.manifest.append(edit)
            self.state.apply(edit)
            return
        want = (value_size, seg_slots, plr_delta)
        have = (self.state.value_size, self.state.seg_slots,
                self.state.plr_delta)
        if have != want:
            raise ValueError(
                f"store was created with (value_size, vlog_seg_slots, "
                f"plr_delta)={have}; refusing to open with {want}")

    # ------------------------------------------------------------------- wal
    def wal_append(self, keys: np.ndarray, seqs: np.ndarray,
                   vptrs: np.ndarray) -> None:
        self.wal.append(keys, seqs, vptrs)

    def wal_sync(self) -> None:
        """Durability barrier: returns once every acknowledged WAL append
        is on disk.  Per-append writers make this a no-op; under group
        commit it waits for (at most) one coalesced flush+fsync."""
        self.wal.sync()

    def wal_stats(self) -> dict:
        """Lifetime WAL accounting across rotations.  ``commits`` counts
        disk flush groups, so appends/commits is the coalesce factor the
        group-commit benchmark reports."""
        return {"appends": self._wal_appends + self.wal.appends,
                "fsyncs": self._wal_fsyncs + self.wal.fsyncs,
                "commits": self._wal_commits + self.wal.commits,
                "group_commit": self.group_commit}

    def drain_wal_batch_sizes(self) -> list[int]:
        """Per-commit group sizes since the last drain (rotated writers'
        tails included) — feeds the fsync-batch-size histogram."""
        out = self._wal_batch_tail
        self._wal_batch_tail = []
        out.extend(self.wal.drain_batch_sizes())
        return out

    def replay_old_wal(self):
        """Batches from the pre-crash WAL (recovery re-ingests them into a
        fresh WAL before ``finish_recovery`` removes this one)."""
        return replay_wal(wal_path(self.dir, self.old_wal_no))

    def finish_recovery(self, seq: int, clock: float, vhead: int,
                        rotate: bool = False) -> None:
        """Acknowledge the recovery WAL in the manifest, drop the old one.
        Only now may flushes rotate the WAL again.

        ``rotate=True`` when the replay flushed everything to sstables
        (memtable empty): the recovery WAL's records are all redundant, so
        a fresh empty WAL replaces it — otherwise each reopen cycle would
        re-flush the same records into duplicate tables."""
        ack_wal = self.wal_no + 1 if rotate else self.wal_no
        edit = {"wal": ack_wal, "seq": seq, "clock": clock, "vhead": vhead}
        self.manifest.append(edit)
        self.state.apply(edit)
        self.in_recovery = False
        if rotate:
            self.drop_old_wal(self._rotate_wal())
        self.drop_old_wal(self.old_wal_no)

    def drop_old_wal(self, old_no: int) -> None:
        if old_no != self.wal_no:
            path = wal_path(self.dir, old_no)
            if os.path.exists(path):
                os.unlink(path)

    def _rotate_wal(self) -> int:
        """Close the current WAL, open the next; returns the old number.
        Callers must only rotate when the memtable is empty (post-flush)
        and AFTER a manifest edit acknowledging wal_no+1 is durable — a
        manifest pointing at a not-yet-created WAL replays as empty, which
        is correct; the reverse order would let acknowledged writes land
        in a WAL the next recovery's stray sweep deletes.  ``close()``
        quiesces a group-commit writer (drains + final sync), so a
        rotated-away WAL never strands queued frames — redundant here
        anyway, since rotation only happens once the flush covered them."""
        self.wal.close()
        self._wal_appends += self.wal.appends
        self._wal_fsyncs += self.wal.fsyncs
        self._wal_commits += self.wal.commits
        self._wal_batch_tail.extend(self.wal.drain_batch_sizes())
        old = self.wal_no
        self.wal_no += 1
        self.wal = self._new_wal(wal_path(self.dir, self.wal_no))
        return old

    # ------------------------------------------------------------- checkpoint
    def manifest_bytes(self) -> int:
        """Total size of the live manifest file (reporting)."""
        return self.manifest.size()

    def manifest_tail_bytes(self) -> int:
        """Edit bytes appended since the last checkpoint — the scheduling
        signal.  Comparing *total* size would loop forever once the folded
        state itself outgrew the threshold: every fold would immediately
        re-trigger.  Tail bytes go to zero after each fold by construction."""
        return self.manifest.size() - self.manifest.base

    def checkpoint(self) -> int:
        """Fold the live state into a single checkpoint edit in a new
        numbered MANIFEST and atomically retire the old one.

        Ordering: the new file is fully written (and fsync'd when enabled)
        *before* CURRENT switches, and the old file is deleted only after.
        A crash at any point leaves CURRENT naming a complete manifest;
        the other file is an orphan the next open sweeps.  Returns the
        size of the edit log that was folded away."""
        folded = self.manifest.size()
        new_no = self.manifest.no + 1
        target = os.path.join(self.dir, manifest_name(new_no))
        if os.path.exists(target):
            # leftover from a failed checkpoint earlier this session (the
            # orphan sweep only runs at open): appending after its stale
            # checkpoint edit would resurrect since-deleted files on replay
            os.unlink(target)
        w = ManifestWriter(self.dir, new_no, self.fsync, publish=False)
        w.append(checkpoint_edit(self.state))
        w.base = w.size()
        if self.fsync:
            # the new file's directory entry must be durable BEFORE CURRENT
            # names it — dir-entry writeback is unordered, and a CURRENT
            # that survives power loss pointing at a missing file would
            # otherwise be the store's only record
            fsync_dir(self.dir)
        set_current(self.dir, new_no, self.fsync)   # the atomic switch
        old_path = self.manifest.path
        self.manifest.close()
        self.manifest = w
        os.unlink(old_path)
        return folded

    @staticmethod
    def _vdead_field(edit: dict, vdead: dict | None) -> dict:
        """Attach a dead-estimate *delta* (segments changed since the last
        persist).  Full snapshots ride only in checkpoint edits, so an
        ordinary edit stays O(changed segments)."""
        if vdead:
            edit["vdead_d"] = {str(s): int(c) for s, c in vdead.items()}
        return edit

    # ----------------------------------------------------------------- flush
    def persist_flush(self, add_tables: list, delete_ids: list,
                      seq: int, clock: float, vhead: int,
                      vdead: dict | None = None) -> None:
        """Durably commit one flush/compaction batch and rotate the WAL.

        During recovery the rotation (and the manifest's WAL field) is
        withheld: un-replayed batches may still live only in the pre-crash
        WAL, and acknowledging a newer number would let the next recovery's
        stray-WAL sweep delete them."""
        for t in add_tables:
            write_sstable(self.dir, t, self.fsync)
            if t.model is not None:
                self.persisted_models.add(t.file_id)
        edit = self._vdead_field({
            "add": [[t.file_id, t.level] for t in add_tables],
            "del": [fid for fid in delete_ids if fid in self.state.live],
            "seq": seq, "clock": clock, "vhead": vhead,
        }, vdead)
        if not self.in_recovery:
            edit["wal"] = self.wal_no + 1
        self.manifest.append(edit)
        self.state.apply(edit)
        for fid in edit["del"]:
            self.persisted_models.discard(fid)
            path = sst_path(self.dir, fid)
            if os.path.exists(path):
                os.unlink(path)
        if not self.in_recovery:
            self.drop_old_wal(self._rotate_wal())

    # ----------------------------------------------------------------- model
    def persist_model(self, table) -> None:
        if table.file_id in self.persisted_models:
            return
        if table.file_id not in self.state.live:
            return  # died before its model landed; nothing on disk to patch
        append_model(sst_path(self.dir, table.file_id), table.model,
                     self.fsync)
        self.persisted_models.add(table.file_id)

    def persist_level_model(self, level: int, model) -> None:
        """Durably publish a level-granularity model (§4.3): the sidecar
        file is fully written first, then the MANIFEST ``lmodel`` edit
        names it — so a torn edit leaves an orphan sidecar (swept on the
        next open) rather than a referenced-but-missing model.  The
        superseded sidecar is deleted only after the new edit landed."""
        epoch = int(model.epoch)
        write_level_model(lmodel_path(self.dir, level, epoch), model,
                          self.fsync)
        old = self.state.level_models.get(level)
        edit = {"lmodel": {str(level): epoch}}
        self.manifest.append(edit)
        self.state.apply(edit)
        if old is not None and old != epoch:
            self.drop_level_model(level, old)

    def drop_level_model(self, level: int, epoch: int) -> None:
        """Remove a superseded/invalidated sidecar.  The manifest stopped
        referencing it already (new lmodel edit, or the add/del edit whose
        replay drops the record), so this is pure garbage collection — a
        crash beforehand just leaves a file the next open sweeps."""
        path = lmodel_path(self.dir, level, epoch)
        if os.path.exists(path):
            os.unlink(path)

    # ---------------------------------------------------------------- filters
    def persist_level_filter(self, level: int, flt) -> None:
        """Durably publish a level bloom filter, same sidecar-first
        protocol as :meth:`persist_level_model`: bits file fully written
        (and renamed) before the MANIFEST ``filter`` edit names it, so a
        torn edit leaves an orphan sidecar the next open sweeps."""
        epoch = int(flt.epoch)
        write_level_filter(filter_path(self.dir, level, epoch), flt,
                           self.fsync)
        old = self.state.filters.get(level)
        edit = {"filter": {str(level): epoch}}
        self.manifest.append(edit)
        self.state.apply(edit)
        if old is not None and old != epoch:
            self.drop_level_filter(level, old)

    def drop_level_filter(self, level: int, epoch: int) -> None:
        """Remove a superseded/invalidated filter sidecar (the manifest
        already stopped referencing it — pure garbage collection)."""
        path = filter_path(self.dir, level, epoch)
        if os.path.exists(path):
            os.unlink(path)

    # -------------------------------------------------------------------- gc
    def persist_gc(self, removed_segs: list[int], seq: int, clock: float,
                   vhead: int, vdead: dict | None = None) -> None:
        edit = self._vdead_field(
            {"vlog_rm": list(removed_segs), "seq": seq, "clock": clock,
             "vhead": vhead}, vdead)
        self.manifest.append(edit)
        self.state.apply(edit)

    # ----------------------------------------------------------------- close
    def close(self, seq: int, clock: float, vhead: int,
              vdead: dict | None = None) -> None:
        self.manifest.append(self._vdead_field(
            {"seq": seq, "clock": clock, "vhead": vhead}, vdead))
        self.abort()

    def abort(self) -> None:
        """Release handles and the directory lock without a final edit —
        used when open() fails after the engine was constructed."""
        self.manifest.close()
        self.wal.close()
        if not self._lock_f.closed:
            fcntl.flock(self._lock_f, fcntl.LOCK_UN)
            self._lock_f.close()
