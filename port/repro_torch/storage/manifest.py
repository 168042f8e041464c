"""MANIFEST: a version-edit log tracking live files across flushes,
compactions, and value-log GC (LevelDB-style, one JSON edit per frame).

Each edit may carry::

    add       [[file_id, level], ...]   tables that became live
    del       [file_id, ...]            tables retired by compaction
    wal       int                       current WAL number after rotation
    seq       int                       next sequence number high-water mark
    clock     float                     virtual-clock high-water mark
    vhead     int                       value-log head (next global slot)
    vlog_rm   [segment_id, ...]         value-log segments reclaimed by GC
    vsize     int                       value size (fixed at creation)
    vslots    int                       value-log slots per segment
    pdelta    int                       PLR error bound models were fit with
    vdead     {seg: n_dead}             dead-entry estimates, full snapshot
                                        (replaces; checkpoint edits only)
    vdead_d   {seg: n_dead}             dead-entry estimates, delta (merges
                                        absolute per-segment counts — keeps
                                        ordinary edits O(changed), not
                                        O(total segments))
    lmodel    {level: epoch}            level-granularity PLR model published
                                        for a level; the segments live in the
                                        ``lm-<level>-<epoch>.plm`` sidecar.
                                        Any add/del touching a level drops its
                                        record first (a structural change
                                        invalidates the model), so replay
                                        order alone decides validity.
    filter    {level: epoch}            level bloom filter published for a
                                        level; the bits live in the
                                        ``flt-<level>-<epoch>.bf`` sidecar.
                                        Same touched-level invalidation rule
                                        as lmodel.

``CURRENT`` names the live manifest file.  Replaying the edits in order
yields the exact live-file set and counters; frames use the shared
crc-framed encoding, so a torn final edit is dropped (its files were
written with ``os.replace`` and simply become unreferenced garbage).

The edit log is folded once it grows past a threshold
(:func:`checkpoint_edit` + ``StorageEngine.checkpoint``): the live state
becomes the single first edit of ``MANIFEST-<no+1>``, CURRENT switches
atomically, and the old file is deleted.  Recovery is unchanged — it
replays checkpoint-then-tail like any other edit sequence.
"""

from __future__ import annotations

import dataclasses
import json
import os

from .format import (CURRENT, FRAME_HDR_SIZE, fsync_dir, manifest_name,
                     read_frames, valid_frames_end, write_frame)

__all__ = ["ManifestState", "ManifestWriter", "read_manifest",
           "checkpoint_edit", "set_current"]


@dataclasses.dataclass
class ManifestState:
    live: dict          # file_id -> level
    wal_no: int = 0
    seq: int = 0
    clock: float = 0.0
    vhead: int = 0
    vlog_removed: set = dataclasses.field(default_factory=set)
    vlog_dead: dict = dataclasses.field(default_factory=dict)  # seg -> n_dead
    value_size: int | None = None   # vlog entry geometry, fixed at creation
    seg_slots: int | None = None
    plr_delta: int | None = None    # error bound the persisted models carry
    level_models: dict = dataclasses.field(default_factory=dict)  # lvl -> epoch
    filters: dict = dataclasses.field(default_factory=dict)       # lvl -> epoch

    def apply(self, edit: dict) -> None:
        if "vsize" in edit:
            self.value_size = edit["vsize"]
        if "vslots" in edit:
            self.seg_slots = edit["vslots"]
        if "pdelta" in edit:
            self.plr_delta = edit["pdelta"]
        # a structural change at a level invalidates its persisted level
        # model; resolve deleted files to levels BEFORE popping them
        touched = {self.live[fid] for fid in edit.get("del", [])
                   if fid in self.live}
        touched |= {level for _, level in edit.get("add", [])}
        for fid in edit.get("del", []):
            self.live.pop(fid, None)
        for fid, level in edit.get("add", []):
            self.live[fid] = level
        for level in touched:
            self.level_models.pop(level, None)
            self.filters.pop(level, None)
        # applied after the invalidation so a checkpoint edit carrying both
        # the full live set and the lmodel/filter records keeps them
        for level, epoch in edit.get("lmodel", {}).items():
            self.level_models[int(level)] = int(epoch)
        for level, epoch in edit.get("filter", {}).items():
            self.filters[int(level)] = int(epoch)
        if "wal" in edit:
            self.wal_no = edit["wal"]
        if "seq" in edit:
            self.seq = max(self.seq, edit["seq"])
        if "clock" in edit:
            self.clock = max(self.clock, edit["clock"])
        if "vhead" in edit:
            self.vhead = max(self.vhead, edit["vhead"])
        if "vdead" in edit:   # full snapshot, not a delta: last edit wins
            self.vlog_dead = {int(s): int(c)
                              for s, c in edit["vdead"].items()}
        for s, c in edit.get("vdead_d", {}).items():   # delta: merge
            self.vlog_dead[int(s)] = int(c)
        for seg in edit.get("vlog_rm", []):   # reclaimed: estimate retired
            self.vlog_removed.add(seg)
            self.vlog_dead.pop(seg, None)


class ManifestWriter:
    def __init__(self, dirpath: str, no: int = 1, fsync: bool = False,
                 publish: bool = True) -> None:
        self.path = os.path.join(dirpath, manifest_name(no))
        self.no = no
        self.fsync = fsync
        # drop a crash-torn trailing frame before appending: edits written
        # after garbage bytes would be invisible to every future replay
        end = valid_frames_end(self.path)
        if os.path.exists(self.path) and os.path.getsize(self.path) != end:
            with open(self.path, "r+b") as f:
                f.truncate(end)
        self._size = end
        self.base = 0   # bytes at the last checkpoint (tail = size - base)
        self._f = open(self.path, "ab")
        # publish=False: checkpoint writers stay unreferenced until their
        # checkpoint edit is durable, then set_current switches atomically
        if publish and not os.path.exists(os.path.join(dirpath, CURRENT)):
            set_current(dirpath, no, fsync)

    def append(self, edit: dict) -> None:
        payload = json.dumps(edit, sort_keys=True).encode()
        write_frame(self._f, payload)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._size += FRAME_HDR_SIZE + len(payload)

    def size(self) -> int:
        """Bytes of valid edit log (drives checkpoint scheduling)."""
        return self._size

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def set_current(dirpath: str, no: int, fsync: bool = False) -> None:
    """Atomically point CURRENT at MANIFEST-<no> (write-tmp + rename)."""
    current = os.path.join(dirpath, CURRENT)
    tmp = current + ".tmp"
    with open(tmp, "w") as f:
        f.write(manifest_name(no))
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, current)
    if fsync:
        fsync_dir(dirpath)


def checkpoint_edit(state: ManifestState) -> dict:
    """One edit that replays to exactly ``state`` from an empty log."""
    edit = {
        "add": sorted([fid, lvl] for fid, lvl in state.live.items()),
        "wal": state.wal_no, "seq": state.seq, "clock": state.clock,
        "vhead": state.vhead, "vlog_rm": sorted(state.vlog_removed),
        "vdead": {str(s): c for s, c in sorted(state.vlog_dead.items())},
    }
    if state.value_size is not None:
        edit.update(vsize=state.value_size, vslots=state.seg_slots,
                    pdelta=state.plr_delta)
    if state.level_models:
        edit["lmodel"] = {str(l): e
                          for l, e in sorted(state.level_models.items())}
    if state.filters:
        edit["filter"] = {str(l): e for l, e in sorted(state.filters.items())}
    return edit


def read_manifest(dirpath: str) -> tuple[ManifestState, int] | None:
    """Replay the manifest named by CURRENT; None if the dir is fresh."""
    current = os.path.join(dirpath, CURRENT)
    if not os.path.exists(current):
        return None
    with open(current) as f:
        name = f.read().strip()
    no = int(name.rsplit("-", 1)[1])
    path = os.path.join(dirpath, name)
    if not os.path.exists(path):
        # dangling CURRENT must be an error, never an empty store: replaying
        # "no frames" here would make recovery sweep every live file as
        # unreferenced garbage — silent total data loss
        raise FileNotFoundError(
            f"CURRENT names {name!r} but it does not exist in {dirpath!r}")
    state = ManifestState(live={})
    for payload in read_frames(path):
        state.apply(json.loads(payload.decode()))
    return state, no
