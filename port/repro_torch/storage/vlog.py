"""Durable segmented value log with WiscKey-style garbage collection.

Entries are ``(key i64, seq i64, value u8[value_size])`` — the key and
sequence ride with the value (WiscKey §4.2) so GC can ask the LSM whether
an entry is still referenced without any extra index.  The *logical*
address space stays flat: global slot ``p`` lives in segment
``p // seg_slots`` at in-file offset ``(p % seg_slots) * entry_size``, so
value pointers stored in sstables keep working as plain arena indices and
``device_view`` remains the (head, value_size) tensor on the engine's
device.

GC drops whole sealed segments: live entries are first relocated (appended
at the head with fresh seqs, pointers updated through the LSM by the
store), then the segment file is deleted and its arena rows zeroed.  The
reclaimed segment ids are recorded in the MANIFEST so recovery skips (and
cleans up) their files.
"""

from __future__ import annotations

import os

import numpy as np

from repro_torch.core.valuelog import ValueLog

from .format import fsync_dir, vlog_path

__all__ = ["DurableValueLog"]


class DurableValueLog(ValueLog):
    def __init__(self, value_size: int, dirpath: str, seg_slots: int = 1 << 12,
                 capacity: int = 1 << 16, fsync: bool = False,
                 device: str = "cuda") -> None:
        super().__init__(value_size, capacity, device=device)
        self.dir = dirpath
        self.seg_slots = seg_slots
        self.fsync = fsync
        self.entry_size = 16 + value_size
        self.removed: set[int] = set()
        # incremental dead-entry estimate per segment (maintained by the
        # store's write path via note_dead, persisted in the MANIFEST):
        # GC candidacy reads this instead of scanning the log
        self.dead_by_seg: dict[int, int] = {}
        self.dead_dirty: set[int] = set()  # changed since last persist
        self.dead_version = 0              # bumps on any estimate change
        self._entry_dt = np.dtype([("key", "<i8"), ("seq", "<i8"),
                                   ("val", "u1", (value_size,))])
        self._head_f = None
        self._head_seg = -1

    # ----------------------------------------------------------------- write
    def append_kv(self, keys: np.ndarray, seqs: np.ndarray,
                  values: np.ndarray) -> np.ndarray:
        ptrs = super().append_batch(values)
        if ptrs.shape[0] == 0:
            return ptrs
        rec = np.empty(ptrs.shape[0], self._entry_dt)
        rec["key"] = keys
        rec["seq"] = seqs
        rec["val"] = values
        segs = ptrs // self.seg_slots
        off = 0
        while off < ptrs.shape[0]:
            seg = int(segs[off])
            end = off + int(np.searchsorted(segs[off:], seg, side="right"))
            self._writer(seg).write(rec[off:end].tobytes())
            off = end
        self._head_f.flush()
        if self.fsync:
            os.fsync(self._head_f.fileno())
        return ptrs

    def _writer(self, seg: int):
        if seg != self._head_seg:
            if self._head_f is not None:
                self._close_handle(self._head_f)
            path = vlog_path(self.dir, seg)
            created = not os.path.exists(path)
            self._head_f = open(path, "ab")
            if self.fsync and created:
                fsync_dir(self.dir)  # the new entry must persist
            self._head_seg = seg
        return self._head_f

    def _close_handle(self, f) -> None:
        f.flush()
        if self.fsync:   # sealed segments must hit disk, not just the OS
            os.fsync(f.fileno())
        f.close()

    # -------------------------------------------------------------------- gc
    def note_dead(self, ptrs: np.ndarray) -> None:
        ptrs = np.asarray(ptrs, np.int64)
        ptrs = ptrs[ptrs >= 0]
        if ptrs.shape[0] == 0:
            return
        self.dead_entries += int(ptrs.shape[0])
        segs, counts = np.unique(ptrs // self.seg_slots, return_counts=True)
        for seg, c in zip(segs.tolist(), counts.tolist()):
            self.dead_by_seg[seg] = self.dead_by_seg.get(seg, 0) + c
            self.dead_dirty.add(seg)
        self.dead_version += 1

    def dead_ratio_est(self, seg: int) -> float:
        """Estimated dead fraction of a sealed segment — no file I/O."""
        return min(1.0, self.dead_by_seg.get(seg, 0) / self.seg_slots)

    def dead_delta(self) -> dict[int, int]:
        """Per-segment counts changed since the last persist (MANIFEST
        edits carry this delta; only checkpoints carry the full map)."""
        return {s: self.dead_by_seg.get(s, 0) for s in self.dead_dirty}

    def clear_dead_dirty(self) -> None:
        self.dead_dirty.clear()

    def sealed_segments(self) -> list[int]:
        """Fully-written, not-yet-reclaimed segments (GC candidates)."""
        n_sealed = self._head // self.seg_slots
        return [s for s in range(n_sealed) if s not in self.removed]

    def read_segment(self, seg: int, with_values: bool = True):
        """Returns (ptrs, keys, seqs, values) for a segment's complete
        entries — a torn trailing entry (crash mid-append) is ignored.
        ``with_values=False`` skips only the materialized payload *copy*
        (entries are interleaved, so the file bytes are read either way);
        the GC liveness pass needs just keys and pointers."""
        with open(vlog_path(self.dir, seg), "rb") as f:
            raw = f.read()
        count = len(raw) // self.entry_size
        rec = np.frombuffer(raw, dtype=self._entry_dt, count=count)
        ptrs = seg * self.seg_slots + np.arange(count, dtype=np.int64)
        vals = rec["val"].copy() if with_values else None
        return ptrs, rec["key"].copy(), rec["seq"].copy(), vals

    def drop_segment(self, seg: int) -> int:
        """Delete a reclaimed (sealed) segment's file; returns bytes freed."""
        if seg >= self._head // self.seg_slots:
            raise ValueError("cannot drop an unsealed segment")
        if seg == self._head_seg:
            # head sits exactly on the segment boundary: the last-written
            # file is sealed and droppable, but its handle is still open
            self._close_handle(self._head_f)
            self._head_f = None
            self._head_seg = -1
        path = vlog_path(self.dir, seg)
        freed = os.path.getsize(path) if os.path.exists(path) else 0
        if os.path.exists(path):
            os.unlink(path)
        self.removed.add(seg)
        self.dead_entries -= self.dead_by_seg.pop(seg, 0)
        self.dead_dirty.discard(seg)
        self.dead_version += 1
        lo, hi = seg * self.seg_slots, (seg + 1) * self.seg_slots
        self._buf[lo: min(hi, self._buf.shape[0])] = 0
        self._device = None
        return freed

    def close(self) -> None:
        if self._head_f is not None and not self._head_f.closed:
            self._close_handle(self._head_f)

    def disk_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.dir):
            if name.startswith("vlog-"):
                total += os.path.getsize(os.path.join(self.dir, name))
        return total

    # --------------------------------------------------------------- recover
    @classmethod
    def open(cls, dirpath: str, value_size: int, seg_slots: int,
             removed: set[int], vhead: int = 0, fsync: bool = False,
             dead_by_seg: dict[int, int] | None = None,
             device: str = "cuda") -> "DurableValueLog":
        vlog = cls(value_size, dirpath, seg_slots, fsync=fsync, device=device)
        vlog.removed = set(removed)
        if dead_by_seg:
            # restore the persisted dead estimates, minus anything a
            # crashed GC already reclaimed (vlog_rm wins over vdead)
            vlog.dead_by_seg = {s: c for s, c in dead_by_seg.items()
                                if s not in vlog.removed}
            vlog.dead_entries = sum(vlog.dead_by_seg.values())
        head = vhead
        segs = []
        for name in sorted(os.listdir(dirpath)):
            if not name.startswith("vlog-"):
                continue
            seg = int(name.split("-")[1].split(".")[0])
            if seg in vlog.removed:
                os.unlink(os.path.join(dirpath, name))  # GC'd then crashed
                continue
            segs.append(seg)
        for seg in segs:
            ptrs, _, _, vals = vlog.read_segment(seg)
            # truncate a torn trailing entry so later appends stay aligned
            path = vlog_path(dirpath, seg)
            want = ptrs.shape[0] * vlog.entry_size
            if os.path.getsize(path) != want:
                with open(path, "r+b") as f:
                    f.truncate(want)
            if ptrs.shape[0] == 0:
                continue
            hi = int(ptrs[-1]) + 1
            while hi > vlog._buf.shape[0]:
                vlog._buf = np.concatenate(
                    [vlog._buf, np.zeros_like(vlog._buf)], axis=0)
            vlog._buf[ptrs[0]: hi] = vals
            head = max(head, hi)
        vlog._head = head
        # if the manifest's vhead ran ahead of the head segment's file (OS
        # lost an unsynced tail), pad the file with dead zero entries so
        # future appends keep slot == file_offset/entry_size aligned —
        # otherwise GC would misattribute pointers and drop live data
        head_seg = head // seg_slots
        used = head - head_seg * seg_slots
        if used:
            path = vlog_path(dirpath, head_seg)
            created = not os.path.exists(path)
            have = 0 if created else os.path.getsize(path)
            want = used * vlog.entry_size
            if have < want:
                with open(path, "ab") as f:
                    f.write(b"\x00" * (want - have))
                    f.flush()
                    if fsync:
                        os.fsync(f.fileno())
                if fsync and created:
                    fsync_dir(dirpath)
        return vlog
