"""LSM tree: levels, flush and compaction (LevelDB-style, §2.1).

Geometry follows LevelDB: seven levels, L0 may hold overlapping files and is
compacted when it reaches a file-count trigger; L1..L6 hold disjoint sorted
files with a 10x per-level record budget.  Compaction merges the picked file
with overlapping files in the next level, drops shadowed versions (newest seq
wins) and tombstones at the bottom, and re-chunks into file_cap-record files.

Every structural change bumps a per-level version (used by level-model
invalidation, §3 "Lifetime of Levels") and logs creations/deletions for the
lifetime analyses (Fig. 3/5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .sstable import SSTable, build_sstable

__all__ = ["LSMConfig", "LSMTree", "CompactionEvent", "merge_order"]

N_LEVELS = 7


def merge_order(keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
    """The permutation ``np.lexsort((seqs, keys))`` gives (keys ascending,
    equal keys by seq ascending, full ties in input order), for any input.
    Fast when the input is a concatenation of key-sorted runs, as a
    compaction's sstables are: a stable argsort of the keys merges the runs
    (timsort finds them), and only the positions of keys that repeat are
    put in seq order again."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    rep = k[1:] == k[:-1]
    if rep.any():
        inrun = np.zeros(k.shape[0], bool)
        inrun[1:] = rep
        inrun[:-1] |= rep
        pos = np.flatnonzero(inrun)
        sub = order[pos]
        order[pos] = sub[np.lexsort((seqs[sub], k[pos]))]
    return order


@dataclasses.dataclass
class LSMConfig:
    memtable_cap: int = 1 << 14        # records buffered before flush
    file_cap: int = 1 << 15            # max records per sstable
    l0_trigger: int = 4                # L0 file count triggering compaction
    l1_cap_records: int = 1 << 17      # L1 budget; Li = L1 * 10^(i-1)
    level_factor: int = 10
    bits_per_key: int = 10
    bloom_k: int = 7
    plr_delta: int = 8

    def level_cap(self, level: int) -> int:
        if level == 0:
            return self.l0_trigger * self.file_cap
        return self.l1_cap_records * self.level_factor ** (level - 1)


@dataclasses.dataclass
class CompactionEvent:
    at: float
    level: int            # source level (-1 = memtable flush)
    n_records: int
    created: list[int]
    deleted: list[int]


class LSMTree:
    def __init__(self, cfg: LSMConfig) -> None:
        self.cfg = cfg
        self.levels: list[list[SSTable]] = [[] for _ in range(N_LEVELS)]
        self.level_version = [0] * N_LEVELS
        self.level_changed_at = [0.0] * N_LEVELS
        self.events: list[CompactionEvent] = []
        self.dead_files: list[SSTable] = []   # for lifetime stats
        self.compacted_records = 0

    # ------------------------------------------------------------------ stats
    def all_files(self):
        for lvl in self.levels:
            yield from lvl

    def total_records(self) -> int:
        return sum(t.n for t in self.all_files())

    def level_records(self, level: int) -> int:
        return sum(t.n for t in self.levels[level])

    # ------------------------------------------------------------------ mutation
    def _touch(self, level: int, now: float) -> None:
        self.level_version[level] += 1
        self.level_changed_at[level] = now

    def _retire(self, table: SSTable, now: float) -> None:
        table.deleted_at = now
        self.dead_files.append(table)

    def flush(self, keys: np.ndarray, seqs: np.ndarray, vptrs: np.ndarray,
              now: float) -> list[SSTable]:
        """Memtable -> one L0 file (memtable_cap <= file_cap by config)."""
        if keys.size == 0:
            return []
        t = build_sstable(keys, seqs, vptrs, 0, now,
                          self.cfg.bits_per_key, self.cfg.bloom_k)
        # newest-first ordering inside L0 (search order = recency)
        self.levels[0].insert(0, t)
        self._touch(0, now)
        self.events.append(CompactionEvent(now, -1, t.n, [t.file_id], []))
        return [t]

    def needs_compaction(self) -> int | None:
        """Return a level to compact, or None."""
        if len(self.levels[0]) >= self.cfg.l0_trigger:
            return 0
        for i in range(1, N_LEVELS - 1):
            if self.level_records(i) > self.cfg.level_cap(i):
                return i
        return None

    def compact_once(self, now: float) -> CompactionEvent | None:
        lvl = self.needs_compaction()
        if lvl is None:
            return None
        return self._compact_level(lvl, now)

    def _merge(self, tables: list[SSTable], drop_tombstones: bool):
        keys = np.concatenate([t.keys for t in tables])
        seqs = np.concatenate([t.seqs for t in tables])
        vptrs = np.concatenate([t.vptrs for t in tables])
        order = merge_order(keys, seqs)
        k, s, v = keys[order], seqs[order], vptrs[order]
        last = np.r_[k[1:] != k[:-1], True]   # newest version of each key
        k, s, v = k[last], s[last], v[last]
        if drop_tombstones:
            live = v >= 0
            k, s, v = k[live], s[live], v[live]
        return k, s, v

    def _compact_level(self, lvl: int, now: float) -> CompactionEvent:
        cfg = self.cfg
        if lvl == 0:
            srcs = list(self.levels[0])
        else:
            # pick the oldest file (round-robin analogue) at this level
            srcs = [min(self.levels[lvl], key=lambda t: t.created_at)]
        lo = min(t.min_key for t in srcs)
        hi = max(t.max_key for t in srcs)
        nxt = lvl + 1
        overlap = [t for t in self.levels[nxt]
                   if not (t.max_key < lo or t.min_key > hi)]
        merged = srcs + overlap
        bottom = nxt == N_LEVELS - 1 or all(
            not self.levels[j] for j in range(nxt + 1, N_LEVELS))
        k, s, v = self._merge(merged, drop_tombstones=bottom)
        self.compacted_records += sum(t.n for t in merged)

        created: list[SSTable] = []
        for off in range(0, k.shape[0], cfg.file_cap):
            sl = slice(off, off + cfg.file_cap)
            created.append(build_sstable(k[sl], s[sl], v[sl], nxt, now,
                                         cfg.bits_per_key, cfg.bloom_k))
        for t in srcs:
            self.levels[lvl].remove(t)
            self._retire(t, now)
        for t in overlap:
            self.levels[nxt].remove(t)
            self._retire(t, now)
        self.levels[nxt].extend(created)
        self.levels[nxt].sort(key=lambda t: t.min_key)
        self._touch(lvl, now)
        self._touch(nxt, now)
        ev = CompactionEvent(now, lvl, int(k.shape[0]),
                             [t.file_id for t in created],
                             [t.file_id for t in srcs + overlap])
        self.events.append(ev)
        return ev
