"""In-memory write buffer (memtable).

LevelDB uses a skiplist; the tensorized analogue is a sorted-run buffer:
puts append to an unsorted tail, and the table is (re)sorted lazily in
batches — batched writes are the device-friendly ingestion pattern.  Point reads
check the memtable before the tree (newest data wins).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MemTable"]


class MemTable:
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._keys = np.empty(capacity, np.int64)
        self._seqs = np.empty(capacity, np.int64)
        self._vptrs = np.empty(capacity, np.int64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def put_batch(self, keys: np.ndarray, seqs: np.ndarray, vptrs: np.ndarray) -> int:
        """Insert up to capacity; returns number consumed."""
        take = min(self.capacity - self._n, keys.shape[0])
        sl = slice(self._n, self._n + take)
        self._keys[sl] = keys[:take]
        self._seqs[sl] = seqs[:take]
        self._vptrs[sl] = vptrs[:take]
        self._n += take
        return take

    def get_batch(self, probes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(found bool, vptr int64) for each probe — newest seq wins."""
        found = np.zeros(probes.shape[0], bool)
        vptr = np.full(probes.shape[0], -1, np.int64)
        if self._n == 0:
            return found, vptr
        k = self._keys[: self._n]
        s = self._seqs[: self._n]
        v = self._vptrs[: self._n]
        # sort by (key, seq) and keep the newest version of each key
        order = np.lexsort((s, k))
        ks, ss, vs = k[order], s[order], v[order]
        last = np.r_[ks[1:] != ks[:-1], True]  # last occurrence = max seq
        ku, vu = ks[last], vs[last]
        idx = np.searchsorted(ku, probes)
        idx_c = np.minimum(idx, ku.shape[0] - 1)
        hit = ku[idx_c] == probes
        found[hit] = True
        vptr[hit] = vu[idx_c[hit]]
        return found, vptr

    def drain_sorted(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sort, dedupe (newest wins), clear; returns (keys, seqs, vptrs)."""
        k = self._keys[: self._n]
        s = self._seqs[: self._n]
        v = self._vptrs[: self._n]
        order = np.lexsort((s, k))
        ks, ss, vs = k[order], s[order], v[order]
        last = np.r_[ks[1:] != ks[:-1], True]
        out = ks[last].copy(), ss[last].copy(), vs[last].copy()
        self._n = 0
        return out
