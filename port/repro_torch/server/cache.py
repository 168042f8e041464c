"""HotKeyCache — learned-path-aware read-through cache.

Caches (key -> value row) for keys the snapshot/memtable path already
answered, so a hot key skips the whole lookup stack on its next GET.
Correctness comes from two invalidation rules, both visible in
``stats()``:

* **epoch** — every entry is stamped with its owning shard's structural
  epoch (``ShardedStore.shard_epochs()``: the flush/compaction event
  count that also versions the device state).  A probe whose entry
  carries a stale epoch drops it and misses: any memtable roll or
  compaction on the shard — including one triggered by value-log GC —
  conservatively flushes that shard's cached keys.
* **write** — PUT/DELETE batches flowing through the server explicitly
  drop their keys (an overwrite that stays in the memtable bumps no
  epoch, so the epoch rule alone would serve stale data).

Only *positive* results are cached — a not-found is never remembered, so
a fresh insert can't be shadowed by a stale negative.  Writes that
bypass the server (direct store calls) are outside the contract: route
all writes through the front end.

Storage is row-oriented numpy (one values matrix, parallel key/epoch/
shard/stamp vectors, a key->row dict for point addressing): probes and
fills are batched array ops, not per-key python — the cache sits on the
serving hot path, where the pipelined server overlaps host admission
with device compute, so its host cost must stay small.  Recency is
tracked with a per-batch clock stamp and eviction takes the
oldest-stamped rows in bulk (batch-granular LRU).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HotKeyCache"]


class HotKeyCache:
    def __init__(self, slots: int = 4096) -> None:
        self.slots = int(slots)
        self._slot: dict[int, int] = {}          # key -> row
        self._key = np.full(self.slots, -1, np.int64)    # -1 = free row
        self._epoch = np.zeros(self.slots, np.int64)
        self._shard = np.zeros(self.slots, np.int32)
        self._stamp = np.zeros(self.slots, np.int64)
        self._vals: np.ndarray | None = None     # (slots, V), first fill
        self._free = list(range(self.slots - 1, -1, -1))
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.inval_epoch = 0
        self.inval_write = 0

    def __len__(self) -> int:
        return len(self._slot)

    def _release(self, rows: np.ndarray) -> None:
        for row in rows:
            del self._slot[int(self._key[row])]
            self._key[row] = -1
            self._free.append(int(row))

    def lookup(self, keys: np.ndarray, epochs: tuple,
               out: np.ndarray) -> np.ndarray:
        """Probe the cache; hit rows are written into ``out`` in place.
        Returns the (B,) hit mask.  ``epochs`` is the fleet's current
        epoch vector — entries stamped under an older epoch are dropped
        here (lazy invalidation) and report as misses."""
        n = keys.shape[0]
        hit = np.zeros(n, bool)
        if self._vals is None:
            self.misses += n
            return hit
        get = self._slot.get
        rows = np.fromiter((get(int(k), -1) for k in keys), np.int64, n)
        have = rows >= 0
        if have.any():
            r = rows[have]
            fresh = (self._epoch[r]
                     == np.asarray(epochs, np.int64)[self._shard[r]])
            stale = r[~fresh]
            if stale.shape[0]:
                self._release(stale)
                self.inval_epoch += int(stale.shape[0])
            live = np.nonzero(have)[0][fresh]
            out[live] = self._vals[r[fresh]]
            hit[live] = True
            self._clock += 1
            self._stamp[r[fresh]] = self._clock
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += n - n_hit
        return hit

    def fill(self, keys: np.ndarray, values: np.ndarray,
             owners: np.ndarray, epochs: tuple) -> None:
        """Admit found (key, value) pairs read under ``epochs``.  Keys
        within one fill must be unique (the batcher dedups)."""
        n = keys.shape[0]
        if n == 0:
            return
        if n > self.slots:
            # a fill larger than the cache: only the last ``slots`` pairs
            # could survive anyway (sequential insertion would evict the
            # rest), so admit exactly those and count the drop
            self.evictions += n - self.slots
            self.fills += n - self.slots
            keys = keys[-self.slots:]
            values = values[-self.slots:]
            owners = owners[-self.slots:]
            n = self.slots
        if self._vals is None:
            self._vals = np.zeros((self.slots, values.shape[1]),
                                  values.dtype)
        self._clock += 1
        get = self._slot.get
        rows = np.fromiter((get(int(k), -1) for k in keys), np.int64, n)
        new = rows < 0
        n_new = int(new.sum())
        need = n_new - len(self._free)
        if need > 0:
            # bulk-evict the oldest-stamped live rows — but never a row
            # this very fill is updating (evicting it would hand the row
            # to a new key and then overwrite it with the old key's
            # value: wrong data served for the new key)
            used = np.nonzero(self._key >= 0)[0]
            if n_new < n:
                used = np.setdiff1d(used, rows[~new])
            oldest = used[np.argpartition(self._stamp[used], need - 1)[:need]]
            self._release(oldest)
            self.evictions += need
        if n_new:
            new_rows = [self._free.pop() for _ in range(n_new)]
            for k, row in zip(keys[new], new_rows):
                self._slot[int(k)] = row
            rows[new] = new_rows
            self._key[rows[new]] = keys[new]
        ep = np.asarray(epochs, np.int64)
        ow = np.asarray(owners, np.int64)
        self._vals[rows] = values
        self._shard[rows] = ow
        self._epoch[rows] = ep[ow]
        self._stamp[rows] = self._clock
        self.fills += n

    def invalidate(self, keys: np.ndarray) -> int:
        """Drop keys a write batch superseded; returns how many were
        actually cached."""
        n = 0
        pop = self._slot.pop
        for k in np.unique(np.asarray(keys, np.int64)):
            row = pop(int(k), None)
            if row is not None:
                self._key[row] = -1
                self._free.append(row)
                n += 1
        self.inval_write += n
        return n

    def stats(self) -> dict:
        probes = self.hits + self.misses
        return {
            "slots": self.slots,
            "entries": len(self._slot),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(probes, 1),
            "fills": self.fills,
            "evictions": self.evictions,
            "inval_epoch": self.inval_epoch,
            "inval_write": self.inval_write,
        }
