"""Filter plane: per-level bloom filters in front of the PLR descent.

A negative GET in Bourbon still pays the full model-probe descent across
every level; a level filter answers "definitely absent here" before any
PLR work (PAPERS.md: Learned LSM-trees via learned bloom filters).  The
plane has two tiers:

* a **host screen** (``filter_maybe_np``) run by the store over the
  memtable-miss keys before the device batch is built — keys absent at
  every level never dispatch at all and resolve as misses with zero
  probes;
* a **device mask**: the host screen's (L, B) maybe-mask, handed to the
  engine as ``fmaybe_host`` with the stacked ``(L, W)`` filters
  (``FilterState``), pruning which levels the descent visits for the
  keys that do dispatch.

Filters are built host-side at flush/compaction time from
``bloom_build_np`` over *all* level keys including tombstones (a
tombstone must pass its filter so the engine finds it and reports the
delete — zero false negatives by construction).  Sizing is CBA-driven:
``MaintenanceScheduler.filter_bits_per_key`` trades the false-positive
cost (wasted model probes) against build time and memory, charged to the
virtual clock like learning jobs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bloom import (DEFAULT_BITS_PER_KEY, _hash2_np, bloom_build_np,
                    bloom_probe_hashed_np, bloom_probe_np, bloom_words)

__all__ = ["FilterConfig", "LevelFilter", "build_level_filter",
           "filter_maybe_np"]


@dataclasses.dataclass
class FilterConfig:
    """Knobs for the filter plane (``StoreConfig.filters``)."""

    enabled: bool = True
    bits_per_key: int = DEFAULT_BITS_PER_KEY   # base sizing; CBA may resize
    min_bits_per_key: int = 6                  # CBA search bounds
    max_bits_per_key: int = 16
    rebuild_delta_bpk: int = 2   # re-filter when CBA's pick drifts this far
    # post-screen remainders at or below this size are answered host-side
    # (numpy binary search over the sstable key arrays) instead of paying
    # the fixed device-dispatch cost — an absent sweep collapses to a
    # handful of bloom false positives, not a device round trip
    host_answer_max: int = 128


@dataclasses.dataclass
class LevelFilter:
    """One level's built filter (host copy; the engine stacks device rows)."""

    bits: np.ndarray        # (n_words,) uint64 packed filter words
    n_words: int            # build-time word count == the hash modulus / 64
    k_hashes: int
    bits_per_key: int
    n_keys: int
    epoch: int = -1         # persistence epoch; -1 = built but not stamped

    def maybe(self, probes: np.ndarray) -> np.ndarray:
        return bloom_probe_np(self.bits, probes, self.k_hashes,
                              n_words=self.n_words)


def build_level_filter(keys: np.ndarray, bits_per_key: int,
                       k_hashes: int) -> LevelFilter:
    """Build a filter over a level's full key set (tombstones included)."""
    keys = np.asarray(keys, np.int64)
    n_words = bloom_words(keys.shape[0], bits_per_key)
    bits = bloom_build_np(keys, n_words, k_hashes)
    return LevelFilter(bits=bits, n_words=n_words, k_hashes=k_hashes,
                       bits_per_key=bits_per_key, n_keys=int(keys.shape[0]))


def filter_maybe_np(filters: list[LevelFilter | None],
                    probes: np.ndarray) -> np.ndarray:
    """Host screen: (L, B) maybe-mask; a level without a filter is all-True.

    ``mask.any(axis=0) == False`` keys are definitely absent everywhere and
    can skip device dispatch entirely.
    """
    out = np.ones((len(filters), probes.shape[0]), bool)
    live = [(i, f) for i, f in enumerate(filters) if f is not None]
    if not live or probes.shape[0] == 0:
        return out
    # the double-hash bases are filter-independent: mix the batch once,
    # probe every level with the same (h1, h2)
    h1, h2 = _hash2_np(np.asarray(probes, np.int64))
    for i, f in live:
        out[i] = bloom_probe_hashed_np(f.bits, h1, h2, f.k_hashes,
                                       n_words=f.n_words)
    return out
