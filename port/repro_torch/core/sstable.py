"""Immutable sstable files (host representation).

An sstable holds fixed-size records (key + value-pointer + seqno) sorted by
key — the WiscKey layout (§2.2): values live in the value log, so records are
fixed-size and a learned model can turn a predicted *position* directly into a
byte offset (§4.2).

Blocks: records are grouped into BLOCK_RECORDS-record blocks; the per-block
first keys form the "index block" (fence keys) used by the baseline path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bloom import bloom_build_np, bloom_words
from .plr import PLRModel, greedy_plr_np

__all__ = ["SSTable", "BLOCK_RECORDS", "build_sstable", "advance_file_ids"]

BLOCK_RECORDS = 256  # records per data block (4KB block / 16B record in paper)
_next_file_id = 0


def _new_file_id() -> int:
    global _next_file_id
    v = _next_file_id
    _next_file_id += 1
    return v


def advance_file_ids(floor: int) -> None:
    """Keep new file ids above any recovered from a MANIFEST."""
    global _next_file_id
    _next_file_id = max(_next_file_id, floor)


@dataclasses.dataclass
class FileStats:
    """Per-file counters feeding the cost-benefit analyzer (§4.4.2)."""

    n_neg: int = 0          # negative internal lookups served
    n_pos: int = 0          # positive internal lookups served
    neg_baseline_us: float = 0.0   # time spent on baseline path during wait
    pos_baseline_us: float = 0.0


@dataclasses.dataclass(eq=False)
class SSTable:
    keys: np.ndarray        # (n,) int64 sorted unique
    seqs: np.ndarray        # (n,) int64
    vptrs: np.ndarray       # (n,) int64, -1 = tombstone
    fences: np.ndarray      # (n_blocks,) int64 first key of each block
    bloom: np.ndarray       # (W,) uint64
    bloom_k: int
    level: int
    file_id: int
    created_at: float       # virtual us
    deleted_at: float | None = None
    model: PLRModel | None = None
    model_built_at: float | None = None
    learn_submitted: bool = False
    stats: FileStats = dataclasses.field(default_factory=FileStats)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def min_key(self) -> int:
        return int(self.keys[0])

    @property
    def max_key(self) -> int:
        return int(self.keys[-1])

    def lifetime(self, now: float) -> float:
        end = self.deleted_at if self.deleted_at is not None else now
        return end - self.created_at

    def learn(self, delta: int, pad_to: int | None = None) -> PLRModel:
        """Fit the PLR model over this file's keys (host Greedy-PLR)."""
        self.model = greedy_plr_np(self.keys, delta=delta, pad_to=pad_to)
        return self.model


def build_sstable(keys: np.ndarray, seqs: np.ndarray, vptrs: np.ndarray,
                  level: int, now: float, bits_per_key: int = 10,
                  bloom_k: int = 7) -> SSTable:
    assert keys.ndim == 1 and keys.shape == seqs.shape == vptrs.shape
    n_blocks = max(1, -(-keys.shape[0] // BLOCK_RECORDS))
    fences = keys[::BLOCK_RECORDS][:n_blocks].copy()
    bloom = bloom_build_np(keys, bloom_words(keys.shape[0], bits_per_key), bloom_k)
    return SSTable(
        keys=np.ascontiguousarray(keys, np.int64),
        seqs=np.ascontiguousarray(seqs, np.int64),
        vptrs=np.ascontiguousarray(vptrs, np.int64),
        fences=np.ascontiguousarray(fences, np.int64),
        bloom=bloom, bloom_k=bloom_k, level=level,
        file_id=_new_file_id(), created_at=now,
    )
