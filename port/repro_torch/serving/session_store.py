"""Bourbon-backed session/prefix-cache index — the paper's technique as a
first-class serving component.

The serving engine must map request/session ids -> KV-cache page locations.
Session ids are 64-bit hashes (sparse, uniform-ish); churn produces immutable
sorted snapshots — exactly the sstable regime Bourbon learns.  The store IS
a BourbonStore: batched lookups of every id in an incoming decode batch take
the learned (PLR) path once snapshots are learned, with the CBA deciding
whether a snapshot (generation) is worth learning under churn.  A batch
whose post-screen remainder exceeds ``FilterConfig.host_answer_max`` goes
through the store's kernels on the card; smaller ones are answered on the
host.

Values in the value log are page-table records: (first_page, n_pages,
prefix_len) packed into the 64-byte payload.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import BourbonStore, LSMConfig, StoreConfig
from repro_torch.core.engine import EngineConfig

__all__ = ["SessionStore", "PageRecord"]


@dataclasses.dataclass
class PageRecord:
    first_page: int
    n_pages: int
    prefix_len: int

    def pack(self) -> np.ndarray:
        out = np.zeros(64, np.uint8)
        out[:24] = np.array([self.first_page, self.n_pages, self.prefix_len],
                            np.int64).view(np.uint8)
        return out

    @classmethod
    def unpack(cls, buf: np.ndarray) -> "PageRecord":
        vals = buf[:24].view(np.int64)
        return cls(int(vals[0]), int(vals[1]), int(vals[2]))


class SessionStore:
    """session_id (int64) -> PageRecord, on a learned-index LSM whose
    engine runs on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, policy: str = "cba", device: str = "cuda") -> None:
        cfg = StoreConfig(
            mode="bourbon", policy=policy,
            lsm=LSMConfig(memtable_cap=1 << 12, file_cap=1 << 13,
                          l1_cap_records=1 << 15),
            engine=EngineConfig(seg_cap=2048),
            fetch_values=True, device=device)
        self.store = BourbonStore(cfg)

    def register_batch(self, session_ids: np.ndarray,
                       records: list[PageRecord]) -> None:
        vals = np.stack([r.pack() for r in records])
        self.store.put_batch(session_ids.astype(np.int64), vals)

    def lookup_batch(self, session_ids: np.ndarray
                     ) -> tuple[np.ndarray, list[PageRecord | None]]:
        found, vals = self.store.get_batch(session_ids.astype(np.int64))
        recs = [PageRecord.unpack(vals[i]) if found[i] else None
                for i in range(session_ids.shape[0])]
        return found, recs

    def evict_batch(self, session_ids: np.ndarray) -> None:
        self.store.delete_batch(session_ids.astype(np.int64))

    def stats(self) -> dict:
        return self.store.stats()
