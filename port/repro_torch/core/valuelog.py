"""WiscKey value log (key-value separation, §2.2/§4.2).

Values are appended to a log; sstables store only (key, value-pointer).
Host side is a growable numpy arena; ``device_view`` exposes the log to the
engine's ReadValue gather as a (len, value_size) uint8 tensor on the engine's
device, rebuilt after appends.

The log also keeps an incremental dead-entry estimate: whenever the store
observes that a slot was superseded (overwrite or delete), it calls
:meth:`note_dead` with the old pointers.  The durable subclass
(``storage.vlog``) buckets the counts per segment so GC candidacy needs no
full-log scan.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import resolve_device, upload

__all__ = ["ValueLog"]


class ValueLog:
    def __init__(self, value_size: int = 64, capacity: int = 1 << 16,
                 device: str = "cuda") -> None:
        self.value_size = value_size
        self.device = resolve_device(device)
        self._buf = np.zeros((capacity, value_size), np.uint8)
        self._head = 0
        self._device = None  # lazily mirrored; invalidated on append
        self.dead_entries = 0  # slots superseded by overwrites/deletes

    def __len__(self) -> int:
        return self._head

    def note_dead(self, ptrs: np.ndarray) -> None:
        """Record that these slots were superseded.  Negative pointers
        (tombstones / never-stored) carry no log bytes and are ignored."""
        self.dead_entries += int((np.asarray(ptrs) >= 0).sum())

    def append_batch(self, values: np.ndarray) -> np.ndarray:
        """Append (B, value_size) payloads; returns (B,) int64 pointers."""
        b = values.shape[0]
        while self._head + b > self._buf.shape[0]:
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)], axis=0)
        ptrs = np.arange(self._head, self._head + b, dtype=np.int64)
        self._buf[self._head: self._head + b] = values
        self._head += b
        self._device = None
        return ptrs

    def append_kv(self, keys: np.ndarray, seqs: np.ndarray,
                  values: np.ndarray) -> np.ndarray:
        """Append with key/seq metadata.  The in-memory log has no use for
        them; the durable log (storage.vlog) persists them so GC can test
        entry liveness against the LSM."""
        del keys, seqs
        return self.append_batch(values)

    def get_batch_np(self, ptrs: np.ndarray) -> np.ndarray:
        ok = (ptrs >= 0) & (ptrs < self._head)
        safe = np.where(ok, ptrs, 0)
        out = self._buf[safe]
        out[~ok] = 0
        return out

    def device_view(self) -> torch.Tensor:
        if self._device is None or self._device.shape[0] < self._head:
            self._device = upload(self._buf[: self._head], self.device)
        return self._device
