"""Data pipeline: deterministic sharded token streams.

A copy of ``repro.data.pipeline``: numpy and threads, nothing to port;
the trainer uploads each batch to the card itself.

Design for 1000+ nodes (DESIGN.md §6):
  * the dataset is a flat token array (memory-mapped .npy in production;
    synthetic generator for tests) carved into fixed-size sequences;
  * step -> sequence assignment is a *pure function* of (step, global batch,
    host count, seed) — any host can recompute any shard, which is what makes
    straggler work-stealing and elastic re-meshing possible without a
    coordinator;
  * a background prefetch thread keeps `prefetch` batches ready.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["DataConfig", "TokenDataset", "synthetic_tokens", "HostDataLoader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    vocab: int = 32000


def synthetic_tokens(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Zipf-ish synthetic corpus (deterministic)."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=n_tokens).astype(np.int64)
    return (z % vocab).astype(np.int32)


class TokenDataset:
    """Flat token array -> (seq_len+1)-sized samples, shuffled per epoch by a
    stateless permutation."""

    def __init__(self, tokens: np.ndarray, cfg: DataConfig) -> None:
        self.tokens = tokens
        self.cfg = cfg
        self.n_samples = (tokens.shape[0] - 1) // cfg.seq_len

    @classmethod
    def mmap(cls, path: str, cfg: DataConfig) -> "TokenDataset":
        return cls(np.load(path, mmap_mode="r"), cfg)

    def _perm_index(self, epoch: int, i: int) -> int:
        """Stateless pseudo-random permutation (multiplicative hash walk)."""
        n = self.n_samples
        h = (i * 0x9E3779B97F4A7C15 + epoch * 2654435761
             + self.cfg.seed) % (1 << 64)
        return int(h % n)

    def sample(self, epoch: int, i: int) -> np.ndarray:
        j = self._perm_index(epoch, i)
        s = self.cfg.seq_len
        chunk = np.asarray(self.tokens[j * s: j * s + s + 1])
        return chunk

    def batch_for_step(self, step: int, host: int, n_hosts: int):
        """Deterministic (tokens, labels) for this host's slice of the global
        batch at `step`.  Pure function of its arguments."""
        gb = self.cfg.global_batch
        per_host = gb // n_hosts
        base = step * gb
        epoch = base // max(self.n_samples, 1)
        idx = [base + host * per_host + k for k in range(per_host)]
        rows = np.stack([self.sample(epoch, i % self.n_samples) for i in idx])
        return rows[:, :-1].astype(np.int32), rows[:, 1:].astype(np.int32)


class HostDataLoader:
    """Background prefetcher over TokenDataset.batch_for_step."""

    def __init__(self, ds: TokenDataset, host: int, n_hosts: int,
                 start_step: int = 0, prefetch: int = 2) -> None:
        self.ds = ds
        self.host = host
        self.n_hosts = n_hosts
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.ds.batch_for_step(step, self.host, self.n_hosts)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
