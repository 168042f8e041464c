"""Request-distribution generators + YCSB-style workload mixes (§5.2.3, §5.5).

A copy of ``repro.core.workloads``: the same seed yields the same streams.

Distributions pick *indices into the loaded key set*; workloads yield batches
of (op, keys) with the paper's read/write mixes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["request_indices", "YCSB_MIXES", "WorkloadSpec", "iter_workload"]


def zipf_indices(rng, n_keys: int, size: int, theta: float = 0.99) -> np.ndarray:
    """YCSB-style scrambled zipfian over [0, n_keys)."""
    # inverse-CDF zipf over ranks, then scramble via multiplicative hash
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    w = 1.0 / ranks ** theta
    cdf = np.cumsum(w) / np.sum(w)
    u = rng.random(size)
    idx = np.searchsorted(cdf, u)
    scr = (idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(n_keys)
    return scr.astype(np.int64)


def request_indices(dist: str, rng: np.random.Generator, n_keys: int,
                    size: int, step: int = 0) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n_keys, size=size)
    if dist == "zipfian":
        return zipf_indices(rng, n_keys, size)
    if dist == "sequential":
        start = (step * size) % n_keys
        return (start + np.arange(size)) % n_keys
    if dist == "hotspot":  # 80% of requests to 20% of keys
        hot = rng.random(size) < 0.8
        lo = rng.integers(0, max(n_keys // 5, 1), size=size)
        hi = rng.integers(0, n_keys, size=size)
        return np.where(hot, lo, hi)
    if dist == "exponential":
        x = rng.exponential(scale=n_keys / 8.0, size=size).astype(np.int64)
        return np.clip(x, 0, n_keys - 1)
    if dist == "latest":  # skewed towards recently inserted (highest index)
        x = n_keys - 1 - rng.exponential(scale=n_keys / 8.0, size=size).astype(np.int64)
        return np.clip(x, 0, n_keys - 1)
    raise ValueError(dist)


# YCSB core workload mixes (§5.5.1)
YCSB_MIXES = {
    "A": dict(read=0.5, update=0.5, scan=0.0, insert=0.0, dist="zipfian"),
    "B": dict(read=0.95, update=0.05, scan=0.0, insert=0.0, dist="zipfian"),
    "C": dict(read=1.0, update=0.0, scan=0.0, insert=0.0, dist="zipfian"),
    "D": dict(read=0.95, update=0.0, scan=0.0, insert=0.05, dist="latest"),
    "E": dict(read=0.0, update=0.0, scan=0.95, insert=0.05, dist="zipfian"),
    "F": dict(read=0.5, update=0.5, scan=0.0, insert=0.0, dist="zipfian"),  # RMW
}


@dataclasses.dataclass
class WorkloadSpec:
    n_ops: int
    batch: int = 4096
    read_frac: float = 1.0
    scan_frac: float = 0.0
    insert_frac: float = 0.0
    dist: str = "uniform"
    scan_len: int = 50
    seed: int = 1

    @classmethod
    def ycsb(cls, name: str, n_ops: int, batch: int = 4096, seed: int = 1):
        m = YCSB_MIXES[name]
        return cls(n_ops=n_ops, batch=batch, read_frac=m["read"],
                   scan_frac=m["scan"], insert_frac=m["insert"],
                   dist=m["dist"], seed=seed)


def iter_workload(spec: WorkloadSpec, keys: np.ndarray):
    """Yields (op, key_batch) where op in {get, put, scan}.

    Updates re-insert existing keys; inserts add fresh keys past the max.
    """
    rng = np.random.default_rng(spec.seed)
    n_keys = keys.shape[0]
    next_new = int(keys[-1]) + 1
    done = 0
    step = 0
    while done < spec.n_ops:
        b = min(spec.batch, spec.n_ops - done)
        u = rng.random()
        if u < spec.read_frac:
            idx = request_indices(spec.dist, rng, n_keys, b, step)
            yield "get", keys[idx]
        elif u < spec.read_frac + spec.scan_frac:
            idx = request_indices(spec.dist, rng, n_keys, max(b // spec.scan_len, 1), step)
            yield "scan", keys[idx]
        elif u < spec.read_frac + spec.scan_frac + spec.insert_frac:
            fresh = np.arange(next_new, next_new + b, dtype=np.int64)
            next_new += b
            yield "put", fresh
        else:  # update = write existing key
            idx = request_indices(spec.dist, rng, n_keys, b, step)
            yield "put", keys[idx]
        done += b
        step += 1
