"""Synthetic + real-shaped key datasets (paper §5, Fig. 7).

All generators return sorted unique int64 keys < 2^53 (exactly representable
in the float64 PLR domain, mirroring the paper's 16B integer keys).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "DATASETS"]


def _unique_sorted(keys: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    keys = np.unique(keys.astype(np.int64))
    while keys.shape[0] < n:  # top up collisions
        extra = rng.integers(0, 1 << 52, size=n, dtype=np.int64)
        keys = np.unique(np.concatenate([keys, extra]))
    return keys[:n]


def linear(n: int, rng) -> np.ndarray:
    """All keys consecutive (paper: best case, 1 segment)."""
    return np.arange(n, dtype=np.int64)


def segmented(n: int, gap_every: int, rng) -> np.ndarray:
    """Gap after every `gap_every` consecutive keys."""
    base = np.arange(n, dtype=np.int64)
    gaps = (base // gap_every) * 1000
    return base + gaps


def normal(n: int, rng) -> np.ndarray:
    """Sampled from N(0,1), scaled to integers (paper's construction)."""
    x = rng.standard_normal(n * 2)
    keys = (x * (1 << 40)).astype(np.int64) + (1 << 45)
    return _unique_sorted(keys, n, rng)


def lognormal_ar(n: int, rng) -> np.ndarray:
    """Amazon-reviews-like: heavy-tailed id space."""
    x = rng.lognormal(mean=0.0, sigma=2.0, size=n * 2)
    keys = (x * (1 << 30)).astype(np.int64)
    return _unique_sorted(keys, n, rng)


def osm_like(n: int, rng) -> np.ndarray:
    """OpenStreetMaps-like: clustered mixture (dense cities, sparse rest)."""
    n_clusters = max(8, n // 4096)
    centers = np.sort(rng.integers(0, 1 << 50, size=n_clusters, dtype=np.int64))
    sizes = rng.multinomial(n * 2, rng.dirichlet(np.ones(n_clusters) * 0.3))
    parts = [c + np.abs(rng.standard_normal(s) * 65536).astype(np.int64)
             for c, s in zip(centers, sizes) if s > 0]
    return _unique_sorted(np.concatenate(parts), n, rng)


def uniform_sparse(n: int, rng) -> np.ndarray:
    """SOSD uspr-like: uniform sparse 64-bit-ish."""
    return _unique_sorted(rng.integers(0, 1 << 52, size=n * 2, dtype=np.int64), n, rng)


def uniform_dense(n: int, rng) -> np.ndarray:
    """SOSD uden-like: dense with small random gaps."""
    gaps = rng.integers(1, 4, size=n, dtype=np.int64)
    return np.cumsum(gaps)


def facebook_like(n: int, rng) -> np.ndarray:
    """SOSD face-like: piecewise uniform with regime shifts."""
    n_seg = 64
    bounds = np.sort(rng.integers(0, 1 << 51, size=n_seg, dtype=np.int64))
    sizes = rng.multinomial(n * 2, np.ones(n_seg) / n_seg)
    parts = [rng.integers(b, b + (1 << 44), size=s, dtype=np.int64)
             for b, s in zip(bounds, sizes)]
    return _unique_sorted(np.concatenate(parts), n, rng)


DATASETS = {
    "linear": linear,
    "seg1%": lambda n, rng: segmented(n, 100, rng),
    "seg10%": lambda n, rng: segmented(n, 10, rng),
    "normal": normal,
    "ar": lognormal_ar,
    "osm": osm_like,
    # SOSD-like family (§5.5.2)
    "amzn": lognormal_ar,
    "face": facebook_like,
    "logn": lognormal_ar,
    "norm": normal,
    "uden": uniform_dense,
    "uspr": uniform_sparse,
}


def make_dataset(name: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = DATASETS[name](n, rng)
    assert keys.shape[0] == n and np.all(np.diff(keys) > 0)
    return keys
