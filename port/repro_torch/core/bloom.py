"""Per-sstable bloom filters, vectorized.

Build is host-side numpy (at flush/compaction time, like LevelDB's filter
block), copied from ``repro.core.bloom`` so the bits are identical; the
device probe is the CUDA kernel in ``repro_torch.kernels`` and
``bloom_probe_ref`` is its plain PyTorch version.

Hashing: double hashing h1 + i*h2 (Kirsch-Mitzenmacher) over 64-bit
Fibonacci-mixed keys.  PyTorch on the CPU has no ``>>``, ``%`` or ``+`` for
``torch.uint64``, so the torch hash runs in int64 — whose multiplication
wraps like uint64 — with the logical shift and the unsigned modulo written
out (``hash2_torch``, ``umod_torch``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bloom_build_np", "bloom_probe_np", "bloom_probe_hashed_np",
           "bloom_probe_ref", "hash2_torch", "umod_torch",
           "bloom_words", "DEFAULT_BITS_PER_KEY"]

DEFAULT_BITS_PER_KEY = 10
_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xC2B2AE3D27D4EB4F)
# the same mixes as two's-complement int64 (torch has no uint64 arithmetic)
_MIX1_I64 = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX2_I64 = 0xC2B2AE3D27D4EB4F - (1 << 64)
_LO32 = (1 << 32) - 1


def bloom_words(n_keys: int, bits_per_key: int = DEFAULT_BITS_PER_KEY) -> int:
    """Number of uint64 words for n_keys (rounded up, min 1)."""
    bits = max(64, n_keys * bits_per_key)
    return (bits + 63) // 64


def _hash2_np(keys: np.ndarray):
    k = keys.astype(np.uint64)
    h1 = (k * _MIX1)
    h1 ^= h1 >> np.uint64(29)
    h2 = (k * _MIX2) | np.uint64(1)
    h2 ^= h2 >> np.uint64(31)
    return h1, h2


def bloom_build_np(keys: np.ndarray, n_words: int, k_hashes: int = 7) -> np.ndarray:
    """Build packed filter bits (uint64 words) for the given keys."""
    bits = np.zeros(n_words, dtype=np.uint64)
    if keys.size == 0:
        return bits
    m = np.uint64(n_words * 64)
    h1, h2 = _hash2_np(keys)
    for i in range(k_hashes):
        pos = (h1 + np.uint64(i) * h2) % m
        np.bitwise_or.at(bits, (pos >> np.uint64(6)).astype(np.int64),
                         np.uint64(1) << (pos & np.uint64(63)))
    return bits


def bloom_probe_np(bits: np.ndarray, probes: np.ndarray, k_hashes: int = 7,
                   n_words: int | None = None) -> np.ndarray:
    """Host-side numpy probe of one (W,) filter — the store's pre-dispatch
    screen (no device work, no transfers).  Same math as bloom_probe_ref."""
    h1, h2 = _hash2_np(probes)
    return bloom_probe_hashed_np(bits, h1, h2, k_hashes, n_words)


def bloom_probe_hashed_np(bits: np.ndarray, h1: np.ndarray, h2: np.ndarray,
                          k_hashes: int = 7,
                          n_words: int | None = None) -> np.ndarray:
    """Probe with pre-mixed hashes: the double-hash bases are filter-
    independent, so a multi-level screen mixes the batch once and probes
    every level's filter with the same (h1, h2)."""
    if n_words is None:
        n_words = bits.shape[0]
    m = np.uint64(int(n_words) * 64)
    maybe = np.ones(h1.shape, bool)
    for i in range(k_hashes):
        pos = (h1 + np.uint64(i) * h2) % m
        word = bits[(pos >> np.uint64(6)).astype(np.int64)]
        maybe &= ((word >> (pos & np.uint64(63))) & np.uint64(1)).astype(bool)
    return maybe


def _lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash2_torch(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_hash2_np`` on int64 tensors: the same 64-bit patterns, as int64."""
    k = keys.to(torch.int64)
    h1 = k * _MIX1_I64
    h1 = h1 ^ _lshr(h1, 29)
    h2 = (k * _MIX2_I64) | 1
    h2 = h2 ^ _lshr(h2, 31)
    return h1, h2


def umod_torch(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x mod m`` reading the int64 ``x`` as uint64, for 0 < m < 2**31.

    Split into 32-bit halves: ``((hi % m) * (2**32 % m) + lo) % m``; every
    product stays below 2**62, so nothing overflows int64."""
    hi = _lshr(x, 32)
    lo = x & _LO32
    r32 = torch.remainder(torch.full_like(m, 1 << 32), m)
    return ((hi % m) * r32 + lo) % m


def bloom_probe_ref(bits: torch.Tensor, probes: torch.Tensor,
                    k_hashes: int = 7, n_words=None) -> torch.Tensor:
    """Plain PyTorch batched probe.

    bits: (W,) shared filter, or (B, W) per-probe filter rows, as int64
    (the uint64 words reinterpreted).  probes: (B,) int64.
    n_words: live word count (int or (B,) tensor) — the hash modulus is the
    filter's *build-time* size, not the padded width.
    Returns bool (B,): True = maybe present.
    """
    if n_words is None:
        n_words = bits.shape[-1]
    m = torch.as_tensor(n_words, dtype=torch.int64, device=probes.device) * 64
    m = torch.broadcast_to(m, probes.shape)
    if int(m.max()) >= 1 << 31:
        raise ValueError("filter too large for the 32-bit split modulus")
    h1, h2 = hash2_torch(probes)
    maybe = torch.ones(probes.shape, dtype=torch.bool, device=probes.device)
    for i in range(k_hashes):
        pos = umod_torch(h1 + i * h2, m)
        widx = pos >> 6
        if bits.ndim == 1:
            word = bits[widx]
        else:
            word = torch.gather(bits, -1, widx[..., None])[..., 0]
        maybe = maybe & (((word >> (pos & 63)) & 1) == 1)
    return maybe
