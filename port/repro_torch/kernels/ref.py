"""Plain PyTorch versions of the five hand-written kernels.

Each takes the engine's row-indexed layout: a level's files are stacked into
(F, ...) tensors and ``rows`` (B,) int32 names the file row each probe reads.
The single-file contracts of ``repro.kernels`` (one (C,) sstable, one (S,)
model) are the case F = 1.  The CPU path and the tests run these; on the card
``chip_smoke.py`` holds each CUDA kernel against its plain version on the
same tensors.  Arithmetic mirrors the kernels exactly, including the PLR
multiply-then-add (no fused multiply-add) and round-half-to-even.

``bloom_probe_stack_ref`` is the filter plane's plain version: not rows
form, but every probe against every row of a stacked (L, W) filter.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.bloom import hash2_torch, umod_torch

__all__ = ["plr_lookup_rows_ref", "bounded_search_rows_ref",
           "bloom_probe_rows_ref", "sstable_search_rows_ref",
           "bloom_probe_stack_hits", "bloom_probe_stack_ref"]


def _bisect_rows(mat: torch.Tensor, rows: torch.Tensor, probes: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, side: str,
                 steps: int | None = None) -> torch.Tensor:
    """Per-probe bisect of ``mat[row]`` within [lo, hi); ``steps`` gather
    steps, enough for the widest range (log2 of the row width by default)."""
    C = mat.shape[-1]
    if steps is None:
        steps = max(1, math.ceil(math.log2(C + 1)))
    rows = rows.long()
    lo = lo.long()
    hi = hi.long()
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        kv = mat[rows, mid.clamp(0, C - 1)]
        go_right = (kv < probes) if side == "left" else (kv <= probes)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def plr_lookup_rows_ref(starts, slopes, icepts, nseg, n, rows, probes):
    """ModelLookup: bisect_right of the probe over ``starts[row, :max(nseg,1)]``,
    ``seg = max(lo-1, 0)``, ``pos = slope*p + icept`` rounded half to even,
    clamped to [0, max(n[row]-1, 0)] in float64 before the int32 cast."""
    r = rows.long()
    p = probes.to(torch.float64)
    zero = torch.zeros_like(r)
    lo = _bisect_rows(starts, rows, p, zero,
                      nseg[r].clamp(1, starts.shape[-1]), "right")
    seg = (lo - 1).clamp(min=0)
    pos = slopes[r, seg] * p
    pos = pos + icepts[r, seg]
    hi = (n[r].to(torch.float64) - 1).clamp(min=0)
    pos = torch.minimum(torch.round(pos).clamp(min=0), hi)
    return pos.to(torch.int32)


def bounded_search_rows_ref(keys, n, rows, pos, probes, delta: int):
    """LoadChunk+LocateKey: the first key equal to the probe among offsets
    -(delta+1)..delta+1 of ``pos``, each clipped to [0, C-1].  Returns
    (idx int32, found bool); a lane with no match gets the window's first
    index, and ``found = hit & idx < n[row]``."""
    C = keys.shape[-1]
    r = rows.long()
    offs = torch.arange(-(delta + 1), delta + 2, dtype=torch.int64,
                        device=probes.device)
    win_idx = (pos.long()[:, None] + offs[None, :]).clamp(0, C - 1)
    eq = keys[r[:, None], win_idx] == probes[:, None]
    hit = eq.any(dim=-1)
    rel = torch.argmax(eq.to(torch.uint8), dim=-1)   # argmax rejects bool
    idx = torch.gather(win_idx, 1, rel[:, None])[:, 0]
    return idx.to(torch.int32), hit & (idx < n[r])


def bloom_probe_rows_ref(bits, nw, rows, probes, k_hashes: int):
    """SearchFB: k double-hash probes into the row's filter (int64 words,
    the uint64 bits reinterpreted), modulus max(nw[row], 1)*64."""
    r = rows.long()
    m = nw[r].long().clamp(min=1) * 64
    W = bits.shape[-1]
    h1, h2 = hash2_torch(probes)
    maybe = torch.ones(probes.shape, dtype=torch.bool, device=probes.device)
    for i in range(k_hashes):
        pos = umod_torch(h1 + i * h2, m)
        word = bits[r, (pos >> 6).clamp(max=W - 1)]
        maybe = maybe & (((word >> (pos & 63)) & 1) == 1)
    return maybe


def sstable_search_rows_ref(fences, keys, n_blocks, n, rows, probes,
                            block_records: int):
    """SearchIB + SearchDB: bisect_right over ``fences[row, :max(nb,1)]`` gives
    ``blk = max(lo-1, 0)``; bisect_left within [blk*R, min(blk*R+R, n)).
    ``found = idx < n & keys[row, idx] == probe``."""
    C = keys.shape[-1]
    r = rows.long()
    zero = torch.zeros_like(r)
    lo = _bisect_rows(fences, rows, probes, zero,
                      n_blocks[r].clamp(1, fences.shape[-1]), "right")
    base = (lo - 1).clamp(min=0) * block_records
    nr = n[r].long()
    hi = torch.minimum(base + block_records, nr)
    idx = _bisect_rows(keys, rows, probes, base, hi, "left",
                       steps=max(1, math.ceil(math.log2(block_records + 1))))
    kv = keys[r, idx.clamp(0, C - 1)]
    return idx.to(torch.int32), (idx < nr) & (kv == probes)


def bloom_probe_stack_hits(bits, nw, probes, k_hashes: int):
    """(k, L, B) bool: whether hash i's bit is set in row l's filter for
    probe b.  The hash modulus is each row's build-time word count
    ``max(nw, 1)*64`` and the word index is clipped to W-1."""
    L, W = bits.shape
    m = nw.long().clamp(min=1)[:, None] * 64                    # (L, 1)
    if L and int(m.max()) >= 1 << 31:
        raise ValueError("filter too large for the 32-bit split modulus")
    h1, h2 = hash2_torch(probes)
    hits = torch.empty((k_hashes, L, probes.shape[0]), dtype=torch.bool,
                       device=probes.device)
    for i in range(k_hashes):
        pos = umod_torch((h1 + i * h2)[None, :], m)             # (L, B)
        word = torch.gather(bits, 1, (pos >> 6).clamp(max=W - 1))
        hits[i] = ((word >> (pos & 63)) & 1) == 1
    return hits


def bloom_probe_stack_ref(bits, nw, probes, k_hashes: int):
    """Filter plane: (L, W) stacked filters (int64 words, the uint64 bits
    reinterpreted) x (B,) probes -> (L, B) bool: every hash's bit set, and
    a row with ``nw == 0`` has no filter: all True."""
    hits = bloom_probe_stack_hits(bits, nw, probes, k_hashes)
    return hits.all(0) | (nw == 0)[:, None]
