"""Range-partitioned Bourbon state, host half (the port of
``repro.core.distributed`` without its mesh).

The sorted key space is range-partitioned into shards (the cluster-level
"FindFiles"); each shard holds its slice plus one PLR model over it, and
the per-shard snapshots are stacked into (n_shards, ...) arrays.  A batched
GET then runs the shard descent :func:`dist_get_local` with one shard row
per probe: the filter plane's (S, B) stack-probe mask, then ModelLookup
(``plr_lookup``) and LoadChunk+LocateKey (``bounded_search``) — the
hand-written kernels of ``repro_torch.kernels.ops`` on the card.

The reference answers a batch by running its shard kernel once per shard
over the whole batch and merging the owner-exclusive hits.  A shard's keys
all lie in its own key range, so a probe can hit only the shard that owns
it: one pass with each probe's owning row gives the same answers.  The
state is built from sorted snapshots (an immutable "level" in paper terms)
and never mutated in place.  The ``shard_map`` mesh GET
(``build_dist_get``) is a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

from .plr import greedy_plr_np

__all__ = ["DistStoreConfig", "build_dist_state",
           "build_dist_state_from_shards", "dist_get_local", "next_pow2"]

KEY_SENTINEL = np.iinfo(np.int64).max


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class DistStoreConfig:
    n_keys: int              # global keys in the snapshot
    probe_batch: int         # global probes per GET step
    delta: int = 8
    seg_cap: int = 512       # per-shard PLR segments (padded)

    def shard_cap(self, n_shards: int) -> int:
        return next_pow2(-(-self.n_keys // n_shards))


def _stack_shards(chunks, delta: int, cap: int | None,
                  seg_cap: int | None, models=None, filters=None):
    """Stack per-shard sorted (keys, vptrs) snapshots into the device-state
    dict, fitting one PLR model per shard.  ``cap``/``seg_cap`` default to
    the live maxima (padded to a power of two) so disk-recovered shards of
    any size fit; passing them pins the legacy fixed geometry.  ``models``
    supplies pre-fit per-shard PLR models (must use the same ``delta``) so
    a caller refreshing one shard need not refit the rest.  ``filters``
    (per-shard LevelFilter or None) adds stacked bloom rows ``fbits``
    (S, W) / ``fnw`` (S,) to the state so the GET kernel can prune shards
    that definitely lack a probe; ``fnw == 0`` marks no-filter rows."""
    n_shards = len(chunks)
    if models is None:
        models = [greedy_plr_np(k, delta=delta) if k.shape[0] else None
                  for k, _ in chunks]
    if cap is None:
        cap = max(64, next_pow2(max((k.shape[0] for k, _ in chunks),
                                    default=1)))
    if seg_cap is None:
        seg_cap = max(16, next_pow2(max(
            (int(m.n_segments) for m in models if m is not None), default=1)))
    ks = np.full((n_shards, cap), KEY_SENTINEL, np.int64)
    vs = np.full((n_shards, cap), -1, np.int64)
    ns = np.zeros((n_shards,), np.int32)
    lo = np.full((n_shards,), KEY_SENTINEL, np.int64)
    hi = np.full((n_shards,), KEY_SENTINEL, np.int64)
    starts = np.full((n_shards, seg_cap), np.inf, np.float64)
    slopes = np.zeros((n_shards, seg_cap), np.float64)
    icepts = np.zeros((n_shards, seg_cap), np.float64)
    nseg = np.zeros((n_shards,), np.int32)
    for s, ((chunk, vp), m) in enumerate(zip(chunks, models)):
        if chunk.shape[0] == 0:
            continue
        if chunk.shape[0] > cap:
            raise ValueError(f"shard {s} holds {chunk.shape[0]} keys > "
                             f"cap {cap}")
        ks[s, : chunk.shape[0]] = chunk
        vs[s, : chunk.shape[0]] = vp
        ns[s] = chunk.shape[0]
        lo[s], hi[s] = chunk[0], chunk[-1]
        k = int(m.n_segments)
        if k > seg_cap:
            raise ValueError(f"shard {s} model needs {k} segments > "
                             f"seg_cap {seg_cap}")
        starts[s, :k] = np.asarray(m.starts)[:k]
        slopes[s, :k] = np.asarray(m.slopes)[:k]
        icepts[s, :k] = np.asarray(m.intercepts)[:k]
        nseg[s] = k
    out = {"keys": ks, "vptrs": vs, "n": ns, "lo": lo, "hi": hi,
           "starts": starts, "slopes": slopes, "icepts": icepts,
           "nseg": nseg}
    if filters is not None:
        fw = max(64, next_pow2(max(
            (f.n_words for f in filters if f is not None), default=1)))
        fbits = np.zeros((n_shards, fw), np.uint64)
        fnw = np.zeros((n_shards,), np.int32)
        for s, f in enumerate(filters):
            if f is not None:
                fbits[s, : f.n_words] = f.bits
                fnw[s] = f.n_words
        out["fbits"] = fbits
        out["fnw"] = fnw
    return out


def build_dist_state(keys: np.ndarray, vptrs: np.ndarray, n_shards: int,
                     cfg: DistStoreConfig):
    """Host build: one globally sorted snapshot -> equal-count range chunks
    stacked into (n_shards, C) arrays + per-shard PLR models."""
    n = keys.shape[0]
    per = -(-n // n_shards)
    chunks = [(keys[s * per: (s + 1) * per], vptrs[s * per: (s + 1) * per])
              for s in range(n_shards)]
    return _stack_shards(chunks, cfg.delta, cfg.shard_cap(n_shards),
                         cfg.seg_cap)


def build_dist_state_from_shards(snapshots, delta: int = 8, models=None,
                                 filters=None):
    """Device state from per-shard snapshots (the durable-plane entry
    point): ``snapshots`` is a list of (keys, vptrs) pairs, one per range
    partition, each sorted by key with shadowed versions and tombstones
    already dropped — exactly what ``repro.distributed`` derives from a
    shard directory's sstables.  Geometry (row capacity, segment cap) is
    sized to the live maxima, so shards recovered from disk never need a
    global key count up front.  ``models`` optionally carries pre-fit
    per-shard PLR models (same ``delta``), letting an epoch-cached caller
    refit only the shards whose snapshot actually changed.  ``filters``
    optionally carries per-shard bloom filters (see ``_stack_shards``)."""
    return _stack_shards([(np.asarray(k, np.int64), np.asarray(v, np.int64))
                          for k, v in snapshots], delta, None, None, models,
                         filters)


def dist_get_local(state: dict, probes: torch.Tensor, rows: torch.Tensor,
                   delta: int, maybe: torch.Tensor | None = None):
    """The shard descent for a batch with one shard row per probe.

    ``state`` holds the stacked (S, ...) tensors of :func:`_stack_shards`
    on one device; ``rows`` (B,) int32 names each probe's owning shard;
    ``maybe`` is the (S, B) filter-plane mask (``ops.bloom_probe_stack``)
    or None.  A probe outside its shard's [lo, hi], or in an empty shard
    (lo = hi = KEY_SENTINEL, so a probe equal to the sentinel must not
    match), or ruled out by the filter, misses.  Returns (hit (B,) bool,
    vptr (B,) int64) with ``vptr = 0`` on misses, as the reference's shard
    kernel does; callers merge misses to -1."""
    r = rows.long()
    mine = ((state["n"][r] > 0) & (probes >= state["lo"][r])
            & (probes <= state["hi"][r]))
    if maybe is not None:
        mine = mine & maybe[r, torch.arange(probes.shape[0],
                                            device=probes.device)]
    pos = ops.plr_lookup(state["starts"], state["slopes"], state["icepts"],
                         state["nseg"], state["n"], rows, probes)
    idx, found = ops.bounded_search(state["keys"], state["n"], rows, pos,
                                    probes, delta)
    hit = found & mine
    return hit, torch.where(hit, state["vptrs"][r, idx.long()], 0)
