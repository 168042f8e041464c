"""Range-partitioned Bourbon state and its distributed GET (the port of
``repro.core.distributed``).

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
and never mutated in place.

The mesh GET (:func:`build_dist_get`, the reference's ``shard_map``
program) spreads the shards over a :class:`~repro_torch.core.mesh.Mesh`,
one shard row a device:

    all-gather the probe batch (8 B a probe)
      -> each device answers the whole batch against its one shard row
         (filter row, ModelLookup, LoadChunk+LocateKey)
      -> a sum combines the results (each probe has one owner at most)

One process drives every device, as the reference's single controller
does; the all-gather and the sums are device-to-device copies ordered on
each device's current stream, so nothing waits for a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

from .mesh import Mesh
from .plr import greedy_plr_np

__all__ = ["DistStoreConfig", "build_dist_state",
           "build_dist_state_from_shards", "dist_state_specs",
           "place_dist_state", "build_dist_get", "dist_get_local",
           "next_pow2"]

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


# the nine leaves of the filterless state, in the reference's order
STATE_KEYS = ("keys", "vptrs", "n", "lo", "hi", "starts", "slopes", "icepts",
              "nseg")


def dist_state_specs(mesh: Mesh, cfg: DistStoreConfig) -> dict:
    """Shape and dtype stand-ins of the stacked state for a mesh of
    ``mesh.size`` shards, as ``device="meta"`` tensors (no allocation)."""
    S = mesh.size
    cap = cfg.shard_cap(S)

    def meta(shape, dtype):
        return torch.empty((S,) + shape, dtype=dtype, device="meta")

    return {
        "keys": meta((cap,), torch.int64), "vptrs": meta((cap,), torch.int64),
        "n": meta((), torch.int32), "lo": meta((), torch.int64),
        "hi": meta((), torch.int64),
        "starts": meta((cfg.seg_cap,), torch.float64),
        "slopes": meta((cfg.seg_cap,), torch.float64),
        "icepts": meta((cfg.seg_cap,), torch.float64),
        "nseg": meta((), torch.int32),
    }


def place_dist_state(state_np: dict, mesh: Mesh) -> list:
    """Row ``s`` of the stacked numpy state (:func:`build_dist_state`,
    :func:`build_dist_state_from_shards`) on ``mesh.devices[s]``: one dict
    of (1, ...) tensors a mesh position, in mesh order.  The filter words
    ``fbits`` (uint64) are carried as int64 bits, as the kernels take
    them."""
    S = mesh.size
    for k, v in state_np.items():
        if v.shape[0] != S:
            raise ValueError(f"state leaf {k!r} has {v.shape[0]} rows, the "
                             f"mesh {S} devices")
    out = []
    for s, dev in enumerate(mesh.devices):
        row = {}
        for k, v in state_np.items():
            v = np.ascontiguousarray(v[s: s + 1])
            if k == "fbits":
                v = v.view(np.int64)
            row[k] = _to(torch.from_numpy(v), dev)
        out.append(row)
    return out


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, ordered on both devices' current streams: a copy
    between cards runs on the source's stream after the target's pending
    work and before the target's next, and a host tensor is pinned so that
    its upload does not wait for the card."""
    if t.device == dev:
        return t
    if t.device.type == "cpu" and dev.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _sum_on(ts, dev: torch.device) -> torch.Tensor:
    """The elementwise sum of ``ts`` on ``dev``, in their order."""
    acc = _to(ts[0], dev)
    for t in ts[1:]:
        acc = acc + _to(t, dev)
    return acc


def build_dist_get(mesh: Mesh, cfg: DistStoreConfig,
                   seg_search: str = "bisect",
                   combine: str = "reduce_scatter",
                   state_keys: tuple | None = None, k_hashes: int = 7):
    """Returns ``dist_get(state, probes) -> (found, vptr)`` over ``mesh``.

    ``state`` is :func:`place_dist_state`'s list, one shard row a mesh
    device; ``probes`` is one (B,) int64 tensor on any device, B a
    multiple of ``mesh.size``.  Its slice ``s`` of B / mesh.size probes is
    the batch's part that originates on device ``s``; every
    device gathers all slices and answers the whole batch against its row
    (its filter row first when the state has ``fbits``/``fnw``, then the
    descent of :func:`dist_get_local` on row 0).  found rides as int8 and
    the vptrs as where(hit, vptr, 0), then:

    combine="reduce_scatter": each origin's slice is summed onto its
    device, and the outputs are the per-device slices in mesh order
    (concatenated, the batch).  combine="allreduce": every device gets the
    whole sum, and the outputs are one full copy a device.  Each probe has
    one owner at most, so the sums are 0/1 and the owner's vptr.  Returns
    ``(found pieces, vptr pieces)``, tuples in mesh order of (bool,
    int64) tensors; a missed probe's vptr is -1.

    ``seg_search`` "bisect" and "compare" find the same segment, so both
    run the ``plr_lookup`` kernel.  ``state_keys`` pins the state's
    layout, as the reference pins its ``shard_map`` specs.  Each launch
    and copy runs on its device's current stream; nothing waits for a
    device."""
    if seg_search not in ("bisect", "compare"):
        raise ValueError(f"unknown seg_search {seg_search!r}")
    if combine not in ("reduce_scatter", "allreduce"):
        raise ValueError(f"unknown combine {combine!r}")
    keys = tuple(STATE_KEYS if state_keys is None else state_keys)
    filtered = "fbits" in keys
    devs = mesh.devices
    S = mesh.size

    def dist_get(state, probes):
        if len(state) != S or any(tuple(sorted(row)) != tuple(sorted(keys))
                                  for row in state):
            raise ValueError(f"state must be {S} rows with leaves {keys}")
        B = probes.shape[0]
        if B % S:
            raise ValueError(f"{B} probes do not split over {S} devices")
        m = B // S
        if probes.device.type == "cpu" and any(d.type == "cuda"
                                               for d in devs):
            probes = probes.pin_memory()       # one pinned upload a slice
        parts = [_to(probes[s * m: (s + 1) * m], d)
                 for s, d in enumerate(devs)]
        found, vsum = [], []
        for row, dev in zip(state, devs):
            # the all-gather: the whole padded batch on this device
            p = torch.cat([_to(x, dev) for x in parts])
            maybe = (ops.bloom_probe_stack(row["fbits"], row["fnw"], p,
                                           k_hashes) if filtered else None)
            rows = torch.zeros(p.shape[0], dtype=torch.int32, device=dev)
            hit, vptr = dist_get_local(row, p, rows, cfg.delta, maybe)
            found.append(hit.to(torch.int8))
            vsum.append(torch.where(hit, vptr, 0))
        if combine == "reduce_scatter":
            outs = [(_sum_on([f[o * m: (o + 1) * m] for f in found], dev),
                     _sum_on([v[o * m: (o + 1) * m] for v in vsum], dev))
                    for o, dev in enumerate(devs)]
        else:
            outs = [(_sum_on(found, dev), _sum_on(vsum, dev))
                    for dev in devs]
        f_out = tuple(f > 0 for f, _ in outs)
        v_out = tuple(torch.where(f > 0, v, -1) for f, v in outs)
        return f_out, v_out

    return dist_get
