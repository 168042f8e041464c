"""Range-partitioned distributed GET on a mesh — the cluster-level Bourbon
read path (all-gather probes -> learned local lookup -> masked sum), the
PyTorch port of examples/distributed_get.py.

  python port/examples/distributed_get.py                      # every card
  python port/examples/distributed_get.py --device cpu --shards 4

On the card the mesh is one shard a visible card (``--shards N``: the
first N); ``--device cpu --shards N`` repeats the CPU N times, one shard a
mesh position.  Expect ``hit_rate=1.000``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DistStoreConfig, build_dist_get, build_dist_state_from_shards,
    place_dist_state)
from repro_torch.core.mesh import Mesh, make_mesh  # noqa: E402


def build(mesh: Mesh, n_keys: int = 1 << 16):
    """The example's data on ``mesh``: ``n_keys`` ar keys, each key's vptr
    its rank, cut into ``mesh.size`` equal range shards, each shard's
    segment table sized to its fitted model.  Returns (keys, cfg, the
    per-device state)."""
    keys = make_dataset("ar", n_keys, seed=2)
    vptrs = np.arange(keys.shape[0], dtype=np.int64)
    per = -(-keys.shape[0] // mesh.size)
    state = build_dist_state_from_shards(
        [(keys[s * per: (s + 1) * per], vptrs[s * per: (s + 1) * per])
         for s in range(mesh.size)])
    cfg = DistStoreConfig(n_keys=keys.shape[0], probe_batch=1 << 12,
                          seg_cap=state["starts"].shape[1])
    return keys, cfg, place_dist_state(state, mesh)


def run(mesh: Mesh, keys: np.ndarray, cfg: DistStoreConfig, state: list,
        batches: int = 1, seed: int = 0) -> dict:
    """``batches`` GETs of ``cfg.probe_batch`` present keys over ``mesh``,
    every answer checked (found, and the vptr = the key's rank); raises on
    a wrong one.  Returns the hit rate, the GETs and their host seconds
    (each GET waits for its pieces on the host)."""
    fn = build_dist_get(mesh, cfg)
    rng = np.random.default_rng(seed)
    hits = 0
    secs = 0.0
    for _ in range(batches):
        probes = rng.choice(keys, cfg.probe_batch)
        t0 = time.perf_counter()
        f, v = fn(state, torch.from_numpy(probes))
        found = np.concatenate([x.cpu().numpy() for x in f])
        vp = np.concatenate([x.cpu().numpy() for x in v])
        secs += time.perf_counter() - t0
        if not found.all():
            raise RuntimeError(f"{int((~found).sum())} present keys missed")
        if not np.array_equal(vp, np.searchsorted(keys, probes)):
            raise RuntimeError("a found key carries the wrong vptr")
        hits += int(found.sum())
    return {"devices": mesh.size, "keys": keys.shape[0],
            "probes": cfg.probe_batch, "batches": batches,
            "hit_rate": hits / (batches * cfg.probe_batch), "seconds": secs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh size (default: every visible card, or one "
                         "CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        n = args.shards or max(torch.cuda.device_count(), 1)
        mesh = make_mesh((n,), ("data",))
    else:
        n = args.shards or 1
        mesh = make_mesh((n,), ("data",), ["cpu"] * n)
    res = run(mesh, *build(mesh))
    print(f"devices={mesh.size} probes={res['probes']} "
          f"hit_rate={res['hit_rate']:.3f}")
    print("all probes answered by their owning range shard")
    return res


if __name__ == "__main__":
    main()
