"""Quickstart: the Bourbon learned-index store, the PyTorch port of
examples/quickstart.py.

  python port/examples/quickstart.py                 # on the card
  python port/examples/quickstart.py --device cpu

Expect ``hit rate 1.000`` and ``model_path=100.0%``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro_torch.core import (BourbonStore, LSMConfig,  # noqa: E402
                              StoreConfig, make_dataset)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # a store with small files so compactions happen quickly
    store = BourbonStore(StoreConfig(
        mode="bourbon", policy="cba",
        lsm=LSMConfig(memtable_cap=1 << 12, file_cap=1 << 13,
                      l1_cap_records=1 << 15),
        fetch_values=True, device=args.device))

    # load 64K OSM-like keys in random order (values default to key-derived)
    keys = make_dataset("osm", 1 << 16, seed=0)
    store.put_batch(np.random.default_rng(0).permutation(keys))
    store.flush_all()

    # learn the sstables (PLR models, error bound delta=8)
    n = store.learn_all()
    print(f"learned {n} sstable models")

    # batched GET: every lookup takes the learned path
    probes = np.random.default_rng(1).choice(keys, 4096)
    found, values = store.get_batch(probes)
    if not found.all():
        raise RuntimeError(f"{int((~found).sum())} present keys missed")
    print(f"hit rate {found.mean():.3f}; first value bytes: {values[0][:4]}")

    # negatives mostly die at the bloom filter (probes+1 may be real keys in
    # clustered data — mask those out)
    missing = probes + 1
    truly_missing = ~np.isin(missing, keys)
    found_n, _ = store.get_batch(missing)
    false_hits = int(found_n[truly_missing].sum())
    print(f"false hits on truly-missing keys: "
          f"{false_hits} / {int(truly_missing.sum())}")

    s = store.stats()
    print(f"files={s['n_files']} avg_segments={s['avg_segments']:.1f} "
          f"space_overhead={100 * s['space_overhead']:.2f}% "
          f"model_path={100 * s['model_path_frac']:.1f}%")
    return {"learned": n, "hit_rate": float(found.mean()),
            "false_hits": false_hits, "stats": s}


if __name__ == "__main__":
    main()
