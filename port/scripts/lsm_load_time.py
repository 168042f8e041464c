#!/usr/bin/env python
"""chip_smoke.py's two host LSM loads, with the port's merge and bloom
build and with the reference's copies of them: where the smoke's set-up
time goes.

    python port/scripts/lsm_load_time.py

Three arms, each a fresh load in this process:

  copy   ``np.lexsort((seqs, keys))`` in the compaction merge and the
         shard snapshot merge, and ``np.bitwise_or.at`` in the bloom build
         (the code the port copied from the reference)
  merge  ``lsm.merge_order`` in both merges, the copied bloom build
  port   the port as it stands (``merge_order`` and the packed bloom build)

For each arm, phase A's load (``chip_smoke.load_store``, A_KEYS OSM keys)
and phase D's (``chip_smoke.load_sharded``, D_KEYS ar keys into four
durable shards in a temporary directory), each timed on the host's clock.
Then phase A's load at PROFILE_KEYS under cProfile in the ``merge`` and
``port`` arms, and phase D's in the ``port`` arm: the functions by self
time.  Prints one JSON line an arm and a profile, then the card's name and
power limit.  The arms build the same sstables, bit for bit
(``tests/test_torch_lsm_merge.py``).
"""

from __future__ import annotations

import contextlib
import cProfile
import json
import os
import pstats
import shutil
import sys
import tempfile
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
from repro_torch.core import bloom, filters, lsm, sstable  # noqa: E402
from repro_torch.distributed import sharded  # noqa: E402

PROFILE_KEYS = 1 << 20


def lexsort_order(keys: np.ndarray, seqs: np.ndarray) -> np.ndarray:
    """The reference's merge order."""
    return np.lexsort((seqs, keys))


def bloom_build_or_at(keys: np.ndarray, n_words: int,
                      k_hashes: int = 7) -> np.ndarray:
    """The reference's bloom build (``repro.core.bloom.bloom_build_np``)."""
    bits = np.zeros(n_words, dtype=np.uint64)
    if keys.size == 0:
        return bits
    m = np.uint64(n_words * 64)
    h1, h2 = bloom._hash2_np(keys)
    for i in range(k_hashes):
        pos = (h1 + np.uint64(i) * h2) % m
        np.bitwise_or.at(bits, (pos >> np.uint64(6)).astype(np.int64),
                         np.uint64(1) << (pos & np.uint64(63)))
    return bits


@contextlib.contextmanager
def arm(name: str):
    """The port's modules with ``name``'s merge and bloom build."""
    saved = (lsm.merge_order, sharded.merge_order, sstable.bloom_build_np,
             filters.bloom_build_np)
    if name == "copy":
        lsm.merge_order = sharded.merge_order = lexsort_order
    if name in ("copy", "merge"):
        sstable.bloom_build_np = filters.bloom_build_np = bloom_build_or_at
    try:
        yield
    finally:
        (lsm.merge_order, sharded.merge_order, sstable.bloom_build_np,
         filters.bloom_build_np) = saved


def load(phase: str, n_keys: int) -> float:
    """Phase ``phase``'s load of ``n_keys`` on the card: its seconds."""
    d = tempfile.mkdtemp(prefix="bourbon_load_time_")
    try:
        t0 = time.perf_counter()
        if phase == "A":
            chip_smoke.load_store("cuda", n_keys, 0)
        else:
            chip_smoke.load_sharded(d, "cuda", n_keys, 0)[0].close()
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    for name in ("copy", "merge", "port"):
        with arm(name):
            print(json.dumps({"arm": name, "keys": chip_smoke.A_KEYS,
                              "shard_keys": chip_smoke.D_KEYS,
                              "a_load_s": load("A", chip_smoke.A_KEYS),
                              "d_load_s": load("D", chip_smoke.D_KEYS)}),
                  flush=True)
    for name, phase in (("merge", "A"), ("port", "A"), ("port", "D")):
        with arm(name):
            prof = cProfile.Profile()
            prof.enable()
            wall = load(phase, PROFILE_KEYS)
            prof.disable()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
        print(json.dumps({
            "profile": name, "load": phase, "keys": PROFILE_KEYS,
            "wall_s": wall,
            "top_self_s": [[f"{os.path.basename(fn)}:{ln}({func})", v[2]]
                           for (fn, ln, func), v in top]}), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
