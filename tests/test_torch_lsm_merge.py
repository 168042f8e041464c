"""The port's compaction merge and bloom build against the code it
replaced, to the last bit.

``lsm.merge_order`` stands in for ``np.lexsort((seqs, keys))`` in
``LSMTree._merge`` and in the sharded store's ``merge_live``; the bloom
build sets per-bit flags and packs them where the reference ORs masks
into words with ``np.bitwise_or.at``.  Randomized sstable runs, each
sorted by key with unique keys as a compaction's inputs are, share many
keys across runs (overwrites), carry tombstones (negative vptrs) and
repeated seqs, and merge with ``drop_tombstones`` both ways: keys, seqs
and vptrs must equal the lexsort copy's in dtype and bytes.  The bloom
words must equal the reference package's ``bloom_build_np``."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core.bloom import bloom_build_np as ref_bloom_build  # noqa: E402
from repro_torch.core.bloom import bloom_build_np, bloom_words  # noqa: E402
from repro_torch.core.lsm import LSMConfig, LSMTree, merge_order  # noqa: E402
from repro_torch.core.sstable import build_sstable  # noqa: E402
from repro_torch.distributed.sharded import merge_live  # noqa: E402


def lexsort_merge(tables, drop_tombstones: bool):
    """``LSMTree._merge`` as it was, with ``np.lexsort``."""
    keys = np.concatenate([t.keys for t in tables])
    seqs = np.concatenate([t.seqs for t in tables])
    vptrs = np.concatenate([t.vptrs for t in tables])
    order = np.lexsort((seqs, keys))
    k, s, v = keys[order], seqs[order], vptrs[order]
    last = np.r_[k[1:] != k[:-1], True]
    k, s, v = k[last], s[last], v[last]
    if drop_tombstones:
        live = v >= 0
        k, s, v = k[live], s[live], v[live]
    return k, s, v


def random_runs(seed: int, n_runs: int, key_space: int, max_len: int,
                unique_seqs: bool):
    """Key-sorted runs with unique keys a run, drawn from ``key_space``
    keys so that runs overlap; a fifth of the records tombstones; seqs
    unique across runs or drawn from a small range (repeats)."""
    r = np.random.default_rng(seed)
    tables, seq0 = [], 0
    for _ in range(n_runs):
        k = np.unique(r.integers(-key_space, key_space,
                                 r.integers(0, max_len + 1))).astype(np.int64)
        if unique_seqs:
            s = r.permutation(np.arange(seq0, seq0 + k.shape[0]))
            seq0 += k.shape[0]
        else:
            s = r.integers(0, 8, k.shape[0])
        v = r.integers(0, 1 << 30, k.shape[0])
        v[r.random(k.shape[0]) < 0.2] = -1
        tables.append(build_sstable(k, s.astype(np.int64),
                                    v.astype(np.int64), 1, 0.0))
    return tables


def same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        assert g.tobytes() == w.tobytes()


CASES = [(seed, n_runs, key_space, max_len, unique)
         for seed, (n_runs, key_space, max_len) in enumerate(
             [(1, 50, 40), (2, 30, 40), (5, 200, 150), (11, 5000, 3000),
              (4, 10, 10)])
         for unique in (True, False)]


@pytest.mark.parametrize("seed,n_runs,key_space,max_len,unique", CASES)
def test_merge_order_is_lexsorts_permutation(seed, n_runs, key_space,
                                             max_len, unique):
    tables = random_runs(seed, n_runs, key_space, max_len, unique)
    keys = np.concatenate([t.keys for t in tables])
    seqs = np.concatenate([t.seqs for t in tables])
    assert np.array_equal(merge_order(keys, seqs), np.lexsort((seqs, keys)))
    # any order of the input, not only sorted runs
    p = np.random.default_rng(seed).permutation(keys.shape[0])
    assert np.array_equal(merge_order(keys[p], seqs[p]),
                          np.lexsort((seqs[p], keys[p])))


@pytest.mark.parametrize("drop_tombstones", [False, True])
@pytest.mark.parametrize("seed,n_runs,key_space,max_len,unique", CASES)
def test_lsm_merge_matches_the_lexsort_copy(seed, n_runs, key_space,
                                            max_len, unique,
                                            drop_tombstones):
    tables = random_runs(seed, n_runs, key_space, max_len, unique)
    got = LSMTree(LSMConfig())._merge(tables, drop_tombstones)
    same(got, lexsort_merge(tables, drop_tombstones))


@pytest.mark.parametrize("seed,n_runs,key_space,max_len,unique", CASES)
def test_merge_live_matches_the_lexsort_copy(seed, n_runs, key_space,
                                             max_len, unique):
    tables = random_runs(seed, n_runs, key_space, max_len, unique)
    k, _, v = lexsort_merge(tables, drop_tombstones=True)
    same(merge_live(tables), (k, v))


def test_lsm_compactions_build_the_lexsort_copys_tree():
    """A whole load with overwrites and deletes through compactions: every
    file of every level equal to the one the lexsort merge builds."""
    from repro_torch.core import lsm as lsm_mod

    def load(order_fn):
        saved = lsm_mod.merge_order
        lsm_mod.merge_order = order_fn
        try:
            tree = LSMTree(LSMConfig(memtable_cap=256, file_cap=512,
                                     l0_trigger=2, l1_cap_records=1024))
            r = np.random.default_rng(5)
            seq = 0
            for b in range(40):
                k = np.unique(r.integers(0, 6000, 256)).astype(np.int64)
                s = np.arange(seq, seq + k.shape[0], dtype=np.int64)
                seq += k.shape[0]
                v = r.integers(0, 1 << 20, k.shape[0]).astype(np.int64)
                v[r.random(k.shape[0]) < 0.1] = -1
                tree.levels[0].insert(0, build_sstable(k, s, v, 0,
                                                       float(b)))
                while tree.compact_once(float(b)) is not None:
                    pass
            return [(t.keys, t.seqs, t.vptrs, t.bloom, t.fences)
                    for lvl in tree.levels for t in lvl]
        finally:
            lsm_mod.merge_order = saved

    got = load(merge_order)
    want = load(lambda keys, seqs: np.lexsort((seqs, keys)))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_keys", [0, 1, 7, 100, 4097, 32768])
@pytest.mark.parametrize("k_hashes", [1, 7, 12])
def test_bloom_build_matches_reference_words(n_keys, k_hashes):
    r = np.random.default_rng(n_keys + k_hashes)
    keys = r.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                      n_keys, dtype=np.int64)
    for n_words in {bloom_words(n_keys), bloom_words(n_keys, 3), 1, 5}:
        got = bloom_build_np(keys, n_words, k_hashes)
        want = ref_bloom_build(keys, n_words, k_hashes)
        assert got.dtype == np.uint64 and got.shape == (n_words,)
        assert got.tobytes() == np.asarray(want).tobytes()
