"""The port's host primitives against the JAX package's, bit for bit: PLR
segments, bloom words and the torch hash, sstable fences, level filters,
memtable answers and LSM level shapes after the same writes."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import bloom as jbloom  # noqa: E402
from repro.core import filters as jfilters  # noqa: E402
from repro.core import lsm as jlsm  # noqa: E402
from repro.core import memtable as jmem  # noqa: E402
from repro.core import plr as jplr  # noqa: E402
from repro.core import sstable as jsst  # noqa: E402
from repro.core.datasets import make_dataset  # noqa: E402
from repro_torch.core import bloom as pbloom  # noqa: E402
from repro_torch.core import datasets as pdata  # noqa: E402
from repro_torch.core import filters as pfilters  # noqa: E402
from repro_torch.core import lsm as plsm  # noqa: E402
from repro_torch.core import memtable as pmem  # noqa: E402
from repro_torch.core import plr as pplr  # noqa: E402
from repro_torch.core import sstable as psst  # noqa: E402
from repro_torch.core.valuelog import ValueLog  # noqa: E402

SENTINEL = np.iinfo(np.int64).max
PAD_PROBE = -(1 << 62)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


@pytest.mark.parametrize("name", ["linear", "seg1%", "normal", "osm", "uspr"])
def test_datasets_and_plr_segments_bit_equal(name):
    keys = make_dataset(name, 5000, seed=3)
    assert np.array_equal(keys, pdata.make_dataset(name, 5000, seed=3))
    for delta, pad in ((8, None), (2, 4096)):
        j = jplr.greedy_plr_np(keys, delta=delta, pad_to=pad)
        p = pplr.greedy_plr_np(keys, delta=delta, pad_to=pad)
        assert int(j.n_segments) == p.n_segments
        for a, b in ((j.starts, p.starts), (j.slopes, p.slopes),
                     (j.intercepts, p.intercepts)):
            assert _bits_equal(a, b)
        probes = np.random.default_rng(0).choice(keys, 256)
        assert _bits_equal(jplr.plr_predict_np(j, probes),
                           pplr.plr_predict_np(p, probes))
        assert j.nbytes == p.nbytes


def test_hash_and_unsigned_modulo_match_numpy():
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        np.array([0, 1, -1, PAD_PROBE, SENTINEL, np.iinfo(np.int64).min],
                 np.int64),
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 2000,
                     dtype=np.int64)])
    h1n, h2n = jbloom._hash2_np(keys)
    h1t, h2t = pbloom.hash2_torch(torch.from_numpy(keys))
    np.testing.assert_array_equal(h1t.numpy().view(np.uint64), h1n)
    np.testing.assert_array_equal(h2t.numpy().view(np.uint64), h2n)
    for m in (64, 64 * 5001, (1 << 31) - 64):
        for i in range(7):
            x = h1n + np.uint64(i) * h2n
            want = x % np.uint64(m)
            got = pbloom.umod_torch(torch.from_numpy(x.view(np.int64)),
                                    torch.full(keys.shape, m,
                                               dtype=torch.int64))
            np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("n_keys,k", [(100, 7), (5000, 7), (5000, 4)])
def test_bloom_words_and_probes_bit_equal(n_keys, k):
    keys = make_dataset("uspr", n_keys, seed=3)
    W = jbloom.bloom_words(n_keys)
    assert W == pbloom.bloom_words(n_keys)
    bits = jbloom.bloom_build_np(keys, W, k)
    assert _bits_equal(bits, pbloom.bloom_build_np(keys, W, k))
    rng = np.random.default_rng(4)
    probes = np.concatenate([rng.choice(keys, 256),
                             rng.integers(0, 1 << 52, 256),
                             [PAD_PROBE, SENTINEL, -5]])
    want = jbloom.bloom_probe_np(bits, probes, k)
    np.testing.assert_array_equal(pbloom.bloom_probe_np(bits, probes, k), want)
    bt = torch.from_numpy(bits.view(np.int64))
    pt = torch.from_numpy(probes)
    np.testing.assert_array_equal(
        pbloom.bloom_probe_ref(bt, pt, k, n_words=W).numpy(), want)
    # per-probe rows padded wider than the build-time word count
    rows = torch.zeros((probes.shape[0], W + 7), dtype=torch.int64)
    rows[:, :W] = bt
    np.testing.assert_array_equal(
        pbloom.bloom_probe_ref(rows, pt, k,
                               n_words=torch.full(pt.shape, W)).numpy(), want)


def test_sstable_and_level_filter_bit_equal():
    keys = make_dataset("osm", 3000, seed=5)
    seqs = np.arange(3000, dtype=np.int64)
    vptrs = np.arange(3000, dtype=np.int64)[::-1].copy()
    j = jsst.build_sstable(keys, seqs, vptrs, 2, 10.0, 10, 7)
    p = psst.build_sstable(keys, seqs, vptrs, 2, 10.0, 10, 7)
    for f in ("keys", "seqs", "vptrs", "fences", "bloom"):
        assert _bits_equal(getattr(j, f), getattr(p, f)), f
    assert (j.level, j.bloom_k, j.created_at) == (p.level, p.bloom_k,
                                                  p.created_at)
    jf = jfilters.build_level_filter(keys, 9, 7)
    pf = pfilters.build_level_filter(keys, 9, 7)
    assert _bits_equal(jf.bits, pf.bits) and jf.n_words == pf.n_words
    probes = np.concatenate([keys[::7], keys[::7] + 1])
    np.testing.assert_array_equal(
        jfilters.filter_maybe_np([jf, None], probes),
        pfilters.filter_maybe_np([pf, None], probes))


def test_lsm_levels_equal_after_same_writes():
    cfg = dict(memtable_cap=1 << 9, file_cap=1 << 10, l1_cap_records=1 << 12)
    trees = [jlsm.LSMTree(jlsm.LSMConfig(**cfg)),
             plsm.LSMTree(plsm.LSMConfig(**cfg))]
    mems = [jmem.MemTable(1 << 9), pmem.MemTable(1 << 9)]
    keys = make_dataset("normal", 1 << 14, seed=6)
    rng = np.random.default_rng(6)
    seq = 0
    now = 0.0
    for r in range(40):
        b = rng.choice(keys, 1 << 9)
        vp = rng.integers(-1, 1 << 20, b.shape[0])   # -1 = tombstone
        vp[: 1 << 8] = np.abs(vp[: 1 << 8])
        s = np.arange(seq, seq + b.shape[0], dtype=np.int64)
        seq += b.shape[0]
        for tree, mem in zip(trees, mems):
            mem.put_batch(b, s, vp)
            k, ss, v = mem.drain_sorted()
            tree.flush(k, ss, v, now)
            while tree.compact_once(now) is not None:
                pass
        now += 100.0
    j, p = trees
    assert j.level_version == p.level_version
    assert j.compacted_records == p.compacted_records
    for lj, lp in zip(j.levels, p.levels):
        assert [t.n for t in lj] == [t.n for t in lp]
        for tj, tp in zip(lj, lp):
            for f in ("keys", "seqs", "vptrs", "fences", "bloom"):
                assert _bits_equal(getattr(tj, f), getattr(tp, f))
    assert any(len(lv) for lv in j.levels[2:])


def test_memtable_answers_equal():
    mems = [jmem.MemTable(1 << 10), pmem.MemTable(1 << 10)]
    rng = np.random.default_rng(7)
    k = rng.integers(0, 300, 900)
    s = np.arange(900, dtype=np.int64)
    v = rng.integers(-1, 1000, 900)
    probes = np.arange(-5, 310)
    outs = []
    for m in mems:
        m.put_batch(k, s, v)
        outs.append(m.get_batch(probes) + m.drain_sorted())
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_valuelog_device_view_rebuilt_after_append():
    vl = ValueLog(8, capacity=4, device="cpu")
    a = vl.append_batch(np.full((3, 8), 7, np.uint8))
    v1 = vl.device_view()
    assert v1.shape == (3, 8) and v1.device.type == "cpu"
    b = vl.append_batch(np.arange(40, dtype=np.uint8).reshape(5, 8))
    v2 = vl.device_view()
    assert v2.shape == (8, 8)
    np.testing.assert_array_equal(v2[b].numpy(),
                                  np.arange(40, dtype=np.uint8).reshape(5, 8))
    np.testing.assert_array_equal(vl.get_batch_np(np.r_[a, -1, 99])[-2:], 0)
