"""The port's four descent kernels against the JAX package.

* Single file (F = 1): each kernel's plain PyTorch version against the
  Pallas kernel run in interpret mode, on the shapes and datasets of
  test_kernels.py.
* Rows form (F = 4 with an empty slot, mixed rows, ragged B = 4096 + 64):
  against the JAX engine's row-indexed primitives (``count_le_rows``,
  ``binsearch_rows``, ``bloom_probe_rows``) and its window arm, exactly;
  the window search also at δ = 40 and on a level narrower than the
  window, the filter probe at k of 1, 7 and 12 — the shapes the card tests
  hold the CUDA kernels to.

The CUDA kernels against these plain versions, on a card, are in
test_torch_kernels_cuda.py, which imports no JAX: the port and its card
tests need PyTorch alone.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.bloom import bloom_build_np, bloom_words  # noqa: E402
from repro.core.datasets import make_dataset  # noqa: E402
from repro.core.plr import greedy_plr_np  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

import test_torch_kernels_cuda as cuda_cases  # noqa: E402  (no JAX there)

SENTINEL = np.iinfo(np.int64).max
PAD_PROBE = -(1 << 62)
R = 256          # block records
DELTA = 8
K = 7


def _t(a):
    return torch.from_numpy(np.array(a))


def _padded(keys, cap):
    out = np.full(cap, SENTINEL, np.int64)
    out[: keys.shape[0]] = keys
    return out


# ------------------------------------------------------------ single file

@pytest.mark.parametrize("name", ["linear", "osm"])
def test_plr_lookup_single_file(name):
    n, B = 1000, 256
    keys = make_dataset(name, n, seed=0)
    m = greedy_plr_np(keys, delta=DELTA, pad_to=512)
    probes = np.random.default_rng(1).choice(keys, B)
    want = np.asarray(jops.plr_lookup(m.starts, m.slopes, m.intercepts,
                                      m.n_segments, jnp.asarray(probes), n,
                                      impl="pallas_interpret", block_b=B))
    got = ops.plr_lookup(_t(np.asarray(m.starts))[None],
                         _t(np.asarray(m.slopes))[None],
                         _t(np.asarray(m.intercepts))[None],
                         torch.tensor([int(m.n_segments)], dtype=torch.int32),
                         torch.tensor([n], dtype=torch.int32),
                         torch.zeros(B, dtype=torch.int32), _t(probes))
    # the Pallas kernel's jit may fuse slope*p + icept into one FMA while the
    # port multiplies then adds: the two round differently exactly at .5,
    # so positions may differ by 1 (the delta+1 window absorbs it)
    assert np.abs(got.numpy() - want).max() <= 1
    assert np.abs(got.numpy() - np.searchsorted(keys, probes)).max() <= DELTA + 1


@pytest.mark.parametrize("name", ["normal", "uspr"])
def test_bounded_search_single_file(name):
    n, cap, B = 4000, 4096, 256
    keys = make_dataset(name, n, seed=0)
    padded = _padded(keys, cap)
    rng = np.random.default_rng(2)
    hit = rng.choice(keys, B // 2)
    probes = np.concatenate([hit, hit + 1])
    true_idx = np.searchsorted(keys, probes).astype(np.int32)
    pos = np.clip(true_idx + rng.integers(-DELTA, DELTA + 1, B), 0,
                  n - 1).astype(np.int32)
    w_idx, w_found = jops.bounded_search(jnp.asarray(padded), jnp.asarray(pos),
                                         jnp.asarray(probes), n, delta=DELTA,
                                         impl="pallas_interpret", block_b=B)
    idx, found = ops.bounded_search(_t(padded)[None],
                                    torch.tensor([n], dtype=torch.int32),
                                    torch.zeros(B, dtype=torch.int32),
                                    _t(pos), _t(probes), DELTA)
    w_found = np.asarray(w_found)
    np.testing.assert_array_equal(found.numpy(), w_found)
    np.testing.assert_array_equal(idx.numpy()[w_found],
                                  np.asarray(w_idx)[w_found])
    assert w_found[: B // 2].all()


@pytest.mark.parametrize("n_keys", [100, 5000])
def test_bloom_probe_single_file(n_keys):
    keys = make_dataset("uspr", n_keys, seed=3)
    W = bloom_words(n_keys)
    bits = bloom_build_np(keys, W, K)
    rng = np.random.default_rng(4)
    B = 512
    probes = np.concatenate([rng.choice(keys, B // 2),
                             rng.integers(0, 1 << 52, B // 2)])
    want = np.asarray(jops.bloom_probe(jnp.asarray(bits), jnp.asarray(probes),
                                       W, k_hashes=K, impl="pallas_interpret",
                                       block_b=256))
    got = ops.bloom_probe(_t(bits.view(np.int64))[None],
                          torch.tensor([W], dtype=torch.int32),
                          torch.zeros(B, dtype=torch.int32), _t(probes), K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[: B // 2].all()


@pytest.mark.parametrize("name,block_records", [("osm", 256), ("normal", 64)])
def test_sstable_search_single_file(name, block_records):
    n, cap, B = 3000, 4096, 256
    keys = make_dataset(name, n, seed=0)
    padded = _padded(keys, cap)
    nb = -(-n // block_records)
    fences = _padded(keys[::block_records][:nb], cap // block_records)
    rng = np.random.default_rng(5)
    probes = np.concatenate([rng.choice(keys, B // 2),
                             rng.choice(keys, B // 2) + 1])
    w_idx, w_found = jops.sstable_search(
        jnp.asarray(fences), jnp.asarray(padded), jnp.asarray(probes), nb, n,
        block_records=block_records, impl="pallas_interpret", block_b=B)
    idx, found = ops.sstable_search(_t(fences)[None], _t(padded)[None],
                                    torch.tensor([nb], dtype=torch.int32),
                                    torch.tensor([n], dtype=torch.int32),
                                    torch.zeros(B, dtype=torch.int32),
                                    _t(probes), block_records)
    w_found = np.asarray(w_found)
    np.testing.assert_array_equal(found.numpy(), w_found)
    np.testing.assert_array_equal(idx.numpy()[w_found],
                                  np.asarray(w_idx)[w_found])
    np.testing.assert_array_equal(w_found, np.isin(probes, keys))


# -------------------------------------------------------------- rows form

def _level(k=K):
    """Three files of different sizes plus one empty slot, stacked as the
    engine stacks a level (filters of k hashes); probes over every row,
    ragged B = 4096 + 64."""
    sizes = [3000, 1200, 2500]
    allk = make_dataset("osm", sum(sizes), seed=7)
    files = np.split(allk, np.cumsum(sizes)[:-1])
    F, C = 4, 4096
    NB, S = C // R, 64
    W = max(bloom_words(s) for s in sizes)
    lv = {"keys": np.full((F, C), SENTINEL, np.int64),
          "n": np.zeros(F, np.int32),
          "fences": np.full((F, NB), SENTINEL, np.int64),
          "n_blocks": np.zeros(F, np.int32),
          "bits": np.zeros((F, W), np.uint64), "nw": np.ones(F, np.int32),
          "starts": np.full((F, S), np.inf), "slopes": np.zeros((F, S)),
          "icepts": np.zeros((F, S)), "nseg": np.zeros(F, np.int32)}
    for i, keys in enumerate(files):
        lv["keys"][i, : keys.shape[0]] = keys
        lv["n"][i] = keys.shape[0]
        fe = keys[::R]
        lv["fences"][i, : fe.shape[0]] = fe
        lv["n_blocks"][i] = fe.shape[0]
        w = bloom_words(keys.shape[0])
        lv["bits"][i, :w] = bloom_build_np(keys, w, k)
        lv["nw"][i] = w
        m = greedy_plr_np(keys, delta=DELTA)
        ns = int(m.n_segments)
        assert ns <= S
        lv["starts"][i, :ns] = np.asarray(m.starts)[:ns]
        lv["slopes"][i, :ns] = np.asarray(m.slopes)[:ns]
        lv["icepts"][i, :ns] = np.asarray(m.intercepts)[:ns]
        lv["nseg"][i] = ns
    rng = np.random.default_rng(8)
    B = 4096 + 64
    rows = rng.integers(0, F, B).astype(np.int32)
    probes = np.empty(B, np.int64)
    for i in range(F):
        sel = rows == i
        src = files[i] if i < len(files) else allk
        probes[sel] = rng.choice(src, sel.sum()) + rng.integers(0, 2, sel.sum())
    probes[::97] = rng.choice(allk, probes[::97].shape[0])  # other files' keys
    probes[-64:] = PAD_PROBE                              # pad lanes
    return lv, rows, probes


def _torch_level(lv):
    out = {k: _t(v) for k, v in lv.items()}
    out["bits"] = _t(lv["bits"].view(np.int64))
    return out


def test_plr_lookup_rows_matches_engine():
    lv, rows, probes = _level()
    # the JAX engine's ModelLookup arm, eagerly (no fused multiply-add):
    # compare-count over the segment starts, then mul, add, round, clip
    p = jnp.asarray(probes).astype(jnp.float64)
    rj = jnp.asarray(rows)
    seg = jnp.maximum(jeng.count_le_rows(jnp.asarray(lv["starts"]), rj, p) - 1,
                      0)
    y = jnp.asarray(lv["slopes"])[rj, seg] * p
    y = y + jnp.asarray(lv["icepts"])[rj, seg]
    y = np.round(np.asarray(y))
    want = np.clip(y, 0, np.maximum(lv["n"][rows] - 1, 0))
    t = _torch_level(lv)
    got = ops.plr_lookup(t["starts"], t["slopes"], t["icepts"], t["nseg"],
                         t["n"], _t(rows), _t(probes)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def _narrow_level():
    """Rows of C = 24 keys, narrower than a window of 2*40+3: a full row,
    a row of 5 keys and the empty row (n = 0); ragged B = 4096 + 64."""
    F, C, B = 3, 24, 4096 + 64
    allk = make_dataset("osm", 29, seed=9)
    keys = np.full((F, C), SENTINEL, np.int64)
    keys[0] = allk[:24]
    keys[1, :5] = allk[24:]
    rng = np.random.default_rng(10)
    rows = rng.integers(0, F, B).astype(np.int32)
    probes = allk[rng.integers(0, 29, B)] + rng.integers(0, 2, B)
    probes[-64:] = PAD_PROBE
    return {"keys": keys, "n": np.array([24, 5, 0], np.int32)}, rows, probes


@pytest.mark.parametrize("delta, narrow", [(DELTA, False), (40, False),
                                           (40, True)],
                         ids=["delta8", "delta40", "narrow-delta40"])
def test_bounded_search_rows_matches_engine(delta, narrow):
    lv, rows, probes = _narrow_level() if narrow else _level()
    C = lv["keys"].shape[1]
    rng = np.random.default_rng(9)
    true_idx = np.empty(rows.shape[0], np.int64)
    for r in range(lv["keys"].shape[0]):
        sel = rows == r
        true_idx[sel] = np.searchsorted(lv["keys"][r], probes[sel])
    pos = np.clip(true_idx + rng.integers(-delta - 2, delta + 3, rows.shape[0]),
                  0, C - 1).astype(np.int32)
    pos[::13] = 0
    pos[6::13] = C - 1
    # the JAX engine's LoadChunk+LocateKey arm
    offs = jnp.arange(-(delta + 1), delta + 2, dtype=jnp.int32)
    win_idx = jnp.clip(jnp.asarray(pos)[:, None] + offs[None, :], 0, C - 1)
    win = jnp.asarray(lv["keys"])[jnp.asarray(rows)[:, None], win_idx]
    eq = win == jnp.asarray(probes)[:, None]
    rel = jnp.argmax(eq, axis=-1)
    w_idx = np.asarray(win_idx[jnp.arange(rows.shape[0]), rel])
    w_found = np.asarray(jnp.any(eq, axis=-1)) & (w_idx < lv["n"][rows])
    idx, found = ops.bounded_search(_t(lv["keys"]), _t(lv["n"]), _t(rows),
                                    _t(pos), _t(probes), delta)
    np.testing.assert_array_equal(found.numpy(), w_found)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    assert 0 < w_found.sum() < rows.shape[0]


@pytest.mark.parametrize("k", [1, K, 12])
def test_bloom_probe_rows_matches_engine(k):
    lv, rows, probes = _level(k)
    probes = probes.copy()
    probes[:5] = [SENTINEL, -1, -(1 << 40), 0, PAD_PROBE]
    want = np.asarray(jeng.bloom_probe_rows(
        jnp.asarray(lv["bits"]), jnp.asarray(lv["nw"]), jnp.asarray(rows),
        jnp.asarray(probes), k))
    t = _torch_level(lv)
    got = ops.bloom_probe(t["bits"], t["nw"], _t(rows), _t(probes), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.shape[0]


def test_sstable_search_rows_matches_engine():
    lv, rows, probes = _level()
    rj, pj = jnp.asarray(rows), jnp.asarray(probes)
    keys = jnp.asarray(lv["keys"])
    # SearchIB by compare-count over the fences, SearchDB by binsearch_rows
    blk = jnp.maximum(jeng.count_le_rows(jnp.asarray(lv["fences"]), rj, pj)
                      - 1, 0)
    lo = blk * R
    hi = jnp.minimum(lo + R, jnp.asarray(lv["n"])[rj])
    w_idx = np.asarray(jeng.binsearch_rows(keys, rj, pj, lo, hi, side="left"))
    kv = np.asarray(keys[rj, jnp.clip(jnp.asarray(w_idx), 0, 4095)])
    w_found = (w_idx < lv["n"][rows]) & (kv == probes)
    t = _torch_level(lv)
    idx, found = ops.sstable_search(t["fences"], t["keys"], t["n_blocks"],
                                    t["n"], _t(rows), _t(probes), R)
    np.testing.assert_array_equal(found.numpy(), w_found)
    np.testing.assert_array_equal(idx.numpy(), w_idx)
    assert 0 < w_found.sum() < rows.shape[0]


@pytest.mark.parametrize("case", ["edges", "level_model"])
def test_plr_lookup_rows_edges_match_engine(case):
    """The (4, 100) edge table (nseg 0, 1, S; duplicated starts; extreme
    probes) against ``count_le_rows``, and phase E's one-row level model
    (3600 segments in 65536) against ``binsearch_rows`` — the engine's arm
    for each width (src/repro/core/engine.py, _probe_file_model)."""
    tb = (cuda_cases.plr_edge_table if case == "edges"
          else cuda_cases.plr_level_model_table)()
    rows, probes = tb["rows"], tb["probes"]
    starts = jnp.asarray(tb["starts"])
    rj = jnp.asarray(rows)
    p = jnp.asarray(probes).astype(jnp.float64)
    if starts.shape[-1] <= 1024:
        cnt = jeng.count_le_rows(starts, rj, p)
    else:
        cnt = jeng.binsearch_rows(starts, rj, p, jnp.zeros_like(rj),
                                  jnp.maximum(jnp.asarray(tb["nseg"])[rj], 1),
                                  side="right")
    seg = jnp.maximum(cnt - 1, 0)
    y = jnp.asarray(tb["slopes"])[rj, seg] * p
    y = y + jnp.asarray(tb["icepts"])[rj, seg]
    want = np.clip(np.round(np.asarray(y)), 0,
                   np.maximum(tb["n"][rows] - 1, 0)).astype(np.int32)
    got = ops.plr_lookup(*(_t(tb[k]) for k in ("starts", "slopes", "icepts",
                                               "nseg", "n", "rows",
                                               "probes"))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.unique(want).shape[0] > 100


@pytest.mark.parametrize("reference", ["pallas", "engine"])
def test_sstable_search_rows_edges_match_reference(reference):
    """Blocks of 100 records, a partial last block, one block, the empty
    row, probes at fences and between blocks: against the Pallas kernel in
    interpret mode (one file at a time, 128 probes of each row) or the
    engine's baseline arm (fence compare-count, block compare-count,
    src/repro/core/engine.py _probe_file_baseline), on found lanes."""
    tb = cuda_cases.sstable_edge_table()
    Rb, C = tb["R"], tb["keys"].shape[1]
    rows, probes = tb["rows"], tb["probes"]
    idx, found = ops.sstable_search(*(_t(tb[k]) for k in (
        "fences", "keys", "n_blocks", "n", "rows", "probes")), Rb)
    idx, found = idx.numpy(), found.numpy()
    if reference == "pallas":
        lanes = np.concatenate([np.flatnonzero(rows == r)[:128]
                                for r in range(tb["keys"].shape[0])])
        w_idx = np.empty(lanes.shape[0], np.int32)
        w_found = np.empty(lanes.shape[0], bool)
        for r in range(tb["keys"].shape[0]):
            sel = rows[lanes] == r
            i, f = jops.sstable_search(
                jnp.asarray(tb["fences"][r]), jnp.asarray(tb["keys"][r]),
                jnp.asarray(probes[lanes[sel]]), int(tb["n_blocks"][r]),
                int(tb["n"][r]), block_records=Rb, impl="pallas_interpret",
                block_b=int(sel.sum()))
            w_idx[sel], w_found[sel] = np.asarray(i), np.asarray(f)
        idx, found = idx[lanes], found[lanes]
    else:
        rj, pj = jnp.asarray(rows), jnp.asarray(probes)
        keys = jnp.asarray(tb["keys"])
        blk = jnp.maximum(jeng.count_le_rows(jnp.asarray(tb["fences"]), rj,
                                             pj) - 1, 0)
        base = blk * Rb
        cols = jnp.clip(base[:, None] + jnp.arange(Rb)[None], 0, C - 1)
        within = jnp.sum(keys[rj[:, None], cols] < pj[:, None], axis=-1)
        w_idx = np.asarray(base + within)
        kv = np.asarray(keys[rj, jnp.clip(base + within, 0, C - 1)])
        w_found = (w_idx < tb["n"][rows]) & (kv == probes)
    np.testing.assert_array_equal(found, w_found)
    np.testing.assert_array_equal(idx[w_found], w_idx[w_found])
    assert 0 < w_found.sum() < w_found.shape[0]


def test_wrappers_check_inputs():
    lv, rows, probes = _level()
    t = _torch_level(lv)
    with pytest.raises(TypeError):
        ops.bloom_probe(t["bits"], t["nw"], _t(rows).long(), _t(probes), K)
    with pytest.raises(ValueError):
        ops.sstable_search(t["fences"], t["keys"], t["n_blocks"][:2], t["n"],
                           _t(rows), _t(probes), R)
    before = dict(ops.launches)
    ops.bloom_probe(t["bits"], t["nw"], _t(rows), _t(probes), K)
    assert ops.launches == before      # the plain version is no launch
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bloom_probe(meta["bits"], meta["nw"], _t(rows).to("meta"),
                        _t(probes).to("meta"), K)
