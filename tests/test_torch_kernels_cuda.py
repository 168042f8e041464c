"""Each CUDA kernel against its plain PyTorch version on the same CUDA
tensors (marker ``gpu``; skips without a card).  Imports no JAX, so it
runs on a machine with a card and PyTorch alone:

  python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The level is the rows-form case of test_torch_kernels.py: three files and
an empty slot, mixed rows, ragged B = 4096 + 64 with pad lanes.  The two
lane-group kernels also run on ragged B of 1 and 63, ``bounded_search`` at
δ of 0, 8, 15 and 40 (windows below, at and above one warp) with pos at 0
and C-1 and on a narrow level whose rows are shorter than the window, and
``bloom_probe`` at k of 1, 7, 8 and 12 with a one-word filter and extreme
keys.  The stack probe takes the same filters as an (L, W) stack with a
filterless row and a ragged batch.  The last tests drive whole stores — file- and
level-granularity, and the sharded store — on the card and on the CPU."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.bloom import bloom_build_np, bloom_words  # noqa: E402
from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.core.plr import greedy_plr_np  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SENTINEL = np.iinfo(np.int64).max
PAD_PROBE = -(1 << 62)
R, DELTA, K = 256, 8, 7


def _level(device, k=K):
    sizes = [3000, 1200, 2500]
    allk = make_dataset("osm", sum(sizes), seed=7)
    files = np.split(allk, np.cumsum(sizes)[:-1])
    F, C, S = 4, 4096, 64
    W = max(bloom_words(s) for s in sizes)
    lv = {"keys": np.full((F, C), SENTINEL, np.int64),
          "n": np.zeros(F, np.int32),
          "fences": np.full((F, C // R), SENTINEL, np.int64),
          "n_blocks": np.zeros(F, np.int32),
          "bits": np.zeros((F, W), np.uint64), "nw": np.ones(F, np.int32),
          "starts": np.full((F, S), np.inf), "slopes": np.zeros((F, S)),
          "icepts": np.zeros((F, S)), "nseg": np.zeros(F, np.int32)}
    for i, keys in enumerate(files):
        n = keys.shape[0]
        lv["keys"][i, :n] = keys
        lv["n"][i] = n
        lv["fences"][i, : -(-n // R)] = keys[::R]
        lv["n_blocks"][i] = -(-n // R)
        w = bloom_words(n)
        lv["bits"][i, :w] = bloom_build_np(keys, w, k)
        lv["nw"][i] = w
        m = greedy_plr_np(keys, delta=DELTA)
        ns = m.n_segments
        lv["starts"][i, :ns] = m.starts[:ns]
        lv["slopes"][i, :ns] = m.slopes[:ns]
        lv["icepts"][i, :ns] = m.intercepts[:ns]
        lv["nseg"][i] = ns
    lv["bits"] = lv["bits"].view(np.int64)
    rng = np.random.default_rng(8)
    B = 4096 + 64
    rows = rng.integers(0, F, B).astype(np.int32)
    probes = rng.choice(allk, B) + rng.integers(0, 2, B)
    for i, keys in enumerate(files):
        sel = rows == i
        probes[sel] = (rng.choice(keys, sel.sum())
                       + rng.integers(0, 2, sel.sum()))
    probes[-64:] = PAD_PROBE
    t = {n: torch.from_numpy(v).to(device) for n, v in lv.items()}
    r = torch.from_numpy(rows).to(device)
    p = torch.from_numpy(probes).to(device)
    pos = ref.plr_lookup_rows_ref(t["starts"], t["slopes"], t["icepts"],
                                  t["nseg"], t["n"], r, p)
    return t, r, p, pos


def _narrow_level(device, k=K):
    """Rows of C = 24 keys, narrower than the widest window (2*40+3): a
    full row, a row of 5 keys and the empty row (n = 0), pos anywhere in
    [0, C-1]."""
    F, C, B = 3, 24, 4096 + 64
    allk = make_dataset("osm", 29, seed=9)
    keys = np.full((F, C), SENTINEL, np.int64)
    keys[0] = allk[:24]
    keys[1, :5] = allk[24:]
    n = np.array([24, 5, 0], np.int32)
    rng = np.random.default_rng(10)
    rows = rng.integers(0, F, B).astype(np.int32)
    probes = allk[rng.integers(0, 29, B)] + rng.integers(0, 2, B)
    probes[-64:] = PAD_PROBE
    pos = rng.integers(0, C, B).astype(np.int32)
    t = {"keys": torch.from_numpy(keys).to(device),
         "n": torch.from_numpy(n).to(device)}
    return (t, torch.from_numpy(rows).to(device),
            torch.from_numpy(probes).to(device),
            torch.from_numpy(pos).to(device))


def _kernel_vs_plain(name, call, B=4096 + 64, k=K, narrow=False):
    """``call(t, rows, probes, pos) -> (kernel out, plain out)`` on the
    first B lanes of a level (the last min(64, B // 8) of them pad lanes),
    with pos at 0 and at C-1 on every 13th lane; every output lane of the
    kernel must equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    t, r, p, pos = (_narrow_level if narrow else _level)("cuda", k)
    r, p, pos = r[:B].clone(), p[:B].clone(), pos[:B].clone()
    p[B - min(64, B // 8):] = PAD_PROBE
    C = t["keys"].shape[1]
    pos[::13] = 0
    pos[6::13] = C - 1
    before = ops.launches[name]
    got, want = call(t, r, p, pos)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == (B,)
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=0, atol=0)


@pytest.mark.gpu
def test_plr_lookup_cuda_matches_plain():
    _kernel_vs_plain("plr_lookup", lambda t, r, p, pos: (
        ops.plr_lookup(t["starts"], t["slopes"], t["icepts"], t["nseg"],
                       t["n"], r, p),
        ref.plr_lookup_rows_ref(t["starts"], t["slopes"], t["icepts"],
                                t["nseg"], t["n"], r, p)))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 63, 4096 + 64])
@pytest.mark.parametrize("delta", [0, 8, 15, 40])
@pytest.mark.parametrize("narrow", [False, True], ids=["wide", "narrow"])
def test_bounded_search_cuda_matches_plain(narrow, delta, B):
    _kernel_vs_plain("bounded_search", lambda t, r, p, pos: (
        ops.bounded_search(t["keys"], t["n"], r, pos, p, delta),
        ref.bounded_search_rows_ref(t["keys"], t["n"], r, pos, p, delta)),
        B=B, narrow=narrow)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 63, 4096 + 64])
@pytest.mark.parametrize("k", [1, 7, 8, 12])
def test_bloom_probe_cuda_matches_plain(k, B):
    def call(t, r, p, pos):
        # the empty slot gets a one-word filter (nw = 1) of five keys, and
        # the first lanes probe the extreme keys
        few = make_dataset("osm", 5, seed=11)
        t["bits"][3, 0] = int(bloom_build_np(few, 1, k).view(np.int64)[0])
        t["nw"][3] = 1
        on3 = torch.nonzero(r == 3)[:5, 0]
        p[on3] = torch.from_numpy(few[: on3.shape[0]]).to(p.device)
        special = torch.tensor([SENTINEL, -1, 0, -(1 << 40), PAD_PROBE],
                               device=p.device)
        p[: min(5, B)] = special[: min(5, B)]
        return (ops.bloom_probe(t["bits"], t["nw"], r, p, k),
                ref.bloom_probe_rows_ref(t["bits"], t["nw"], r, p, k))

    _kernel_vs_plain("bloom_probe", call, B=B, k=k)


@pytest.mark.gpu
def test_sstable_search_cuda_matches_plain():
    _kernel_vs_plain("sstable_search", lambda t, r, p, pos: (
        ops.sstable_search(t["fences"], t["keys"], t["n_blocks"], t["n"], r,
                           p, R),
        ref.sstable_search_rows_ref(t["fences"], t["keys"], t["n_blocks"],
                                    t["n"], r, p, R)))


@pytest.mark.gpu
def test_bloom_probe_stack_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    t, _, p, _ = _level("cuda")
    nw = t["nw"].clone()
    nw[3] = 0                            # the empty slot: no filter
    for B in (4096 + 64, 4096 + 37, 1):
        before = ops.launches["bloom_probe_stack"]
        got = ops.bloom_probe_stack(t["bits"], nw, p[:B], K)
        want = ref.bloom_probe_stack_ref(t["bits"], nw, p[:B], K)
        torch.cuda.synchronize()
        assert ops.launches["bloom_probe_stack"] == before + 1
        assert got.shape == (4, B) and got.dtype == torch.bool
        assert torch.equal(got.cpu(), want.cpu())
        assert bool(got[3].all())


@pytest.mark.gpu
def test_cuda_level_and_sharded_stores_match_cpu(tmp_path):
    """Level granularity (mode "level", the device filter probe) and the
    durable sharded GET give the same answers on the card as on the CPU,
    through the stack probe and the descent kernels."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core import LSMConfig, StoreConfig
    from repro_torch.distributed import ShardedConfig, ShardedStore

    keys = make_dataset("ar", 1 << 14, seed=3)
    rng = np.random.default_rng(4)
    perm = rng.permutation(keys)
    bounds = tuple(int(b) for b in np.quantile(keys, [0.25, 0.5, 0.75]))
    probes = np.concatenate([rng.choice(keys, 3000),
                             rng.choice(keys, 1000) + 1])
    outs = []
    ops.reset_launches()
    for device in ("cpu", "cuda"):
        st = ShardedStore.open(
            str(tmp_path / device), ShardedConfig(4, boundaries=bounds),
            StoreConfig(granularity="level", policy="always", value_size=16,
                        lsm=LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                                      l1_cap_records=1 << 13)),
            device=device)
        for off in range(0, keys.shape[0], 4096):
            st.put_batch(perm[off: off + 4096])
        st.flush_all()
        st.learn_all()
        sh = st.shards[0]
        own = probes[st.shard_of(probes) == 0]
        own_res = sh.get_batch(own)           # builds the level filters
        lookup = sh.engine.lookup(
            sh.engine.build_state(sh.tree, sh.level_models),
            np.resize(own, 1024), "level", l0_live=len(sh.tree.levels[0]),
            fstate=sh.engine.build_filter_state(sh.level_filters))
        outs.append((st.get_batch(probes, with_values=True), own_res,
                     lookup.found, lookup.vptr))
        st.close()
    (a, a1, a2, a3), (b, b1, b2, b3) = outs
    for x, y in ((a, b), (a1, b1)):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    np.testing.assert_array_equal(a2, b2)
    np.testing.assert_array_equal(a3, b3)
    assert a[0][:3000].all()
    for name in ("bloom_probe_stack", "plr_lookup", "bounded_search"):
        assert ops.launches[name] > 0, name


@pytest.mark.gpu
def test_cuda_store_matches_cpu_store():
    """The whole GET path on the card equals the plain path on the CPU:
    answers, clock, engine modes, per-file counters and path counts, over
    deletes, batch sizes on both sides of host_answer_max, and learning
    between GETs under the CBA policy."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core import BourbonStore, LSMConfig, StoreConfig

    def mk(device):
        return BourbonStore(StoreConfig(
            mode="bourbon", policy="cba", fetch_values=True, device=device,
            lsm=LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                          l1_cap_records=1 << 13)))

    stores = [mk("cpu"), mk("cuda")]
    keys = make_dataset("osm", 1 << 14, seed=1)
    rng = np.random.default_rng(2)
    perm = rng.permutation(keys)
    dead = rng.choice(keys, 512, replace=False)
    for st in stores:
        st.put_batch(perm)
        st.delete_batch(dead)
        st.flush_all()
    outs = [[], []]
    for r in range(12):
        size = (64, 512, 4096)[r % 3]
        p = np.concatenate([rng.choice(keys, size // 2),
                            rng.choice(keys, size // 4) + 1,
                            rng.choice(dead, size - size // 2 - size // 4)])
        if r == 6:
            for st in stores:
                st.learn_all()
        for o, st in zip(outs, stores):
            f, v = st.get_batch(p)
            o.append((f.tobytes(), v.tobytes(), st.clock.now,
                      st._engine_mode()))
    assert outs[0] == outs[1]
    assert {o[3] for o in outs[0]} == {"model", "model_pure"}
    a, b = stores
    assert ([[(t.stats.n_pos, t.stats.n_neg) for t in lvl]
             for lvl in a.tree.levels]
            == [[(t.stats.n_pos, t.stats.n_neg) for t in lvl]
                for lvl in b.tree.levels])
    assert ((a.lookups_model_path, a.lookups_baseline_path)
            == (b.lookups_model_path, b.lookups_baseline_path))
