"""Each CUDA kernel against its plain PyTorch version on the same CUDA
tensors (marker ``gpu``; skips without a card).  Imports no JAX, so it
runs on a machine with a card and PyTorch alone:

  python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The level is the rows-form case of test_torch_kernels.py: three files and
an empty slot, mixed rows, ragged B = 4096 + 64 with pad lanes."""

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


def _level(device):
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
    for i, k in enumerate(files):
        n = k.shape[0]
        lv["keys"][i, :n] = k
        lv["n"][i] = n
        lv["fences"][i, : -(-n // R)] = k[::R]
        lv["n_blocks"][i] = -(-n // R)
        w = bloom_words(n)
        lv["bits"][i, :w] = bloom_build_np(k, w, K)
        lv["nw"][i] = w
        m = greedy_plr_np(k, delta=DELTA)
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
    for i, k in enumerate(files):
        sel = rows == i
        probes[sel] = rng.choice(k, sel.sum()) + rng.integers(0, 2, sel.sum())
    probes[-64:] = PAD_PROBE
    t = {k: torch.from_numpy(v).to(device) for k, v in lv.items()}
    return t, torch.from_numpy(rows).to(device), torch.from_numpy(probes).to(device)


def _kernel_vs_plain(name, call):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    t, r, p = _level("cuda")
    pos = ref.plr_lookup_rows_ref(t["starts"], t["slopes"], t["icepts"],
                                  t["nseg"], t["n"], r, p)
    before = ops.launches[name]
    got, want = call(t, r, p, pos)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=0, atol=0)


@pytest.mark.gpu
def test_plr_lookup_cuda_matches_plain():
    _kernel_vs_plain("plr_lookup", lambda t, r, p, pos: (
        ops.plr_lookup(t["starts"], t["slopes"], t["icepts"], t["nseg"],
                       t["n"], r, p),
        ref.plr_lookup_rows_ref(t["starts"], t["slopes"], t["icepts"],
                                t["nseg"], t["n"], r, p)))


@pytest.mark.gpu
def test_bounded_search_cuda_matches_plain():
    _kernel_vs_plain("bounded_search", lambda t, r, p, pos: (
        ops.bounded_search(t["keys"], t["n"], r, pos, p, DELTA),
        ref.bounded_search_rows_ref(t["keys"], t["n"], r, pos, p, DELTA)))


@pytest.mark.gpu
def test_bloom_probe_cuda_matches_plain():
    _kernel_vs_plain("bloom_probe", lambda t, r, p, pos: (
        ops.bloom_probe(t["bits"], t["nw"], r, p, K),
        ref.bloom_probe_rows_ref(t["bits"], t["nw"], r, p, K)))


@pytest.mark.gpu
def test_sstable_search_cuda_matches_plain():
    _kernel_vs_plain("sstable_search", lambda t, r, p, pos: (
        ops.sstable_search(t["fences"], t["keys"], t["n_blocks"], t["n"], r,
                           p, R),
        ref.sstable_search_rows_ref(t["fences"], t["keys"], t["n_blocks"],
                                    t["n"], r, p, R)))


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
