"""Each CUDA kernel against its plain PyTorch version on the same CUDA
tensors (marker ``gpu``; skips without a card).  Imports no JAX, so it
runs on a machine with a card and PyTorch alone:

  python -m pytest -q -m gpu tests/test_torch_kernels_cuda.py

The level is the rows-form case of test_torch_kernels.py: three files and
an empty slot, mixed rows, ragged B = 4096 + 64 with pad lanes.  The
lane-group kernels also run on ragged B of 1 and 63, ``bounded_search`` at
δ of 0, 8, 15 and 40 (windows below, at and above one warp) with pos at 0
and C-1 and on a narrow level whose rows are shorter than the window, and
``bloom_probe`` at k of 1, 7, 8 and 12 with a one-word filter and extreme
keys.  ``plr_lookup`` and ``sstable_search`` run through their wrappers
and built with groups of 8, 16 and 32 lanes a probe, on the level and on
edge tables (``plr_edge_table``, ``plr_level_model_table``,
``sstable_edge_table``, which test_torch_kernels.py holds to the JAX
package on the CPU).  The stack probe runs through its wrapper and built
with 1, 2, 4 and 8 lanes a (row, probe), at k of 1, 7, 8 and 12 on the
(L, W) stacks of ``stack_edge_table`` (L of 1, 4 and 7, filterless rows
first, in the middle and last, a one-word filter, rows whose nw is below
the padded W; test_torch_filter_plane.py holds them to the JAX package)
and ragged B of 1, 63 and 4096 + 37.  ``greedy_plr_torch``'s loop runs
on the card with synchronizing calls made errors, and fits the segments
of ``greedy_plr_np``; so do the stores' dispatch halves, in steady state
and in the first dispatch after a structure change, which restacks and
uploads the device state.  The store tests drive whole stores — file- and
level-granularity, and the sharded store — on the card and on the CPU.
The mesh tests run the mesh GET on cuda:0 four times against the CPU four
times, and (with two cards or more) on two distinct cards while cuda:0 is
current, so that each kernel must launch on its own tensors' card; the
last checks that ``mesh="auto"`` starts its mesh at the engine's card.
The serving cases run the LM serving engine on the card against the CPU
(equal tokens on the f32 smoke config) and a 64K-session index on both,
and check that each entry point of the serving path refuses without a
card unless given ``device="cpu"``.  The model case holds
deepseek-v2-lite's MoE FFN and MLA decode at full width, one layer, in
float32 on the card against the CPU; the recurrent cases hold hymba-1.5b
(one layer) and xlstm-1.3b (one unit) the same way, on both sides of
their chunk thresholds.  The training cases run three train steps of
qwen2's smoke config on the card against the CPU from the same
parameters, and save a bf16 trainer state from the card and restore it
bit for bit."""

import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.bloom import bloom_build_np, bloom_words  # noqa: E402
from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.core.plr import (greedy_plr_np, greedy_plr_tensors,  # noqa: E402
                                  greedy_plr_torch)
from repro_torch.kernels import build, ops, ref  # noqa: E402

SENTINEL = np.iinfo(np.int64).max
PAD_PROBE = -(1 << 62)
R, DELTA, K = 256, 8, 7
GROUPS = (8, 16, 32)       # lanes a probe that chip_smoke.py times
STACK_GROUPS = (1, 2, 4, 8)  # lanes a (row, probe) of the stack probe


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
    _assert_lanes_equal(got, want, B)


# ------------------------------------- edge tables of the count searches
# numpy, so that test_torch_kernels.py can hold the same inputs to the JAX
# package; B = 4096 + 64 probes, the edge probes in the first lanes so that
# B = 1 and 63 meet them too


def _edge_lanes(rng, rows_n, pool, specials, B=4096 + 64):
    """Rows over ``rows_n`` files and probes from ``pool``; lane i < len(
    specials) probes specials[i] on row i % rows_n, the next 32 lanes
    cycle over the rows."""
    rows = rng.integers(0, rows_n, B).astype(np.int32)
    rows[: len(specials) + 32] = np.arange(len(specials) + 32) % rows_n
    probes = rng.choice(pool, B)
    probes[: len(specials)] = specials
    probes[-64:] = PAD_PROBE
    return rows, probes


def plr_edge_table():
    """(F = 4, S = 100) segment tables — S no multiple of 8, 16 or 32 —
    with nseg of 0 (one finite start at [0]), 1, S and 57, +inf beyond
    max(nseg, 1).  The starts hold repeated keys, and keys 2^60 + [0, 2000)
    whose doubles collide (a double's step there is 256).  Probes: every
    start and its neighbours, below the first and above the last start,
    int64 max, -1, 0 and the pad probe."""
    rng = np.random.default_rng(21)
    F, S = 4, 100
    base = np.sort(np.concatenate([
        rng.integers(-(1 << 40), 1 << 40, 60),
        (1 << 60) + rng.integers(0, 2000, 40)]))
    base[10:14] = base[10]
    starts = np.full((F, S), np.inf)
    starts[0, 0] = base[50]
    starts[1, 0] = base[0]
    starts[2] = base
    starts[3, :57] = np.sort(rng.choice(base, 57))
    nseg = np.array([0, 1, S, 57], np.int32)
    n = np.array([1000, 1, 5000, 0], np.int32)
    slopes = rng.uniform(0, 4e-9, (F, S))
    icepts = rng.uniform(-100, 5000, (F, S))
    pool = np.concatenate([base, base + 1, base - 1])
    specials = np.array([SENTINEL, -1, 0, PAD_PROBE, base[0] - 1,
                         base[-1] + 1, base[10], base[-1], base[50]],
                        np.int64)
    rows, probes = _edge_lanes(rng, F, pool, specials)
    return {"starts": starts, "slopes": slopes, "icepts": icepts,
            "nseg": nseg, "n": n, "rows": rows, "probes": probes}


def plr_level_model_table():
    """Phase E's shape: one row padded to the level model's 65536 entries
    with 3600 live segments (3 rounds of 16 or 32 lanes), interpolating
    2^18 ar keys; probes are keys, keys + 1 and the extremes."""
    rng = np.random.default_rng(22)
    keys = make_dataset("ar", 1 << 18, seed=23)
    at = np.sort(rng.choice(np.arange(1, keys.shape[0] - 1), 3599,
                            replace=False))
    at = np.concatenate([[0], at, [keys.shape[0] - 1]])
    x = keys[at].astype(np.float64)
    slopes = np.diff(at) / np.diff(x)
    S, ns = 1 << 16, 3600
    t = {"starts": np.full((1, S), np.inf), "slopes": np.zeros((1, S)),
         "icepts": np.zeros((1, S)),
         "nseg": np.array([ns], np.int32),
         "n": np.array([keys.shape[0]], np.int32)}
    t["starts"][0, :ns] = x[:-1]
    t["slopes"][0, :ns] = slopes
    t["icepts"][0, :ns] = at[:-1] - slopes * x[:-1]
    specials = np.array([SENTINEL, -1, 0, PAD_PROBE, keys[0], keys[-1],
                         keys[-1] + 1], np.int64)
    rows, probes = _edge_lanes(rng, 1, np.concatenate([keys, keys + 1]),
                               specials)
    return {**t, "rows": rows, "probes": probes}


def sstable_edge_table():
    """Blocks of R = 100 records (no power of two) in (F = 4, C = 1000)
    rows, NB = 10: n = 950 (a partial last block), n = 60 with one block,
    the empty row (n = 0, n_blocks = 0) and n = 1000 (full blocks).
    Probes: every fence, the key before each fence + 1 (between two
    blocks: idx at the block's end), keys, keys + 1 and the extremes."""
    rng = np.random.default_rng(24)
    F, C, Rb = 4, 1000, 100
    allk = make_dataset("osm", 950 + 60 + 1000, seed=25)
    n = np.array([950, 60, 0, 1000], np.int32)
    keys = np.full((F, C), SENTINEL, np.int64)
    fences = np.full((F, C // Rb), SENTINEL, np.int64)
    off = 0
    for i, ni in enumerate(n):
        keys[i, :ni] = allk[off: off + ni]
        fences[i, : -(-ni // Rb)] = keys[i, :ni:Rb]
        off += ni
    n_blocks = -(-n // Rb)
    live = keys[keys != SENTINEL]
    bounds = fences[fences != SENTINEL]
    pool = np.concatenate([live, live + 1, bounds,
                           keys[3, Rb - 1: C - 1: Rb] + 1])
    specials = np.array([SENTINEL, -1, 0, PAD_PROBE, live.min() - 1,
                         live.max() + 1, fences[0, 3], keys[3, 199] + 1,
                         keys[0, 949] + 1], np.int64)
    rows, probes = _edge_lanes(rng, F, pool, specials)
    return {"fences": fences, "keys": keys, "n_blocks": n_blocks.astype(
        np.int32), "n": n, "rows": rows, "probes": probes, "R": Rb}


# rows of the stack edge tables: no filter, a one-word filter of 5 keys,
# a filter as wide as the padded W, and two whose nw is below it
STACK_LAYOUTS = {1: ("partial",),
                 4: ("none", "one_word", "full", "partial"),
                 7: ("full", "partial", "none", "one_word", "small", "full",
                     "none")}
STACK_W = 512
STACK_KEYS = {"none": 400, "one_word": 5, "full": 3000, "partial": 1200,
              "small": 700}


def stack_edge_table(L, k):
    """An (L, STACK_W) filter stack of the layout STACK_LAYOUTS[L], each
    row built with k hashes over its own keys (nw = 0 for "none", whose
    keys are still probed), and 4096 + 37 probes: 0, -1, int64 min and
    max and the pad probe first, then keys of every row, keys + 1, and
    random int64s."""
    rng = np.random.default_rng(26 + L)
    layout = STACK_LAYOUTS[L]
    allk = make_dataset("osm", sum(STACK_KEYS[r] for r in layout),
                        seed=27 + L)
    sets = np.split(rng.permutation(allk),
                    np.cumsum([STACK_KEYS[r] for r in layout])[:-1])
    bits = np.zeros((L, STACK_W), np.uint64)
    nw = np.zeros(L, np.int32)
    for i, (kind, keys) in enumerate(zip(layout, sets)):
        w = {"none": 0, "one_word": 1, "full": STACK_W}.get(
            kind, bloom_words(keys.shape[0]))
        assert kind != "partial" or w < STACK_W
        bits[i, :w] = bloom_build_np(keys, w, k) if w else 0
        nw[i] = w
    B = 4096 + 37
    specials = np.array([0, -1, np.iinfo(np.int64).min, SENTINEL, PAD_PROBE],
                        np.int64)
    pool = np.concatenate([allk, allk + 1])
    probes = np.concatenate([
        specials, rng.choice(pool, B - 5 - 512),
        rng.integers(np.iinfo(np.int64).min, SENTINEL, 512, np.int64)])
    probes[5: 5 + 32] = allk[rng.choice(allk.shape[0], 32)]
    return {"bits": bits.view(np.int64), "nw": nw, "probes": probes}


@functools.lru_cache(maxsize=None)
def _group_lib(name, G):
    """``name``.cu built with G lanes a probe, in a library of its own."""
    macro = {"plr_lookup": "PLR_LOOKUP_GROUP",
             "sstable_search": "SSTABLE_SEARCH_GROUP",
             "bloom_probe_stack": "BLOOM_PROBE_STACK_GROUP"}[name]
    return build.load_variant([build.CSRC / f"{name}.cu"],
                              (f"-D{macro}={G}",))


def _on_card(table, B):
    """The table's tensors on the card, rows (where it has them) and
    probes cut to B lanes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
         for k, v in table.items() if k != "R"}
    for k in ("rows", "probes"):
        if k in t:
            t[k] = t[k][:B].clone()
    return t


def _through(name, G, wrapper, raw):
    """Run ``wrapper()`` (G None: the default build, one launch counted)
    or ``raw(lib, stream)`` on the library built with G lanes a probe."""
    if G is None:
        before = ops.launches[name]
        out = wrapper()
        torch.cuda.synchronize()
        assert ops.launches[name] == before + 1
        return out
    out, err = raw(_group_lib(name, G), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    return out


def _assert_lanes_equal(got, want, B):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == (B,)
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=0, atol=0)


def _level_plr_table():
    t, r, p, _ = _level("cpu")
    return {**{k: t[k].numpy() for k in ("starts", "slopes", "icepts",
                                          "nseg", "n")},
            "rows": r.numpy(), "probes": p.numpy()}


def _level_sstable_table():
    t, r, p, _ = _level("cpu")
    return {**{k: t[k].numpy() for k in ("fences", "keys", "n_blocks", "n")},
            "rows": r.numpy(), "probes": p.numpy(), "R": R}


PLR_TABLES = {"level": _level_plr_table, "edges": plr_edge_table,
              "level_model": plr_level_model_table}
SSTABLE_TABLES = {"level": _level_sstable_table, "edges": sstable_edge_table}


@pytest.mark.gpu
@pytest.mark.parametrize("G", [None, *GROUPS],
                         ids=["wrapper", *(f"G{g}" for g in GROUPS)])
@pytest.mark.parametrize("B", [1, 63, 4096 + 64])
@pytest.mark.parametrize("case", list(PLR_TABLES))
def test_plr_lookup_cuda_matches_plain(case, B, G):
    t = _on_card(PLR_TABLES[case](), B)
    args = [t[k] for k in ("starts", "slopes", "icepts", "nseg", "n", "rows",
                           "probes")]

    def raw(lib, stream):
        pos = torch.empty(B, dtype=torch.int32, device="cuda")
        err = lib.plr_lookup_rows(*(a.data_ptr() for a in args),
                                  pos.data_ptr(), B, t["starts"].shape[1],
                                  stream)
        return pos, err

    got = _through("plr_lookup", G, lambda: ops.plr_lookup(*args), raw)
    _assert_lanes_equal(got, ref.plr_lookup_rows_ref(*args), B)


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
@pytest.mark.parametrize("G", [None, *GROUPS],
                         ids=["wrapper", *(f"G{g}" for g in GROUPS)])
@pytest.mark.parametrize("B", [1, 63, 4096 + 64])
@pytest.mark.parametrize("case", list(SSTABLE_TABLES))
def test_sstable_search_cuda_matches_plain(case, B, G):
    table = SSTABLE_TABLES[case]()
    Rb = table["R"]
    t = _on_card(table, B)
    args = [t[k] for k in ("fences", "keys", "n_blocks", "n", "rows",
                           "probes")]

    def raw(lib, stream):
        idx = torch.empty(B, dtype=torch.int32, device="cuda")
        found = torch.empty(B, dtype=torch.bool, device="cuda")
        err = lib.sstable_search_rows(*(a.data_ptr() for a in args),
                                      idx.data_ptr(), found.data_ptr(), B,
                                      t["fences"].shape[1],
                                      t["keys"].shape[1], Rb, stream)
        return (idx, found), err

    got = _through("sstable_search", G,
                   lambda: ops.sstable_search(*args, Rb), raw)
    want = ref.sstable_search_rows_ref(*args, Rb)
    _assert_lanes_equal(got, want, B)
    if B > 64:
        assert 0 < int(want[1].sum()) < B


@pytest.mark.gpu
@pytest.mark.parametrize("G", [None, *STACK_GROUPS],
                         ids=["wrapper", *(f"G{g}" for g in STACK_GROUPS)])
@pytest.mark.parametrize("B", [1, 63, 4096 + 37])
@pytest.mark.parametrize("L", list(STACK_LAYOUTS))
@pytest.mark.parametrize("k", [1, 7, 8, 12])
def test_bloom_probe_stack_cuda_matches_plain(k, L, B, G):
    t = _on_card(stack_edge_table(L, k), B)
    bits, nw, p = t["bits"], t["nw"], t["probes"]

    def raw(lib, stream):
        maybe = torch.empty((L, B), dtype=torch.bool, device="cuda")
        err = lib.bloom_probe_stack(bits.data_ptr(), nw.data_ptr(),
                                    p.data_ptr(), maybe.data_ptr(), L, B,
                                    bits.shape[1], k, stream)
        return maybe, err

    got = _through("bloom_probe_stack", G,
                   lambda: ops.bloom_probe_stack(bits, nw, p, k), raw)
    want = ref.bloom_probe_stack_ref(bits, nw, p, k)
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.shape == (L, B)
    assert torch.equal(got.cpu(), want.cpu())
    assert bool(got[nw == 0].all())
    if B > 64:                       # the filters answer both ways
        filtered = want[nw > 0]
        assert bool(filtered.any()) and not bool(filtered.all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["normal", "duplicates", "cap_clamp"])
def test_greedy_plr_torch_on_cuda_never_syncs_in_loop(case):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    keys = make_dataset("normal", 512, seed=6)
    delta, cap = 8, 256
    if case == "duplicates":
        keys = np.sort(np.concatenate([keys, keys[:50], keys[300:310]]))
    elif case == "cap_clamp":
        delta, cap = 1, 8
    x = torch.from_numpy(keys).to("cuda", torch.float64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        greedy_plr_tensors(x, delta, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    m_pt = greedy_plr_torch(keys, delta=delta, cap=cap)
    m_cpu = greedy_plr_torch(keys, delta=delta, cap=cap, device="cpu")
    for a, b in ((m_cpu.starts, m_pt.starts), (m_cpu.slopes, m_pt.slopes),
                 (m_cpu.intercepts, m_pt.intercepts)):
        np.testing.assert_array_equal(b, a)
    assert m_pt.n_segments == m_cpu.n_segments
    if case != "cap_clamp":
        m_np = greedy_plr_np(keys, delta=delta, pad_to=cap)
        assert m_pt.n_segments == m_np.n_segments
        n = m_np.n_segments
        np.testing.assert_allclose(m_pt.starts[:n], m_np.starts[:n])
        np.testing.assert_allclose(m_pt.slopes[:n], m_np.slopes[:n],
                                   rtol=1e-12)


def _never_syncing(fn, *args, **kw):
    """``fn(*args, **kw)`` with every synchronizing CUDA call an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")


DISPATCH_CASES = ["model", "model_pure", "level", "sharded", "mesh"]


def _card_store(case, tmp_path, keys):
    """A store on the card holding ``keys``, flushed and learned: in
    memory in mode ``case`` (values fetched on the device in mode model),
    or sharded four ways, stacked or on a mesh of cuda:0 four times."""
    from repro_torch.core import BourbonStore, LSMConfig, StoreConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.distributed import ShardedConfig, ShardedStore

    lsm = LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                    l1_cap_records=1 << 13)
    if case in ("sharded", "mesh"):
        bounds = tuple(int(b) for b in np.quantile(keys, [0.25, 0.5, 0.75]))
        st = ShardedStore.open(
            str(tmp_path), ShardedConfig(4, boundaries=bounds),
            StoreConfig(granularity="level", policy="always", value_size=16,
                        lsm=lsm), device="cuda",
            mesh=make_mesh((4,), ("shard",), ["cuda:0"] * 4)
            if case == "mesh" else None)
        assert st.uses_shard_map == (case == "mesh")
    else:
        st = BourbonStore(StoreConfig(
            granularity="level" if case == "level" else "file",
            policy="always" if case == "level" else "offline", lsm=lsm,
            fetch_values=case == "model", device="cuda"))
    _settle(st, case, np.random.default_rng(22).permutation(keys))
    return st


def _settle(st, case, keys):
    """PUT ``keys``, flush, and let the learning it starts complete (a
    structure change the next dispatch restacks)."""
    st.put_batch(keys)
    st.flush_all()
    st.drain_learning()
    if case == "model_pure":
        st.learn_all()
    if case not in ("sharded", "mesh"):
        assert st._engine_mode() == case


@pytest.mark.gpu
@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_halves_never_sync(case, tmp_path):
    """The dispatch halves launch their device work without a
    synchronizing CUDA call once the first GET has built the device state,
    as the reference's dispatch is asynchronous: the in-memory store's
    ``dispatch_get`` in modes model, model_pure and level (in level also
    ``LookupEngine.lookup_async`` with the device filter probe), and the
    sharded store's ``dispatch_get`` stacked and on a mesh of cuda:0 four
    times.  Each batch resolves after the mode is reset, every answer
    right."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    keys = make_dataset("osm", 1 << 14, seed=21)
    rng = np.random.default_rng(23)
    st = _card_store(case, tmp_path, keys)
    batches = [np.concatenate([rng.choice(keys, 2048),
                               rng.choice(keys, 2048) + 1])
               for _ in range(4)]
    st.get_batch(batches[0])                 # builds the device state
    ops.reset_launches()
    for p in batches[1:]:
        pb = _never_syncing(st.dispatch_get, p)
        found, _ = st.resolve_get(pb)
        np.testing.assert_array_equal(found, np.isin(p, keys))
    assert ops.launches["plr_lookup"] > 0
    if case == "level":
        eng = st.engine
        state = eng.build_state(st.tree, st.level_models)
        fstate = eng.build_filter_state(st.level_filters)
        pl = _never_syncing(eng.lookup_async, state, batches[1], "level",
                            l0_live=len(st.tree.levels[0]), fstate=fstate)
        res = pl.resolve()
        np.testing.assert_array_equal(res.found & (res.vptr >= 0),
                                      np.isin(batches[1], keys))
        assert ops.launches["bloom_probe_stack"] > 0
    if case in ("sharded", "mesh"):
        st.close()


@pytest.mark.gpu
@pytest.mark.parametrize("case", DISPATCH_CASES)
def test_dispatch_after_structure_change_never_syncs(case, tmp_path):
    """The first dispatch after a structure change restacks the device
    state it reads (levels, level models, the filter stack, the value
    log's copy, the sharded rows or their mesh placement) and uploads it
    without a synchronizing CUDA call: the uploads are pinned and
    non-blocking, as the reference's ``device_put`` is asynchronous.  New
    keys are flushed and their learning drained after the state was
    built; the next dispatch runs with synchronizing calls made errors,
    and finds the new keys."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    keys = make_dataset("osm", 1 << 14, seed=21)
    rng = np.random.default_rng(24)
    st = _card_store(case, tmp_path, keys)
    st.get_batch(rng.choice(keys, 4096))     # builds the device state
    new = np.setdiff1d(np.unique(rng.choice(keys, 2048) + 1), keys)
    _settle(st, case, new)                   # flush + learning: restack
    every = np.union1d(keys, new)
    p = np.concatenate([rng.choice(keys, 2048), new[:1024],
                        np.setdiff1d(new[:1024] + 1, every)])
    ops.reset_launches()
    pb = _never_syncing(st.dispatch_get, p)
    found, _ = st.resolve_get(pb)
    np.testing.assert_array_equal(found, np.isin(p, every))
    assert ops.launches["plr_lookup"] > 0
    if case in ("sharded", "mesh"):
        st.close()


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


def _mesh_case(n_shards, filters):
    """A stacked numpy state of 1 << 14 "ar" keys over ``n_shards``
    equal-count shards (each shard's bloom row in ``fbits``/``fnw`` with
    ``filters``), and 4096 probes: present keys, absent neighbours, pad
    probes and KEY_SENTINEL."""
    from repro_torch.core.distributed import (DistStoreConfig,
                                              build_dist_state,
                                              build_dist_state_from_shards)
    from repro_torch.core.filters import build_level_filter
    keys = make_dataset("ar", 1 << 14, seed=11)
    vptrs = np.arange(keys.shape[0], dtype=np.int64)
    cfg = DistStoreConfig(n_keys=keys.shape[0], probe_batch=4096)
    if filters:
        per = -(-keys.shape[0] // n_shards)
        snaps = [(keys[s * per: (s + 1) * per], vptrs[s * per: (s + 1) * per])
                 for s in range(n_shards)]
        state = build_dist_state_from_shards(
            snaps, cfg.delta,
            filters=[build_level_filter(k, 10, K) for k, _ in snaps])
    else:
        state = build_dist_state(keys, vptrs, n_shards, cfg)
    rng = np.random.default_rng(12)
    probes = np.concatenate([rng.choice(keys, 2048),
                             rng.choice(keys, 1024) + 1,
                             rng.integers(int(keys[0]), int(keys[-1]), 1016,
                                          dtype=np.int64),
                             [SENTINEL] * 4 + [PAD_PROBE] * 4])
    return state, probes.astype(np.int64), cfg


def _mesh_get(mesh, state, probes, cfg, combine):
    """The mesh GET's (found, vptr) pieces, copied to the host."""
    from repro_torch.core.distributed import build_dist_get, place_dist_state
    fn = build_dist_get(mesh, cfg, combine=combine, state_keys=tuple(state),
                        k_hashes=K)
    f, v = fn(place_dist_state(state, mesh), torch.from_numpy(probes))
    for x, dev in zip(f + v, mesh.devices * 2):
        assert x.device == dev
    return [x.cpu() for x in f], [x.cpu() for x in v]


@pytest.mark.gpu
@pytest.mark.parametrize("filters", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("combine", ["reduce_scatter", "allreduce"])
def test_mesh_get_on_one_card_matches_cpu(combine, filters):
    """The mesh GET on cuda:0 four times equals the same GET on the CPU
    four times, piece by piece; each device runs the kernels once."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.core.mesh import make_mesh
    state, probes, cfg = _mesh_case(4, filters)
    ops.reset_launches()
    got = _mesh_get(make_mesh((4,), ("shard",), ["cuda:0"] * 4), state,
                    probes, cfg, combine)
    torch.cuda.synchronize()
    assert ops.launches["plr_lookup"] == ops.launches["bounded_search"] == 4
    assert ops.launches["bloom_probe_stack"] == (4 if filters else 0)
    want = _mesh_get(make_mesh((4,), ("shard",), ["cpu"] * 4), state,
                     probes, cfg, combine)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    found = (torch.cat(got[0]) if combine == "reduce_scatter"
             else got[0][0]).numpy()
    assert found[:2048].all() and not found[-8:].any()


@pytest.mark.gpu
def test_mesh_get_on_two_cards_launches_on_each_card():
    """A mesh of two distinct cards, driven while cuda:0 is current: each
    kernel launches on the card that holds its tensors, on that card's
    stream, and the answers equal the CPU's.  A kernel wrapper called
    from cuda:0 on probes that cuda:1's stream writes only after a long
    sleep must wait for them: launched on cuda:0's stream, it would read
    the pad probes that were there before."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core.mesh import make_mesh
    state, probes, cfg = _mesh_case(2, True)
    with torch.cuda.device(0):
        for combine in ("reduce_scatter", "allreduce"):
            ops.reset_launches()
            got = _mesh_get(make_mesh((2,), ("shard",)), state, probes, cfg,
                            combine)
            assert ops.launches["bloom_probe_stack"] == 2
            want = _mesh_get(make_mesh((2,), ("shard",), ["cpu"] * 2), state,
                             probes, cfg, combine)
            for g, w in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(g, w)
        t = {k: torch.from_numpy(np.ascontiguousarray(state[k][1:2]))
             for k in ("starts", "slopes", "icepts", "nseg", "n")}
        p = torch.from_numpy(probes)
        rows = torch.zeros(p.shape[0], dtype=torch.int32)
        want = ref.plr_lookup_rows_ref(*t.values(), rows, p)
        dev = torch.device("cuda", 1)
        t1 = [x.to(dev) for x in t.values()]
        src, late = p.to(dev), torch.full_like(p, PAD_PROBE, device=dev)
        torch.cuda.synchronize(dev)
        with torch.cuda.device(dev):
            torch.cuda._sleep(int(2e8))     # cuda:1's stream busy ~0.1 s
            late.copy_(src)                 # the probes land after it
        got = ops.plr_lookup(*t1, rows.to(dev), late)
        assert got.device == dev and torch.cuda.current_device() == 0
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_mesh_store_on_distinct_cards_matches_cpu(tmp_path):
    """A sharded store on a mesh of distinct cards (up to four, one a
    shard) answers as the same store on the CPU repeated, through writes,
    a flush and the epoch refresh; each mesh GET launches each of the
    three kernels once a card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core import LSMConfig, StoreConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.distributed import ShardedConfig, ShardedStore

    n = min(torch.cuda.device_count(), 4)
    keys = make_dataset("ar", 1 << 14, seed=13)
    rng = np.random.default_rng(14)
    perm = rng.permutation(keys)
    bounds = tuple(int(b) for b in np.quantile(keys, np.arange(1, n) / n))
    probes = np.concatenate([rng.choice(keys, 3000),
                             rng.choice(keys, 1000) + 1])
    outs = []
    for device, mesh in (("cpu", make_mesh((n,), ("shard",), ["cpu"] * n)),
                         ("cuda", make_mesh((n,), ("shard",)))):
        st = ShardedStore.open(
            str(tmp_path / device), ShardedConfig(n, boundaries=bounds),
            StoreConfig(granularity="level", policy="always", value_size=16,
                        lsm=LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                                      l1_cap_records=1 << 13)),
            device=device, mesh=mesh)
        assert st.uses_shard_map
        st.put_batch(perm[:12000])
        res = [st.get_batch(probes, with_values=True)]
        st.put_batch(perm[12000:])
        st.delete_batch(perm[:500])
        st.flush_all()
        ops.reset_launches()
        res.append(st.get_batch(probes, with_values=True))
        launched = dict(ops.launches)
        outs.append((res, launched))
        st.close()
    (a, _), (b, launched) = outs
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
    for name in ("bloom_probe_stack", "plr_lookup", "bounded_search"):
        assert launched[name] == n, name


@pytest.mark.gpu
def test_auto_mesh_starts_at_engine_card(tmp_path):
    """``mesh="auto"`` on an engine placed on cuda:1 builds its mesh from
    that card: a one-shard store serves its GETs from state on cuda:1, and
    a two-shard store takes cuda:1 and the card after it, wrapping to
    cuda:0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core import StoreConfig
    from repro_torch.distributed import ShardedConfig, ShardedStore

    have = torch.cuda.device_count()
    keys = make_dataset("ar", 1 << 12, seed=15)
    for n in (1, 2):
        st = ShardedStore.open(
            str(tmp_path / f"s{n}"), ShardedConfig(n),
            StoreConfig(granularity="level", policy="always", value_size=8),
            device="cuda:1", mesh="auto")
        want = tuple(torch.device("cuda", (1 + i) % have) for i in range(n))
        assert st.uses_shard_map and st._mesh.devices == want
        st.put_batch(keys)
        st.flush_all()
        found, _ = st.get_batch(np.concatenate([keys[:100], keys[:100] + 1]))
        assert found[:100].all()
        assert [r["keys"].device for r in st.device_state()] == list(want)
        st.close()


# ----------------------------------------------------------------------------
# the LM serving path: the session index and the engine on the card
# ----------------------------------------------------------------------------

@pytest.mark.gpu
def test_serving_engine_cuda_matches_cpu():
    """The serve launcher's workload on the f32 smoke config, on the card
    and on the CPU from the same parameters: equal tokens, steps, page
    pool and session-store stats."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = get_smoke_config("qwen2-0.5b")
    engines, reqs = [], []
    for device in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
        eng = ServingEngine(cfg, params, EngineConfig(max_batch=4,
                                                      max_seq=64),
                            device=device)
        rng = np.random.default_rng(0)
        rs = [Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab, size=rng.integers(3, 10)).astype(np.int32),
            max_new=8) for i in range(12)]
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        engines.append(eng)
        reqs.append(rs)
    cpu, card = engines
    assert [r.generated for r in reqs[0]] == [r.generated for r in reqs[1]]
    assert all(r.done and len(r.generated) == 8 for r in reqs[1])
    assert card.steps == cpu.steps and card.pool.free == cpu.pool.free
    assert card.sessions.stats() == cpu.sessions.stats()
    assert card.caches["s0_attn_mlp"]["k"].device.type == "cuda"


@pytest.mark.gpu
def test_session_store_on_card_matches_cpu():
    """~64K sessions (signed 64-bit ids, 10% evicted) answer a 512-id
    batch, half live and half absent or evicted, on the card as on the
    CPU, and the card's answer went through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.serving.session_store import PageRecord, SessionStore

    rng = np.random.default_rng(23)
    ids = np.unique(rng.integers(np.iinfo(np.int64).min, SENTINEL, 1 << 16,
                                 dtype=np.int64))
    ids = rng.permutation(ids)
    stores = [SessionStore(policy="always", device=d) for d in ("cpu",
                                                                 "cuda")]
    gone = rng.choice(ids, ids.shape[0] // 10, replace=False)
    for st in stores:
        for off in range(0, ids.shape[0], 4096):
            b = ids[off:off + 4096]
            st.register_batch(b, [PageRecord(int(i) & 0xFFF, 1, 3)
                                  for i in b])
        st.evict_batch(gone)
    q = np.concatenate([rng.choice(ids, 256),
                        rng.integers(np.iinfo(np.int64).min, SENTINEL, 256,
                                     dtype=np.int64)])
    answers = []
    for st in stores:
        ops.reset_launches()
        found, recs = st.lookup_batch(q)
        answers.append((found, [None if r is None else r.first_page
                                for r in recs]))
    assert sum(ops.launches.values()) > 0
    assert np.array_equal(answers[0][0], answers[1][0])
    assert answers[0][1] == answers[1][1]
    want = np.isin(q, ids) & ~np.isin(q, gone)
    assert np.array_equal(answers[1][0], want)


def test_serving_entry_points_refuse_without_a_card(monkeypatch):
    """Each entry point of the serving path takes the card by default and
    raises without one; ``device="cpu"`` runs the plain path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.models import init_caches, init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.session_store import SessionStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = {"embed": params.tree()["embed"].numpy()}
    for call in (lambda: SessionStore(),
                 lambda: init_params(cfg, torch.Generator()),
                 lambda: init_caches(cfg, 2, 8),
                 lambda: params_from_numpy(tree, cfg),
                 lambda: ServingEngine(cfg, params, EngineConfig()),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=2), device="cpu")
    assert eng.sessions.store.engine.device.type == "cpu"
    assert eng.caches["s0_attn_mlp"]["k"].device.type == "cpu"


@pytest.mark.gpu
def test_moe_and_mla_decode_full_width_cuda_matches_cpu():
    """deepseek-v2-lite-16b at full width, one layer, float32, on the card
    against the CPU from the same parameters: ``moe_ffn`` at the decode
    capacity on 256 rows (the served batch) and at the forward capacity
    on one 1024-token group, with the same experts kept; 4 ``mla_decode``
    steps over a 16-token compressed cache.  Within 2^-15 of the largest
    output, chip_smoke.py's I_F32_TOL for the cut stacks."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    from repro_torch.models import moe
    from repro_torch.models.layers import Spec

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)

    def draw(t):
        if isinstance(t, Spec):
            if len(t.shape) < 2:
                return torch.ones(t.shape)
            return torch.randn(t.shape, generator=g).mul_(0.02)
        return {k: draw(t[k]) for k in sorted(t)}

    def to(t, dev):
        if isinstance(t, dict):
            return {k: to(v, dev) for k, v in t.items()}
        return t.to(dev)

    def near(got, want):
        got = got.cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2.0 ** -15 * want.abs().max()

    p = draw(moe.moe_shapes(cfg, torch.float32))
    pc = to(p, "cuda")
    for shape, cf in (((256, 1, cfg.d_model), 2.0),
                      ((4, 256, cfg.d_model), 1.25)):
        x = torch.randn(shape, generator=g)
        want, _ = moe.moe_ffn(x, p, cfg, cfg.act, capacity_factor=cf,
                              with_aux=False)
        got, _ = moe.moe_ffn(x.cuda(), pc, cfg, cfg.act, capacity_factor=cf,
                             with_aux=False)
        near(got, want)
        C = moe.capacity(shape[0] * shape[1], cfg.top_k, cfg.n_experts, cf)
        xg = x.reshape(1, -1, cfg.d_model)
        assert torch.equal(moe.route(xg.cuda(), pc["router"], cfg.top_k,
                                     C)[3].cpu(),
                           moe.route(xg, p["router"], cfg.top_k, C)[3])
    del p, pc
    p = draw(att.mla_shapes(cfg, torch.float32))
    pc = to(p, "cuda")
    caches = []
    for dev in ("cpu", "cuda"):
        caches.append({"c_kv": torch.zeros(8, 16, cfg.kv_lora_rank,
                                           device=dev),
                       "k_rope": torch.zeros(8, 16, cfg.qk_rope_dim,
                                             device=dev),
                       "pos": torch.zeros((), dtype=torch.int32,
                                          device=dev)})
    for _ in range(4):
        x = torch.randn((8, 1, cfg.d_model), generator=g)
        want, caches[0] = att.mla_decode(x, p, cfg, caches[0])
        got, caches[1] = att.mla_decode(x.cuda(), pc, cfg, caches[1])
        near(got, want)
    near(caches[1]["c_kv"], caches[0]["c_kv"])
    assert caches[1]["pos"].item() == 4


@pytest.mark.gpu
@pytest.mark.parametrize("arch,units,long,tol", [
    ("hymba-1.5b", 1, 1024, 2.0 ** -15), ("xlstm-1.3b", 1, 512, 2.0 ** -8)])
def test_recurrent_stacks_full_width_cuda_match_cpu(arch, units, long, tol):
    """hymba-1.5b (one ``hybrid`` layer) and xlstm-1.3b (one unit: 7
    mLSTM and 1 sLSTM layers) at full width in float32, from the same
    parameters on the card and on the CPU: ``forward`` over 1 x 8 tokens
    and over 1 x ``long`` (the chunked side of MAMBA_CHUNK and of
    MLSTM_CHUNK), and 4 decode steps.  Within ``tol`` of the largest
    logit, chip_smoke.py's J2_F32_TOL: xlstm's stack moves its own f32
    logits 3.2e-5 to 3.5e-4 of their scale under one ulp of input noise
    (J2's ``cpu_ulp_perturbation`` over four seeds, on the host of an
    NVIDIA H100 80GB HBM3, 700.00 W), and 2^-8 lies between its sound
    card-against-CPU readings (at most 1.4e-3) and those with TF32
    products on the card (at least 1.2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (Model, decode_step, forward,
                                    init_caches, init_params)

    cfg = dataclasses.replace(get_config(arch), n_units=units,
                              dtype="float32")
    card = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, _cpu_tree(card.tree()))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, long)).astype(np.int32))

    def near(got, want):
        got = got.float().cpu()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= tol * want.abs().max()

    with torch.inference_mode():
        for t in (toks[:, :8], toks):
            near(forward(card, cfg, tokens=t.cuda())[0],
                 forward(cpu, cfg, tokens=t)[0])
        cc = init_caches(cfg, 1, 8)
        hc = init_caches(cfg, 1, 8, device="cpu")
        for i in range(4):
            got, cc = decode_step(card, cfg, cc, tokens=toks[:, i:i + 1].cuda())
            want, hc = decode_step(cpu, cfg, hc, tokens=toks[:, i:i + 1])
            near(got, want)


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return tree.detach().cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_on_card_matches_cpu(remat):
    """Three ``build_train_step`` steps (forward, backward through autograd,
    AdamW in place) of qwen2's f32 smoke config, TF32 off, from the same
    parameters on the card and on the CPU: loss and grad norm within 1e-5
    relative, each parameter within lr / 10 (an entry whose gradient is
    rounding noise moves by a share of lr; the CPU-against-reference
    readings are in test_torch_train_step.py)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import TrainConfig, build_train_step
    from repro_torch.models import Model, init_params
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen2-0.5b")
    tc = TrainConfig(remat=remat)
    card = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, _cpu_tree(card.tree()))
    sc, sh = adamw_init(card, tc.optim), adamw_init(cpu, tc.optim)
    step = build_train_step(cfg, tc)
    rng = np.random.default_rng(3)
    for _ in range(3):
        t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)
                                          ).astype(np.int32))
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        card, sc, mc = step(card, sc, {k: v.cuda() for k, v in b.items()})
        cpu, sh, mh = step(cpu, sh, b)
        for k in ("loss", "grad_norm"):
            assert abs(float(mc[k]) - float(mh[k])) <= 1e-5 * float(mh[k])
    for got, want in zip(card.parameters(), cpu.parameters()):
        assert (got.detach().cpu() - want.detach()).abs().max() <= \
            tc.optim.lr / 10


@pytest.mark.gpu
def test_checkpoint_round_trip_from_the_card(tmp_path):
    """A bf16 trainer state (parameters bf16, master and moments f32) on
    the card saves through ``AsyncSaver`` and restores bit for bit, onto
    the card and onto the CPU, bf16 leaves as bf16."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import dataclasses

    from repro_torch.checkpoint.ckpt import AsyncSaver, restore
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    state = {"p": params.tree(), "o": adamw_init(params, AdamWConfig())}
    host = _cpu_tree(state)
    saver = AsyncSaver()
    saver.save_async(state, tmp_path, 6)
    with torch.no_grad():
        params.params.embed.add_(1.0)   # after the snapshot
    saver.wait()
    for like, want in ((state, _to_card(host)), (host, host)):
        got, step = restore(like, tmp_path)
        assert step == 6
        assert _bits(got) == _bits(want)
    assert got["p"]["embed"].dtype == torch.bfloat16


def _bits(tree, name=""):
    """{name: (device, dtype, shape, bytes)} of a tree's leaves."""
    if isinstance(tree, dict):
        return {n: v for k in sorted(tree)
                for n, v in _bits(tree[k], f"{name}.{k}").items()}
    t = tree.detach()
    return {name: (t.device, t.dtype, tuple(t.shape),
                   t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes())}


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda()

