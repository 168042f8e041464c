"""The port's LookupEngine (device="cpu") against repro's on the same LSM
content: modes baseline, model, mixed and model_pure, with the filter plane off
and with the host-screen mask (``fmaybe_host``).  Batches have the shapes
the store dispatches — multiples of 64 padded with ``_PAD_PROBE``.  Held
exactly: found, vptr, served level, per-file pos/neg counts, probe split
and filter stats."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import filters as jfilters  # noqa: E402
from repro.core import lsm as jlsm  # noqa: E402
from repro.core.datasets import make_dataset  # noqa: E402
from repro_torch.core import engine as peng  # noqa: E402
from repro_torch.core import filters as pfilters  # noqa: E402
from repro_torch.core import lsm as plsm  # noqa: E402

PAD_PROBE = -(1 << 62)
N_LEVELS = 7
B_LIVE = 1000
B_PAD = 1024 + 64        # quarter-pow2 bucket the store would pick


def _trees(learn: str):
    """The same writes (puts, overwrites, tombstones) into both packages'
    trees, leaving files in L0 and in two sorted levels."""
    cfg = dict(memtable_cap=1 << 9, file_cap=1 << 10, l1_cap_records=1 << 12)
    trees = [jlsm.LSMTree(jlsm.LSMConfig(**cfg)),
             plsm.LSMTree(plsm.LSMConfig(**cfg))]
    keys = make_dataset("osm", 1 << 13, seed=11)
    rng = np.random.default_rng(11)
    order = rng.permutation(keys)
    batches = [order[i: i + 512] for i in range(0, keys.shape[0], 512)]
    batches.append(rng.choice(keys, 512, replace=False))   # overwrites
    seq = 0
    for bi, b in enumerate(batches):
        b = np.sort(b)
        vp = np.arange(seq, seq + b.shape[0], dtype=np.int64)
        if bi >= len(batches) - 2:
            vp[::3] = -1                       # tombstones
        s = np.arange(seq, seq + b.shape[0], dtype=np.int64)
        seq += b.shape[0]
        for t in trees:
            t.flush(b, s, vp, float(bi))
            while t.compact_once(float(bi)) is not None:
                pass
    for t in trees:
        files = list(t.all_files())
        for i, f in enumerate(files):
            if learn == "all" or (learn == "half" and i % 2 == 0):
                f.learn(8, pad_to=4096)
    assert trees[0].levels[0] and sum(bool(lv) for lv in trees[0].levels) >= 3
    return trees, keys


def _probes(keys):
    rng = np.random.default_rng(12)
    live = np.concatenate([rng.choice(keys, B_LIVE // 2),
                           rng.choice(keys, B_LIVE // 4) + 1,
                           rng.integers(0, 1 << 50, B_LIVE - 3 * B_LIVE // 4)])
    out = np.full(B_PAD, PAD_PROBE, np.int64)
    out[:B_LIVE] = live
    return out


def _filter_inputs(tree, fmod, probes):
    """Per-level filters, the host-screen mask and the level hint, as the
    store builds them in dispatch_get."""
    filters = [None] * N_LEVELS
    for li, tables in enumerate(tree.levels):
        if tables:
            filters[li] = fmod.build_level_filter(
                np.concatenate([t.keys for t in tables]), 10, 7)
    live_idx = [li for li in range(N_LEVELS) if tree.levels[li]]
    fm = fmod.filter_maybe_np([filters[li] for li in live_idx],
                              probes[:B_LIVE])
    fm_host = np.ones((N_LEVELS, B_PAD), bool)
    hint = [True] * N_LEVELS
    for row, li in enumerate(live_idx):
        fm_host[li, :B_LIVE] = fm[row]
        hint[li] = bool(fm[row].any())
    return filters, fm_host, tuple(hint)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("mode,learn", [("baseline", "none"),
                                        ("model", "half"),
                                        ("model_pure", "all")])
def test_engine_matches_reference(mode, learn, filtered):
    (jt, pt), keys = _trees(learn)
    probes = _probes(keys)
    je = jeng.LookupEngine(jeng.EngineConfig())
    pe = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    je.record_probe_split = pe.record_probe_split = True
    results = []
    for eng, tree, fmod in ((je, jt, jfilters), (pe, pt, pfilters)):
        state = eng.build_state(tree)
        kw = {}
        if filtered:
            filters, fm_host, hint = _filter_inputs(tree, fmod, probes)
            kw = dict(fstate=eng.build_filter_state(filters),
                      fmaybe_host=fm_host, level_maybe=hint)
        res = eng.lookup_async(state, probes, mode,
                               l0_live=len(tree.levels[0]), **kw).resolve()
        results.append((res, eng.probe_split_np(), eng.filter_stats_np()))
    (jr, jsplit, jfst), (pr, psplit, pfst) = results
    np.testing.assert_array_equal(pr.found, jr.found)
    np.testing.assert_array_equal(pr.vptr, jr.vptr)
    np.testing.assert_array_equal(pr.served_level, jr.served_level)
    assert pr.served_level.dtype == np.int8 and pr.vptr.dtype == np.int64
    for li in range(N_LEVELS):
        np.testing.assert_array_equal(pr.pos_counts[li], jr.pos_counts[li])
        np.testing.assert_array_equal(pr.neg_counts[li], jr.neg_counts[li])
    np.testing.assert_array_equal(psplit, jsplit)
    np.testing.assert_array_equal(pfst, jfst)
    assert psplit.dtype == np.int64 and pfst.dtype == np.int64
    # the workload reaches every outcome: hits in several levels, misses
    assert jr.found[:B_LIVE].any() and not jr.found[:B_LIVE].all()
    assert len(set(jr.served_level[jr.found].tolist())) >= 2
    if filtered:
        assert jfst[:, 0].sum() > 0          # the mask pruned something


def test_learning_after_stacking_restacks_segment_tables():
    (_, pt), keys = _trees("none")
    pe = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    state = pe.build_state(pt)
    assert all(int(lv.nseg.sum()) == 0 for lv in state.levels)
    for f in pt.all_files():
        f.learn(8, pad_to=4096)
    state2 = pe.build_state(pt)
    for li, lv in enumerate(state2.levels):
        assert int((lv.nseg > 0).sum()) == len(pt.levels[li])
        # the level data itself was not restacked
        assert lv.keys is state.levels[li].keys
    probes = _probes(keys)
    res = pe.lookup(state2, probes, "model_pure", l0_live=len(pt.levels[0]))
    live = np.isin(probes[:B_LIVE // 2], keys)
    assert res.found[:B_LIVE // 2][live].mean() > 0.9


def test_mixed_mode_matches_reference():
    """Mode "mixed" (which the store never selects) takes the per-file arms
    of mode "model" in both packages: held to the reference on half-learned
    trees, with the filter plane off and with the device filter probe."""
    (jt, pt), keys = _trees("half")
    probes = _probes(keys)
    je = jeng.LookupEngine(jeng.EngineConfig())
    pe = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    je.record_probe_split = pe.record_probe_split = True
    for filtered in (False, True):
        results = []
        for eng, tree, fmod in ((je, jt, jfilters), (pe, pt, pfilters)):
            state = eng.build_state(tree)
            kw = {}
            if filtered:
                filters, _, _ = _filter_inputs(tree, fmod, probes)
                kw = dict(fstate=eng.build_filter_state(filters))
            results.append(eng.lookup_async(
                state, probes, "mixed", l0_live=len(tree.levels[0]),
                **kw).resolve())
        jr, pr = results
        np.testing.assert_array_equal(pr.found, jr.found)
        np.testing.assert_array_equal(pr.vptr, jr.vptr)
        np.testing.assert_array_equal(pr.served_level, jr.served_level)
        for li in range(N_LEVELS):
            np.testing.assert_array_equal(pr.pos_counts[li],
                                          jr.pos_counts[li])
            np.testing.assert_array_equal(pr.neg_counts[li],
                                          jr.neg_counts[li])
        assert jr.found[:B_LIVE].any() and not jr.found[:B_LIVE].all()
    np.testing.assert_array_equal(pe.probe_split_np(), je.probe_split_np())
    np.testing.assert_array_equal(pe.filter_stats_np(),
                                  je.filter_stats_np())
    # the model arm really served: some probes went the model path
    assert pe.probe_split_np()[:, 0].sum() > 0
