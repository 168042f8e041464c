"""Level granularity in the port's engine: mode "level" (one PLR per level:
a global index, then the owning file by bisect over the files' first
indexes, SearchFB on the selected file) against repro's on the same LSM
content, with filters off, with the host mask and with the device filter
probe; and the level-model cache keyed on (level version, epoch)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro_torch.core as P  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import filters as jfilters  # noqa: E402
from repro.core import plr as jplr  # noqa: E402
from repro_torch.core import engine as peng  # noqa: E402
from repro_torch.core import filters as pfilters  # noqa: E402
from repro_torch.core import plr as pplr  # noqa: E402
from test_torch_engine import (B_LIVE, N_LEVELS, _filter_inputs,  # noqa: E402
                               _probes, _trees)


def _level_models(tree, plr, skip=()):
    """A level model for every sorted level but those in ``skip`` (which
    then take the baseline arm), stamped with distinct epochs."""
    lms = [None] * N_LEVELS
    for li in range(1, N_LEVELS):
        if tree.levels[li] and li not in skip:
            lms[li] = plr.greedy_plr_np(
                np.concatenate([t.keys for t in tree.levels[li]]), delta=8)
            lms[li].epoch = li
    return lms


@pytest.mark.parametrize("filters", ["off", "host", "device"])
def test_level_mode_engine_matches_reference(filters):
    (jt, pt), keys = _trees("half")
    probes = _probes(keys)
    je = jeng.LookupEngine(jeng.EngineConfig())
    pe = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    je.record_probe_split = pe.record_probe_split = True
    outs = []
    for eng, tree, fmod, plr in ((je, jt, jfilters, jplr),
                                 (pe, pt, pfilters, pplr)):
        # L2 without a level model: its probes take the baseline arm
        state = eng.build_state(tree, _level_models(tree, plr, skip=(2,)))
        kw = {}
        if filters != "off":
            filt, fm_host, hint = _filter_inputs(tree, fmod, probes)
            kw = dict(fstate=eng.build_filter_state(filt), level_maybe=hint,
                      fmaybe_host=fm_host if filters == "host" else None)
        res = eng.lookup_async(state, probes, "level",
                               l0_live=len(tree.levels[0]), **kw).resolve()
        outs.append((res, eng.probe_split_np(), eng.filter_stats_np()))
    (jr, jsplit, jfst), (pr, psplit, pfst) = outs
    np.testing.assert_array_equal(pr.found, jr.found)
    np.testing.assert_array_equal(pr.vptr, jr.vptr)
    np.testing.assert_array_equal(pr.served_level, jr.served_level)
    for li in range(N_LEVELS):
        np.testing.assert_array_equal(pr.pos_counts[li], jr.pos_counts[li])
        np.testing.assert_array_equal(pr.neg_counts[li], jr.neg_counts[li])
    np.testing.assert_array_equal(psplit, jsplit)
    np.testing.assert_array_equal(pfst, jfst)
    # both arms ran: L1 on its level model, L2 on the baseline
    assert psplit[1, 0] > 0 and psplit[1, 1] == 0
    assert psplit[2, 0] == 0 and psplit[2, 1] > 0
    assert jr.found[:B_LIVE].any() and not jr.found[:B_LIVE].all()
    if filters != "off":
        assert pfst[:, 0].sum() > 0


def test_level_model_cache_keyed_on_epoch():
    """Same level version + a different model rebuilds the stacked level
    model (keyed on the epoch, not id()); unstamped models get unique
    negative epochs; the same model object is a cache hit."""
    tree = P.LSMTree(P.LSMConfig())
    from repro_torch.core.sstable import build_sstable
    keys = np.cumsum(np.random.default_rng(7).integers(1, 50, 4096))
    n = keys.shape[0]
    tree.levels[1] = [build_sstable(keys, np.arange(n), np.arange(n), 1, 0.0)]
    eng = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    lms = [None] * N_LEVELS
    lms[1] = pplr.greedy_plr_np(keys, delta=8)
    lms[1].epoch = 0
    s1 = eng.build_state(tree, lms)
    assert s1.level_models[1].n_seg == lms[1].n_segments
    assert int(s1.level_models[1].total) == n
    m2 = pplr.greedy_plr_np(keys[: n // 8], delta=8)
    m2.epoch = 1
    lms[1] = m2
    s2 = eng.build_state(tree, lms)
    assert s2.level_models[1].n_seg == m2.n_segments
    assert s2.level_models[1].n_seg != s1.level_models[1].n_seg
    m3 = pplr.greedy_plr_np(keys[: n // 2], delta=8)
    lms[1] = m3
    s3 = eng.build_state(tree, lms)
    assert s3.level_models[1].n_seg == m3.n_segments and m3.epoch < -1
    assert eng.build_state(tree, lms).level_models[1] is s3.level_models[1]
    assert s3.level_models[1].starts.shape == (1, eng.cfg.level_seg_cap)
