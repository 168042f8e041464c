"""The port's in-memory level-granularity store against repro's on the
tests/test_level_models.py geometry — answers, virtual clock, level-model
epochs, level_attempts/level_failures and the CBA counters — and
``store_from_numpy`` carrying level models with their epochs."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.convert import store_from_numpy  # noqa: E402
from test_torch_store import _get_both, _to_numpy  # noqa: E402

N_LEVELS = 7
LEVEL_LSM = dict(memtable_cap=1 << 10, file_cap=1 << 11,
                 l1_cap_records=1 << 13)


def _level_pair(policy="always"):
    kw = dict(granularity="level", policy=policy, value_size=16,
              fetch_values=True)
    rs = R.BourbonStore(R.StoreConfig(lsm=R.LSMConfig(**LEVEL_LSM), **kw))
    ps = P.BourbonStore(P.StoreConfig(lsm=P.LSMConfig(**LEVEL_LSM),
                                      device="cpu", **kw))
    return rs, ps


def _level_state(st):
    return ([None if m is None else (m.epoch, int(m.n_segments))
             for m in st.level_models],
            st.executor.level_attempts, st.executor.level_failures,
            st.executor.jobs_done, st.executor.files_learned,
            st.executor.next_model_epoch, st.clock.now, st.foreground_us,
            st.lookups_model_path, st.lookups_baseline_path,
            dict(st.cba.decisions), dict(st.cba.filter_decisions),
            st.filters_built, st.filter_screened, st.filter_host_answered,
            [[(t.stats.n_pos, t.stats.n_neg) for t in lv]
             for lv in st.tree.levels])


def test_level_store_matches_reference():
    """The level-granularity store, fed the same stream: the executor's
    level jobs, their epochs, and every GET (the level-model arm, the
    baseline arm before a level is learned, L0 file models after
    learn_all) come out identical."""
    rs, ps = _level_pair()
    keys = np.random.default_rng(2).permutation(
        np.arange(1, 20001, dtype=np.int64) * 3)
    rng = np.random.default_rng(3)
    modes = set()
    for off in range(0, keys.shape[0], 4096):
        for st in (rs, ps):
            st.put_batch(keys[off: off + 4096])
        probes = np.concatenate([rng.choice(keys[: off + 4096], 600),
                                 rng.choice(keys, 200) + 1])
        (found, _), mode = _get_both(rs, ps, probes)
        modes.add(mode)
        assert _level_state(ps) == _level_state(rs)
    for st in (rs, ps):
        st.flush_all()
        st.drain_learning()
    assert _level_state(ps) == _level_state(rs)
    assert ps.executor.level_attempts > 0
    assert all(ps.level_models[i] is not None
               for i in range(1, N_LEVELS) if ps.tree.levels[i])
    for probes in (keys[:4096], keys[4096:4160] + 1, keys[:200]):
        (found, values), mode = _get_both(rs, ps, probes)
        modes.add(mode)
    assert found.all()
    np.testing.assert_array_equal(values[:, 0], (keys[:200] & 0xFF))
    for st in (rs, ps):
        st.learn_all()
    _get_both(rs, ps, keys[8000:12096])
    assert _level_state(ps) == _level_state(rs)
    assert modes == {"level"}
    assert ps.lookups_model_path > 0 and ps.lookups_baseline_path > 0


def test_store_from_numpy_carries_level_models():
    rs, _ = _level_pair(policy="offline")
    keys = np.random.default_rng(4).permutation(
        np.arange(1, 12001, dtype=np.int64) * 5)
    for off in range(0, keys.shape[0], 4096):
        rs.put_batch(keys[off: off + 4096])
    rs.flush_all()
    rs.learn_all()
    probes = np.concatenate([keys[:3000], keys[:1000] + 1])
    rs.get_batch(probes)                  # builds the level filters
    state = _to_numpy(rs)
    state["level_models"] = [None if m is None else {
        "starts": np.asarray(m.starts), "slopes": np.asarray(m.slopes),
        "intercepts": np.asarray(m.intercepts),
        "n_segments": int(m.n_segments), "epoch": m.epoch}
        for m in rs.level_models]
    ps = store_from_numpy(state, P.StoreConfig(
        granularity="level", policy="offline", value_size=16,
        fetch_values=True, lsm=P.LSMConfig(**LEVEL_LSM), device="cpu"))
    assert [None if m is None else m.epoch for m in ps.level_models] == \
        [None if m is None else m.epoch for m in rs.level_models]
    base = ps.lookups_baseline_path
    for _ in range(2):
        (found, _), mode = _get_both(rs, ps, probes)
        assert mode == "level" and found[:3000].all()
    assert ps.lookups_baseline_path == base      # every level had its model
    assert ps.filters_built == 0 and ps.executor.jobs_done == 0
