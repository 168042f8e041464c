"""The slice as a whole: the port's BourbonStore (device="cpu") fed the same
operations as repro's, answering byte-identically with the same virtual
clock, CBA decisions, per-file counters and engine-mode sequence.

The reference engine keys its stacked device state on the level version
alone, and learning a file does not bump it, so after a file is learned
the reference keeps serving that file with no model (in mode model_pure it
then misses every key the file holds; see ROADMAP Queue 3).  The port
tracks the learned set.  Where learning happens between GETs, these tests
make the reference restack before each GET so both are held to correct
answers."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.filters import FilterConfig as RFilters  # noqa: E402
from repro_torch.convert import store_from_numpy  # noqa: E402
from repro_torch.core.filters import FilterConfig as PFilters  # noqa: E402

N_LEVELS = 7
SMALL_LSM = dict(memtable_cap=1 << 10, file_cap=1 << 11,
                 l1_cap_records=1 << 13)


def _pair(policy="cba", mode="bourbon", fetch_values=True):
    rs = R.BourbonStore(R.StoreConfig(
        mode=mode, policy=policy, fetch_values=fetch_values,
        filters=RFilters(), lsm=R.LSMConfig(**SMALL_LSM)))
    ps = P.BourbonStore(P.StoreConfig(
        mode=mode, policy=policy, fetch_values=fetch_values,
        filters=PFilters(), lsm=P.LSMConfig(**SMALL_LSM), device="cpu"))
    return rs, ps


def _get_both(rs, ps, probes, restack=True):
    if restack:
        rs.engine._state_versions = [-1] * N_LEVELS
    modes = (rs._engine_mode(), ps._engine_mode())
    a, b = rs.get_batch(probes), ps.get_batch(probes)
    assert modes[0] == modes[1]
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    assert ps.clock.now == rs.clock.now
    return a, modes[0]


def _same_state(rs, ps):
    assert ps.clock.now == rs.clock.now
    assert ps.foreground_us == rs.foreground_us
    assert (ps.lookups_model_path, ps.lookups_baseline_path) == \
        (rs.lookups_model_path, rs.lookups_baseline_path)
    assert ps.executor.files_learned == rs.executor.files_learned
    assert ps.cba.decisions == rs.cba.decisions
    assert ps.cba.filter_decisions == rs.cba.filter_decisions
    assert [[(t.stats.n_pos, t.stats.n_neg, t.model is not None, t.n)
             for t in lv] for lv in ps.tree.levels] == \
        [[(t.stats.n_pos, t.stats.n_neg, t.model is not None, t.n)
          for t in lv] for lv in rs.tree.levels]
    rst = rs.stats()
    for k, v in ps.stats().items():
        assert rst[k] == v, k


def test_quickstart_workload():
    """examples/quickstart.py, scaled down to 16K keys."""
    rs, ps = _pair()
    keys = R.make_dataset("osm", 1 << 14, seed=0)
    perm = np.random.default_rng(0).permutation(keys)
    for st in (rs, ps):
        st.put_batch(perm)
        st.flush_all()
        assert st.learn_all() > 0
    probes = np.random.default_rng(1).choice(keys, 4096)
    (found, values), mode = _get_both(rs, ps, probes, restack=False)
    assert found.all() and mode == "model_pure"
    np.testing.assert_array_equal(values[:, 0], (probes & 0xFF).astype(np.uint8))
    _get_both(rs, ps, probes + 1, restack=False)
    _same_state(rs, ps)
    assert ps.stats()["model_path_frac"] == 1.0


def test_mixed_workload_with_cba():
    """Present, absent, deleted and overwritten keys under policy="cba",
    with batches on both sides of host_answer_max (the host-answer path
    and the padded device dispatch)."""
    rs, ps = _pair()
    keys = R.make_dataset("osm", 1 << 13, seed=3)
    rng = np.random.default_rng(3)
    dead = rng.choice(keys, 512, replace=False)
    ow = rng.choice(np.setdiff1d(keys, dead), 256, replace=False)
    ow_vals = rng.integers(0, 256, (256, 64), dtype=np.uint8)
    for st in (rs, ps):
        for off in range(0, keys.shape[0], 1 << 11):
            st.put_batch(keys[off: off + (1 << 11)])
        st.delete_batch(dead)
        st.put_batch(ow, ow_vals)
        st.flush_all()
    _same_state(rs, ps)
    absent = np.setdiff1d(keys + 1, keys)
    modes = []
    for r in range(10):
        size = (64, 512, 1024)[r % 3]
        probes = np.concatenate([rng.choice(keys, size // 2),
                                 rng.choice(absent, size // 4),
                                 rng.choice(dead, size // 8),
                                 rng.choice(ow, size - size // 2 - size // 4
                                            - size // 8)])
        (found, values), mode = _get_both(rs, ps, probes)
        modes.append(mode)
        assert not found[np.isin(probes, dead)].any()
        sel = np.isin(probes, ow)
        order = np.argsort(ow)
        np.testing.assert_array_equal(
            values[sel],
            ow_vals[order][np.searchsorted(ow[order], probes[sel])])
        if r == 4:      # writes between reads: a fresh L0 file, unlearned
            more = rng.choice(absent, 1 << 10, replace=False)
            for st in (rs, ps):
                st.put_batch(more)
                st.flush_all()
    _same_state(rs, ps)
    assert ps.filter_host_answered == rs.filter_host_answered > 0
    assert ps.filter_screened == rs.filter_screened > 0
    assert "model" in modes
    # range scans shadow tombstones identically
    starts = rng.choice(keys, 8)
    np.testing.assert_array_equal(ps.range_query(starts, 16),
                                  rs.range_query(starts, 16))


def _to_numpy(st) -> dict:
    """A repro store's state as plain numpy arrays (np.asarray)."""
    def table(t):
        m = None
        if t.model is not None:
            m = {"starts": np.asarray(t.model.starts),
                 "slopes": np.asarray(t.model.slopes),
                 "intercepts": np.asarray(t.model.intercepts),
                 "n_segments": int(t.model.n_segments)}
        return {"keys": t.keys, "seqs": t.seqs, "vptrs": t.vptrs,
                "fences": t.fences, "bloom": t.bloom, "bloom_k": t.bloom_k,
                "level": t.level, "file_id": t.file_id,
                "created_at": t.created_at, "model": m}
    n = len(st.memtable)
    return {
        "levels": [[table(t) for t in lv] for lv in st.tree.levels],
        "vlog_buf": np.asarray(st.vlog._buf), "vlog_head": len(st.vlog),
        "memtable": {"keys": st.memtable._keys[:n],
                     "seqs": st.memtable._seqs[:n],
                     "vptrs": st.memtable._vptrs[:n]},
        "level_filters": [None if f is None else {
            "bits": f.bits, "n_words": f.n_words, "k_hashes": f.k_hashes,
            "bits_per_key": f.bits_per_key, "n_keys": f.n_keys,
            "epoch": f.epoch} for f in st.level_filters],
        "level_version": list(st.tree.level_version),
        "seq": st._seq, "clock": st.clock.now}


def test_store_from_numpy_answers_identically():
    rs, _ = _pair(policy="offline")
    keys = R.make_dataset("normal", 1 << 13, seed=5)
    rng = np.random.default_rng(5)
    rs.put_batch(rng.permutation(keys))
    rs.flush_all()
    rs.learn_all()
    rs.delete_batch(keys[:300])
    rs.flush_all()
    rs.put_batch(keys[300:400] + 1)       # left in the memtable
    probes = np.concatenate([rng.choice(keys, 700), keys[:150],
                             keys[300:400] + 1, rng.choice(keys, 74) + 3])
    rs.get_batch(probes)                  # builds the level filters
    ps = store_from_numpy(_to_numpy(rs), P.StoreConfig(
        mode="bourbon", policy="offline", fetch_values=True,
        lsm=P.LSMConfig(**SMALL_LSM), device="cpu"))
    assert len(ps.memtable) == len(rs.memtable) > 0
    for _ in range(2):
        (found, values), mode = _get_both(rs, ps, probes)
        assert mode == "model"
        assert not found[700:850].any()        # deleted
        assert found[850:950].all()            # memtable
    assert ps.filters_built == 0           # carried filters were reused
    carried = {t.file_id for t in ps.tree.all_files()}
    ps.put_batch(np.array([7], np.int64))
    ps.flush_all()
    fresh = {t.file_id for t in ps.tree.all_files()} - carried
    assert fresh and min(fresh) > max(carried)


def test_learning_between_reads_serves_the_models():
    """Files learned after the level was stacked: every present key is
    still found once the store is model_pure."""
    _, ps = _pair(policy="offline")
    keys = P.make_dataset("osm", 1 << 13, seed=9)
    ps.put_batch(np.random.default_rng(9).permutation(keys))
    ps.flush_all()
    probes = np.random.default_rng(10).choice(keys, 512)
    assert ps.get_batch(probes)[0].all() and ps._engine_mode() == "model"
    ps.learn_all()
    found, _ = ps.get_batch(probes)
    assert ps._engine_mode() == "model_pure" and found.all()
    assert ps.stats()["model_path_frac"] > 0.4


def test_unported_options_raise():
    """Durable storage, level granularity, the I/O pool and the obs plane
    are ported: a store attached to an obs plane answers and reports as the
    reference's does (every counter and gauge equal), and detaching
    restores the null handles.  Only an unknown granularity raises."""
    import _torch_serving as common
    rs, ps = _pair(policy="offline")
    ro, po = common.RO.Obs(), common.PO.Obs()
    rs.attach_obs(ro, labels={"shard": "0"})
    ps.attach_obs(po, labels={"shard": "0"})
    keys = P.make_dataset("osm", 1 << 12, seed=5)
    for st in (rs, ps):
        st.put_batch(keys)
        st.flush_all()
        st.learn_all()
    probes = np.concatenate([keys[:300], keys[:100] + 1])
    _get_both(rs, ps, probes)
    _same_state(rs, ps)
    snap = po.snapshot()
    common.assert_snapshots_equal(ro.snapshot(), snap)
    assert common.sample(snap, "store_gets_total", shard="0") == 400
    assert ps.engine.probe_acc_materializations == 1
    ps.detach_obs()
    assert ps._obs is None and not ps.engine.record_probe_split
    assert ps.executor.events is None
    with pytest.raises(ValueError, match="granularity"):
        P.BourbonStore(P.StoreConfig(granularity="block", device="cpu"))
    st = P.BourbonStore(P.StoreConfig(device="cpu"))
    st.attach_io(object())
    st.detach_io()
    assert P.BourbonStore(P.StoreConfig(granularity="level",
                                        device="cpu"))._engine_mode() == \
        "level"
