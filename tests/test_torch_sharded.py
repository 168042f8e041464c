"""The port's ShardedStore (device="cpu") against repro's opened with
``mesh=None`` — the host-fallback GET the reference runs on one device —
on the shard config of tests/test_distributed.py: durable level-granularity
shards, filters on.  Held exactly: values and tombstones, kill/reopen from
the directories alone, the state-epoch refresh on a memtable roll,
``load_shard_snapshot``, an empty shard probed with KEY_SENTINEL, SHARDS.json
written by either package opening in the other, and I/O pool sizes 0, 1
and 4.  The shard descent runs on each probe's owning shard row; it is
held against the reference's loop over every shard."""

import gc
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.distributed import dist_get_local as r_local  # noqa: E402
from repro.core.engine import EngineConfig as REngineConfig  # noqa: E402
from repro.distributed import sharded as rsh  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    KEY_SENTINEL, build_dist_state_from_shards, dist_get_local)
from repro_torch.core.engine import EngineConfig as PEngineConfig  # noqa: E402
from repro_torch.core.filters import build_level_filter  # noqa: E402
from repro_torch.distributed import sharded as psh  # noqa: E402
from repro_torch.io import IOPool  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_storage import sync_file_ids  # noqa: E402

PAD_PROBE = -(1 << 62)


def _store_cfg(M, EC, **kw):
    defaults = dict(granularity="level", policy="always", value_size=16,
                    lsm=M.LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                                    l1_cap_records=1 << 13),
                    engine=EC(seg_cap=4096))
    defaults.update(kw)
    return M.StoreConfig(**defaults)


def _values_for(keys, version):
    v = np.zeros((keys.shape[0], 16), np.uint8)
    v[:, 0] = (keys % 251).astype(np.uint8)
    v[:, 1] = version % 251
    return v


def _open_pair(tmp_path, keys, n_shards, boundaries=None):
    if boundaries is None:
        boundaries = tuple(int(b) for b in np.quantile(
            keys, np.arange(1, n_shards) / n_shards))
    rs = rsh.ShardedStore.open(
        str(tmp_path / "r"), rsh.ShardedConfig(n_shards, boundaries),
        _store_cfg(R, REngineConfig), mesh=None)
    ps = psh.ShardedStore.open(
        str(tmp_path / "p"), psh.ShardedConfig(n_shards, boundaries),
        _store_cfg(P, PEngineConfig), device="cpu")
    return rs, ps


def _same(a, b):
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])


def _get_both(rs, ps, probes, with_values=True):
    a = rs.get_batch(probes, with_values=with_values)
    b = ps.get_batch(probes, with_values=with_values)
    _same(a, b)
    assert ps.state_epoch == rs.state_epoch
    return b


def test_sharded_values_tombstones_and_files_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    keys = rng.permutation(np.arange(1, 12001, dtype=np.int64) * 7)
    rs, ps = _open_pair(tmp_path, keys, 2)
    sync_file_ids()
    for st in (rs, ps):
        for off in range(0, keys.shape[0], 2048):
            ks = keys[off: off + 2048]
            st.put_batch(ks, _values_for(ks, 0))
        st.put_batch(keys[:2000], _values_for(keys[:2000], 1))
        st.delete_batch(keys[2000:3000])
    probes = np.concatenate([keys, keys[:500] + 1])
    found, vals = _get_both(rs, ps, probes)
    assert found[:2000].all() and (vals[:2000, 1] == 1).all()
    assert not found[2000:3000].any()
    assert found[3000:12000].all() and (vals[3000:12000, 1] == 0).all()
    _get_both(rs, ps, probes[::3], with_values=False)   # vptrs too
    starts = rng.choice(keys, 6)
    np.testing.assert_array_equal(ps.range_query(starts, 40),
                                  rs.range_query(starts, 40))
    sr, sp = rs.stats(), ps.stats()
    for k in ("n_records", "n_files", "files_learned", "n_gets", "wal",
              "vlog_disk_bytes", "per_shard"):
        assert sp[k] == sr[k], k
    rs.close()
    ps.close()
    for i in range(2):   # every shard directory: the same bytes
        rd, pd = tmp_path / "r" / f"shard-{i}", tmp_path / "p" / f"shard-{i}"
        names = sorted(n for n in os.listdir(rd) if n != "LOCK")
        assert names == sorted(n for n in os.listdir(pd) if n != "LOCK")
        for n in names:
            assert (rd / n).read_bytes() == (pd / n).read_bytes(), n


def test_sharded_kill_reopen_from_directories(tmp_path):
    rng = np.random.default_rng(1)
    keys = rng.permutation(np.arange(1, 20001, dtype=np.int64) * 3)
    rs, ps = _open_pair(tmp_path, keys, 4)
    flushed, tail = keys[:16384], keys[16384:17000]
    for st in (rs, ps):
        for off in range(0, flushed.shape[0], 4096):
            ks = flushed[off: off + 4096]
            st.put_batch(ks, _values_for(ks, 0))
        st.flush_all()
        st.learn_all()
        st.put_batch(tail, _values_for(tail, 0))   # WAL-only at kill time
    del rs, ps, st                                  # KILL: no close
    gc.collect()
    rs = rsh.ShardedStore.open(str(tmp_path / "r"), mesh=None)
    ps = psh.ShardedStore.open(str(tmp_path / "p"), device="cpu")
    sr, sp = rs.stats(), ps.stats()
    for k in ("n_shards", "files_learned", "models_recovered",
              "level_models_recovered", "n_records"):
        assert sp[k] == sr[k], k
    assert sp["files_learned"] == 0 and sp["level_models_recovered"] > 0
    probes = np.concatenate([flushed[:4000], tail, flushed[:500] + 1])
    found, vals = _get_both(rs, ps, probes)
    assert found[:4616].all()
    assert all(sh.executor.jobs_done == 0 for sh in ps.shards)
    # a shard's own GET runs mode "level" on its persisted level models
    a = rs.shards[0].get_batch(flushed[:512])
    b = ps.shards[0].get_batch(flushed[:512])
    _same(a, b)
    assert ps.shards[0]._engine_mode() == "level"
    assert ps.shards[0].lookups_baseline_path == 0
    rs.close()
    ps.close()


def test_sharded_state_epoch_refreshes_on_memtable_roll(tmp_path):
    rng = np.random.default_rng(2)
    keys = rng.permutation(np.arange(1, 6001, dtype=np.int64) * 11)
    rs, ps = _open_pair(tmp_path, keys, 2)
    small = keys[:512]
    for st in (rs, ps):
        st.put_batch(small, _values_for(small, 0))
    assert _get_both(rs, ps, small)[0].all()        # memtable overlay
    e0 = ps.state_epoch
    for st in (rs, ps):
        for off in range(0, keys.shape[0], 2048):
            ks = keys[off: off + 2048]
            st.put_batch(ks, _values_for(ks, 1))
        st.flush_all()
    assert _get_both(rs, ps, keys)[0].all()         # the snapshot path
    assert ps.state_epoch > e0
    e1 = ps.state_epoch
    _get_both(rs, ps, keys[:256])
    assert ps.state_epoch == e1                     # a read does not rebuild
    rs.close()
    ps.close()


def test_load_shard_snapshot_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    keys = rng.permutation(np.arange(1, 8001, dtype=np.int64) * 5)
    rs, ps = _open_pair(tmp_path, keys, 2)
    for st in (rs, ps):
        st.put_batch(keys, _values_for(keys, 0))
        st.delete_batch(keys[:1000])
        st.flush_all()
    want = [psh.merge_live(list(sh.tree.all_files())) for sh in ps.shards]
    rs.close()
    ps.close()
    for i, (wk, wv) in enumerate(want):
        for d in ("p", "r"):                         # either package's dir
            gk, gv = psh.load_shard_snapshot(str(tmp_path / d / f"shard-{i}"))
            rk, rv = rsh.load_shard_snapshot(str(tmp_path / d / f"shard-{i}"))
            np.testing.assert_array_equal(gk, wk)
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gk, rk)
            np.testing.assert_array_equal(gv, rv)
        assert not np.isin(keys[:1000], gk).any()


def test_owning_rows_equal_the_loop_over_every_shard():
    """The descent on each probe's owning row == the reference's shard
    kernel run once per shard and merged, with an empty shard, a probe
    equal to KEY_SENTINEL, pad lanes, misses, and the filter mask."""
    rng = np.random.default_rng(9)
    k0 = np.sort(rng.choice(1 << 40, 5000, replace=False)).astype(np.int64)
    k2 = np.sort(rng.choice(1 << 40, 37, replace=False)
                 + (1 << 42)).astype(np.int64)
    snaps = [(k0, np.arange(5000, dtype=np.int64)),
             (np.empty(0, np.int64), np.empty(0, np.int64)),   # empty
             (k2, np.arange(37, dtype=np.int64) + 7)]
    splits = np.array([1 << 41, 1 << 42], np.int64)
    filters = [build_level_filter(k, 10, 7) if k.shape[0] else None
               for k, _ in snaps]
    probes = np.concatenate([k0[:64], k2, k0[:10] + 1, [KEY_SENTINEL,
                             KEY_SENTINEL - 1, (1 << 41) + 5, PAD_PROBE,
                             0]]).astype(np.int64)
    rows = np.searchsorted(splits, probes, side="right").astype(np.int32)
    for with_filters in (False, True):
        state_np = build_dist_state_from_shards(
            snaps, 8, filters=filters if with_filters else None)
        # the reference: every shard over the whole batch, owner-merged
        found = np.zeros(probes.shape[0], bool)
        vptr = np.full(probes.shape[0], -1, np.int64)
        for s in range(3):
            shard = {k: jnp.asarray(v[s: s + 1]) for k, v in state_np.items()}
            h, v = r_local(shard, jnp.asarray(probes), 8)
            h = np.asarray(h)
            found |= h
            vptr = np.where(h, np.asarray(v), vptr)
        st = {k: torch.from_numpy(v.view(np.int64) if k == "fbits" else v)
              for k, v in state_np.items()}
        p = torch.from_numpy(probes)
        maybe = (ops.bloom_probe_stack(st["fbits"], st["fnw"], p, 7)
                 if with_filters else None)
        hit, v = dist_get_local(st, p, torch.from_numpy(rows), 8, maybe)
        np.testing.assert_array_equal(hit.numpy(), found)
        np.testing.assert_array_equal(
            np.where(hit.numpy(), v.numpy(), -1), vptr)
        assert not hit.numpy()[-5:].any() and found[:101].all()


def test_empty_shard_with_sentinel_probe_in_the_store(tmp_path):
    """A shard that never receives a key: its row stays lo = hi = n = 0
    placeholders and a probe equal to KEY_SENTINEL routed to it misses."""
    keys = np.arange(1, 3001, dtype=np.int64) * 13
    rs, ps = _open_pair(tmp_path, keys, 3,
                        boundaries=(int(keys[-1]) + 1, int(keys[-1]) + 100))
    for st in (rs, ps):
        st.put_batch(keys, _values_for(keys, 0))
        st.flush_all()
    probes = np.concatenate([keys[:100], keys[:50] + 1,
                             [KEY_SENTINEL, KEY_SENTINEL - 1,
                              int(keys[-1]) + 50]]).astype(np.int64)
    found, _ = _get_both(rs, ps, probes)
    assert found[:100].all() and not found[100:].any()
    assert int(ps.device_state()["n"][1]) == int(ps.device_state()["n"][2]) \
        == 0
    rs.close()
    ps.close()


def test_shards_json_opens_in_either_package(tmp_path):
    """SHARDS.json holds the reference's field set: a port-written file
    carries no device and opens in repro; a repro-written one opens in the
    port, with the default device (the card) unless the caller names one."""
    keys = np.arange(1, 4001, dtype=np.int64) * 3
    rs, ps = _open_pair(tmp_path, keys, 2)
    for st in (rs, ps):
        st.put_batch(keys, _values_for(keys, 0))
    rs.close()
    ps.close()
    rj = json.loads((tmp_path / "r" / "SHARDS.json").read_text())
    pj = json.loads((tmp_path / "p" / "SHARDS.json").read_text())
    assert pj == rj
    assert "device" not in pj["store_cfg"]
    assert "device" not in pj["store_cfg"]["engine"]
    assert (tmp_path / "r" / "SHARDS.json").read_bytes() == \
        (tmp_path / "p" / "SHARDS.json").read_bytes()
    assert psh._store_cfg_from_dict(rj["store_cfg"],
                                    P.StoreConfig.device).device == "cuda"
    probes = np.concatenate([keys[:1000], keys[:200] + 1])
    r2 = rsh.ShardedStore.open(str(tmp_path / "p"), mesh=None)
    p2 = psh.ShardedStore.open(str(tmp_path / "r"), device="cpu")
    assert p2.shards[0].cfg.engine.level_seg_cap == 65536
    assert p2.shards[0].cfg.engine.device == "cpu"
    found, _ = _get_both(r2, p2, probes)
    assert found[:1000].all()
    r2.close()
    p2.close()


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_io_pool_sizes_give_identical_results(tmp_path, workers):
    """Writes fan out, wal_sync and value fetches resolve through the pool
    (or inline with none): every result equals the reference's inline run,
    bit for bit, with group-commit WALs."""
    rng = np.random.default_rng(5)
    keys = rng.permutation(np.arange(1, 9001, dtype=np.int64) * 7)
    bounds = tuple(int(b) for b in np.quantile(keys, [0.25, 0.5, 0.75]))
    rs = rsh.ShardedStore.open(
        str(tmp_path / "r"), rsh.ShardedConfig(4, bounds),
        _store_cfg(R, REngineConfig, wal_group_commit=True), mesh=None)
    ps = psh.ShardedStore.open(
        str(tmp_path / "p"), psh.ShardedConfig(4, bounds),
        _store_cfg(P, PEngineConfig, wal_group_commit=True), device="cpu")
    pool = IOPool(workers=workers) if workers else None
    if pool is not None:
        ps.attach_io(pool)
    try:
        outs = []
        for st in (rs, ps):
            res = []
            for off in range(0, keys.shape[0], 1500):
                ks = keys[off: off + 1500]
                st.put_batch(ks, _values_for(ks, off))
                st.wal_sync()
                pb = st.dispatch_get(np.concatenate([ks[:700], ks[:64] + 1]),
                                     with_values=True)
                res.append(st.resolve_get_async(pb).wait())
            st.delete_batch(keys[:500])
            st.wal_sync()
            res.append(st.get_batch(keys[:5000], with_values=True))
            outs.append(res)
        for a, b in zip(*outs):
            _same(a, b)
        assert outs[1][-1][0][500:].all() and not outs[1][-1][0][:500].any()
    finally:
        if pool is not None:
            ps.detach_io()
            pool.close()
        rs.close()
        ps.close()


def test_mesh_and_obs_are_later_slices(tmp_path):
    with pytest.raises(NotImplementedError, match="later slice"):
        psh.ShardedStore.open(str(tmp_path / "m"), mesh=object(),
                              device="cpu")
    st = psh.ShardedStore.open(str(tmp_path / "s"),
                               psh.ShardedConfig(n_shards=2), device="cpu")
    assert not st.uses_shard_map
    with pytest.raises(NotImplementedError, match="later slice"):
        st.attach_obs(object())
    st.close()
