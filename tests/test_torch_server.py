"""The port's serving front end (``repro_torch.server``) over the port's
``ShardedStore`` on the CPU (``device="cpu"``).

Port cases of the 18 tests of tests/test_server.py, with the same names
and bodies: the bounded queue, the batcher's coalescing, dedup, hold and
op order, the server's reads, writes and misses, the hot-key cache under
supersession and epoch moves, kill and reopen, the maintenance
coordinator's budget, the learning clock, the cache's fill edge cases,
and the sharded range query and stats.  (The one change: a store reopened
from its directory names its device, which ``SHARDS.json`` does not
store.)

And one parity test: the request streams of
``benchmarks/bench_serve.py::_request_streams`` (64 closed-loop clients,
two requests outstanding each) through the reference's ``BourbonServer``
on the reference's store and the port's on the port's: every request's
``found``, ``result`` and ``completed_tick`` equal, and ``stats()`` equal
less its wall-clock fields."""

import gc
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import _torch_serving as common  # noqa: E402
from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.cba import MaintenanceConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.distributed import ShardedConfig, ShardedStore  # noqa: E402
from repro_torch.server import (Batcher, BourbonServer,  # noqa: E402
                                CoordinatorConfig, RequestQueue,
                                ServerConfig, ServerRequest)
from test_torch_storage import sync_file_ids  # noqa: E402

VALUE_SIZE = 16


def _store_cfg(**kw):
    defaults = dict(granularity="level", policy="always",
                    value_size=VALUE_SIZE, vlog_seg_slots=1 << 9,
                    lsm=LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                                  l1_cap_records=1 << 13),
                    engine=EngineConfig(seg_cap=4096), device="cpu")
    defaults.update(kw)
    return StoreConfig(**defaults)


def _keys(n, seed=0, stride=7):
    return np.random.default_rng(seed).permutation(
        np.arange(1, n + 1, dtype=np.int64) * stride)


def _sharded(tmp_path, keys, n_shards=2, **kw):
    bounds = tuple(int(b) for b in
                   np.quantile(keys, np.arange(1, n_shards) / n_shards))
    return ShardedStore.open(str(tmp_path / "db"),
                             ShardedConfig(n_shards=n_shards,
                                           boundaries=bounds),
                             _store_cfg(**kw))


def _values(keys, version):
    v = np.zeros((keys.shape[0], VALUE_SIZE), np.uint8)
    v[:, 0] = (keys % 251).astype(np.uint8)
    v[:, 1] = version % 251
    return v


def _drain(srv, reqs=None):
    srv.run_until_drained()
    if reqs is not None:
        for r in reqs:
            assert r.done


# ---------------------------------------------------------------- admission

def test_queue_backpressure_rejects_when_full():
    q = RequestQueue(capacity=2)
    a = ServerRequest(0, "get", np.array([1]))
    b = ServerRequest(1, "get", np.array([2]))
    c = ServerRequest(2, "get", np.array([3]))
    assert q.submit(a, 0) and q.submit(b, 0)
    assert not q.submit(c, 0)
    assert q.rejected == 1 and q.submitted == 2 and len(q) == 2


def test_batcher_coalesces_dedups_and_scatters():
    q = RequestQueue(capacity=8)
    r1 = ServerRequest(0, "get", np.array([10, 20, 30]))
    r2 = ServerRequest(1, "get", np.array([20, 40]))     # 20 shared
    q.submit(r1, 0)
    q.submit(r2, 0)
    b = Batcher(max_batch_keys=16, max_wait_ticks=0)
    batch = b.next_batch(q, 0)
    assert batch is not None and batch.op == "get"
    np.testing.assert_array_equal(batch.keys, [10, 20, 30, 40])  # deduped
    # fan-in maps recover each request's own key order
    np.testing.assert_array_equal(batch.keys[batch.scatter[0]], r1.keys)
    np.testing.assert_array_equal(batch.keys[batch.scatter[1]], r2.keys)
    assert b.request_keys == 5 and b.batch_keys == 4
    assert len(q) == 0


def test_batcher_holds_partial_batch_then_dispatches():
    q = RequestQueue(capacity=8)
    q.submit(ServerRequest(0, "get", np.array([1, 2])), 0)
    b = Batcher(max_batch_keys=64, max_wait_ticks=2)
    assert b.next_batch(q, 0) is None          # partial: wait for more
    assert b.next_batch(q, 1) is None
    assert b.next_batch(q, 2) is not None      # max_wait_ticks reached
    assert b.held == 2 and b.batches == 1


def test_batcher_never_reorders_ops():
    """A PUT ahead of a GET in the queue always dispatches first — the
    write run is cut at the op change and dispatches immediately (no
    hold), so the GET can only ever run after it."""
    q = RequestQueue(capacity=8)
    q.submit(ServerRequest(0, "put", np.array([5]),
                           _values(np.array([5]), 1)), 0)
    q.submit(ServerRequest(1, "get", np.array([5])), 0)
    b = Batcher(max_batch_keys=64, max_wait_ticks=2)
    first = b.next_batch(q, 0)
    assert first is not None and first.op == "put"
    assert b.next_batch(q, 0) is None       # lone partial GET may wait...
    second = b.next_batch(q, 2)             # ...but only max_wait_ticks
    assert second is not None and second.op == "get"


# ------------------------------------------------------------------- server

def test_server_serves_reads_writes_and_misses(tmp_path):
    keys = _keys(4000, seed=1)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=512,
                                         max_wait_ticks=1,
                                         queue_capacity=64))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks, 0)))
        rid += 1
        srv.run_until_drained()
    reqs = []
    for c in range(16):
        ks = np.concatenate([keys[c * 50: c * 50 + 40],
                             keys[c * 50: c * 50 + 10] + 1])  # 10 misses
        r = ServerRequest(rid, "get", ks)
        rid += 1
        assert srv.submit(r)
        reqs.append(r)
    _drain(srv, reqs)
    for c, r in enumerate(reqs):
        assert r.found[:40].all()
        assert (r.result[:40, 0] == (r.keys[:40] % 251)).all()
        miss = ~np.isin(r.keys[40:], keys)
        assert not r.found[40:][miss].any()
    s = srv.stats()
    assert s["completed"] == s["submitted"] == rid
    assert s["batches"] < rid          # coalescing actually happened
    st.close()


def test_cache_hot_keys_then_put_delete_supersede(tmp_path):
    """The satellite correctness matrix: a cached key must not serve
    stale data after a PUT or DELETE that supersedes it."""
    keys = _keys(3000, seed=2)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=512,
                                         max_wait_ticks=0))
    rid = [0]

    def do(op, ks, values=None):
        r = ServerRequest(rid[0], op, ks, values)
        rid[0] += 1
        assert srv.submit(r)
        srv.run_until_drained()
        return r

    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        do("put", ks, _values(ks, 0))
    hot = keys[:64]
    do("get", hot)
    h0 = srv.cache.hits
    r = do("get", hot)                       # second read: cache hits
    assert srv.cache.hits > h0
    assert r.found.all() and (r.result[:, 1] == 0).all()
    # PUT supersedes: the very next read must see version 1
    do("put", hot, _values(hot, 1))
    r = do("get", hot)
    assert r.found.all() and (r.result[:, 1] == 1).all()
    # DELETE supersedes: the very next read must miss
    do("delete", hot[:8])
    r = do("get", hot[:8])
    assert not r.found.any()
    assert srv.cache.inval_write > 0
    st.close()


def test_cache_epoch_invalidation_on_roll_and_compaction(tmp_path):
    """A cached key is dropped when its shard's structural epoch moves —
    exercised by a memtable roll and then by enough load to compact —
    without the key itself ever being rewritten."""
    keys = _keys(12000, seed=3)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=1024,
                                         max_wait_ticks=0))
    rid = [0]

    def do(op, ks, values=None):
        r = ServerRequest(rid[0], op, ks, values)
        rid[0] += 1
        assert srv.submit(r)
        srv.run_until_drained()
        return r

    seed_ks = keys[:512]
    do("put", seed_ks, _values(seed_ks, 0))
    probe = seed_ks[:16]
    do("get", probe)                          # fills the cache (memtable)
    # roll shard memtables by writing OTHER keys only: no explicit
    # invalidation of `probe` ever happens, the epoch must do it
    filler = keys[512:2600]
    e0 = st.shard_epochs()
    for off in range(0, filler.shape[0], 500):
        ks = filler[off: off + 500]
        do("put", ks, _values(ks, 0))
    assert st.shard_epochs() != e0            # memtable(s) rolled
    inv0 = srv.cache.inval_epoch
    r = do("get", probe)
    assert srv.cache.inval_epoch > inv0       # dropped by the epoch rule
    assert r.found.all() and (r.result[:, 1] == 0).all()  # still correct
    # now push enough data to trigger compaction events too
    rest = keys[2600:]
    for off in range(0, rest.shape[0], 500):
        ks = rest[off: off + 500]
        do("put", ks, _values(ks, 0))
    assert any(len(sh.tree.levels[1]) > 0 for sh in st.shards)
    inv1 = srv.cache.inval_epoch
    r = do("get", probe)
    assert srv.cache.inval_epoch > inv1       # compaction epoch bump
    assert r.found.all() and (r.result[:, 1] == 0).all()
    st.close()


def test_server_kill_reopen_comes_back_cold_but_correct(tmp_path):
    keys = _keys(5000, seed=4)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=1024,
                                         max_wait_ticks=0))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        srv.submit(ServerRequest(rid, "put", ks, _values(ks, 0)))
        rid += 1
        srv.run_until_drained()
    r = ServerRequest(rid, "get", keys[:64])
    rid += 1
    srv.submit(r)
    srv.run_until_drained()
    assert r.found.all()
    del srv, st                               # CRASH: no close
    gc.collect()

    st2 = ShardedStore.open(str(tmp_path / "db"), device="cpu")
    srv2 = BourbonServer(st2, ServerConfig(max_batch_keys=1024,
                                           max_wait_ticks=0))
    assert srv2.cache.hits == 0 and len(srv2.cache) == 0   # cold cache
    probes = np.concatenate([keys[:2000], keys[:200] + 1])
    r = ServerRequest(0, "get", probes)
    srv2.submit(r)
    srv2.run_until_drained()
    assert r.found[:2000].all()
    assert (r.result[:2000, 0] == (probes[:2000] % 251)).all()
    miss = ~np.isin(keys[:200] + 1, keys)
    assert not r.found[2000:][miss].any()
    assert srv2.cache.hits == 0               # first pass was all misses
    st2.close()


# -------------------------------------------------------------- maintenance

def _overwrite_rounds(srv, keys, rounds, rid0=0):
    rid = rid0
    for rnd in range(rounds):
        for off in range(0, keys.shape[0], 500):
            ks = keys[off: off + 500]
            srv.submit(ServerRequest(rid, "put", ks, _values(ks, rnd)))
            rid += 1
            srv.run_until_drained()
    return rid


def test_coordinator_budget_is_a_hard_per_tick_ceiling(tmp_path):
    budget = 1500.0
    keys = _keys(4096, seed=5)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(
        max_batch_keys=512, max_wait_ticks=0,
        coordinator=CoordinatorConfig(budget_us_per_tick=budget,
                                      max_shards_per_tick=1)))
    assert all(sh.maintenance_deferred for sh in st.shards)
    _overwrite_rounds(srv, keys, rounds=5)
    for _ in range(200):                      # drain deferred maintenance
        srv.tick()
    s = srv.stats()
    assert s["store"]["auto_gc"]["segments_removed"] > 0
    assert s["max_maintenance_tick_us"] <= budget + 1e-9
    co = s["coordinator"]
    assert co["max_tick_us"] <= budget + 1e-9
    assert co["runs"] > 0
    # round-robin staggering: both shards got their own maintenance turns
    assert all(n > 0 for n in co["per_shard_runs"])
    st.close()


def test_coordinator_rejects_starving_budget_and_autosizes(tmp_path):
    """GC is atomic per segment: a budget below one segment's worst-case
    collect cost would defer every candidate forever, so it is refused;
    an unset budget auto-sizes to exactly that atomic unit."""
    keys = _keys(500, seed=10)
    st = _sharded(tmp_path, keys)
    atomic = st.shards[0].cfg.costs.t_gc(st.shards[0].cfg.vlog_seg_slots,
                                         st.shards[0].cfg.vlog_seg_slots)
    with pytest.raises(ValueError, match="atomic"):
        BourbonServer(st, ServerConfig(
            coordinator=CoordinatorConfig(budget_us_per_tick=atomic / 2)))
    srv = BourbonServer(st, ServerConfig())          # auto budget
    assert srv.coordinator.budget_us == pytest.approx(atomic)
    st.close()


def test_batcher_splits_puts_with_and_without_values(tmp_path):
    """Puts with explicit values and default-valued puts cannot share one
    store call: the run is cut at the boundary, both still complete in
    submission order (the crash path would have lost both)."""
    keys = _keys(100, seed=11)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=512,
                                         max_wait_ticks=0))
    a = ServerRequest(0, "put", keys[:10], _values(keys[:10], 3))
    b = ServerRequest(1, "put", keys[10:20])         # store-default values
    assert srv.submit(a) and srv.submit(b)
    srv.run_until_drained()
    assert a.done and b.done
    r = ServerRequest(2, "get", keys[:20])
    srv.submit(r)
    srv.run_until_drained()
    assert r.found.all()
    assert (r.result[:10, 1] == 3).all()             # explicit values
    assert (r.result[10:20, 0]
            == (keys[10:20] & 0xFF).astype(np.uint8)).all()  # defaults
    st.close()


def test_run_maintenance_budget_defers_not_drops(tmp_path):
    """A zero budget does no work but remembers it; an uncapped call
    later collects what was deferred."""
    keys = _keys(3000, seed=6)
    st = _sharded(tmp_path, keys,
                  maintenance=MaintenanceConfig(gc_t_wait_us=0.0,
                                                gc_scan_interval_us=0.0))
    st.set_maintenance_deferred(True)
    for rnd in range(4):                      # pile up dead entries
        for off in range(0, keys.shape[0], 500):
            ks = keys[off: off + 500]
            st.put_batch(ks, _values(ks, rnd))
    spent = sum(st.run_shard_maintenance(i, budget_us=0.0)
                for i in range(st.n_shards))
    assert spent == 0.0
    assert st.stats()["auto_gc"]["segments_removed"] == 0
    assert sum(sh.cba.gc_deferred for sh in st.shards) > 0
    for i in range(st.n_shards):
        assert st.run_shard_maintenance(i) > 0.0  # no budget: collect now
        assert st.shards[i].last_maintenance_us > 0.0
    assert st.stats()["auto_gc"]["segments_removed"] > 0
    st.close()


def test_learning_and_virtual_time_progress_under_coordinator(tmp_path):
    """With a coordinator owning maintenance, the shards' own learning
    pipeline must still progress: read batches charge the virtual clocks
    (ShardedStore.get_batch alone charges nothing) and every server tick
    ticks the stores, so queued learning jobs complete during idle —
    they must not freeze the moment write traffic stops."""
    keys = _keys(8000, seed=12)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=1024,
                                         max_wait_ticks=0))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        srv.submit(ServerRequest(rid, "put", ks, _values(ks, 0)))
        rid += 1
        srv.run_until_drained()
    # read-only traffic advances virtual time on the probed shards
    t0 = [sh.clock.now for sh in st.shards]
    r = ServerRequest(rid, "get", keys[:800])
    rid += 1
    srv.submit(r)
    srv.run_until_drained()
    assert r.found.all()
    assert all(sh.clock.now > t for sh, t in zip(st.shards, t0))
    # idle ticks drain any queued/running learning jobs to completion
    for _ in range(2000):
        if all(not sh.executor.queue and not sh.executor.running
               for sh in st.shards):
            break
        srv.tick()
    assert all(not sh.executor.queue and not sh.executor.running
               for sh in st.shards)
    assert all(sh.level_models[1] is not None or not sh.tree.levels[1]
               for sh in st.shards)
    st.close()


def test_uncoordinated_server_still_tracks_stall_metric(tmp_path):
    keys = _keys(3000, seed=7)
    st = _sharded(tmp_path, keys)
    srv = BourbonServer(st, ServerConfig(max_batch_keys=512,
                                         max_wait_ticks=0,
                                         coordinate_maintenance=False))
    assert srv.coordinator is None
    assert not any(sh.maintenance_deferred for sh in st.shards)
    _overwrite_rounds(srv, keys, rounds=4)
    s = srv.stats()
    assert s["store"]["auto_gc"]["segments_removed"] > 0
    assert s["max_maintenance_tick_us"] > 0.0   # self-driven GC observed
    st.close()


# ------------------------------------------------------------ cache (unit)

def test_cache_fill_never_evicts_a_row_it_is_updating():
    """Regression: a full cache filled with a batch mixing new keys and
    an already-cached (oldest-stamped) key must not evict that key's row
    for one of the new keys — the later duplicate-row write would serve
    the old key's value under the new key."""
    from repro_torch.server import HotKeyCache
    c = HotKeyCache(slots=4)
    def v(key):
        row = np.zeros((1, 8), np.uint8)
        row[0, 0] = key % 251
        return row
    ep = (0,)
    for k in (1, 2, 3, 4):
        c.fill(np.array([k], np.int64), v(k), np.zeros(1, np.int64), ep)
    # key 1 is oldest-stamped; refill it together with three new keys
    batch = np.array([5, 6, 7, 1], np.int64)
    vals = np.concatenate([v(5), v(6), v(7), v(1)])
    c.fill(batch, vals, np.zeros(4, np.int64), ep)
    out = np.zeros((4, 8), np.uint8)
    hit = c.lookup(batch, ep, out)
    assert hit.all()
    assert (out[:, 0] == batch % 251).all()     # every key its own value


def test_cache_fill_larger_than_slots_keeps_tail_and_counts_evictions():
    """Regression: one fill with more new keys than the cache has slots
    must not crash — the last ``slots`` pairs are admitted (what
    sequential insertion would have kept) and the drop is counted."""
    from repro_torch.server import HotKeyCache
    c = HotKeyCache(slots=8)
    keys = np.arange(1, 13, dtype=np.int64)
    vals = np.zeros((12, 8), np.uint8)
    vals[:, 0] = keys
    c.fill(keys, vals, np.zeros(12, np.int64), (0,))
    assert len(c) == 8
    assert c.evictions == 4
    out = np.zeros((8, 8), np.uint8)
    hit = c.lookup(keys[-8:], (0,), out)
    assert hit.all() and (out[:, 0] == keys[-8:]).all()


# ------------------------------------------------- ShardedStore satellites

def test_sharded_range_query_merges_across_shard_boundaries(tmp_path):
    keys = np.arange(1, 4001, dtype=np.int64) * 5
    st = _sharded(tmp_path, np.random.default_rng(8).permutation(keys),
                  n_shards=4)
    st.put_batch(keys, _values(keys, 0))
    # deleted keys must not appear in scans (newest version is a
    # tombstone), even though older versions remain in the tree
    deleted = keys[100:140]
    st.delete_batch(deleted)
    st.flush_all()
    flat = np.sort(np.setdiff1d(keys, deleted))
    got = st.range_query(np.array([int(deleted[0]) - 5], np.int64), 30)[0]
    i0 = np.searchsorted(flat, int(deleted[0]) - 5)
    np.testing.assert_array_equal(got, flat[i0: i0 + 30])
    assert not np.isin(deleted, got).any()
    bounds = np.asarray(st._splits)
    # start just below each boundary with a length that crosses it, plus
    # one scan long enough to span two boundaries
    starts = [int(b) - 60 for b in bounds] + [int(bounds[0]) - 60]
    lengths = [40, 40, 40, int(np.searchsorted(flat, bounds[1]))]
    for sk, ln in zip(starts, lengths):
        got = st.range_query(np.array([sk], np.int64), ln)[0]
        i0 = np.searchsorted(flat, sk)
        np.testing.assert_array_equal(got, flat[i0: i0 + ln])
    # running off the end of the keyspace pads with -1
    got = st.range_query(np.array([flat[-3]], np.int64), 10)[0]
    np.testing.assert_array_equal(got[:3], flat[-3:])
    assert (got[3:] == -1).all()
    # batched form matches per-key form
    batch = st.range_query(np.asarray(starts, np.int64), 40)
    for bi, sk in enumerate(starts):
        i0 = np.searchsorted(flat, sk)
        np.testing.assert_array_equal(batch[bi], flat[i0: i0 + 40])
    st.close()


def test_sharded_stats_aggregate_maintenance_counters(tmp_path):
    keys = _keys(3000, seed=9)
    st = _sharded(tmp_path, keys)
    for rnd in range(4):
        for off in range(0, keys.shape[0], 500):
            ks = keys[off: off + 500]
            st.put_batch(ks, _values(ks, rnd))
    s = st.stats()
    per = s["shards"]
    assert s["vlog_segments_removed"] == sum(
        p["vlog_segments_removed"] for p in per) > 0
    assert s["auto_gc"]["segments_removed"] == sum(
        p["auto_gc"]["segments_removed"] for p in per)
    assert s["auto_gc"]["bytes_reclaimed"] > 0
    assert s["gc_us"] == pytest.approx(sum(p["gc_us"] for p in per))
    assert s["gc_us"] > 0
    assert s["manifest_checkpoints"] == sum(
        p["manifest_checkpoints"] for p in per)
    assert s["maintenance_us"] >= s["gc_us"]
    assert s["n_gets"] == 0
    st.close()


# ------------------------------------------------------- parity with repro

def _serve(pkg, root, keys, streams, overwrite):
    M = common.PKGS[pkg]
    S = M["server"]
    st = common.open_sharded(pkg, root, keys, n_shards=4, fetch_values=True)
    srv = S.BourbonServer(st, S.ServerConfig(
        max_batch_keys=1024, max_wait_ticks=1, queue_capacity=128,
        max_batches_per_tick=8,
        coordinator=S.CoordinatorConfig(budget_us_per_tick=2048.0)))
    common.load_through(srv, S, keys)
    common.load_through(srv, S, overwrite, version=1)
    reqs = common.closed_loop(srv, S, streams)
    out = ([common.request_record(r) for r in reqs],
           common.stats_less_wall_time(srv.stats()))
    st.close()
    return out


def test_server_matches_reference(tmp_path):
    keys = common.keys_of(4000, seed=40)
    streams = common._request_streams(keys, seed=41, clients=64, rounds=3,
                                      keys_per_req=32)
    # a few clients also write and delete between their reads
    rng = np.random.default_rng(42)
    for c in range(0, 64, 8):
        ks = rng.choice(keys, 16, replace=False)
        streams[c].insert(1, ("put", ks, common.values_of(ks, 2)))
        streams[c + 1].insert(2, ("delete", ks[:4], None))
    sync_file_ids()
    ref = _serve("repro", tmp_path / "r", keys, streams, keys[:600])
    port = _serve("repro_torch", tmp_path / "p", keys, streams, keys[:600])
    assert len(port[0]) == len(ref[0]) == 64 * 3 + 16
    for a, b in zip(ref[0], port[0]):
        assert a == b, a[:2]
    assert port[1] == ref[1]
    assert port[1]["cache"]["hits"] > 0 and port[1]["batches"] > 1
