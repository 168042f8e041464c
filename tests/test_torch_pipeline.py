"""The port's pipelined server (``repro_torch.server.PipelinedServer``)
over the port's ``ShardedStore`` on the CPU (``device="cpu"``).

Port cases of tests/test_pipeline.py, with the same names and bodies: the
pipelined server against the synchronous one and against an oracle,
in-flight epoch pinning across a memtable roll, write barriers,
backpressure at ``max_inflight``, maintenance in bubbles and forced
drains, lazy counter copies, and the stores' dispatch/resolve halves.
``test_lookup_trace_count_stable_across_epochs`` has no counterpart: it
counts jit retraces, and the port runs eagerly, with no jit cache.

And two parity tests: the same closed-loop streams (with writes) through
the reference's ``PipelinedServer`` and the port's, every request equal
including ``epochs_served``; and the port's results byte-identical for
``io_workers`` 0, 1 and 4 with ``epoch_violations == 0``, which is what
scripts/check_io_determinism.py checks on the reference."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import _torch_serving as common  # noqa: E402
from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.lsm import N_LEVELS  # noqa: E402
from repro_torch.core.store import BourbonStore  # noqa: E402
from repro_torch.distributed import ShardedConfig, ShardedStore  # noqa: E402
from repro_torch.server import (BourbonServer, PipelineConfig,  # noqa: E402
                                PipelinedServer, ServerConfig,
                                ServerRequest)
from repro_torch.core.engine import EngineConfig  # noqa: E402
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


def _load(srv, keys, version=0, rid0=0, chunk=500):
    rid = rid0
    for off in range(0, keys.shape[0], chunk):
        ks = keys[off: off + chunk]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks, version)))
        rid += 1
        srv.run_until_drained()
    return rid


# --------------------------------------------------------------- correctness

def test_pipelined_matches_synchronous_server(tmp_path):
    """Same mixed workload through the synchronous tick loop and the
    pipelined one: identical answers, request by request."""
    keys = _keys(4000, seed=1)
    results = []
    for cls, cfg in ((BourbonServer, ServerConfig(max_batch_keys=256,
                                                  max_wait_ticks=0)),
                     (PipelinedServer, PipelineConfig(max_batch_keys=256,
                                                      max_wait_ticks=0,
                                                      max_inflight=4))):
        st = _sharded(tmp_path / cls.__name__, keys)
        srv = cls(st, cfg)
        rid = _load(srv, keys)
        got = []
        reqs = []
        for c in range(12):
            ks = np.concatenate([keys[c * 60: c * 60 + 50],
                                 keys[c * 60: c * 60 + 10] + 1])  # misses
            r = ServerRequest(rid, "get", ks)
            rid += 1
            assert srv.submit(r)
            reqs.append(r)
        srv.run_until_drained()
        for r in reqs:
            assert r.done
            got.append((r.found.copy(), r.result.copy()))
        results.append(got)
        st.close()
    for (f_sync, v_sync), (f_pipe, v_pipe) in zip(*results):
        np.testing.assert_array_equal(f_sync, f_pipe)
        np.testing.assert_array_equal(v_sync, v_pipe)


def test_pipelined_mixed_stream_matches_oracle(tmp_path):
    """Interleaved put/get/delete stream against a python-dict oracle:
    with writes acting as pipeline barriers, every GET must observe
    exactly the prefix of writes submitted before it."""
    keys = _keys(3000, seed=2)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(max_batch_keys=128,
                                             max_wait_ticks=0,
                                             max_inflight=4))
    rng = np.random.default_rng(3)
    oracle: dict[int, int] = {}
    rid = _load(srv, keys, version=0)
    oracle.update((int(k), 0) for k in keys)
    pending = []   # (request, expected {key: version|None})
    for step in range(30):
        op = rng.choice(["put", "get", "get", "delete"])
        ks = rng.choice(keys, 40, replace=False)
        if op == "put":
            ver = step % 251
            assert srv.submit(ServerRequest(rid, "put", ks,
                                            _values(ks, ver)))
            oracle.update((int(k), ver) for k in ks)
        elif op == "delete":
            assert srv.submit(ServerRequest(rid, "delete", ks))
            for k in ks:
                oracle[int(k)] = None
        else:
            r = ServerRequest(rid, "get", ks)
            assert srv.submit(r)
            pending.append((r, {int(k): oracle.get(int(k)) for k in ks}))
        rid += 1
        if step % 7 == 0:
            srv.tick()
    srv.run_until_drained()
    assert pending
    for r, expect in pending:
        assert r.done
        for i, k in enumerate(r.keys):
            want = expect[int(k)]
            if want is None:
                assert not r.found[i]
            else:
                assert r.found[i] and r.result[i, 1] == want
    assert srv.stats()["pipeline"]["epoch_violations"] == 0
    st.close()


# ------------------------------------------------------------ epoch pinning

def test_inflight_epoch_consistency_when_memtable_rolls(tmp_path):
    """Read batches in flight when a memtable-rolling write arrives must
    all have been answered under the single pre-roll epoch vector."""
    keys = _keys(6000, seed=4)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(max_batch_keys=128,
                                             max_wait_ticks=0,
                                             max_inflight=4,
                                             max_batches_per_tick=8))
    rid = _load(srv, keys)
    e_pre = st.shard_epochs()
    reads = []
    for c in range(3):                    # three separate 100-key batches
        r = ServerRequest(rid, "get", keys[c * 100: c * 100 + 100])
        rid += 1
        assert srv.submit(r)
        reads.append(r)
    # a write big enough to roll at least one shard's memtable, queued
    # BEHIND the reads in the same tick
    roll = keys[1000: 1000 + 2048]
    assert srv.submit(ServerRequest(rid, "put", roll, _values(roll, 5)))
    rid += 1
    srv.run_until_drained()
    e_post = st.shard_epochs()
    assert e_post != e_pre                # the write really rolled
    for r in reads:
        assert r.done and r.found.all()
        assert (r.result[:, 1] == 0).all()          # pre-put snapshot
        assert r.epochs_served == e_pre             # pinned, one vector
    s = srv.stats()["pipeline"]
    assert s["epoch_violations"] == 0
    assert s["write_barriers"] >= 1
    assert s["max_depth_seen"] >= 2       # batches really were in flight
    # a read AFTER the roll serves under the new epoch vector
    r = ServerRequest(rid, "get", roll[:64])
    assert srv.submit(r)
    srv.run_until_drained()
    assert r.found.all() and (r.result[:, 1] == 5).all()
    assert r.epochs_served == e_post
    st.close()


def test_write_barrier_get_after_put_never_sees_old_value(tmp_path):
    """Strict ordering through the pipeline: GET submitted after a PUT
    (same tick, pipeline already holding older reads) must see the new
    value; reads submitted before the PUT see the old snapshot."""
    keys = _keys(3000, seed=5)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(max_batch_keys=128,
                                             max_wait_ticks=0,
                                             max_inflight=4,
                                             max_batches_per_tick=8))
    rid = _load(srv, keys)
    hot = keys[:64]
    pre = ServerRequest(rid, "get", hot)
    rid += 1
    assert srv.submit(pre)
    assert srv.submit(ServerRequest(rid, "put", hot, _values(hot, 7)))
    rid += 1
    post = ServerRequest(rid, "get", hot)
    rid += 1
    assert srv.submit(post)
    srv.run_until_drained()
    assert pre.done and pre.found.all() and (pre.result[:, 1] == 0).all()
    assert post.done and post.found.all() and (post.result[:, 1] == 7).all()
    # delete ordering too: GET after DELETE must miss
    assert srv.submit(ServerRequest(rid, "delete", hot[:8]))
    rid += 1
    post_del = ServerRequest(rid, "get", hot[:8])
    rid += 1
    assert srv.submit(post_del)
    srv.run_until_drained()
    assert post_del.done and not post_del.found.any()
    assert srv.stats()["pipeline"]["epoch_violations"] == 0
    st.close()


# ------------------------------------------------------------- backpressure

def test_backpressure_with_max_inflight_outstanding(tmp_path):
    keys = _keys(3000, seed=6)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(
        max_batch_keys=64, max_wait_ticks=0, max_inflight=2,
        max_batches_per_tick=8, queue_capacity=4, cache_slots=0))
    rid = _load(srv, keys)
    # 4 fill the queue, the rest bounce
    reqs, rejected = [], 0
    for c in range(8):
        r = ServerRequest(rid, "get", keys[c * 64: c * 64 + 64])
        rid += 1
        if srv.submit(r):
            reqs.append(r)
        else:
            rejected += 1
    assert len(reqs) == 4 and rejected == 4
    srv.tick()
    s = srv.stats()["pipeline"]
    # the pipeline admitted only up to its depth limit even though the
    # queue held more and max_batches_per_tick allowed more
    assert s["max_depth_seen"] == 2
    assert s["dispatched"] >= 2
    assert len(srv.queue) > 0             # backpressure held work back
    srv.run_until_drained()
    for r in reqs:
        assert r.done and r.found.all()
    assert srv.stats()["pipeline"]["max_depth_seen"] <= 2
    assert srv.queue.rejected == 4
    st.close()


# -------------------------------------------------------------- maintenance

def test_maintenance_runs_only_in_bubbles(tmp_path):
    """Coordinator rounds happen at drain points (bubbles), not on every
    tick — and deferred GC still converges during idle draining."""
    keys = _keys(3000, seed=7)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(max_batch_keys=512,
                                             max_wait_ticks=0,
                                             bubble_every_ticks=8))
    assert all(sh.maintenance_deferred for sh in st.shards)
    rid = 0
    for rnd in range(4):
        rid = _load(srv, keys, version=rnd, rid0=rid)
    for _ in range(400):                  # idle ticks: drain deferred GC
        srv.tick()
    s = srv.stats()
    assert s["store"]["auto_gc"]["segments_removed"] > 0
    p = s["pipeline"]
    assert p["bubbles"] == s["coordinator"]["ticks"]
    assert p["bubbles"] < s["ticks"]      # strictly fewer rounds than ticks
    assert s["max_maintenance_tick_us"] <= srv.coordinator.budget_us + 1e-9
    st.close()


def test_sustained_reads_force_drain_keeps_maintenance_alive(tmp_path):
    """Under a read stream that never drains naturally, the forced-drain
    guard still creates bubbles so maintenance cannot starve forever."""
    keys = _keys(2000, seed=8)
    st = _sharded(tmp_path, keys)
    srv = PipelinedServer(st, PipelineConfig(
        max_batch_keys=64, max_wait_ticks=0, max_inflight=4,
        max_batches_per_tick=1, queue_capacity=256, cache_slots=0,
        force_drain_ticks=16, bubble_every_ticks=4))
    rid = _load(srv, keys)
    rng = np.random.default_rng(9)
    b0 = srv.stats()["pipeline"]["bubbles"]
    for i in range(120):                  # open-loop: queue never empties
        for _ in range(3):
            srv.submit(ServerRequest(rid, "get",
                                     rng.choice(keys, 64, replace=False)))
            rid += 1
        srv.tick()
    p = srv.stats()["pipeline"]
    assert p["forced_drains"] > 0
    assert p["bubbles"] > b0
    srv.run_until_drained()
    st.close()


# ------------------------------------------------------- engine satellites

def test_counter_materialization_is_lazy():
    """The CBA counter vectors stay device-side until first touched."""
    cfg = StoreConfig(mode="wisckey",
                      lsm=LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                                    l1_cap_records=1 << 13), device="cpu")
    st = BourbonStore(cfg)
    keys = _keys(2000, seed=11)
    st.put_batch(keys)
    st.flush_all()
    state = st.engine.build_state(st.tree, st.level_models)
    res = st.engine.lookup(state, keys[:64], "baseline",
                           l0_live=len(st.tree.levels[0]))
    assert res._pos_np is None and res._neg_np is None   # not yet pulled
    pos = res.pos_counts                  # first touch materializes
    assert res._pos_np is not None
    assert len(pos) == N_LEVELS
    assert all(isinstance(p, np.ndarray) for p in pos)
    assert sum(int(p.sum()) for p in pos) == 64          # all hits counted
    assert res.found.all()


def test_store_dispatch_resolve_roundtrip_and_double_resolve(tmp_path):
    """BourbonStore's split halves compose to exactly get_batch, pending
    handles are single-shot, and two dispatches may be in flight."""
    cfg = _store_cfg()
    st = BourbonStore.open(str(tmp_path / "db"), cfg)
    keys = _keys(3000, seed=12)
    st.put_batch(keys, _values(keys, 0))
    st.flush_all()
    pb1 = st.dispatch_get(keys[:100])
    pb2 = st.dispatch_get(keys[100:200])       # two in flight at once
    f1, v1 = st.resolve_get(pb1)
    f2, v2 = st.resolve_get(pb2)
    assert f1.all() and f2.all()
    fs, vs = st.get_batch(keys[:100])
    np.testing.assert_array_equal(f1, fs)
    np.testing.assert_array_equal(v1, vs)
    with pytest.raises(RuntimeError, match="resolved"):
        st.resolve_get(pb1)
    st.close()


def test_sharded_dispatch_pins_epoch_vector(tmp_path):
    keys = _keys(3000, seed=13)
    st = _sharded(tmp_path, keys)
    st.put_batch(keys, _values(keys, 0))
    st.flush_all()
    e0 = st.shard_epochs()
    pb = st.dispatch_get(keys[:128], with_values=True)
    assert pb.epochs == e0
    # a write that rolls the memtable moves the live epochs, but the
    # dispatched batch still resolves under its pinned snapshot
    roll = keys[200: 200 + 2048]
    st.put_batch(roll, _values(roll, 1))
    assert st.shard_epochs() != e0
    f, v = st.resolve_get(pb)
    assert f.all() and (v[:, 1] == 0).all()
    assert pb.epochs == e0
    with pytest.raises(RuntimeError, match="resolved"):
        st.resolve_get(pb)
    st.close()


# ------------------------------------------------------- parity with repro

def _mixed_streams(keys, seed):
    """bench_serve's read streams (32 clients, 4 rounds, 32 keys a
    request), with a PUT every 5th request of some clients and a DELETE
    in others: the write barriers run between in-flight reads."""
    streams = common._request_streams(keys, seed=seed, clients=32,
                                      rounds=4, keys_per_req=32)
    rng = np.random.default_rng(seed + 1)
    for c in range(0, 32, 4):
        ks = rng.choice(keys, 24, replace=False)
        streams[c].insert(2, ("put", ks, common.values_of(ks, 3 + c)))
        streams[c + 2].insert(3, ("delete", ks[:6], None))
    return streams


def _serve_pipelined(pkg, root, keys, streams, io_workers):
    M = common.PKGS[pkg]
    S = M["server"]
    st = common.open_sharded(pkg, root, keys, n_shards=4, fetch_values=True)
    srv = S.PipelinedServer(st, S.PipelineConfig(
        max_batch_keys=1024, max_wait_ticks=0, queue_capacity=128,
        max_batches_per_tick=8, max_inflight=8, carry=1,
        io_workers=io_workers,
        coordinator=S.CoordinatorConfig(budget_us_per_tick=2048.0)))
    try:
        common.load_through(srv, S, keys)
        reqs = common.closed_loop(srv, S, streams)
    finally:
        srv.shutdown()
    out = ([common.request_record(r) + (r.epochs_served,) for r in reqs],
           common.stats_less_wall_time(srv.stats()))
    st.close()
    return out


def test_pipelined_server_matches_reference(tmp_path):
    keys = common.keys_of(4000, seed=50)
    streams = _mixed_streams(keys, 51)
    sync_file_ids()
    ref = _serve_pipelined("repro", tmp_path / "r", keys, streams, 0)
    port = _serve_pipelined("repro_torch", tmp_path / "p", keys, streams, 0)
    assert len(port[0]) == len(ref[0]) == 32 * 4 + 16
    for a, b in zip(ref[0], port[0]):
        assert a == b, a[:2]
    assert port[1] == ref[1]
    p = port[1]["pipeline"]
    assert p["epoch_violations"] == 0 and p["max_depth_seen"] > 1
    assert p["write_barriers"] > 0


def test_results_identical_across_io_workers(tmp_path):
    keys = common.keys_of(4000, seed=52)
    streams = _mixed_streams(keys, 53)
    runs = {}
    for w in (0, 1, 4):
        sync_file_ids()
        runs[w] = _serve_pipelined("repro_torch", tmp_path / f"w{w}", keys,
                                   streams, w)
    for w in (1, 4):
        assert runs[w][0] == runs[0][0], w
        s = runs[w][1]
        assert s["pipeline"]["epoch_violations"] == 0
        assert s["io"]["workers"] == w and s["io"]["submitted"] > 0
        assert s["store"]["n_gets"] == runs[0][1]["store"]["n_gets"]
    assert runs[0][1]["pipeline"]["epoch_violations"] == 0
