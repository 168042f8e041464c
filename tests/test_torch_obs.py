"""The port's observability plane (``repro_torch.obs``) and its wiring
into the port's stores and servers, on the CPU (``device="cpu"``).

Port cases of the 22 tests of tests/test_obs.py, with the same names and
bodies: registry and label semantics, restart detection, delta counters
and histograms, collector replacement, the JSON and Prometheus exporters,
the stage tracer's sampling, the null tracer, the bounded event log, and
the store cases (the probe split adds no blocking device-to-host copy,
the split by mode, counters across memtable rolls and reopen, the
sharded store's labels and fleet aggregate, the servers' snapshots and
the cache reconciliation).

And one parity test: the same puts, learns and GETs through the
reference's ``BourbonStore`` and ``ShardedStore`` with ``attach_obs`` and
through the port's; the two snapshots are equal on every counter, gauge
and histogram count, and their Prometheus texts line for line, leaving
out only the wall-clock metrics named in
``_torch_serving.TIMING_METRICS``."""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import _torch_serving as common  # noqa: E402
from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, LookupResult  # noqa: E402
from repro_torch.core.lsm import N_LEVELS  # noqa: E402
from repro_torch.core.store import BourbonStore  # noqa: E402
from repro_torch.distributed import ShardedConfig, ShardedStore  # noqa: E402
from repro_torch.obs import (EventLog, MetricsRegistry, NULL_TRACER,  # noqa: E402
                             Obs, ObsConfig, READ_STAGES, StageTracer,
                             parse_prometheus, publish_stats, to_json,
                             to_prometheus)
from repro_torch.server import (PipelineConfig, PipelinedServer,  # noqa: E402
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


def _values(keys, version=0):
    v = np.zeros((keys.shape[0], VALUE_SIZE), np.uint8)
    v[:, 0] = (keys % 251).astype(np.uint8)
    v[:, 1] = version % 251
    return v


def _fill(store, keys, chunk=1 << 11):
    for off in range(0, keys.shape[0], chunk):
        store.put_batch(keys[off: off + chunk])
    store.flush_all()


def _sample(snap, name, **labels):
    for s in snap[name]["samples"]:
        if dict(s["labels"]) == labels:
            return s["value"]
    raise KeyError((name, labels))


# ------------------------------------------------------------------ registry

def test_registry_instruments_and_label_identity():
    reg = MetricsRegistry()
    c = reg.counter("reqs_total", shard="0")
    c.inc()
    c.inc(4)
    # same (name, labels) -> same instrument regardless of kwarg order
    assert reg.counter("reqs_total", shard="0") is c
    assert reg.counter("reqs_total", shard="1") is not c
    g = reg.gauge("depth", shard="0", level="2")
    g.set(7)
    assert reg.gauge("level", **{"level": "2", "shard": "0"}) is not g
    h = reg.histogram("lat_us")
    for x in (0.5, 3.0, 3.0, 1e9):
        h.observe(x)
    assert h.count == 4 and h.max == 1e9 and h.mean == pytest.approx(
        (0.5 + 3.0 + 3.0 + 1e9) / 4)
    assert h.buckets[-1] == 1          # 1e9 us lands in the overflow bucket
    snap = reg.snapshot()
    assert _sample(snap, "reqs_total", shard="0") == 5.0
    assert _sample(snap, "depth", shard="0", level="2") == 7.0
    # kind mismatch on an existing family is an error, not a silent alias
    with pytest.raises(ValueError):
        reg.gauge("reqs_total", shard="0")


def test_counter_observe_total_restart_detection():
    reg = MetricsRegistry()
    c = reg.counter("gets_total")
    c.observe_total(10)
    c.observe_total(25)
    assert c.value == 25
    # a lower total = the source restarted (reopen): its new cumulative
    # count is fresh progress, and the registry counter stays monotonic
    c.observe_total(4)
    assert c.value == 29
    c.observe_total(6)
    assert c.value == 31


def test_delta_counter_rates_and_restart_detection():
    """``MetricsRegistry.delta``: counters report cur-prev per window,
    with the same restart rule as ``observe_total`` — a current value
    below the previous one means the source restarted, so the whole
    current value is the window's progress."""
    reg = MetricsRegistry()
    c = reg.counter("server_gets_total", shard="0")
    g = reg.gauge("server_queued")
    c.inc(10)
    g.set(7)
    prev = reg.snapshot()
    c.inc(5)
    g.set(3)
    d = reg.delta(prev)
    assert _sample(d, "server_gets_total", shard="0") == 5
    assert _sample(d, "server_queued") == 3          # gauges: current
    # restart: simulate by replacing the counter's cumulative value
    prev2 = reg.snapshot()
    c.value = 2.0                                    # restarted source
    d2 = reg.delta(prev2)
    assert _sample(d2, "server_gets_total", shard="0") == 2
    # a sample new in cur counts from zero; prev-only samples are omitted
    reg.counter("server_puts_total").inc(4)
    d3 = reg.delta(prev2)
    assert _sample(d3, "server_puts_total") == 4
    assert all(n in reg.snapshot() for n in d3)


def test_delta_histogram_bucket_deltas_and_restart():
    reg = MetricsRegistry()
    h = reg.histogram("server_stage_us", stage="dispatch")
    h.observe(3.0)
    h.observe(100.0)
    prev = reg.snapshot()
    h.observe(100.0)
    d = reg.delta(prev)
    v = _sample(d, "server_stage_us", stage="dispatch")
    assert v["count"] == 1 and v["sum"] == 100.0
    assert sum(v["buckets"]) == 1                    # one new observation
    assert v["max"] == 100.0                         # current max, not rate
    assert "exemplars" not in v                      # not a rate: dropped
    # histogram restart rule keys on count going backwards
    h2 = reg.histogram("server_stage_us", stage="dispatch")
    assert h2 is h
    prev2 = reg.snapshot()
    h.count = 1
    h.sum = 50.0
    h.buckets = [0] * len(h.buckets)
    h.buckets[0] = 1
    d2 = reg.delta(prev2)
    v2 = _sample(d2, "server_stage_us", stage="dispatch")
    assert v2["count"] == 1 and v2["sum"] == 50.0    # whole cur is fresh


def test_collector_keyed_replacement():
    reg = MetricsRegistry()
    reg.register_collector("src", lambda r: r.counter("a").observe_total(5))
    reg.snapshot()
    # same key replaces: the stale collector must not double-report
    reg.register_collector("src", lambda r: r.counter("a").observe_total(2))
    snap = reg.snapshot()
    assert _sample(snap, "a") == 7.0   # 5, then restart-to-2
    reg.unregister_collector("src")
    assert _sample(reg.snapshot(), "a") == 7.0


# ----------------------------------------------------------------- exporters

def _demo_registry():
    reg = MetricsRegistry()
    reg.counter("ops_total", shard="0").inc(3)
    reg.counter("ops_total", shard="1").inc(5)
    reg.gauge("depth").set(2.5)
    h = reg.histogram("stage_us", stage='tricky"name\\')
    h.observe(3.0)
    h.observe(900.0)
    publish_stats(reg, "layer", {
        "num": 7, "flag": True, "skipme": "a string", "none": None,
        "sub": {"x": 1.5}, "by_level": {0: 10, 2: 30},
        "per_shard_us": [1.0, 2.0],
    })
    return reg


def test_json_snapshot_round_trips_exactly():
    snap = _demo_registry().snapshot()
    assert json.loads(to_json(snap)) == snap


def test_publish_stats_flatten_semantics():
    snap = _demo_registry().snapshot()
    assert _sample(snap, "layer_num") == 7.0
    assert _sample(snap, "layer_flag") == 1.0
    assert _sample(snap, "layer_sub_x") == 1.5
    assert _sample(snap, "layer_by_level", key="2") == 30.0
    assert _sample(snap, "layer_per_shard_us", index="1") == 2.0
    assert "layer_skipme" not in snap and "layer_none" not in snap


def test_prometheus_export_parses_back():
    reg = _demo_registry()
    snap = reg.snapshot()
    back = parse_prometheus(to_prometheus(snap))
    assert back[("ops_total", (("shard", "0"),))] == 3.0
    assert back[("ops_total", (("shard", "1"),))] == 5.0
    assert back[("depth", ())] == 2.5
    assert back[("layer_by_level", (("key", "2"),))] == 30.0
    # histogram expansion: escaped label value, cumulative buckets, sum
    lbl = (("stage", 'tricky"name\\'),)
    assert back[("stage_us_count", lbl)] == 2.0
    assert back[("stage_us_sum", lbl)] == 903.0
    assert back[("stage_us_max", lbl)] == 900.0
    inf_key = ("stage_us_bucket", (("le", "+Inf"),) + lbl)
    inf_key = ("stage_us_bucket", tuple(sorted((("le", "+Inf"),) + lbl)))
    assert back[inf_key] == 2.0


# -------------------------------------------------------------------- tracer

def test_tracer_sampling_and_timeline():
    reg = MetricsRegistry()
    tr = StageTracer(reg, sample_every=2, timeline_ticks=4)
    h = tr.stage("work")
    assert tr.stage("work") is h        # pre-bound: get-or-create
    for i in range(6):
        tick = tr.begin_tick()
        t0 = h.begin()
        if i % 2 == 0:
            assert t0 > 0.0             # armed tick
        else:
            assert t0 == 0.0            # unsampled: end() must no-op
        h.end(t0)
        tr.end_tick(tick)
    assert tr.ticks_seen == 6 and tr.sampled_ticks == 3
    assert h.count == 3
    tl = tr.timeline()
    assert len(tl) == 3 and all("work" in row for row in tl)
    assert [row["tick"] for row in tl] == [0, 2, 4]
    assert h.hist.count == 3            # histogram fed only when sampled


def test_null_tracer_is_inert():
    h = NULL_TRACER.stage("anything")
    t = NULL_TRACER.begin_tick()
    assert h.begin() == 0.0
    h.end(0.0)
    NULL_TRACER.end_tick(t)
    assert NULL_TRACER.timeline() == []


def test_event_log_bounded():
    ev = EventLog(cap=3)
    for i in range(5):
        ev.log("learn", level=i)
    assert ev.total == 5 and len(ev) == 3
    assert [e["level"] for e in ev.tail()] == [2, 3, 4]
    assert ev.tail(1)[0]["kind"] == "learn"


# ----------------------------------------------------- store instrumentation

def test_store_snapshot_covers_stats_and_events():
    st = BourbonStore(_store_cfg())
    obs = Obs(ObsConfig(sample_every=1))
    st.attach_obs(obs, labels={"shard": "0"})
    keys = _keys(6000, seed=3)
    _fill(st, keys)
    st.learn_all()
    f, _ = st.get_batch(keys[:256])
    assert f.all()
    snap = obs.snapshot()
    s = st.stats()
    lb = {"shard": "0"}
    assert _sample(snap, "store_gets_total", **lb) == s["n_gets"]
    assert _sample(snap, "store_puts_total", **lb) == s["n_puts"]
    assert _sample(snap, "store_n_records", **lb) == s["n_records"]
    assert _sample(snap, "store_files_learned_total",
                   **lb) == s["files_learned"]
    # per-level gauges agree with the tree
    for li, tables in enumerate(st.tree.levels):
        assert _sample(snap, "store_level_files", level=str(li),
                       **lb) == len(tables)
    # the maintenance event log saw the learning decisions (with their
    # CBA cost estimates attached)
    kinds = {e["kind"] for e in obs.events.tail()}
    assert "learn" in kinds
    assert all("cost_us" in e for e in obs.events.tail()
               if e["kind"] == "learn")


def test_probe_split_no_extra_blocking_transfers():
    """Satellite: per-level model/baseline probe counts must ride the
    lazy-materialization pattern — obs-on adds ZERO host syncs per batch
    (one device add only), and the accumulator syncs once per snapshot."""
    keys = _keys(6000, seed=4)

    def run(with_obs):
        st = BourbonStore(_store_cfg())
        obs = Obs() if with_obs else None
        if with_obs:
            st.attach_obs(obs)
        _fill(st, keys)
        st.learn_all()
        base = LookupResult.n_materializations
        for off in range(0, 2048, 256):
            f, _ = st.get_batch(keys[off: off + 256])
            assert f.all()
        return st, obs, LookupResult.n_materializations - base

    st_off, _, mat_off = run(False)
    st_on, obs, mat_on = run(True)
    # identical number of result materializations: the probe split never
    # forces an extra device->host sync on the read path
    assert mat_on == mat_off
    assert st_on.engine.probe_acc_materializations == 0
    snap = obs.snapshot()                  # first (and only) sync happens here
    assert st_on.engine.probe_acc_materializations == 1
    mp = sum(_sample(snap, "engine_probes_total", level=str(li), path="model")
             for li in range(N_LEVELS))
    bp = sum(_sample(snap, "engine_probes_total", level=str(li),
                     path="baseline") for li in range(N_LEVELS))
    assert mp == st_on.lookups_model_path
    assert bp == st_on.lookups_baseline_path
    assert mp + bp > 0


def test_probe_split_paths_by_mode():
    """wisckey mode attributes every probe to the baseline path; a fully
    learned bourbon store attributes every probe to the model path."""
    keys = _keys(6000, seed=5)
    for mode, want_path in (("wisckey", "baseline"), ("bourbon", "model")):
        st = BourbonStore(_store_cfg(mode=mode))
        obs = Obs()
        st.attach_obs(obs)
        _fill(st, keys)
        if mode == "bourbon":
            st.learn_all()
        st.get_batch(keys[:512])
        snap = obs.snapshot()
        other = "model" if want_path == "baseline" else "baseline"
        want = sum(_sample(snap, "engine_probes_total", level=str(li),
                           path=want_path) for li in range(N_LEVELS))
        got_other = sum(_sample(snap, "engine_probes_total", level=str(li),
                                path=other) for li in range(N_LEVELS))
        assert want > 0 and got_other == 0, mode


# ----------------------------------------------- counters across epoch events

def test_counters_monotonic_across_roll_and_compaction():
    st = BourbonStore(_store_cfg())
    obs = Obs()
    st.attach_obs(obs)
    keys = _keys(8000, seed=6)
    prev = {}
    for off in range(0, keys.shape[0], 1 << 10):   # many memtable rolls
        st.put_batch(keys[off: off + (1 << 10)])
        st.get_batch(keys[max(0, off - 256): max(256, off)])
        snap = obs.snapshot()
        for name in ("store_gets_total", "store_puts_total",
                     "store_files_learned_total"):
            cur = _sample(snap, name)
            assert cur >= prev.get(name, 0.0), name
            prev[name] = cur
    assert prev["store_puts_total"] == keys.shape[0]


def test_counters_survive_store_reopen(tmp_path):
    keys = _keys(4000, seed=7)
    obs = Obs()
    st = BourbonStore.open(tmp_path / "db", _store_cfg())
    st.attach_obs(obs)
    _fill(st, keys)
    st.get_batch(keys[:512])
    x = _sample(obs.snapshot(), "store_gets_total")
    assert x == 512
    st.close()
    # reopen: the new instance counts n_gets from zero, and its collector
    # REPLACES the old one (same key) — totals keep accumulating
    st = BourbonStore.open(tmp_path / "db", _store_cfg())
    st.attach_obs(obs)
    st.get_batch(keys[:256])
    snap = obs.snapshot()
    assert _sample(snap, "store_gets_total") == 512 + 256
    # records gauge reflects the recovered store, not a stale double
    assert _sample(snap, "store_n_records") == st.stats()["n_records"]
    st.close()


# ------------------------------------------------------------- sharded store

def test_sharded_stats_per_shard_breakdown(tmp_path):
    keys = _keys(8000, seed=8)
    st = _sharded(tmp_path, keys, n_shards=2)
    _fill(st, keys, chunk=1 << 10)
    st.get_batch(keys[:256])
    s = st.stats()
    ps = s["per_shard"]
    assert sorted(ps) == ["shard-0", "shard-1"]
    for field in ("n_records", "n_files", "files_learned", "gc_us",
                  "checkpoint_us", "vlog_disk_bytes",
                  "manifest_checkpoints"):
        assert sum(p[field] for p in ps.values()) == s[
            {"checkpoint_us": "checkpoint_us"}.get(field, field)], field
    assert sum(p["auto_gc"]["runs"] for p in ps.values()) == \
        s["auto_gc"]["runs"]
    # both shards actually hold data (the split is by quantile)
    assert all(p["n_records"] > 0 for p in ps.values())
    assert all(p["epoch"] >= 1 for p in ps.values())
    st.close()


def test_sharded_attach_obs_labels_and_fleet_aggregate(tmp_path):
    keys = _keys(6000, seed=9)
    st = _sharded(tmp_path, keys, n_shards=2)
    obs = Obs()
    st.attach_obs(obs)
    _fill(st, keys, chunk=1 << 10)
    st.get_batch(keys[:128])
    snap = obs.snapshot()
    shards = {dict(s["labels"])["shard"]
              for s in snap["store_n_records"]["samples"]}
    assert shards == {"0", "1"}
    agg = st.stats()
    assert _sample(snap, "fleet_n_records") == agg["n_records"]
    assert _sample(snap, "fleet_gets_total") == agg["n_gets"]
    per = sum(_sample(snap, "store_n_records", shard=s) for s in ("0", "1"))
    assert per == agg["n_records"]
    st.detach_obs()
    assert st.shards[0].engine.record_probe_split is False
    st.close()


# ------------------------------------------------------------------- servers

def _serve_reads(srv, keys, rounds=6, per_req=32, rid0=10_000):
    rng = np.random.default_rng(11)
    rid = rid0
    reqs = []
    for _ in range(rounds):
        for _ in range(8):
            r = ServerRequest(rid, "get", rng.choice(keys, per_req))
            assert srv.submit(r)
            reqs.append(r)
            rid += 1
        srv.tick()
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return reqs


def test_pipelined_server_snapshot_completeness(tmp_path):
    """Acceptance: one snapshot carries every layered stats() metric with
    per-level and per-shard labels, all read-path stages have sampled
    observations, and both exporters round-trip it."""
    keys = _keys(6000, seed=10)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True)
    srv = PipelinedServer(st, PipelineConfig(
        max_wait_ticks=0, obs=ObsConfig(sample_every=1)))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks)))
        rid += 1
        srv.run_until_drained()
    _serve_reads(srv, keys)
    snap = srv.obs.snapshot()
    s = srv.stats()
    # every stage observed
    stages = {dict(x["labels"])["stage"]: x["value"]["count"]
              for x in snap["server_stage_us"]["samples"]}
    assert all(stages.get(name, 0) > 0 for name in READ_STAGES), stages
    # server layer
    assert _sample(snap, "server_completed_total") == s["completed"]
    assert _sample(snap, "server_submitted_total") == s["submitted"]
    assert _sample(snap, "server_batches_total") == s["batches"]
    assert _sample(snap, "server_queued") == s["queued"]
    # pipeline layer
    for k in ("dispatched", "retired", "write_barriers", "bubbles",
              "epoch_violations", "max_depth_seen"):
        assert _sample(snap, f"server_pipeline_{k}") == s["pipeline"][k], k
    # cache layer
    assert _sample(snap, "cache_hits_total") == s["cache"]["hits"]
    assert _sample(snap, "server_cache_hit_rate") == s["cache"]["hit_rate"]
    # coordinator layer (per-shard lists become index= labels)
    assert _sample(snap, "server_coordinator_runs") == \
        s["coordinator"]["runs"]
    assert "server_coordinator_per_shard_us" in snap
    # store/fleet layer with shard labels
    assert _sample(snap, "fleet_n_records") == s["store"]["n_records"]
    assert {dict(x["labels"])["shard"]
            for x in snap["store_gets_total"]["samples"]} == {"0", "1"}
    # per-level labels
    assert {dict(x["labels"])["level"]
            for x in snap["store_level_files"]["samples"]} \
        >= {str(i) for i in range(N_LEVELS)}
    # exporters round-trip the whole thing
    assert json.loads(to_json(snap)) == snap
    back = parse_prometheus(to_prometheus(snap))
    assert back[("server_completed_total", ())] == s["completed"]
    assert back[("fleet_n_records", ())] == s["store"]["n_records"]
    st.close()


def test_cache_counters_reconcile_with_served_totals(tmp_path):
    keys = _keys(4000, seed=12)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True)
    srv = PipelinedServer(st, PipelineConfig(
        max_wait_ticks=0, obs=ObsConfig(sample_every=1)))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks)))
        rid += 1
        srv.run_until_drained()
    hot = keys[:64]
    for _ in range(4):                     # repeated hot reads: cache hits
        _serve_reads(srv, hot, rounds=2, per_req=16, rid0=rid)
        rid += 1000
    snap = srv.obs.snapshot()
    s = srv.stats()
    assert s["served_from_cache"] > 0
    # the server's served-from-cache total IS the cache's hit counter —
    # both through stats() and through the registry
    assert s["served_from_cache"] == s["cache"]["hits"]
    assert _sample(snap, "cache_hits_total") == s["cache"]["hits"]
    assert _sample(snap, "server_served_from_cache_total") == \
        s["served_from_cache"]
    # every key either came from the cache or probed the store
    assert _sample(snap, "server_served_from_cache_total") + \
        _sample(snap, "server_store_probe_keys_total") == \
        s["served_from_cache"] + s["store_probe_keys"]
    # write invalidations show up and reconcile too
    ks = hot[:32]
    assert srv.submit(ServerRequest(rid, "put", ks, _values(ks, 1)))
    srv.run_until_drained()
    snap2 = srv.obs.snapshot()
    assert _sample(snap2, "cache_inval_write_total") == \
        srv.cache.stats()["inval_write"]
    st.close()


def test_obs_disabled_server_serves_and_is_uninstrumented(tmp_path):
    keys = _keys(3000, seed=13)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True)
    # attach-then-disable: constructing the obs-off server must detach
    # the previous plane (clean obs-off bench arm)
    st.attach_obs(Obs())
    srv = PipelinedServer(st, PipelineConfig(
        max_wait_ticks=0, obs=ObsConfig(enabled=False)))
    assert srv.obs is None
    assert st.shards[0].engine.record_probe_split is False
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks)))
        rid += 1
        srv.run_until_drained()
    reqs = _serve_reads(srv, keys, rounds=3)
    assert all(r.found.all() for r in reqs)
    st.close()


def test_sync_server_snapshot_has_stages(tmp_path):
    keys = _keys(3000, seed=14)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True)
    from repro_torch.server import BourbonServer
    srv = BourbonServer(st, ServerConfig(
        max_wait_ticks=0, obs=ObsConfig(sample_every=1)))
    rid = 0
    for off in range(0, keys.shape[0], 500):
        ks = keys[off: off + 500]
        assert srv.submit(ServerRequest(rid, "put", ks, _values(ks)))
        rid += 1
        srv.run_until_drained()
    _serve_reads(srv, keys, rounds=3)
    snap = srv.obs.snapshot()
    stages = {dict(x["labels"])["stage"]: x["value"]["count"]
              for x in snap["server_stage_us"]["samples"]}
    assert all(stages.get(name, 0) > 0 for name in READ_STAGES), stages
    tl = srv.obs.timeline()
    assert tl and all("tick" in row for row in tl)
    st.close()


# ------------------------------------------------------- parity with repro

def _drive_observed(pkg, root, keys):
    """Puts, learns, GETs, overwrites and deletes through one in-memory
    and one durable store and a 2-shard sharded store of ``pkg``, all
    attached to one obs plane; returns its snapshot and Prometheus text."""
    M = common.PKGS[pkg]
    obs = M["obs"].Obs(M["obs"].ObsConfig(sample_every=1))
    single = M["core"].BourbonStore(common.store_cfg(
        pkg, granularity="file", policy="offline", mode="bourbon"))
    durable = M["core"].BourbonStore.open(
        str(root / "durable"), common.store_cfg(pkg, wal_group_commit=True))
    single.attach_obs(obs, labels={"store": "single"})
    durable.attach_obs(obs, labels={"store": "durable"})
    fleet = common.open_sharded(pkg, root / "fleet", keys)
    fleet.attach_obs(obs)
    rng = np.random.default_rng(31)
    probes = np.concatenate([rng.choice(keys, 700), keys[:300] + 1])
    for st in (single, durable, fleet):
        for off in range(0, keys.shape[0], 1 << 10):
            ks = keys[off: off + (1 << 10)]
            st.put_batch(ks, common.values_of(ks))
        if st is durable:
            st.wal_sync()
        st.flush_all()
        st.learn_all()
        st.get_batch(probes)
        st.put_batch(keys[:256], common.values_of(keys[:256], 1))
        st.delete_batch(keys[256:384])
        st.get_batch(probes[:512])
    snap = obs.snapshot()
    text = obs.to_prometheus()
    durable.close()
    fleet.close()
    return snap, text


def test_obs_snapshot_matches_reference(tmp_path):
    keys = common.keys_of(4000, seed=30)
    sync_file_ids()
    ref_snap, ref_text = _drive_observed("repro", tmp_path / "r", keys)
    snap, text = _drive_observed("repro_torch", tmp_path / "p", keys)
    common.assert_snapshots_equal(ref_snap, snap)
    assert common.prometheus_without_timing(text) == \
        common.prometheus_without_timing(ref_text)
    # the comparison covers every layer: the stores under both labels,
    # the per-shard stores, the fleet, the engine split and the WAL
    for name, labels in (("store_gets_total", {"store": "single"}),
                         ("store_gets_total", {"store": "durable"}),
                         ("store_n_records", {"shard": "1"}),
                         ("fleet_gets_total", {}),
                         ("store_wal_appends_total", {"store": "durable"})):
        assert common.sample(snap, name, **labels) > 0, (name, labels)
    assert sum(common.sample(snap, "engine_probes_total", level=str(li),
                             path="model", store="single")
               for li in range(N_LEVELS)) > 0
