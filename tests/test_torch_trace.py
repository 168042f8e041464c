"""The port's causal tracer (``repro_torch.obs.trace``) on the CPU.

Port cases of the 13 tests of tests/test_trace.py, with the same names and
bodies: admission sampling, the unsampled and null tracers, batch fan-in
links and queue-wait credit, the critical path and its exemplars, the
trace description, the cross-thread handoff under out-of-order I/O-pool
completion, the group-commit WAL fan-in, maintenance event stamps, the
Perfetto export, and the traced, threaded pipelined server end to end.
(One change: the cross-thread case spaces its forced completion order by
20 ms instead of 1 ms, so that a loaded host cannot reorder it.)

And one parity test: the same request stream through the reference's
traced ``PipelinedServer`` and the port's, whose span graphs must have the
same structure — span names, parents, links and arguments per trace — and
the same constants (``SPAN_NAMES``, ``CRITICAL_STAGES``, ``READ_STAGES``).
Timestamps and thread tracks are not compared."""

import json
import os
import sys
import threading
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402

import _torch_serving as common  # noqa: E402
from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.distributed import ShardedConfig, ShardedStore  # noqa: E402
from repro_torch.io import IOPool, wait_all  # noqa: E402
from repro_torch.obs import (CRITICAL_STAGES, CausalTracer,  # noqa: E402
                             MetricsRegistry, NULL_CTRACE, Obs, ObsConfig,
                             SPAN_NAMES)
from repro_torch.server import (PipelineConfig, PipelinedServer,  # noqa: E402
                                ServerRequest)
from repro_torch.storage.wal import GroupCommitWAL  # noqa: E402
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


def _sample(snap, name, **labels):
    for s in snap[name]["samples"]:
        if dict(s["labels"]) == labels:
            return s["value"]
    raise KeyError((name, labels))


def _req(ctx):
    """join_batch only reads ``.trace`` off a request."""
    return SimpleNamespace(trace=ctx)


# ------------------------------------------------------------------ sampling

def test_admission_sampling_rate():
    ct = CausalTracer(MetricsRegistry(), sample_every=4)
    admits = [ct.admit(tick=i) for i in range(16)]
    traced = [i for i, c in enumerate(admits) if c is not None]
    assert traced == [0, 4, 8, 12]       # first admission always traced
    assert ct.traced_requests == 4
    tids = {admits[i].tid for i in traced}
    assert len(tids) == 4
    # each traced request opened its root + queue_wait spans
    names = [s.name for s in ct.spans()]
    assert names.count("request") == 4 and names.count("queue_wait") == 4


def test_unsampled_request_is_one_identity_test_everywhere():
    ct = CausalTracer(MetricsRegistry(), sample_every=2)
    assert ct.admit() is not None
    assert ct.admit() is None            # downstream sees None
    assert ct.join_batch([_req(None)]) is None
    assert ct.begin_span("dispatch", None) is None
    ct.end_span(None, stage="dispatch")  # None-safe
    ct.complete(None)
    assert ct.completed_requests == 0


def test_null_tracer_is_inert():
    assert NULL_CTRACE.admit() is None
    assert NULL_CTRACE.join_batch([]) is None
    assert NULL_CTRACE.wal_append() is None
    assert NULL_CTRACE.begin_maintenance() is None
    assert NULL_CTRACE.active_tid() == 0
    assert NULL_CTRACE.spans() == []
    assert NULL_CTRACE.to_trace_events()["traceEvents"] == []
    assert "disabled" in NULL_CTRACE.describe_trace(1)


# ---------------------------------------------------------------- span graph

def test_batch_fan_in_links_and_queue_wait_credit():
    ct = CausalTracer(MetricsRegistry(), sample_every=1)
    a, b = ct.admit(), ct.admit()
    time.sleep(0.002)
    bt = ct.join_batch([_req(a), _req(None), _req(b)])
    assert bt.name == "batch" and bt.args["n_requests"] == 3
    # flow links: one per *traced* member, to the member's root span
    assert bt.links == [a.root.sid, b.root.sid]
    # queue_wait spans were closed and credited to each member
    for c in (a, b):
        assert c.queue_span.t1 > 0
        assert c.segments["queue_wait"] > 0
    # a second join does not re-close or double-credit queue spans
    q = a.segments["queue_wait"]
    ct.join_batch([_req(a)])
    assert a.segments["queue_wait"] == q


def test_critical_path_dominant_stage_and_exemplars():
    reg = MetricsRegistry()
    ct = CausalTracer(reg, sample_every=1)
    ctx = ct.admit(tick=2)
    ctx.segments.update({"dispatch": 10.0, "device_compute": 500.0,
                         "value_fetch": 20.0})
    ct.complete(ctx, tick=5)
    assert ctx.root.t1 > 0
    assert ctx.root.args["critical"] == "device_compute"
    assert ctx.root.args["done_tick"] == 5
    snap = reg.snapshot()
    v = _sample(snap, "server_critical_path_us", stage="device_compute")
    assert v["count"] == 1
    # the observation carries the trace id as a bucket exemplar
    ex = list(v["exemplars"].values())
    assert ex and ex[0]["trace_id"] == ctx.tid
    # per-segment exemplars annotate the stage-latency family
    sv = _sample(snap, "server_stage_us", stage="compute")
    assert any(e["trace_id"] == ctx.tid
               for e in sv["exemplars"].values())
    # annotate() never counts as an observation
    assert sv["count"] == 0
    # every critical stage family is pre-bound (present in the snapshot)
    have = {dict(s["labels"])["stage"]
            for s in snap["server_critical_path_us"]["samples"]}
    assert have == set(CRITICAL_STAGES)


def test_describe_trace_tree_and_cross_trace_marker():
    ct = CausalTracer(MetricsRegistry(), sample_every=1)
    a, b = ct.admit(), ct.admit()
    bt = ct.join_batch([_req(a), _req(b)])   # bt rides a's trace id
    dsp = ct.begin_span("dispatch", bt, shard=0)
    ct.end_span(dsp, stage="dispatch")
    ct.end_span(bt)
    ct.complete(a)
    ct.complete(b)
    own = ct.describe_trace(a.tid)
    assert own.startswith(f"trace {a.tid}:")
    assert "-- request" in own and "-- dispatch" in own
    # the batch span belongs to a's trace but links from b's root, so
    # b's view shows it as a cross-trace fan-in
    other = ct.describe_trace(b.tid)
    assert "~> batch" in other
    assert f"links=[{a.root.sid}, {b.root.sid}]" in other
    assert "no spans in ring" in ct.describe_trace(10_000)


# ------------------------------------------------- cross-thread span handoff

def test_cross_thread_handoff_out_of_order_completion():
    """A span begun on the submitting thread and finished inside an
    IOPool worker keeps its parent edge and never tears, even when the
    workers complete in reverse submission order (same forced-reverse
    harness as test_io.py)."""
    ct = CausalTracer(MetricsRegistry(), sample_every=1, ring=256)
    pool = IOPool(workers=4, name="io")
    gate = threading.Event()
    n_tasks = 4
    ctxs, batches, iospans, tasks = [], [], [], []
    for i in range(n_tasks):
        ctx = ct.admit(tick=0)
        bt = ct.join_batch([_req(ctx)])
        iosp = ct.begin_span("io_task", bt, link=bt, keys=8)
        assert iosp.track == threading.current_thread().name

        def task(i=i, iosp=iosp):
            if i == n_tasks - 1:
                gate.set()               # last submitted finishes first
            else:
                gate.wait(5.0)
                # 20 ms steps (the reference's are 1 ms): the forced
                # order must hold on a loaded host too
                time.sleep(0.02 * (n_tasks - i))
            ct.end_span(iosp, retrack=True)

        ctxs.append(ctx)
        batches.append(bt)
        iospans.append(iosp)
        tasks.append(task)
    try:
        wait_all([pool.submit(t) for t in tasks])
    finally:
        pool.close()
    for i, (ctx, bt, iosp) in enumerate(zip(ctxs, batches, iospans)):
        assert iosp.t1 >= iosp.t0 > 0    # ended exactly once, never torn
        assert iosp.parent == bt.sid and iosp.tid == ctx.tid
        assert iosp.links == [bt.sid]
        assert iosp.track.startswith("io-")   # re-stamped to the worker
    # the forced schedule completed the first submission last
    assert iospans[0].t1 == max(s.t1 for s in iospans)
    # export draws each worker's track; flow arrows stay matched
    ev = ct.to_trace_events()["traceEvents"]
    tracks = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert any(t.startswith("io-") for t in tracks)


# ------------------------------------------------------------- WAL tracing

def test_group_commit_wal_fan_in(tmp_path):
    """M traced appends collapse into one wal_commit span on the
    committer thread; every append span ends at durability, crediting
    the wal_fsync segment before sync() returns."""
    ct = CausalTracer(MetricsRegistry(), sample_every=1)
    w = GroupCommitWAL(str(tmp_path / "wal.log"))
    w.tracer = ct
    ctx = ct.admit()
    bt = ct.join_batch([_req(ctx)], kind="write")
    assert bt.name == "write_apply"
    ct.set_write(bt)
    arr = np.arange(4, dtype=np.int64)
    for _ in range(3):
        w.append(arr, arr, arr)
    ct.set_write(None)
    w.sync()
    ct.end_span(bt)
    ct.complete(ctx)
    w.close()
    spans = ct.spans()
    appends = [s for s in spans if s.name == "wal_append"]
    commits = [s for s in spans if s.name == "wal_commit"]
    assert len(appends) == 3 and len(commits) == 1
    assert all(s.t1 > 0 and s.tid == ctx.tid for s in appends)
    assert all(s.parent == bt.sid for s in appends)
    cm = commits[0]
    assert cm.args["group"] == 3
    assert set(cm.links) == {s.sid for s in appends}  # fan-in arrows
    assert cm.track == "wal-commit"                   # committer thread
    # durability latency was credited before sync() returned
    assert ctx.segments["wal_fsync"] > 0


def test_untraced_wal_append_is_free_and_crash_drops_spans(tmp_path):
    ct = CausalTracer(MetricsRegistry(), sample_every=1)
    w = GroupCommitWAL(str(tmp_path / "wal.log"))
    w.tracer = ct
    arr = np.arange(4, dtype=np.int64)
    w.append(arr, arr, arr)              # no write armed: no span
    assert [s for s in ct.spans() if s.name == "wal_append"] == []
    ctx = ct.admit()
    bt = ct.join_batch([_req(ctx)], kind="write")
    ct.set_write(bt)
    w.append(arr, arr, arr)
    ct.set_write(None)
    w.crash()                            # queued frame dropped pre-commit
    assert [s for s in ct.spans() if s.name == "wal_commit"] == []


# ------------------------------------------------------- EventLog stamping

def test_gc_event_trace_id_resolves_to_maintenance_span():
    obs = Obs(ObsConfig(sample_every=1, trace_sample_every=1))
    obs.events.log("flush")              # outside any bubble
    msp = obs.ctrace.begin_maintenance(tick=7, kind="bubble")
    obs.events.log("gc", segments_removed=2, cost_us=10.0)
    obs.ctrace.end_maintenance(msp)
    ev = {e["kind"]: e for e in obs.events.tail()}
    assert ev["flush"]["trace_id"] == 0 and "tick" in ev["flush"]
    gc_ev = ev["gc"]
    assert gc_ev["trace_id"] == msp.tid > 0
    assert gc_ev["segments_removed"] == 2
    spans = obs.ctrace.get_trace(gc_ev["trace_id"])
    assert [s.name for s in spans] == ["maintenance"]
    assert spans[0].args == {"tick": 7, "kind": "bubble"}
    assert spans[0].t1 > 0
    assert obs.ctrace.active_tid() == 0  # disarmed after the bubble
    assert "maintenance" in obs.describe_trace(gc_ev["trace_id"])


# ----------------------------------------------------------------- export

def _flow_pairs(events):
    starts = {e["id"]: e for e in events if e["ph"] == "s"}
    finishes = {e["id"]: e for e in events if e["ph"] == "f"}
    return starts, finishes


def _check_trace_events(doc):
    """Structural validity of a Chrome trace-event / Perfetto export."""
    evs = doc["traceEvents"]
    json.dumps(doc)                      # plain JSON types throughout
    meta = [e for e in evs if e["ph"] == "M"]
    body = [e for e in evs if e["ph"] != "M"]
    assert all(e["name"] == "thread_name" for e in meta)
    assert {e["tid"] for e in meta} >= {e["tid"] for e in body}
    # ts monotone non-decreasing, X events complete with dur >= 0
    ts = [e["ts"] for e in body]
    assert ts == sorted(ts) and (not ts or ts[0] >= 0)
    xs = [e for e in body if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 for e in xs)
    assert all(e["ph"] in ("X", "s", "f") for e in body)
    # every flow id has exactly one s and one f, arrow never goes back
    starts, finishes = _flow_pairs(body)
    assert set(starts) == set(finishes)
    for fid, s in starts.items():
        assert finishes[fid]["ts"] >= s["ts"]
        assert finishes[fid]["bp"] == "e"
    return xs, starts


def test_trace_events_structure_unit():
    ct = CausalTracer(MetricsRegistry(), sample_every=1)
    assert ct.to_trace_events() == {"traceEvents": [],
                                    "displayTimeUnit": "ms"}
    a, b = ct.admit(), ct.admit()
    bt = ct.join_batch([_req(a), _req(b)])
    dsp = ct.begin_span("dispatch", bt)
    ssp = ct.begin_span("shard_probe", dsp, link=dsp, shard=1)
    ct.end_span(ssp)
    ct.end_span(dsp, stage="dispatch")
    ct.end_span(bt)
    ct.complete(a)
    ct.complete(b)
    xs, starts = _check_trace_events(ct.to_trace_events())
    names = {e["name"] for e in xs}
    assert {"request", "queue_wait", "batch", "dispatch",
            "shard_probe"} <= names
    # fan-in (2 roots -> batch) + fan-out (dispatch -> shard_probe)
    assert len(starts) == 3
    by_sid = {e["args"]["sid"]: e for e in xs}
    assert by_sid[ssp.sid]["args"]["parent"] == dsp.sid
    assert by_sid[ssp.sid]["args"]["shard"] == 1


# ------------------------------------------------------------- end to end

def test_traced_threaded_pipelined_server_end_to_end(tmp_path):
    """Acceptance: tracing on through the threaded pipelined server with
    group-commit WAL — zero epoch violations, populated critical-path
    histograms with exemplars, a structurally valid Perfetto export
    whose flow links connect request, batch, shard, io-task, and
    wal-commit spans, and EventLog stamps resolving into the ring."""
    keys = _keys(3000, seed=21)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True,
                  wal_group_commit=True)
    srv = PipelinedServer(st, PipelineConfig(
        max_batch_keys=256, max_wait_ticks=0, io_workers=2,
        bubble_every_ticks=8,
        obs=ObsConfig(sample_every=1, trace_sample_every=2,
                      trace_ring=1 << 16)))
    ct = srv.obs.ctrace
    rng = np.random.default_rng(3)
    rid = 0
    # overwrite every key across several rounds so the value log
    # accumulates dead entries — that is what gives the maintenance
    # bubbles auto-GC work to log (mirrors test_pipeline's bubble test)
    for rnd in range(3):
        for off in range(0, keys.shape[0], 500):
            ks = keys[off: off + 500]
            assert srv.submit(
                ServerRequest(rid, "put", ks, _values(ks, version=rnd)))
            rid += 1
            srv.run_until_drained()
    reqs = []
    for _ in range(6):
        for _ in range(8):
            r = ServerRequest(rid, "get", rng.choice(keys, 32))
            assert srv.submit(r)
            reqs.append(r)
            rid += 1
        srv.tick()
    srv.run_until_drained()
    for _ in range(64):                  # idle ticks: maintenance bubbles
        srv.tick()
    assert all(r.done for r in reqs)
    assert srv.stats()["pipeline"]["epoch_violations"] == 0
    assert ct.traced_requests > 0
    assert ct.completed_requests > 0

    # ---- span graph: every expected span name was drawn
    spans = ct.spans()
    by_sid = {s.sid: s for s in spans}
    names = {s.name for s in spans}
    assert {"request", "queue_wait", "batch", "dispatch", "shard_probe",
            "device_compute", "io_task", "value_fetch", "write_apply",
            "wal_append", "wal_commit", "wal_sync",
            "maintenance"} <= names
    assert names <= set(SPAN_NAMES)
    # fan-out: shard probes and io tasks hang off their dispatch span
    for s in spans:
        if s.name in ("shard_probe", "io_task"):
            assert by_sid[s.parent].name == "dispatch"
        if s.name == "batch":            # fan-in from member roots
            assert s.links
            assert all(by_sid[l].name == "request" for l in s.links
                       if l in by_sid)
        if s.name == "wal_commit":       # fan-in from member appends
            assert all(by_sid[l].name == "wal_append" for l in s.links
                       if l in by_sid)
            assert s.track == "wal-commit"
        if s.name == "io_task" and s.t1:
            assert s.track.startswith("io-")

    # ---- critical path: one observation per completed request, with
    # exemplars pointing back at real traces
    snap = srv.obs.snapshot()
    crit = snap["server_critical_path_us"]["samples"]
    assert sum(s["value"]["count"] for s in crit) == \
        ct.completed_requests
    exemplars = [e for s in crit
                 for e in s["value"].get("exemplars", {}).values()]
    assert exemplars
    tid = exemplars[0]["trace_id"]
    assert ct.get_trace(tid)
    text = srv.obs.describe_trace(tid)
    assert text.startswith(f"trace {tid}:") and "request" in text

    # ---- EventLog stamps resolve into the ring
    stamped = [e for e in srv.obs.events.tail() if e["trace_id"] > 0]
    assert stamped                       # bubbles logged maintenance work
    for e in stamped[-4:]:
        assert any(s.name == "maintenance"
                   for s in ct.get_trace(e["trace_id"]))

    # ---- Perfetto export is structurally valid end to end
    xs, _ = _check_trace_events(srv.obs.trace_events())
    assert {"request", "batch", "shard_probe", "io_task",
            "wal_commit"} <= {e["name"] for e in xs}
    st.close()


def test_tracing_disabled_server_serves_and_exports_empty(tmp_path):
    keys = _keys(800, seed=5)
    st = _sharded(tmp_path, keys, n_shards=2, fetch_values=True)
    srv = PipelinedServer(st, PipelineConfig(
        max_wait_ticks=0,
        obs=ObsConfig(sample_every=1, trace_sample_every=0)))
    assert srv.obs.ctrace is NULL_CTRACE
    rid = 0
    assert srv.submit(ServerRequest(rid, "put", keys, _values(keys)))
    srv.run_until_drained()
    r = ServerRequest(1, "get", keys[:64])
    assert srv.submit(r)
    srv.run_until_drained()
    assert r.done
    assert srv.obs.trace_events()["traceEvents"] == []
    assert "disabled" in srv.obs.describe_trace(1)
    snap = srv.obs.snapshot()
    assert _sample(snap, "obs_traced_requests_total") == 0
    st.close()


# ------------------------------------------------------- parity with repro

def _traced_run(pkg, root, keys, io_workers):
    """Writes (two overwrite rounds, group-commit WAL), GETs and idle
    maintenance ticks through ``pkg``'s traced pipelined server."""
    M = common.PKGS[pkg]
    S, O = M["server"], M["obs"]
    st = common.open_sharded(pkg, root, keys, fetch_values=True,
                             wal_group_commit=True)
    srv = S.PipelinedServer(st, S.PipelineConfig(
        max_batch_keys=256, max_wait_ticks=0, io_workers=io_workers,
        bubble_every_ticks=8,
        obs=O.ObsConfig(sample_every=1, trace_sample_every=2,
                        trace_ring=1 << 16)))
    rid = 0
    for rnd in range(2):
        for off in range(0, keys.shape[0], 500):
            ks = keys[off: off + 500]
            assert srv.submit(S.ServerRequest(
                rid, "put", ks, common.values_of(ks, rnd)))
            rid += 1
            srv.run_until_drained()
    rng = np.random.default_rng(3)
    for _ in range(6):
        for _ in range(8):
            assert srv.submit(S.ServerRequest(rid, "get",
                                              rng.choice(keys, 32)))
            rid += 1
        srv.tick()
    srv.run_until_drained()
    for _ in range(32):
        srv.tick()
    srv.shutdown()
    ct = srv.obs.ctrace
    out = (common.span_structure(ct.spans()), ct.traced_requests,
           ct.completed_requests,
           sorted((e["kind"], e["trace_id"]) for e in srv.obs.events.tail()))
    st.close()
    return out


def test_span_graph_matches_reference(tmp_path):
    import repro.obs as RO
    import repro.obs.trace as rtrace
    import repro_torch.obs.trace as ptrace
    assert SPAN_NAMES == rtrace.SPAN_NAMES
    assert CRITICAL_STAGES == rtrace.CRITICAL_STAGES
    assert ptrace._EXEMPLAR_STAGES == rtrace._EXEMPLAR_STAGES
    import repro_torch.obs as PO
    assert PO.READ_STAGES == RO.READ_STAGES
    assert sorted(PO.__all__) == sorted(RO.__all__)
    keys = common.keys_of(2000, seed=22)
    sync_file_ids()
    ref = _traced_run("repro", tmp_path / "r", keys, io_workers=2)
    port = _traced_run("repro_torch", tmp_path / "p", keys, io_workers=2)
    assert port[1:] == ref[1:]
    assert port[0] == ref[0]
    names = {s[1] for s in port[0]}
    assert {"request", "batch", "dispatch", "shard_probe", "device_compute",
            "io_task", "value_fetch", "wal_append", "wal_commit",
            "maintenance"} <= names
