"""Helpers shared by the port's obs, trace, server and pipeline tests
(``tests/test_torch_{obs,trace,server,pipeline}.py``): the reference
tests' small sharded-store config built for either package, the request
streams of ``benchmarks/bench_serve.py``, and the comparisons that hold
the port's snapshots, span graphs and served requests to the reference's.

Wall-clock metrics cannot agree between two runs, so the snapshot
comparison leaves them out, by name (``TIMING_METRICS``); every other
counter and gauge, and every other histogram's count, sum and buckets,
must be equal."""

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import repro.core as R  # noqa: E402
import repro.obs as RO  # noqa: E402
import repro.server as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.server as PS  # noqa: E402
from benchmarks.bench_serve import _request_streams  # noqa: E402,F401
from repro.core.engine import EngineConfig as REngineConfig  # noqa: E402
from repro.distributed import sharded as rsh  # noqa: E402
from repro_torch.core.engine import EngineConfig as PEngineConfig  # noqa: E402
from repro_torch.distributed import sharded as psh  # noqa: E402

VALUE_SIZE = 16

# the two packages' modules, by name, so one test body drives either
PKGS = {
    "repro": dict(core=R, obs=RO, server=RS, sharded=rsh,
                  EngineConfig=REngineConfig, open_kw=dict(mesh=None)),
    "repro_torch": dict(core=P, obs=PO, server=PS, sharded=psh,
                        EngineConfig=PEngineConfig,
                        open_kw=dict(device="cpu")),
}

# wall-clock metrics (host timers), the only ones left out of a snapshot
# comparison: the stage and critical-path latency histograms, and the
# value-fetch overlap totals the I/O plane measures
TIMING_METRICS = ("server_stage_us", "server_critical_path_us",
                  "fleet_value_fetch_hidden_us_total",
                  "fleet_value_fetch_exposed_us_total",
                  "fleet_value_fetch_overlap_ratio",
                  "fleet_value_fetch_hidden_us",
                  "fleet_value_fetch_exposed_us")


def store_cfg(pkg: str, **kw):
    """``tests/test_server.py::_store_cfg`` built for ``pkg``."""
    M = PKGS[pkg]
    core = M["core"]
    defaults = dict(granularity="level", policy="always",
                    value_size=VALUE_SIZE, vlog_seg_slots=1 << 9,
                    lsm=core.LSMConfig(memtable_cap=1 << 10,
                                       file_cap=1 << 11,
                                       l1_cap_records=1 << 13),
                    engine=M["EngineConfig"](seg_cap=4096))
    if pkg == "repro_torch":
        defaults["device"] = "cpu"
    defaults.update(kw)
    return core.StoreConfig(**defaults)


def keys_of(n, seed=0, stride=7):
    return np.random.default_rng(seed).permutation(
        np.arange(1, n + 1, dtype=np.int64) * stride)


def open_sharded(pkg: str, path, keys, n_shards=2, **kw):
    """A fresh sharded store of ``pkg`` split at the keys' quantiles."""
    M = PKGS[pkg]
    bounds = tuple(int(b) for b in
                   np.quantile(keys, np.arange(1, n_shards) / n_shards))
    return M["sharded"].ShardedStore.open(
        str(path), M["sharded"].ShardedConfig(n_shards=n_shards,
                                              boundaries=bounds),
        store_cfg(pkg, **kw), **M["open_kw"])


def values_of(keys, version=0):
    v = np.zeros((keys.shape[0], VALUE_SIZE), np.uint8)
    v[:, 0] = (keys % 251).astype(np.uint8)
    v[:, 1] = version % 251
    return v


def sample(snap, name, **labels):
    for s in snap[name]["samples"]:
        if dict(s["labels"]) == labels:
            return s["value"]
    raise KeyError((name, labels))


def comparable(snap: dict) -> dict:
    """Every counter and gauge of a snapshot, and every histogram's count,
    sum and buckets, keyed by (name, labels); the ``TIMING_METRICS`` are
    left out."""
    out = {}
    for name, fam in snap.items():
        if name in TIMING_METRICS:
            continue
        for s in fam["samples"]:
            key = (name, tuple(sorted(dict(s["labels"]).items())))
            v = s["value"]
            if fam["kind"] == "histogram":
                v = (v["count"], v["sum"], tuple(v["buckets"]))
            out[key] = v
    return out


def assert_snapshots_equal(ref: dict, port: dict) -> None:
    a, b = comparable(ref), comparable(port)
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))[:10]
    diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not diff, list(diff.items())[:10]


def prometheus_without_timing(text: str) -> list:
    """The Prometheus text's lines, less those of ``TIMING_METRICS``."""
    keep = []
    for line in text.splitlines():
        words = line.split()
        if not words:
            continue
        name = words[2] if line.startswith("#") and len(words) > 2 \
            else words[0].split("{")[0]
        if any(name == t or name.startswith(t + "_") for t in TIMING_METRICS):
            continue
        keep.append(line)
    return keep


def span_structure(spans) -> list:
    """A span ring as a sorted list of (trace id, name, parent name,
    linked names, args) per span, timings and the timing-picked
    ``critical`` stage left out: what two runs of one request stream must
    agree on, whatever thread ended each span first."""
    by_sid = {s.sid: s for s in spans}
    out = []
    for s in spans:
        parent = by_sid[s.parent].name if s.parent in by_sid else None
        links = tuple(sorted(by_sid[x].name if x in by_sid else ""
                             for x in s.links))
        args = tuple(sorted((k, v) for k, v in s.args.items()
                            if k != "critical"))
        out.append((s.tid, s.name, parent or "", links, repr(args)))
    return sorted(out)


def request_record(r) -> tuple:
    """A served request's outcome: found, result and completion tick."""
    return (r.rid, r.op, np.asarray(r.found).tobytes()
            if r.found is not None else None,
            np.asarray(r.result).tobytes() if r.result is not None
            else None, r.completed_tick)


def closed_loop(srv, S, streams, depth=2):
    """``benchmarks/bench_serve.py::_closed_loop_async`` without its
    clock: each client keeps up to ``depth`` requests outstanding and
    resubmits after backpressure; returns every request in submission
    order, served."""
    clients = len(streams)
    nxt = [0] * clients
    pending = [[] for _ in range(clients)]
    reqs = []
    rid = 1 << 20
    total = sum(len(s) for s in streams)
    served = 0
    while served < total:
        for c in range(clients):
            while len(pending[c]) < depth and nxt[c] < len(streams[c]):
                item = streams[c][nxt[c]]
                op, ks, vals = item if isinstance(item, tuple) \
                    else ("get", item, None)
                r = S.ServerRequest(rid, op, ks, vals)
                if not srv.submit(r):
                    break
                rid += 1
                pending[c].append(r)
                reqs.append(r)
                nxt[c] += 1
        srv.tick()
        for c in range(clients):
            done = [r for r in pending[c] if r.done]
            for r in done:
                pending[c].remove(r)
                served += 1
    return reqs


def load_through(srv, S, keys, version=0, chunk=500):
    """PUT ``keys`` through the server in ``chunk``-key requests."""
    for off in range(0, keys.shape[0], chunk):
        ks = keys[off: off + chunk]
        assert srv.submit(S.ServerRequest(off, "put", ks,
                                          values_of(ks, version)))
        srv.run_until_drained()


def stats_less_wall_time(s: dict) -> dict:
    """A server's ``stats()`` less its wall-clock fields: the store's
    value-fetch overlap totals, and the I/O pool's completed count and
    queue depths (which depend on thread timing)."""
    s = dict(s)
    s["store"] = {k: v for k, v in s["store"].items() if k != "value_fetch"}
    if s.get("io") is not None:
        s["io"] = {k: v for k, v in s["io"].items()
                   if k not in ("completed", "depth", "max_depth")}
    return s
