"""MetricsRegistry — the unified, labeled metric store for the whole
stack (the tentpole of the observability plane).

One registry holds every counter/gauge/histogram the layered ``stats()``
dicts used to scatter: instruments are keyed by (family name, sorted
label tuple), created on first touch, and a single :meth:`snapshot`
yields the consistent fleet view the exporters (obs/export.py) render.

Two write disciplines coexist:

* **push** — hot-path code holds a pre-bound instrument (no dict lookup
  or string formatting per batch: ``reg.counter(...)`` once at attach
  time, ``.inc()`` per event).
* **collect** — layers that already maintain their own counters register
  a collector callback; ``snapshot()`` runs the collectors first, so the
  registry never needs the layers to push on their hot paths at all.
  Collectors are *keyed*: a store reopening at the same path (same
  labels) replaces its stale predecessor instead of double-reporting.

Counter semantics across epoch events (memtable roll, compaction, store
reopen) come from :meth:`Counter.observe_total`: collectors report their
layer's *cumulative* value, and a reported value below the previous one
is treated as a source restart (the new source starts its own cumulative
count from zero), so registry counters stay monotonic across reopens.
"""

from __future__ import annotations

import bisect

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "publish_stats"]


class Counter:
    """Monotonic counter.  ``inc`` for push-style sources;
    ``observe_total`` for collectors that report a cumulative value."""

    kind = "counter"
    __slots__ = ("value", "_last_total")

    def __init__(self) -> None:
        self.value = 0.0
        self._last_total = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def observe_total(self, cur: float) -> None:
        """Fold a source's cumulative total into this counter.  A value
        below the previous observation means the source restarted (store
        reopen: the new instance counts from zero), so the whole new
        total is fresh progress — the registry counter never decreases."""
        cur = float(cur)
        if cur >= self._last_total:
            self.value += cur - self._last_total
        else:
            self.value += cur
        self._last_total = cur


class Gauge:
    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log2-bucketed latency histogram (microseconds): bounds 1, 2, 4,
    ... 2^20 us (~1 s) plus +inf, so one fixed layout covers cache-probe
    nanoseconds through maintenance stalls without configuration."""

    kind = "histogram"
    __slots__ = ("sum", "count", "max", "buckets", "exemplars")
    BOUNDS = tuple(float(1 << i) for i in range(21))

    def __init__(self) -> None:
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self.buckets = [0] * (len(self.BOUNDS) + 1)
        # bucket index -> {"trace_id": int, "value": float}; latest trace
        # exemplar per bucket (a fat-tail bucket links to a concrete
        # trace a human can pull up with describe_trace)
        self.exemplars: dict[int, dict] = {}

    def observe(self, x: float) -> None:
        x = float(x)
        self.sum += x
        self.count += 1
        if x > self.max:
            self.max = x
        self.buckets[bisect.bisect_left(self.BOUNDS, x)] += 1

    def annotate(self, x: float, trace_id: int) -> None:
        """Attach a trace exemplar to the bucket ``x`` falls in (does
        not count as an observation — the causal tracer annotates the
        same families the StageTracer populates)."""
        x = float(x)
        self.exemplars[bisect.bisect_left(self.BOUNDS, x)] = {
            "trace_id": int(trace_id), "value": x}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    def __init__(self) -> None:
        # family name -> {"kind": str, "samples": {label_tuple: instrument}}
        self._families: dict[str, dict] = {}
        # collector key -> callback(reg); keyed so a reopened source
        # REPLACES its stale predecessor (same key) instead of leaving an
        # orphan collector double-reporting final values forever
        self._collectors: dict = {}

    # ------------------------------------------------------------ instruments
    @staticmethod
    def _label_key(labels: dict) -> tuple:
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _get(self, kind: str, name: str, labels: dict):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {"kind": kind, "samples": {}}
        elif fam["kind"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam['kind']}, "
                f"requested {kind}")
        key = self._label_key(labels)
        inst = fam["samples"].get(key)
        if inst is None:
            inst = fam["samples"][key] = _KINDS[kind]()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # ------------------------------------------------------------- collectors
    def register_collector(self, key, fn) -> None:
        """Register (or replace — same key wins latest) a snapshot-time
        callback ``fn(registry)``.  Layers report through collectors so
        their hot paths never touch the registry."""
        self._collectors[key] = fn

    def unregister_collector(self, key) -> None:
        """Drop a collector (a detaching source); its already-folded
        counter values stay in the registry."""
        self._collectors.pop(key, None)

    def collect(self) -> None:
        for fn in list(self._collectors.values()):
            fn(self)

    # --------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """Run the collectors, then return every family as plain JSON
        types: ``{name: {"kind": ..., "samples": [{"labels": {...},
        "value": ...}, ...]}}`` — one call, the whole fleet, stable
        ordering."""
        self.collect()
        out: dict = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            for key in sorted(fam["samples"]):
                inst = fam["samples"][key]
                if fam["kind"] == "histogram":
                    value = {"sum": float(inst.sum), "count": int(inst.count),
                             "max": float(inst.max),
                             "buckets": [int(b) for b in inst.buckets]}
                    if inst.exemplars:
                        value["exemplars"] = {
                            str(i): {"trace_id": int(e["trace_id"]),
                                     "value": float(e["value"])}
                            for i, e in sorted(inst.exemplars.items())}
                else:
                    value = float(inst.value)
                samples.append({"labels": dict(key), "value": value})
            out[name] = {"kind": fam["kind"], "samples": samples}
        return out

    def delta(self, prev: dict, cur: dict | None = None) -> dict:
        """Rolling-rate view between two snapshots (the self-tuning
        controller's per-interval observation vector in one call).

        ``prev`` is an earlier :meth:`snapshot`; ``cur`` defaults to a
        fresh one.  Same shape as a snapshot, but values are per-window:

        * counters — ``cur - prev``, with the same restart rule as
          :meth:`Counter.observe_total`: a current value *below* the
          previous one means the source restarted, so the whole current
          value is fresh progress for the window.
        * gauges — the current value (point-in-time by definition).
        * histograms — per-bucket count deltas plus sum/count deltas
          (restart rule keyed on ``count``); ``max`` is the current max
          (no windowed max is recoverable from two cumulative
          snapshots).  Exemplars are dropped — they are not rates.

        Samples new in ``cur`` count from zero; samples only in ``prev``
        (a detached source) are omitted.
        """
        if cur is None:
            cur = self.snapshot()

        def _index(snap_fam) -> dict:
            return {self._label_key(s["labels"]): s["value"]
                    for s in snap_fam["samples"]}

        out: dict = {}
        for name in sorted(cur):
            fam = cur[name]
            kind = fam["kind"]
            prev_by = _index(prev[name]) if name in prev \
                and prev[name]["kind"] == kind else {}
            samples = []
            for s in fam["samples"]:
                key = self._label_key(s["labels"])
                cv, pv = s["value"], prev_by.get(key)
                if kind == "counter":
                    if pv is None or cv < pv:      # new or restarted
                        value = float(cv)
                    else:
                        value = float(cv) - float(pv)
                elif kind == "gauge":
                    value = float(cv)
                else:
                    if pv is None or cv["count"] < pv["count"]:
                        value = {"sum": float(cv["sum"]),
                                 "count": int(cv["count"]),
                                 "max": float(cv["max"]),
                                 "buckets": [int(b) for b in cv["buckets"]]}
                    else:
                        value = {"sum": float(cv["sum"]) - float(pv["sum"]),
                                 "count": int(cv["count"]) - int(pv["count"]),
                                 "max": float(cv["max"]),
                                 "buckets": [int(a) - int(b) for a, b in
                                             zip(cv["buckets"],
                                                 pv["buckets"])]}
                samples.append({"labels": dict(key), "value": value})
            out[name] = {"kind": kind, "samples": samples}
        return out


def publish_stats(reg: MetricsRegistry, prefix: str, stats: dict,
                  labels: dict | None = None, skip=()) -> None:
    """Flatten a layer's ``stats()`` dict into labeled gauges.

    Naming/label conventions (``repro.obs``'s README.md):
    * numbers (and bools, as 0/1) -> gauge ``<prefix>_<key>``
    * str-keyed sub-dicts recurse with the key joined into the name
      (``auto_gc: {runs: 3}`` -> ``store_auto_gc_runs``)
    * int-keyed sub-dicts become a ``key=`` label per entry
      (``level_models_persisted: {2: 7}`` -> label ``key="2"``)
    * numeric lists become one sample per element, labeled ``index=``
      (the coordinator's ``per_shard_us`` -> ``index="0"`` ...)
    * strings, Nones, and non-numeric list elements are skipped
    """
    lb = dict(labels or {})
    for k in stats:
        if k in skip:
            continue
        _publish_value(reg, f"{prefix}_{k}", stats[k], lb)


def _publish_value(reg, name, v, lb) -> None:
    if isinstance(v, bool):
        reg.gauge(name, **lb).set(1.0 if v else 0.0)
    elif isinstance(v, (int, float)):
        reg.gauge(name, **lb).set(float(v))
    elif isinstance(v, dict):
        for kk, vv in v.items():
            if isinstance(kk, int):
                _publish_value(reg, name, vv, {**lb, "key": str(kk)})
            else:
                _publish_value(reg, f"{name}_{kk}", vv, lb)
    elif isinstance(v, (list, tuple)):
        for i, vv in enumerate(v):
            if isinstance(vv, (bool, int, float)):
                _publish_value(reg, name, vv, {**lb, "index": str(i)})
    elif v is None or isinstance(v, str):
        pass
    else:
        # numpy scalars and the like: publish anything float()-able
        try:
            reg.gauge(name, **lb).set(float(v))
        except (TypeError, ValueError):
            pass
