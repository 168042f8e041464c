"""CausalTracer — sampled per-request causal tracing for the serving stack.

The paper's whole argument (§3) is a latency decomposition: knowing
*where* a lookup spends its time is what justifies learning.  The
:class:`~repro_torch.obs.tracer.StageTracer` answers that in aggregate; this
module answers it **per request** — "why was *this* request's p99 4 ms"
— after the request fans into a coalesced batch, per-shard probes,
IOPool threads, and a group-commit fsync.

Design (mirrors the StageTracer's sampling discipline):

* **countdown sampling** — :meth:`CausalTracer.admit` traces one request
  every ``sample_every`` admissions.  The unsampled cost is one integer
  decrement; every downstream call site receives ``None`` and the
  null-check is a single identity test (HOTSYNC-clean, no string
  formatting, no allocation).
* **span graph, not a span stack** — spans carry explicit ``parent``
  and ``links`` (flow) edges so fan-in (N requests → 1 batch, M WAL
  appends → 1 commit group) and fan-out (1 batch → per-shard probes,
  1 batch → an IOPool task) are first-class.
* **cross-thread handoff** — a span begun on the tick loop may be ended
  inside an IOPool worker or the WAL committer thread
  (``end_span(..., retrack=True)`` re-stamps the track); the bounded
  ring is appended under a lock at begin, and each span is mutated by
  exactly one finisher, so spans never tear under out-of-order
  completion.
* **critical-path extraction** — batch-level spans credit their wall
  time to every member request's segment table; at completion the
  dominant segment labels a ``server_critical_path_us`` observation and
  the per-segment times annotate the matching ``server_stage_us``
  buckets as exemplars (fat tail bucket → concrete trace id).
* **export** — :meth:`to_trace_events` renders Chrome trace-event /
  Perfetto JSON ("X" complete events plus "s"/"f" flow arrows);
  :meth:`describe_trace` renders a human tree view.

``NULL_CTRACE`` is the obs-off null object: every method no-ops or
returns ``None`` so instrumented call sites never branch on "is tracing
enabled".
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["CausalTracer", "NullCausalTracer", "Span", "TraceContext",
           "CRITICAL_STAGES", "NULL_CTRACE", "SPAN_NAMES"]

_now = time.perf_counter

# Canonical span names (the causal-graph vocabulary): the same tuple as
# repro.obs.trace.SPAN_NAMES, so the two packages' traces compare span
# for span (tests/test_torch_trace.py holds them equal).
SPAN_NAMES = (
    "request",          # root: admission → completion of one request
    "queue_wait",       # admission → the batcher picks the request up
    "batch",            # fan-in: the coalesced batch (links from members)
    "dispatch",         # host overlay probe + async device enqueue
    "shard_probe",      # fan-out: one shard's overlay probe
    "device_compute",   # dispatch → retire (device latency to hide)
    "io_task",          # the ValueFetch body on an IOPool worker
    "value_fetch",      # the exposed wait joining the ValueFetch
    "write_apply",      # fan-in: apply one coalesced write batch
    "wal_append",       # WAL enqueue → durable (group-commit latency)
    "wal_commit",       # committer thread: one write+flush+fsync group
    "wal_sync",         # the tick loop's durability barrier
    "maintenance",      # a maintenance bubble (learn / GC / checkpoint)
)

# Critical-path segment labels: each request accumulates µs per segment;
# the dominant one labels its server_critical_path_us observation.
CRITICAL_STAGES = ("queue_wait", "dispatch", "device_compute",
                   "value_fetch", "wal_fsync")

# segment → server_stage_us stage whose buckets get the trace exemplar
_EXEMPLAR_STAGES = (("dispatch", "dispatch"),
                    ("device_compute", "compute"),
                    ("value_fetch", "value_fetch"))


class Span:
    """One node of the causal graph.  ``parent`` / ``links`` are span
    ids (ints) so a span survives its relatives' eviction from the ring;
    ``track`` is the thread name it is drawn on; ``ctxs`` are the
    member :class:`TraceContext`\\ s whose critical-path segment tables
    this span credits when ended with a ``stage``."""

    __slots__ = ("sid", "tid", "name", "parent", "t0", "t1", "track",
                 "links", "args", "ctxs")

    def __init__(self, sid: int, tid: int, name: str, parent: int,
                 t0: float, track: str, links, args, ctxs) -> None:
        self.sid = sid
        self.tid = tid
        self.name = name
        self.parent = parent
        self.t0 = t0
        self.t1 = 0.0
        self.track = track
        self.links = links
        self.args = args
        self.ctxs = ctxs

    @property
    def dur_us(self) -> float:
        return (self.t1 - self.t0) * 1e6 if self.t1 else 0.0


class TraceContext:
    """Per-sampled-request handle minted at admission: the trace id, the
    root span, the open queue-wait span, and the critical-path segment
    table (stage → µs) batch-level spans credit into."""

    __slots__ = ("tid", "root", "queue_span", "segments")

    def __init__(self, tid: int, root=None, queue_span=None) -> None:
        self.tid = tid
        self.root = root
        self.queue_span = queue_span
        self.segments: dict = {}


class CausalTracer:
    """Sampled causal tracing over a bounded span ring.

    Thread model: sids/tids are allocated and spans appended to the ring
    under ``_lock`` (begin may race between the tick loop, IOPool
    workers, and the WAL committer); each span is *ended* by exactly one
    caller, so end-side mutation is lock-free.  Segment crediting for a
    request happens before its completion barrier (the pipelined
    server's ``wal_sync`` / ``ValueFetch.wait``), so ``complete`` reads
    a quiesced table.
    """

    def __init__(self, registry, sample_every: int = 64,
                 ring: int = 4096) -> None:
        self.sample_every = max(int(sample_every), 1)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(ring))
        self._sid = 0
        self._tid = 0
        self._countdown = 0          # 0 → trace the next admit
        self._cur_write: Span | None = None
        self._cur_maint: Span | None = None
        self.traced_requests = 0
        self.completed_requests = 0
        # pre-bound histogram handles (never per-request dict lookups on
        # family/label resolution)
        self._crit = {s: registry.histogram("server_critical_path_us",
                                            stage=s)
                      for s in CRITICAL_STAGES}
        self._ex = {seg: registry.histogram("server_stage_us", stage=st)
                    for seg, st in _EXEMPLAR_STAGES}

    # ------------------------------------------------------------ spans

    def _new_span(self, name: str, tid: int, parent: int, ctxs,
                  links=(), t0: float = 0.0, args=None) -> Span:
        with self._lock:
            self._sid += 1
            sp = Span(self._sid, tid, name, parent,
                      t0 if t0 else _now(),
                      threading.current_thread().name,
                      list(links), args or {}, ctxs)
            self._ring.append(sp)
        return sp

    def admit(self, tick: int = -1) -> TraceContext | None:
        """Mint a trace for this request, or ``None`` (the common case).
        Opens the root ``request`` span and its ``queue_wait`` child."""
        if self._countdown:
            self._countdown -= 1
            return None
        self._countdown = self.sample_every - 1
        with self._lock:
            self._tid += 1
            tid = self._tid
        self.traced_requests += 1
        ctx = TraceContext(tid)
        ctx.root = self._new_span("request", tid, 0, (ctx,),
                                  args={"tick": int(tick)})
        ctx.queue_span = self._new_span("queue_wait", tid,
                                        ctx.root.sid, (ctx,))
        return ctx

    def join_batch(self, requests, kind: str = "batch") -> Span | None:
        """Fan-in: N admitted requests coalesce into one batch.  Ends
        every member's ``queue_wait`` span (crediting the segment) and
        opens a batch span flow-linked from each member's root.  Returns
        ``None`` when no member is traced."""
        ctxs = tuple(r.trace for r in requests if r.trace is not None)
        if not ctxs:
            return None
        now = _now()
        links = []
        for c in ctxs:
            q = c.queue_span
            if q is not None and not q.t1:
                q.t1 = now
                c.segments["queue_wait"] = (
                    c.segments.get("queue_wait", 0.0) + (now - q.t0) * 1e6)
            links.append(c.root.sid)
        name = "batch" if kind == "batch" else "write_apply"
        sp = self._new_span(name, ctxs[0].tid, ctxs[0].root.sid, ctxs,
                            links=links, t0=now,
                            args={"n_requests": len(requests)})
        return sp

    def begin_span(self, name: str, parent: Span | None,
                   link: Span | None = None, **args) -> Span | None:
        """Open a child of ``parent`` (a Span); ``None`` parent means the
        request is unsampled and the whole call is one identity test.
        ``link`` adds a flow arrow from another span (fan-out edges)."""
        if parent is None:
            return None
        links = (link.sid,) if link is not None else ()
        return self._new_span(name, parent.tid, parent.sid, parent.ctxs,
                              links=links, args=args)

    def end_span(self, span: Span | None, stage: str | None = None,
                 retrack: bool = False) -> None:
        """Close ``span`` (None-safe).  ``stage`` credits the span's
        duration to every member request's critical-path segment table;
        ``retrack=True`` re-stamps the track for spans ended on a
        different thread than they began on (IOPool / WAL committer)."""
        if span is None:
            return
        now = _now()
        span.t1 = now
        if retrack:
            span.track = threading.current_thread().name
        if stage is not None:
            us = (now - span.t0) * 1e6
            for c in span.ctxs:
                c.segments[stage] = c.segments.get(stage, 0.0) + us

    def complete(self, ctx: TraceContext | None,
                 tick: int = -1) -> None:
        """The request is done: close the root span, extract the
        critical path (dominant segment labels the
        ``server_critical_path_us`` observation), and attach the trace
        id as an exemplar to the matching ``server_stage_us`` buckets."""
        if ctx is None:
            return
        root = ctx.root
        if not root.t1:
            root.t1 = _now()
        if tick >= 0:
            root.args["done_tick"] = int(tick)
        self.completed_requests += 1
        segs = ctx.segments
        total_us = root.dur_us
        if segs:
            dominant = max(segs, key=segs.__getitem__)
            root.args["critical"] = dominant
            h = self._crit.get(dominant)
            if h is not None:
                h.observe(total_us)
                h.annotate(total_us, ctx.tid)
            for seg, eh in self._ex.items():
                us = segs.get(seg)
                if us:
                    eh.annotate(us, ctx.tid)
        else:
            self._crit["queue_wait"].observe(total_us)

    # ------------------------------------------------- write / WAL path

    def set_write(self, span: Span | None) -> None:
        """Arm (or with ``None``, disarm) the ambient write span: WAL
        appends issued while armed parent under it.  Tick-loop writes are
        serial, so a plain attribute is enough."""
        self._cur_write = span

    def wal_append(self) -> Span | None:
        """Called by the WAL writer inside ``append``: one attribute
        read when no traced write is in flight."""
        w = self._cur_write
        if w is None:
            return None
        return self._new_span("wal_append", w.tid, w.sid, w.ctxs)

    def wal_commit(self, appends, t0: float) -> None:
        """Called on the committer thread after the group's fsync:
        fan-in M ``wal_append`` spans → one ``wal_commit`` span.  Ends
        each append span at durability (crediting the ``wal_fsync``
        segment) and draws flow arrows append → commit."""
        spans = [s for s in appends if s is not None]
        if not spans:
            return
        first = spans[0]
        sp = self._new_span("wal_commit", first.tid, first.sid, (),
                            links=[s.sid for s in spans], t0=t0,
                            args={"group": len(spans)})
        sp.t1 = _now()
        sp.track = threading.current_thread().name
        for s in spans:
            self.end_span(s, stage="wal_fsync")

    # ------------------------------------------------------ maintenance

    def begin_maintenance(self, tick: int = -1, kind: str = "bubble"):
        """Open a maintenance root span (its own trace id — bubbles are
        not on any request's path) and expose it via :meth:`active_tid`
        so EventLog entries logged inside correlate to it."""
        with self._lock:
            self._tid += 1
            tid = self._tid
        sp = self._new_span("maintenance", tid, 0, (),
                            args={"tick": int(tick), "kind": kind})
        self._cur_maint = sp
        return sp

    def end_maintenance(self, span: Span | None) -> None:
        self._cur_maint = None
        self.end_span(span)

    def active_tid(self) -> int:
        """Trace id EventLog entries should be stamped with (0 when no
        maintenance span is open — events outside bubbles are unlinked)."""
        m = self._cur_maint
        return m.tid if m is not None else 0

    # ----------------------------------------------------------- export

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._ring)

    def get_trace(self, tid: int) -> list[Span]:
        """All ring spans of trace ``tid`` plus cross-trace spans that
        flow-link from them (e.g. the wal_commit group of an append)."""
        spans = self.spans()
        mine = [s for s in spans if s.tid == tid]
        sids = {s.sid for s in mine}
        extra = [s for s in spans
                 if s.tid != tid and any(l in sids for l in s.links)]
        return sorted(mine + extra, key=lambda s: (s.t0, s.sid))

    def to_trace_events(self) -> dict:
        """Chrome trace-event / Perfetto JSON: "X" complete events on
        per-thread tracks plus "s"/"f" flow arrows for every link edge.
        Timestamps are µs relative to the earliest span."""
        spans = [s for s in self.spans() if s.t1]
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        by_sid = {s.sid: s for s in spans}
        origin = min(s.t0 for s in spans)
        tids: dict = {}      # track name → chrome tid

        def us(t: float) -> float:
            return round((t - origin) * 1e6, 3)

        def track(name: str) -> int:
            return tids.setdefault(name, len(tids) + 1)

        events = []
        flow = 0
        for s in sorted(spans, key=lambda x: (x.t0, x.sid)):
            args = {"trace": s.tid, "sid": s.sid}
            if s.parent:
                args["parent"] = s.parent
            args.update(s.args)
            events.append({"ph": "X", "name": s.name, "cat": "serve",
                           "ts": us(s.t0), "dur": round(s.dur_us, 3),
                           "pid": 1, "tid": track(s.track), "args": args})
            for src_sid in s.links:
                src = by_sid.get(src_sid)
                if src is None or not src.t1:
                    continue        # source evicted from the ring
                flow += 1
                # arrow departs when the source ends, lands no earlier
                # than it departed and no later than the dest interval
                ts_s = us(min(src.t1, s.t1))
                ts_f = max(ts_s, us(s.t0))
                events.append({"ph": "s", "id": flow, "name": "causal",
                               "cat": "flow", "ts": ts_s, "pid": 1,
                               "tid": track(src.track)})
                events.append({"ph": "f", "bp": "e", "id": flow,
                               "name": "causal", "cat": "flow",
                               "ts": ts_f, "pid": 1,
                               "tid": track(s.track)})
        events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "X" else 1))
        meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": n,
                 "args": {"name": t}} for t, n in sorted(
                     tids.items(), key=lambda kv: kv[1])]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def describe_trace(self, tid: int) -> str:
        """Human tree view of one trace (children indented under their
        parent; cross-trace fan-ins shown with a ``~>`` marker)."""
        spans = self.get_trace(tid)
        if not spans:
            return f"trace {tid}: no spans in ring"
        by_parent: dict = {}
        sids = {s.sid for s in spans}
        roots = []
        for s in spans:
            if s.parent in sids:
                by_parent.setdefault(s.parent, []).append(s)
            else:
                roots.append(s)
        out = [f"trace {tid}:"]

        def emit(s: Span, depth: int) -> None:
            mark = "~>" if s.tid != tid else "--"
            extra = ""
            if s.links:
                extra += f" links={list(s.links)}"
            if s.args:
                kv = ", ".join(f"{k}={v}" for k, v in s.args.items())
                extra += f" [{kv}]"
            out.append(f"  {'  ' * depth}{mark} {s.name} "
                       f"{s.dur_us:9.1f}us  sid={s.sid} "
                       f"@{s.track}{extra}")
            for c in sorted(by_parent.get(s.sid, ()),
                            key=lambda x: (x.t0, x.sid)):
                emit(c, depth + 1)

        for r in sorted(roots, key=lambda x: (x.t0, x.sid)):
            emit(r, 0)
        return "\n".join(out)


class NullCausalTracer:
    """Tracing-off null object: one method call, no state, no branches
    at the call site."""

    __slots__ = ()
    sample_every = 0

    def admit(self, tick: int = -1):
        return None

    def join_batch(self, requests, kind: str = "batch"):
        return None

    def begin_span(self, name, parent, link=None, **args):
        return None

    def end_span(self, span, stage=None, retrack=False) -> None:
        pass

    def complete(self, ctx, tick: int = -1) -> None:
        pass

    def set_write(self, span) -> None:
        pass

    def wal_append(self):
        return None

    def wal_commit(self, appends, t0: float) -> None:
        pass

    def begin_maintenance(self, tick: int = -1, kind: str = "bubble"):
        return None

    def end_maintenance(self, span) -> None:
        pass

    def active_tid(self) -> int:
        return 0

    def spans(self) -> list:
        return []

    def get_trace(self, tid: int) -> list:
        return []

    def to_trace_events(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def describe_trace(self, tid: int) -> str:
        return f"trace {tid}: tracing disabled"


NULL_CTRACE = NullCausalTracer()
