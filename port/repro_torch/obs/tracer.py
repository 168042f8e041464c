"""StageTracer — sampling stage timer for the serving hot path.

The paper's §3 analysis works because lookup latency is decomposed into
stages; this tracer does the same for the serving read path (admission,
coalesce, cache probe, dispatch, device compute, resolve, value fetch)
at a cost low enough to leave on in production:

* **pre-bound handles** — each stage is resolved to a :class:`StageHandle`
  once at server construction.  Per batch the hot path does
  ``t0 = h.begin(); ...; h.end(t0)``: no dict lookup, no string
  formatting, no allocation.
* **tick sampling** — ``begin_tick`` arms the handles on every
  ``sample_every``-th tick only; an unarmed ``begin()`` returns 0.0 and
  ``end(0.0)`` is a no-op, so the unsampled cost is one attribute read
  and a float compare.
* **timeline** — sampled ticks append one per-stage-microseconds row to
  a bounded ring, the raw material for a paper-style stage-breakdown
  plot over time.

Obs-off code paths hold :data:`NULL_HANDLE` / :data:`NULL_TRACER`
(null-object singletons) so instrumented call sites never branch on
"is obs enabled".

On the card every stage is timed with the host clock and never waits for
the device: around an asynchronous launch (``filter_probe``,
``dispatch``) a stage measures the host's launch path, not the kernels.
The device's share shows in ``compute`` (dispatch to retire, the span a
batch is in flight) and in ``value_fetch`` (the exposed wait that joins
the device-to-host copy and the value reads).
"""

from __future__ import annotations

import time
from collections import deque

__all__ = ["EventLog", "NullTracer", "StageHandle", "StageTracer",
           "NULL_HANDLE", "NULL_TRACER"]

_now = time.perf_counter


class StageHandle:
    """Pre-bound timer for one stage.  ``begin`` returns a start stamp
    (0.0 when the tracer is not sampling this tick — ``end`` then
    no-ops), so cross-tick spans survive the sampling state changing
    between begin and end."""

    __slots__ = ("_tracer", "name", "hist", "count", "total_us", "tick_us")

    def __init__(self, tracer: "StageTracer", name: str, hist) -> None:
        self._tracer = tracer
        self.name = name
        self.hist = hist
        self.count = 0          # sampled observations
        self.total_us = 0.0     # sampled microseconds
        self.tick_us = 0.0      # accumulator drained by end_tick

    def begin(self) -> float:
        return _now() if self._tracer._on else 0.0

    def end(self, t0: float) -> None:
        if t0:
            dt = (_now() - t0) * 1e6
            self.count += 1
            self.total_us += dt
            self.tick_us += dt
            self.hist.observe(dt)


class StageTracer:
    def __init__(self, registry, sample_every: int = 4,
                 timeline_ticks: int = 512,
                 family: str = "server_stage_us") -> None:
        self._registry = registry
        self._family = family
        self.sample_every = max(int(sample_every), 1)
        self._on = False
        self._n = 0
        self._stages: dict[str, StageHandle] = {}
        self._timeline: deque = deque(maxlen=int(timeline_ticks))
        self.ticks_seen = 0
        self.sampled_ticks = 0

    def stage(self, name: str) -> StageHandle:
        """Pre-bind a handle for ``name`` (get-or-create).  Call once at
        construction time, never per batch."""
        h = self._stages.get(name)
        if h is None:
            hist = self._registry.histogram(self._family, stage=name)
            h = self._stages[name] = StageHandle(self, name, hist)
        return h

    def begin_tick(self) -> int:
        """Arm (or disarm) the handles for this tick; returns the tick
        index to hand back to :meth:`end_tick`."""
        self._on = self._n % self.sample_every == 0
        self._n += 1
        self.ticks_seen += 1
        if self._on:
            self.sampled_ticks += 1
        return self.ticks_seen - 1

    def end_tick(self, tick: int) -> None:
        if not self._on:
            return
        row = {"tick": int(tick)}
        nonzero = False
        for name, h in self._stages.items():
            if h.tick_us:
                row[name] = round(h.tick_us, 3)
                h.tick_us = 0.0
                nonzero = True
        if nonzero:
            self._timeline.append(row)

    def timeline(self) -> list[dict]:
        """Sampled per-tick stage breakdown rows, oldest first."""
        return list(self._timeline)


class _NullHandle:
    """Obs-off stand-in: same interface, zero state, no branches at the
    call site."""

    __slots__ = ()

    def begin(self) -> float:
        return 0.0

    def end(self, t0: float) -> None:
        pass


class NullTracer:
    __slots__ = ()
    _on = False

    def stage(self, name: str) -> _NullHandle:
        return NULL_HANDLE

    def begin_tick(self) -> int:
        return 0

    def end_tick(self, tick: int) -> None:
        pass

    def timeline(self) -> list:
        return []


NULL_HANDLE = _NullHandle()
NULL_TRACER = NullTracer()


class EventLog:
    """Bounded log of maintenance-plane events (learn / GC / checkpoint),
    each carrying the CBA cost/benefit estimates that drove the decision
    — the paper's §4.4 inputs, made observable."""

    def __init__(self, cap: int = 1024) -> None:
        self._events: deque = deque(maxlen=int(cap))
        self.total = 0
        # optional ambient-context hook (set by Obs): a callable
        # returning fields merged under every entry — the serving stack
        # stamps `tick` and `trace_id` so a GC/learn/checkpoint decision
        # correlates with the causal spans of the tick it ran in
        self.stamp = None

    def log(self, kind: str, **fields) -> None:
        if self.stamp is None:
            self._events.append({"kind": kind, **fields})
        else:
            self._events.append({"kind": kind, **self.stamp(), **fields})
        self.total += 1

    def tail(self, n: int | None = None) -> list[dict]:
        ev = list(self._events)
        return ev if n is None else ev[-n:]

    def __len__(self) -> int:
        return len(self._events)
