"""End-to-end observability plane (a copy of ``repro.obs``, whose
README.md describes it).

One :class:`Obs` bundle per serving stack: a labeled
:class:`MetricsRegistry` every layer reports into (collectors replace
the scattered ``stats()`` dicts at snapshot time), a sampling
:class:`StageTracer` timing the read-path stages through pre-bound
handles, and an :class:`EventLog` of maintenance decisions with their
CBA cost/benefit estimates.  ``Obs.snapshot()`` is the one call that
yields the whole fleet's metrics; exporters render it as JSON,
Prometheus text, or the per-tick stage timeline.
"""

from __future__ import annotations

import dataclasses

from .export import parse_prometheus, to_json, to_prometheus
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       publish_stats)
from .trace import (CausalTracer, NullCausalTracer, Span, TraceContext,
                    CRITICAL_STAGES, NULL_CTRACE, SPAN_NAMES)
from .tracer import (EventLog, NullTracer, StageHandle, StageTracer,
                     NULL_HANDLE, NULL_TRACER)

__all__ = ["CausalTracer", "Counter", "EventLog", "Gauge", "Histogram",
           "MetricsRegistry", "NullCausalTracer", "NullTracer", "Obs",
           "ObsConfig", "Span", "StageHandle", "StageTracer", "TraceContext",
           "CRITICAL_STAGES", "NULL_CTRACE", "NULL_HANDLE", "NULL_TRACER",
           "SPAN_NAMES", "parse_prometheus", "publish_stats", "to_json",
           "to_prometheus"]

# canonical read-path stage names (the §3-style decomposition the serve
# bench reports); layers pre-bind handles for exactly these
READ_STAGES = ("admission", "coalesce", "cache_probe", "filter_probe",
               "dispatch", "compute", "resolve", "value_fetch")


@dataclasses.dataclass
class ObsConfig:
    enabled: bool = True
    # time stages on every Nth server tick (1 = every tick); unsampled
    # ticks cost one attribute read per stage call
    sample_every: int = 4
    timeline_ticks: int = 512    # per-tick stage rows kept in the ring
    events_cap: int = 1024       # maintenance events kept
    # causal tracing: trace every Nth *request* end to end (0 disables;
    # unsampled requests cost one integer decrement at admission and one
    # identity test per downstream span site)
    trace_sample_every: int = 64
    trace_ring: int = 4096       # spans kept for export/describe_trace


class Obs:
    """The per-stack observability bundle: registry + tracer + causal
    tracer + events."""

    def __init__(self, cfg: ObsConfig | None = None) -> None:
        self.cfg = cfg if cfg is not None else ObsConfig()
        self.registry = MetricsRegistry()
        self.tracer = StageTracer(self.registry,
                                  sample_every=self.cfg.sample_every,
                                  timeline_ticks=self.cfg.timeline_ticks)
        self.ctrace = (CausalTracer(self.registry,
                                    sample_every=self.cfg.trace_sample_every,
                                    ring=self.cfg.trace_ring)
                       if self.cfg.trace_sample_every > 0 else NULL_CTRACE)
        self.events = EventLog(self.cfg.events_cap)
        # maintenance events correlate to the tick + causal trace they
        # ran under (satellite of the causal-tracing plane)
        self.events.stamp = self._stamp
        self.registry.register_collector("obs_self", self._collect)

    def _stamp(self) -> dict:
        return {"tick": self.tracer.ticks_seen,
                "trace_id": self.ctrace.active_tid()}

    def _collect(self, reg: MetricsRegistry) -> None:
        reg.counter("obs_events_total").observe_total(self.events.total)
        reg.counter("obs_ticks_seen_total").observe_total(
            self.tracer.ticks_seen)
        reg.counter("obs_sampled_ticks_total").observe_total(
            self.tracer.sampled_ticks)
        reg.counter("obs_traced_requests_total").observe_total(
            self.ctrace.traced_requests
            if self.ctrace is not NULL_CTRACE else 0)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def to_json(self) -> str:
        return to_json(self.snapshot())

    def to_prometheus(self) -> str:
        return to_prometheus(self.snapshot())

    def timeline(self) -> list[dict]:
        return self.tracer.timeline()

    def trace_events(self) -> dict:
        """Chrome trace-event / Perfetto JSON of the causal span ring."""
        return self.ctrace.to_trace_events()

    def describe_trace(self, tid: int) -> str:
        return self.ctrace.describe_trace(tid)
