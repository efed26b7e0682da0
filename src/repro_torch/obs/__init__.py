"""Deterministic observability: tick-stamped tracing + one metrics
registry (DESIGN.md §Observability).

``tracer.py``  — span/event records stamped with the engine's tick
clock and a global monotone sequence number; no wall clock unless a
clock is injected, so same-seed runs produce byte-identical traces.
``metrics.py`` — typed counter/gauge/histogram registry the serving
subsystems publish into; the legacy ``stats``/``summary()`` surfaces
are views over it.
``export.py``  — Chrome trace-event (Perfetto-loadable) JSON and
compact JSONL export, wired into ``--trace-out``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                               MetricsRegistry, StatsView, percentile)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer, TraceRecord

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "StatsView", "percentile", "NULL_TRACER", "NullTracer",
           "Tracer", "TraceRecord"]
