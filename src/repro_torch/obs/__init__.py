"""Serving telemetry: span tracing and a metrics registry, zero cost when
off and deterministic where they must be.

  * :mod:`repro_torch.obs.trace` — span API (``span(...)`` context
    manager + ``event(...)`` instant marks) wired through the mixer and
    the serving loop; exports Chrome trace-event JSON and a
    deterministic ``stable_trace`` projection.
  * :mod:`repro_torch.obs.metrics` — named counters / gauges / histograms
    with adapters over :class:`~repro_torch.runtime.fault.StragglerMonitor`
    and :class:`~repro_torch.runtime.guard.HealthReport`; JSON + Prometheus
    text exposition exports.
"""

from repro_torch.obs.metrics import (MetricsRegistry, collecting,
                                     current_metrics, ingest_health,
                                     ingest_straggler)
from repro_torch.obs.trace import (Tracer, current_tracer, event, span,
                                   trace_id, tracing)

__all__ = [
    "MetricsRegistry", "Tracer", "collecting", "current_metrics",
    "current_tracer", "event", "ingest_health", "ingest_straggler", "span",
    "trace_id", "tracing",
]
