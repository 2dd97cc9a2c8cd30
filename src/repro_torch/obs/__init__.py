"""Serving telemetry: span tracing and a metrics registry, zero cost when
off and deterministic where they must be.

  * :mod:`repro_torch.obs.trace` — span API (``span(...)`` context
    manager + ``event(...)`` instant marks) wired through the mixer and
    the serving loop; exports Chrome trace-event JSON and a
    deterministic ``stable_trace`` projection.
  * :mod:`repro_torch.obs.metrics` — named counters / gauges / histograms
    with adapters over :class:`~repro_torch.runtime.fault.StragglerMonitor`
    and :class:`~repro_torch.runtime.guard.HealthReport`, the dispatch
    counters and the kernel cache; JSON + Prometheus text exposition
    exports.
  * :mod:`repro_torch.obs.profile` — an opt-in ``torch.profiler`` capture
    and a per-kernel-dispatch timing hook (device seconds on the card).

Surfaced by the serve CLI's ``--trace PATH`` / ``--metrics PATH`` flags.
"""

from repro_torch.obs.metrics import (MetricsRegistry, collect_caches,
                                     collecting, current_metrics,
                                     ingest_health, ingest_instrument,
                                     ingest_kernel_cache, ingest_straggler)
from repro_torch.obs.profile import annotation, kernel_timer, torch_trace
from repro_torch.obs.trace import (Tracer, current_tracer, event, span,
                                   trace_id, tracing)

__all__ = [
    "MetricsRegistry", "Tracer", "annotation", "collect_caches",
    "collecting", "current_metrics", "current_tracer", "event",
    "ingest_health", "ingest_instrument", "ingest_kernel_cache",
    "ingest_straggler", "kernel_timer", "span", "torch_trace", "trace_id",
    "tracing",
]
