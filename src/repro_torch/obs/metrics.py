"""Metrics registry: named counters / gauges / histograms, one snapshot.

A copy of the reference's ``repro.obs.metrics`` registry (standard library
only; the port imports nothing of the reference).  Live metrics flow in
through the ambient registry (installed with :func:`collecting`; the
module-level :func:`counter_inc` / :func:`gauge_set` / :func:`observe` are
no-ops when none is — the same zero-cost-when-off contract as
:mod:`repro_torch.obs.trace`), and the ``ingest_*`` adapters fold a
:class:`~repro_torch.runtime.fault.StragglerMonitor` and a per-request
:class:`~repro_torch.runtime.guard.HealthReport` into the same registry
without touching their source of truth, as do
:func:`ingest_instrument` (the dispatcher's per-role traffic counters) and
:func:`ingest_kernel_cache` (the loaded-library cache).  The reference's
memo registry has no source in the port yet, so :func:`collect_caches`
folds the kernel cache alone.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-able dict, saved with
:meth:`save`) and :meth:`MetricsRegistry.prometheus_text` (Prometheus
text exposition format — ``# TYPE`` headers, ``name{label="v"} value``
samples, ``_bucket``/``_sum``/``_count`` histogram series).

Metric-name conventions: counters end in ``_total``, histograms in their
unit (``_seconds``); label keys are plain identifiers.  The serving
counters (``serve_tokens_generated_total``, ``serve_fallbacks_total{code=}``,
``mixer_evictions_total{reason=}`` …) are the reference's.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from typing import Iterator, Optional, Sequence


# decode-step / dispatch latencies land between 100us and seconds on the
# configs this repo serves; buckets are seconds
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _series_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


def _series_str(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _prom_label_value(v) -> str:
    s = str(v)
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class MetricsRegistry:
    """Counters, gauges and histograms keyed by (name, sorted labels).

    A name belongs to exactly one metric type — re-registering it as
    another raises (the registry is the schema).  Counters only go up;
    histograms bucket against a per-name bucket tuple fixed at first
    observation."""

    def __init__(self) -> None:
        self._types: dict[str, str] = {}
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, dict] = {}
        self._hist_buckets: dict[str, tuple] = {}

    def _check_type(self, name: str, kind: str) -> None:
        have = self._types.setdefault(name, kind)
        if have != kind:
            raise ValueError(f"metric {name!r} is a {have}, not a {kind}")

    # -- recording -----------------------------------------------------------
    def counter_inc(self, name: str, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r}: counters only go up "
                             f"(got {value})")
        self._check_type(name, "counter")
        k = _series_key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **labels) -> None:
        self._check_type(name, "gauge")
        self._gauges[_series_key(name, labels)] = float(value)

    def observe(self, name: str, value: float,
                buckets: Optional[Sequence[float]] = None, **labels) -> None:
        self._check_type(name, "histogram")
        bks = self._hist_buckets.setdefault(
            name, tuple(buckets) if buckets is not None else DEFAULT_BUCKETS)
        k = _series_key(name, labels)
        h = self._hists.get(k)
        if h is None:
            h = self._hists[k] = {"counts": [0] * (len(bks) + 1),
                                  "sum": 0.0, "count": 0}
        h["counts"][bisect.bisect_left(bks, value)] += 1
        h["sum"] += float(value)
        h["count"] += 1

    # -- reading -------------------------------------------------------------
    def value(self, name: str, **labels) -> float:
        """Current value of one counter/gauge series (KeyError if absent)."""
        k = _series_key(name, labels)
        if name in self._types and self._types[name] == "gauge":
            return self._gauges[k]
        return self._counters[k]

    def total(self, name: str) -> float:
        """Sum of a counter's series across all label values (0 if none)."""
        return sum(v for (n, _), v in self._counters.items() if n == name)

    def series(self, name: str) -> dict[tuple, float]:
        """All ``{sorted-label-items: value}`` series of a counter/gauge."""
        src = self._gauges if self._types.get(name) == "gauge" \
            else self._counters
        return {labels: v for (n, labels), v in src.items() if n == name}

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able state: every series, deterministically ordered."""
        hists = {}
        for k in sorted(self._hists):
            name = k[0]
            bks = self._hist_buckets[name]
            h = self._hists[k]
            hists[_series_str(k)] = {
                "buckets": {**{str(b): c for b, c in
                               zip(bks, h["counts"])},
                            "+Inf": h["counts"][-1]},
                "sum": h["sum"], "count": h["count"]}
        return {"counters": {_series_str(k): self._counters[k]
                             for k in sorted(self._counters)},
                "gauges": {_series_str(k): self._gauges[k]
                           for k in sorted(self._gauges)},
                "histograms": hists}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []

        def fmt(name: str, labels: tuple, value, extra: dict = ()) -> str:
            items = list(labels) + list(dict(extra).items())
            if not items:
                return f"{name} {value}"
            inner = ",".join(f'{k}="{_prom_label_value(v)}"'
                             for k, v in items)
            return f"{name}{{{inner}}} {value}"

        for name in sorted(self._types):
            kind = self._types[name]
            lines.append(f"# TYPE {name} {kind}")
            if kind == "counter":
                for k in sorted(s for s in self._counters if s[0] == name):
                    lines.append(fmt(name, k[1], self._counters[k]))
            elif kind == "gauge":
                for k in sorted(s for s in self._gauges if s[0] == name):
                    lines.append(fmt(name, k[1], self._gauges[k]))
            else:
                bks = self._hist_buckets[name]
                for k in sorted(s for s in self._hists if s[0] == name):
                    h = self._hists[k]
                    cum = 0
                    for b, c in zip(bks, h["counts"]):
                        cum += c
                        lines.append(fmt(f"{name}_bucket", k[1], cum,
                                         {"le": b}))
                    lines.append(fmt(f"{name}_bucket", k[1], h["count"],
                                     {"le": "+Inf"}))
                    lines.append(fmt(f"{name}_sum", k[1], h["sum"]))
                    lines.append(fmt(f"{name}_count", k[1], h["count"]))
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Ambient registry (same pattern as obs.trace's ambient tracer)
# ---------------------------------------------------------------------------

_METRICS: Optional[MetricsRegistry] = None


def current_metrics() -> Optional[MetricsRegistry]:
    return _METRICS


@contextlib.contextmanager
def collecting(registry: Optional[MetricsRegistry] = None
               ) -> Iterator[MetricsRegistry]:
    """Install ``registry`` (or a fresh one) as the ambient registry."""
    global _METRICS
    prev = _METRICS
    reg = registry if registry is not None else MetricsRegistry()
    _METRICS = reg
    try:
        yield reg
    finally:
        _METRICS = prev


def counter_inc(name: str, value: float = 1.0, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.counter_inc(name, value, **labels)


def gauge_set(name: str, value: float, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.gauge_set(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    m = _METRICS
    if m is not None:
        m.observe(name, value, **labels)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------

def ingest_instrument(reg: MetricsRegistry, counters: dict) -> None:
    """Fold :func:`repro_torch.exec.dispatch.instrument` per-role traffic
    counters in, one labelled series per role — values equal the
    ``OpCounters`` fields exactly."""
    for role in sorted(counters):
        c = counters[role]
        reg.counter_inc("exec_dispatch_calls_total", c.calls, role=role)
        reg.counter_inc("exec_w_fetch_bits_total", c.w_fetch_bits, role=role)
        reg.counter_inc("exec_w_distinct_bits_total", c.w_distinct_bits,
                        role=role)
        reg.counter_inc("exec_w_stream_bits_total", c.w_stream_bits,
                        role=role)
        reg.counter_inc("exec_x_bits_total", c.x_bits, role=role)
        reg.counter_inc("exec_y_bits_total", c.y_bits, role=role)
        reg.counter_inc("exec_macs_total", c.macs, role=role)
        reg.counter_inc("exec_decode_ops_total", c.decode_ops, role=role)
        reg.gauge_set("exec_refetch_factor", c.refetch_factor, role=role)


def ingest_kernel_cache(reg: MetricsRegistry,
                        stats: Optional[dict] = None) -> None:
    """Fold the loaded-library cache counters in
    (:func:`repro_torch.kernels.ops.kernel_cache_stats`)."""
    if stats is None:
        from repro_torch.kernels import ops as kops
        stats = kops.kernel_cache_stats()
    reg.counter_inc("kernel_cache_hits_total", stats["hits"])
    reg.counter_inc("kernel_cache_misses_total", stats["misses"])
    reg.gauge_set("kernel_cache_entries", stats["entries"])


def collect_caches(reg: MetricsRegistry) -> None:
    """Ingest the global cache sources: the kernel cache (the reference
    folds its memo registry too, which the port has not yet)."""
    ingest_kernel_cache(reg)


def ingest_straggler(reg: MetricsRegistry, monitor) -> None:
    """Fold a :class:`~repro_torch.runtime.fault.StragglerMonitor` in: the EWMA
    step time as a gauge, the flagged-spike count as a counter."""
    reg.gauge_set("straggler_ewma_seconds", monitor.ewma)
    reg.counter_inc("straggler_flagged_total", len(monitor.flagged))


def ingest_health(reg: MetricsRegistry, report) -> None:
    """Fold one request's :class:`~repro_torch.runtime.guard.HealthReport` in.

    The mixer calls this once per finished request, at its eviction, so
    ``serve_tokens_generated_total``
    equals the sum of ``report.steps`` over the run — the snapshot's
    counters exactly match the reports they came from."""
    reg.counter_inc("serve_requests_total")
    reg.counter_inc("serve_tokens_generated_total", report.steps)
    reg.counter_inc("serve_retries_total", report.retries)
    reg.counter_inc("serve_dense_steps_total", report.dense_steps)
    if report.deadline_hit:
        reg.counter_inc("serve_deadline_hits_total")
    if report.eos_hit:
        reg.counter_inc("serve_eos_hits_total")
    fc = report.fallback_counts()
    for code in sorted(fc):
        reg.counter_inc("serve_fallbacks_total", fc[code], code=code)
    for role in sorted(report.verify):
        if report.verify[role] != "ok":
            reg.counter_inc("serve_verify_failures_total", 1.0, role=role)
