"""Opt-in profiling hooks: a ``torch.profiler`` capture and kernel-dispatch
timing, the counterparts of the reference's ``repro.obs.profile``.

Both are off by default and free when off:

  * :func:`torch_trace` — wraps a region in a ``torch.profiler`` capture
    written into ``log_dir`` (a Chrome trace, ``trace-<pid>.json``; the
    reference's ``jax_trace`` writes TensorBoard artifacts).  A no-op when
    ``log_dir`` is falsy; a profiler that cannot start is skipped, so
    serving never fails because profiling could not start.  Errors of the
    profiled region itself propagate.
  * :func:`kernel_timer` — installs a
    :func:`repro_torch.kernels.ops.kernel_dispatch_hook` that records every
    kernel dispatch into the metrics registry
    (``kernel_dispatch_total{kind=}`` counter, ``kernel_dispatch_seconds``
    histogram) and as ``kernel:<kind>`` ``X`` events in the trace.  A hook
    keeps the decode step eager
    (:func:`repro_torch.exec.dispatch.serves_eagerly`), so it records
    every executed dispatch, where the reference's records once per jit
    trace.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
from typing import Iterator, Optional

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the region (CPU, and CUDA
    where a card is present) into ``log_dir``/``trace-<pid>.json``; a
    no-op when ``log_dir`` is None or empty."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    except Exception:  # noqa: BLE001 — profiling is best-effort by contract
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                path = pathlib.Path(log_dir)
                path.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(path / f"trace-{os.getpid()}.json"))
            except Exception:  # noqa: BLE001
                pass


def annotation(name: str):
    """A ``torch.profiler.record_function`` naming a region inside a
    :func:`torch_trace` capture."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def kernel_timer(registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer: Optional[_trace.Tracer] = None) -> Iterator[None]:
    """Record every kernel dispatch while active.

    ``registry`` / ``tracer`` default to the ambient ones at dispatch
    time.  Trace events are complete (``X``) events named
    ``kernel:<kind>``, marked unstable (timing-derived), so
    :meth:`~repro_torch.obs.trace.Tracer.stable_trace` leaves them out.

    On the CPU the seconds are the dispatch's host seconds, as the
    reference's.  On a CUDA tensor they are device seconds: the dispatch
    records a CUDA event pair around the launch and nothing waits for it;
    the counter counts at once, and when the context exits the events are
    read in one pass (the first read waits for the device, the others
    find their events passed), each X event's ``dur`` is set
    to its device time (its ``ts`` stays the host's launch time) and the
    histogram observes it."""
    from repro_torch.kernels import ops as kops
    pending: list[tuple] = []          # (registry, event dict, kind, pair)

    def hook(kind: str, dt) -> None:
        reg = registry if registry is not None else \
            _metrics.current_metrics()
        tr = tracer if tracer is not None else _trace.current_tracer()
        if reg is not None:
            reg.counter_inc("kernel_dispatch_total", 1.0, kind=kind)
        ev = None
        if tr is not None:
            tr.complete(f"kernel:{kind}",
                        0.0 if isinstance(dt, tuple) else dt,
                        {"kind": kind}, stable=False)
            ev = tr.events[-1]
        if isinstance(dt, tuple):
            pending.append((reg, ev, kind, dt))
        elif reg is not None:
            reg.observe("kernel_dispatch_seconds", dt, kind=kind)

    try:
        with kops.kernel_dispatch_hook(hook, device_events=True):
            yield
    finally:
        for reg, ev, kind, (start, end) in pending:
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
            if reg is not None:
                reg.observe("kernel_dispatch_seconds", dt, kind=kind)
            if ev is not None:
                ev["dur"] = dt
