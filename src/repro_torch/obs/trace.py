"""Span tracing for the serving plane — zero cost when off.

A copy of the reference's ``repro.obs.trace`` (standard library only; the
port imports nothing of the reference).  One ambient :class:`Tracer`
(installed with :func:`tracing`) collects an ordered stream of span
begin/end marks and instant events.  The module functions :func:`span` /
:func:`event` are the instrumentation surface the serving code calls: with
no tracer installed they resolve to a shared no-op (one ``None`` check —
the serving hot loops pay nothing).

Two exports, two purposes:

  * :meth:`Tracer.chrome_trace` — the Chrome trace-event JSON dialect
    (load the saved file in ``chrome://tracing`` or Perfetto): ``B``/``E``
    span pairs, ``i`` instants, ``X`` complete events, microsecond
    timestamps relative to the tracer's epoch.
  * :meth:`Tracer.stable_trace` — the deterministic projection: timings
    dropped, ordering and args kept, timing-derived events (recorded with
    ``stable=False``, e.g. straggler spikes) excluded.  Two runs of the
    same seeded stream produce IDENTICAL stable traces — the trace-plane
    analogue of :meth:`repro_torch.runtime.guard.HealthReport.stable_dict`
    — and a stream served by the port and by the reference produce the
    same one (``tests/test_torch_mixer.py``).

Request linkage: :func:`trace_id` mints the id a
:class:`~repro_torch.runtime.guard.HealthReport` carries in ``trace_id`` —
derived from the request id when there is one (``"t:req0"``), a tracer
counter otherwise — and every span/event belonging to that request carries
the same id in its args, so "why was request 417 slow" is one filter over
the trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Iterator, Optional


class Tracer:
    """Ordered in-memory trace collector.

    ``events`` is the raw record stream: dicts with ``ph`` (``"B"`` begin
    span / ``"E"`` end span / ``"i"`` instant / ``"X"`` complete),
    ``name``, ``ts`` (seconds since the tracer's epoch), ``args`` and —
    for ``"X"`` — ``dur``.  Span begin/end must nest strictly (LIFO);
    a mismatched :meth:`end` raises instead of silently corrupting the
    stream."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        self._stack: list[str] = []
        self._n_ids = 0

    # -- recording -----------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def begin(self, name: str, args: Optional[dict] = None) -> None:
        self.events.append({"ph": "B", "name": name, "ts": self._now(),
                            "args": dict(args or {})})
        self._stack.append(name)

    def end(self, name: str) -> None:
        if not self._stack or self._stack[-1] != name:
            open_ = self._stack[-1] if self._stack else None
            raise RuntimeError(f"span end {name!r} does not match the "
                               f"innermost open span {open_!r}")
        self._stack.pop()
        self.events.append({"ph": "E", "name": name, "ts": self._now(),
                            "args": {}})

    def instant(self, name: str, args: Optional[dict] = None,
                stable: bool = True) -> None:
        ev = {"ph": "i", "name": name, "ts": self._now(),
              "args": dict(args or {})}
        if not stable:
            ev["stable"] = False
        self.events.append(ev)

    def complete(self, name: str, dur_s: float,
                 args: Optional[dict] = None, stable: bool = True) -> None:
        """Record an already-finished region ending now (``dur_s`` long) —
        the shape hook-based timers produce (kernel dispatch)."""
        ev = {"ph": "X", "name": name, "ts": max(self._now() - dur_s, 0.0),
              "dur": dur_s, "args": dict(args or {})}
        if not stable:
            ev["stable"] = False
        self.events.append(ev)

    @property
    def depth(self) -> int:
        """Current span nesting depth (0 outside every span)."""
        return len(self._stack)

    def new_trace_id(self) -> str:
        """A fresh deterministic id (per-tracer counter, not wall-clock)."""
        self._n_ids += 1
        return f"t{self._n_ids:04d}"

    # -- export --------------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The trace as a ``chrome://tracing``-loadable document."""
        out = []
        for ev in self.events:
            row: dict[str, Any] = {"name": ev["name"], "ph": ev["ph"],
                                   "ts": round(ev["ts"] * 1e6, 3),
                                   "pid": 0, "tid": 0}
            if ev["ph"] == "X":
                row["dur"] = round(ev["dur"] * 1e6, 3)
            if ev["ph"] == "i":
                row["s"] = "t"
            if ev["args"]:
                row["args"] = ev["args"]
            out.append(row)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def stable_trace(self) -> list[dict]:
        """The deterministic projection: timings dropped, order and args
        kept, ``stable=False`` (timing-derived) events excluded."""
        return [{"ph": ev["ph"], "name": ev["name"], "args": ev["args"]}
                for ev in self.events if ev.get("stable", True)]

    def save_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    def save_stable(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.stable_trace(), f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Ambient tracer + the zero-cost instrumentation surface
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def current_tracer() -> Optional[Tracer]:
    return _TRACER


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Install ``tracer`` (or a fresh one) as the ambient tracer."""
    global _TRACER
    prev = _TRACER
    t = tracer if tracer is not None else Tracer()
    _TRACER = t
    try:
        yield t
    finally:
        _TRACER = prev


class _Null:
    """The shared no-op span (tracing off)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("_t", "_name")

    def __init__(self, tracer: Tracer, name: str, args: dict) -> None:
        self._t = tracer
        self._name = name
        tracer.begin(name, args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._t.end(self._name)
        return False


def span(name: str, **args):
    """Context manager marking a span; a shared no-op when tracing is off.

    The span BEGINS at the call (not at ``__enter__``), so exceptions
    between construction and entry still nest correctly in practice —
    always use it as ``with span(...):``."""
    t = _TRACER
    if t is None:
        return _NULL
    return _Span(t, name, args)


def event(name: str, stable: bool = True, **args) -> None:
    """Record an instant event; no-op when tracing is off.  Pass
    ``stable=False`` for timing-derived events (straggler spikes) that
    must not appear in :meth:`Tracer.stable_trace`."""
    t = _TRACER
    if t is not None:
        t.instant(name, args, stable=stable)


def trace_id(request_id: Optional[str] = None) -> Optional[str]:
    """The id linking a request's :class:`HealthReport` to its spans.

    Deterministic: derived from ``request_id`` when given (``"t:req0"``),
    a per-tracer counter otherwise.  ``None`` when tracing is off — so
    ``HealthReport.stable_dict`` stays byte-identical for untraced runs."""
    t = _TRACER
    if t is None:
        return None
    return f"t:{request_id}" if request_id is not None else t.new_trace_id()
