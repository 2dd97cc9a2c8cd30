"""The device events of a CUDA-only ``torch.profiler`` trace, between
marker kernels.

On an H100 the profiler has returned traces without any event and traces
without their first kernel (about 1 in 100, now and then several in a
row; ``tools/trace_loss.py`` counts them), never a trace without a
kernel between two that it kept.  Late in a long process it has also
lost the first one to five events of every trace of a graphed decode
(``chip_smoke.py``'s serving phase, ten traces in a row, with or without
a 50 ms host wait after the trace starts).  So :func:`events` runs
``prelude()`` (work the trace may lose), two marker kernels
(``torch.cuda._sleep``'s spin kernel, about 0.5 ms each), ``fn()`` and a
third marker; :func:`between_markers` accepts a trace only when it holds
one or both leading markers, in a row, and ends with the trailing one:
a lost event is then told apart from a kernel that did not run.
:func:`traced` takes a trace again, after a pause, until one is
complete.

Used by ``chip_smoke.py`` (the kernels each naive call launches, the
decode step's device time) and the card tests; it needs a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Callable, NamedTuple, Optional

MARKER_CYCLES = 1_000_000          # about 0.5 ms at the H100's clock
MARKER = "spin_kernel"
LEADING = 2                        # markers before fn(); one after it
# the Chrome export's categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    name: str
    cat: str                       # one of DEVICE_CATS
    grid: tuple                    # a kernel's grid; () for a copy or set
    us: float                      # device duration


def events(fn: Callable[[], object], path: pathlib.Path,
           prelude: Optional[Callable[[], object]] = None) -> list[Event]:
    """Every device event of a CUDA-only trace of ``prelude()`` and the
    markers around ``fn()``, in time order.  The trace is exported to
    ``path`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if prelude is not None:
            prelude()
        for _ in range(LEADING):
            torch.cuda._sleep(MARKER_CYCLES)
        fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    path = pathlib.Path(path)
    prof.export_chrome_trace(str(path))
    try:
        raw = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return [Event(e["name"], e["cat"], tuple(e["args"].get("grid", ())),
                  float(e.get("dur", 0.0)))
            for e in sorted(raw, key=lambda e: e.get("ts", 0))
            if e.get("cat") in DEVICE_CATS]


def between_markers(evs: list[Event]) -> Optional[list[Event]]:
    """The events between the last leading marker and the trailing one,
    or None when the trace lost an event: it is complete only when it
    holds one or both leading markers in a row (the events before them
    may be lost), ends with the trailing marker and holds no other."""
    marks = [i for i, e in enumerate(evs) if MARKER in e.name]
    lead = marks[:-1]
    if not 1 <= len(lead) <= LEADING or marks[-1] != len(evs) - 1 \
            or lead != list(range(lead[0], lead[0] + len(lead))):
        return None
    return evs[lead[-1] + 1:-1]


def traced(fn: Callable[[], object], path: pathlib.Path, tries: int = 10,
           on_loss: Optional[Callable[[int, list[Event]], None]] = None,
           prelude: Optional[Callable[[], object]] = None) -> list[Event]:
    """:func:`between_markers` of the first complete trace of ``fn()``
    (after ``prelude()``, see :func:`events`); a trace that lost an event
    is reported to ``on_loss(attempt, events)`` and taken again after 50
    ms.  Raises after ``tries`` lossy traces in a row."""
    for attempt in range(tries):
        evs = events(fn, path, prelude)
        ran = between_markers(evs)
        if ran is not None:
            return ran
        if on_loss is not None:
            on_loss(attempt, evs)
        time.sleep(0.05)
    raise RuntimeError(f"{tries} profiler traces in a row lost an event")
