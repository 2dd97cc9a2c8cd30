"""Straggler detection: a copy of the reference's
``repro.runtime.fault.StragglerMonitor``.

The mixer watches every decode step's wall time with it; a flagged step
lands in the metrics snapshot and, as an unstable event, in the trace.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA-based step-time anomaly detection.

    A step slower than ``threshold × ewma`` is flagged; persistent flags on
    the same host indicate a straggler (in multi-host: compare per-host
    timings via an all-gather of wall-times — here single-host, we track the
    global step time and expose the cordon signal)."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 5
    ewma: float = 0.0
    n: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            self.ewma = dt if self.ewma == 0 else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow

    def should_remesh(self, window: int = 20, tolerance: int = 5) -> bool:
        """Persistent straggling → cordon + elastic re-mesh."""
        recent = [s for s, _, _ in self.flagged[-tolerance:]]
        return len(recent) >= tolerance and \
            (recent[-1] - recent[0]) <= window
