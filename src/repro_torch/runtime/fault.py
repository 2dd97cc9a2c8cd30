"""Fault tolerance, straggler detection and elastic re-meshing: a copy of
the reference's ``repro.runtime.fault``.

  * :class:`StepGuard` — bounded retry around an effectful step.  The
    guarded serving path (:mod:`repro_torch.runtime.guard`) runs every
    prefill / decode step through it and degrades to the dense model on
    exhaustion.  It retries non-finite logits (:class:`NonFiniteError`)
    and injected kernel faults only.  The reference retries every
    ``RuntimeError`` and ``OSError``; on the card those include a kernel
    that fails to build and every CUDA launch error (sticky, so a retry
    is futile), and a retry ending in the dense model would hide the
    kernel behind the plain matmul.  Such errors propagate.
  * :class:`StragglerMonitor` — per-step wall-time EWMA + spike
    detection; the mixer watches every decode step's wall time with it
    (a flagged step lands in the metrics snapshot and, as an unstable
    event, in the trace).
  * :func:`elastic_remesh` — given the surviving device count, proposes
    the largest (data × model) mesh that preserves the model axis (the
    TP degree must not change — the param layout depends on it) and
    shrinks data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.kernels.ops import KernelFault


class NonFiniteError(RuntimeError):
    """Logits came back NaN/Inf: a step failure the :class:`StepGuard`
    retries."""


@dataclasses.dataclass
class FailureEvent:
    step: int
    error: str
    action: str               # "retry" | "restore"


# what a StepGuard retries; anything else propagates at once
_RETRIED = (NonFiniteError, KernelFault)


@dataclasses.dataclass
class StepGuard:
    """Retry wrapper around an effectful step function.

    A :class:`NonFiniteError` or :class:`~repro_torch.kernels.ops.KernelFault`
    is retried up to ``max_retries`` times; after that ``on_restore`` runs
    and the step returns None (or, with no ``on_restore``, the exception
    propagates).  Any other exception propagates at once."""

    max_retries: int = 2
    on_restore: Optional[Callable[[], None]] = None
    events: list = dataclasses.field(default_factory=list)

    def run(self, step: int, fn: Callable[[], Any]) -> Any:
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except _RETRIED as e:
                if attempt < self.max_retries:
                    self.events.append(FailureEvent(step, repr(e), "retry"))
                    continue
                self.events.append(FailureEvent(step, repr(e), "restore"))
                if self.on_restore is not None:
                    self.on_restore()
                    return None
                raise
        return None


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


def elastic_remesh(n_devices: int, model_parallel: int,
                   pod_size: Optional[int] = None) -> tuple[int, ...]:
    """Largest legal mesh after losing nodes.

    TP degree is pinned (parameter layout); DP shrinks to the largest
    multiple that fits.  Returns (pod, data, model) or (data, model)."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot sustain TP={model_parallel}")
    data = n_devices // model_parallel
    if pod_size:
        pods = max(n_devices // pod_size, 1)
        data = (n_devices // pods) // model_parallel
        return (pods, data, model_parallel)
    return (data, model_parallel)


def replay_steps(last_ckpt_step: int, failed_step: int) -> range:
    """Steps to replay after restore — exact because a counter-based data
    pipeline is a pure function of the step index."""
    return range(last_ckpt_step, failed_step)
