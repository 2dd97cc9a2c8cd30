"""The per-request health report: a copy of the reference's
``repro.runtime.guard.HealthReport``.

The mixer fills one per request (its id, trace id, steps, EOS or deadline
and the deadline's fallback, admission and decode seconds).  The guarded
serving path that fills the rest of it (store verification, retries,
dense degradation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class HealthReport:
    """Everything the guarded serving path observed for one request batch.

    ``fallbacks`` rows are ``{"role", "layer", "code", "detail"}`` with
    role ``"*"`` for whole-step events; ``verify`` maps each planned role
    to ``"ok"`` or the :class:`IntegrityError` reason.
    ``switched_to_dense_at`` is the decode position where the request
    degraded to the dense model (``-1`` = during prefill, ``None`` =
    never).  Under mixed traffic (:mod:`repro_torch.launch.mixer`) one report
    is produced PER REQUEST: ``request_id`` names it and ``eos_hit``
    records an EOS-terminated generation (``steps`` < ``gen`` with no
    deadline).  ``trace_id`` links the report to its spans in the active
    :class:`repro_torch.obs.trace.Tracer` (None when tracing was off — the id
    is deterministic, derived from the request id or a tracer counter).
    Timings are wall-clock seconds; everything else is deterministic for
    a fixed seed — :meth:`stable_dict` drops the timings so two runs can
    be diffed exactly, and :meth:`timings_dict` is the complementary
    projection (``stable_dict() | timings_dict() == to_dict()``)."""

    verify: dict = dataclasses.field(default_factory=dict)
    fallbacks: list = dataclasses.field(default_factory=list)
    retries: int = 0
    dense_steps: int = 0
    switched_to_dense_at: Optional[int] = None
    deadline_hit: bool = False
    eos_hit: bool = False
    steps: int = 0
    gen: int = 0
    request_id: Optional[str] = None
    trace_id: Optional[str] = None
    t_prefill_s: float = 0.0
    t_decode_s: float = 0.0
    t_total_s: float = 0.0

    def record_fallback(self, role: str, code: str, detail: str = "",
                        layer: Optional[int] = None) -> None:
        self.fallbacks.append({"role": role, "layer": layer,
                               "code": code, "detail": detail})

    def fallback_counts(self) -> dict[str, int]:
        """Occurrences by reason code (same shape as
        :meth:`ExecPlan.fallback_counts`)."""
        out: dict[str, int] = {}
        for fb in self.fallbacks:
            out[fb["code"]] = out.get(fb["code"], 0) + 1
        return out

    def fallback_reasons(self) -> list:
        """The fallbacks as plan-plane :class:`FallbackReason` values."""
        from repro_torch.exec.plans import FallbackReason
        return [FallbackReason(fb["code"], fb["detail"])
                for fb in self.fallbacks]

    @property
    def healthy(self) -> bool:
        """No fallbacks, no retries, nothing non-ok in verify."""
        return (not self.fallbacks and not self.retries
                and not self.deadline_hit
                and all(v == "ok" for v in self.verify.values()))

    @property
    def latency_per_token_s(self) -> float:
        return self.t_decode_s / self.steps if self.steps else 0.0

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    _TIMING_KEYS = ("t_prefill_s", "t_decode_s", "t_total_s")

    def stable_dict(self) -> dict:
        """The deterministic projection: everything except wall-clock."""
        out = self.to_dict()
        for k in self._TIMING_KEYS:
            del out[k]
        return out

    def timings_dict(self) -> dict:
        """The wall-clock half :meth:`stable_dict` drops, structured:
        ``stable_dict() | timings_dict()`` reconstructs :meth:`to_dict`
        exactly."""
        return {k: getattr(self, k) for k in self._TIMING_KEYS}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "HealthReport":
        return HealthReport(**d)

    @staticmethod
    def from_json(s: str) -> "HealthReport":
        return HealthReport.from_dict(json.loads(s))
