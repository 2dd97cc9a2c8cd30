"""Serving-runtime robustness: integrity, fault injection, guarded decode.

  * :mod:`repro_torch.runtime.integrity` — payload checksums + structural
    invariants for the compressed store (:class:`IntegrityError`);
  * :mod:`repro_torch.runtime.inject`    — deterministic, seeded fault
    injection (bit flips, structural corruption, NaN poison, kernel
    failure);
  * :mod:`repro_torch.runtime.guard`     — the guarded serving path:
    verify → demote → retry → degrade to dense, reported as a
    :class:`HealthReport`;
  * :mod:`repro_torch.runtime.fault`     — step retry / straggler
    detection / elastic re-mesh primitives.
"""

from repro_torch.runtime.fault import (FailureEvent, StepGuard,
                                       StragglerMonitor, elastic_remesh)
from repro_torch.runtime.guard import (HealthReport, NonFiniteError,
                                       guarded_generate)
from repro_torch.runtime.integrity import (IntegrityError, checksum_store,
                                           verify, verify_report)

__all__ = [
    "FailureEvent", "StepGuard", "StragglerMonitor", "elastic_remesh",
    "HealthReport", "NonFiniteError", "guarded_generate",
    "IntegrityError", "checksum_store", "verify", "verify_report",
]
