"""Serving-runtime reporting: the per-request :class:`HealthReport`
(:mod:`repro_torch.runtime.guard`) and the decode-step
:class:`StragglerMonitor` (:mod:`repro_torch.runtime.fault`)."""

from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.runtime.guard import HealthReport

__all__ = ["HealthReport", "StragglerMonitor"]
