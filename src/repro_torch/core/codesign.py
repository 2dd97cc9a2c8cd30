"""Codesign bridge — compatibility shim.

The DSE → kernel translation grew into the execution-plane subsystem at
:mod:`repro_torch.exec.plans` (whole-model :class:`~repro_torch.exec.plans.ExecPlan`\\ s,
JSON round-trip, structured fallbacks); this module keeps the original
import surface (``KernelChoice`` / ``CompressionPlan`` / ``ffn_workload`` /
``plan_for_model``) alive for existing callers.
"""

from __future__ import annotations

from repro_torch.exec.plans import (MXU_ALIGN, CompressionPlan, FallbackReason,
                                    KernelChoice, ffn_workload, plan_for_model,
                                    translate)

# the seed's private name, kept for callers that reached into it
_translate = translate

__all__ = ["MXU_ALIGN", "CompressionPlan", "FallbackReason", "KernelChoice",
           "ffn_workload", "plan_for_model", "translate"]
