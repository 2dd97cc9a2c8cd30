"""Execution plane: searched designs become running compressed models.

  * :mod:`repro_torch.exec.plans`     — whole-model :class:`ExecPlan`\\ s
    searched by :func:`build_exec_plan` (or read from JSON), round-trippable;
  * :mod:`repro_torch.exec.compress`  — apply a plan to a weight tree
    (bitmap / N:M / dense stores with exact achieved-ratio accounting);
  * :mod:`repro_torch.exec.dispatch`  — route the model's planned
    projections to the CUDA kernels per plan entry;
  * :mod:`repro_torch.exec.calibrate` — measured-vs-predicted traffic
    counters, least-squares energy-coefficient fitting, search re-run
    drift report.
"""

from repro_torch.exec.plans import (PLAN_VERSION, ExecPlan, FallbackReason,
                                    KernelChoice, OpPlan, PlanMismatchError,
                                    PlanVersionError, build_exec_plan,
                                    load_plan, model_workload, shipped_plan)
from repro_torch.exec.compress import (CompressedStore, CompressedTensor,
                                       compress_params, prune_params)
from repro_torch.exec.dispatch import (CompressedModel, OpCounters,
                                       instrument, kernel_guard)
from repro_torch.exec.calibrate import CalibrationReport, calibrate

__all__ = [
    "PLAN_VERSION", "ExecPlan", "FallbackReason", "KernelChoice", "OpPlan",
    "PlanMismatchError", "PlanVersionError", "build_exec_plan", "load_plan",
    "model_workload", "shipped_plan",
    "CompressedStore", "CompressedTensor", "compress_params", "prune_params",
    "CompressedModel", "OpCounters", "instrument", "kernel_guard",
    "CalibrationReport", "calibrate",
]
