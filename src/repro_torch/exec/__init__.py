"""Execution plane: plans (read from JSON) → pruned, compressed weights →
a served model whose planned projections run the CUDA kernels."""

from repro_torch.exec.compress import (CompressedStore, CompressedTensor,
                                       compress_params, prune_params)
from repro_torch.exec.dispatch import (CompressedModel, OpCounters,
                                       instrument, kernel_guard)
from repro_torch.exec.plans import (PLAN_VERSION, ExecPlan, FallbackReason,
                                    KernelChoice, OpPlan, PlanMismatchError,
                                    PlanVersionError, load_plan,
                                    shipped_plan)

__all__ = [
    "CompressedStore", "CompressedTensor", "compress_params", "prune_params",
    "CompressedModel", "OpCounters", "instrument", "kernel_guard",
    "PLAN_VERSION", "ExecPlan", "FallbackReason", "KernelChoice", "OpPlan",
    "PlanMismatchError", "PlanVersionError", "load_plan", "shipped_plan",
]
