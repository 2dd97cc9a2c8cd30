"""Measured-vs-predicted calibration loop.

Closes the loop the analytical co-search leaves open: run the plan's
compressed model under :func:`repro_torch.exec.dispatch.instrument`,
compare the EXACT per-role fetched bits against the cost model's expected
fetch terms (:class:`~repro_torch.exec.plans.OpPlan`
``predicted_w_fetch_bits``), fit a
per-:class:`~repro_torch.core.arch.HardwareConfig` energy-coefficient
scalar by least squares, and re-run the search with the calibrated hardware to report
prediction drift.

Why predictions drift: the search's statistical sparsity model may not
match the realized weights — e.g. i.i.d. ``Bernoulli`` predicts near-dense
bitmap payloads (any large block is almost surely non-empty) while block
pruning clusters zeros into whole blocks, so measured traffic comes in at
~the block density.  Calibration absorbs the aggregate mismatch into the
DRAM energy coefficient (the per-bit cost the search actually ranks
designs by); a model-aware spec (``BlockBernoulli``) makes the fit scale
≈ 1 and the residuals collapse.

The fit is PER LEVEL: distinct fetches (first pass over the payload) fit
the DRAM coefficient as before, while the refetch residual — total
streamed bits minus distinct bits, i.e. the passes the streaming pipeline
re-issues per output stripe — fits the GLB coefficient
(:func:`fit_glb_scale`).  A systematic gap between the searched tile's
refetch factor and the kernel's realized ``M / tile_M`` passes shows up
as exactly this residual, which is what the drift report surfaces.

Counter provenance: the port's :func:`~repro_torch.exec.dispatch.instrument`
counts every EXECUTED dispatch (the reference counts one per jit trace),
so the per-call means compared here are the same either way.  The
distinct side (payload + metadata of one pass) is a size of the store and
fits as the reference's does.  The stream side counts the passes the CUDA
kernels' grids make over the payload (``stream_passes`` of
:mod:`repro_torch.kernels.bitmap_spmm` / :mod:`~.nm_spmm`), where the
reference counts its TPU grid's ``M / tile_M``: at decode both are one
pass, at prefill they differ, and so does :func:`fit_glb_scale`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.arch import HardwareConfig
from repro_torch.core.cosearch import CoSearchConfig
from repro_torch.exec.dispatch import OpCounters
from repro_torch.exec.plans import ExecPlan, build_exec_plan
from repro_torch.obs import trace as otr


@dataclasses.dataclass(frozen=True)
class CalibRow:
    """One role's measured-vs-predicted W-side fetch comparison (bits per
    full pass over the weight).

    The ``*_stream_bits`` pair covers the memory pipeline's second level:
    TOTAL payload bits streamed across all output-stripe passes (measured
    by ``OpCounters.w_stream_bits``; predicted as distinct fetch × the
    mapping's tile-reuse refetch factor).  ``stream − distinct`` is the
    refetch residual the GLB coefficient is fitted on."""

    role: str
    kind: str
    measured_bits: float
    predicted_bits: float
    measured_stream_bits: float = 0.0
    predicted_stream_bits: float = 0.0

    @property
    def rel_err(self) -> float:
        if self.predicted_bits == 0.0:
            return 0.0
        return self.measured_bits / self.predicted_bits - 1.0

    def residual(self, scale: float) -> float:
        """Relative error after scaling predictions by ``scale``."""
        p = self.predicted_bits * scale
        return self.measured_bits / p - 1.0 if p else 0.0

    @property
    def measured_refetch_bits(self) -> float:
        """Measured bits re-streamed BEYOND the first (distinct) pass."""
        return max(self.measured_stream_bits - self.measured_bits, 0.0)

    @property
    def predicted_refetch_bits(self) -> float:
        return max(self.predicted_stream_bits - self.predicted_bits, 0.0)

    @property
    def stream_rel_err(self) -> float:
        if self.predicted_stream_bits == 0.0:
            return 0.0
        return self.measured_stream_bits / self.predicted_stream_bits - 1.0

    def refetch_residual(self, glb_scale: float) -> float:
        """Relative refetch-bits error after the GLB fit."""
        p = self.predicted_refetch_bits * glb_scale
        return self.measured_refetch_bits / p - 1.0 if p else 0.0


def compare(plan: ExecPlan, counters: dict[str, OpCounters]
            ) -> list[CalibRow]:
    """Join measured per-call counters with the plan's predicted terms."""
    rows = []
    for op in plan.ops:
        c = counters.get(op.role)
        if c is None or not c.calls:
            continue
        rows.append(CalibRow(
            role=op.role, kind=op.choice.kind,
            measured_bits=c.w_fetch_bits_per_call,
            predicted_bits=op.predicted_w_fetch_bits,
            measured_stream_bits=c.w_stream_bits_per_call,
            predicted_stream_bits=op.predicted_w_stream_bits))
    return rows


def fit_scale(rows: Sequence[CalibRow]) -> float:
    """Least-squares scalar s minimizing Σ (s·predicted − measured)²."""
    num = sum(r.predicted_bits * r.measured_bits for r in rows)
    den = sum(r.predicted_bits ** 2 for r in rows)
    return num / den if den else 1.0


def fit_glb_scale(rows: Sequence[CalibRow]) -> float:
    """Least-squares scalar on the REFETCH residual (stream − distinct).

    Re-fetched passes are what the on-chip level absorbs under the
    streaming pipeline (the cost model's reuse term), so the measured/
    predicted refetch ratio folds into the GLB coefficient — separately
    from :func:`fit_scale`'s distinct-fetch DRAM fit.  With no refetch on
    either side (single-pass mappings) the fit is the identity."""
    num = sum(r.predicted_refetch_bits * r.measured_refetch_bits
              for r in rows)
    den = sum(r.predicted_refetch_bits ** 2 for r in rows)
    return num / den if den else 1.0


def calibrated_hardware(arch: HardwareConfig, scale: float,
                        glb_scale: float = 1.0) -> HardwareConfig:
    """``arch`` with its DRAM (and optionally GLB) energy coefficients
    scaled by the fits.

    ``scale`` folds the measured/predicted DISTINCT-fetch traffic ratio
    into the per-bit DRAM cost; ``glb_scale`` folds the refetch-residual
    ratio into the per-bit GLB cost — so the search's energy objective
    ranks candidates by what the execution plane will actually move at
    each level."""
    dram = arch.levels[0]
    dram = dataclasses.replace(
        dram,
        pj_per_bit_read=dram.pj_per_bit_read * scale,
        pj_per_bit_write=dram.pj_per_bit_write * scale)
    levels = (dram,) + arch.levels[1:]
    name = f"{arch.name}+cal{scale:.3g}"
    if glb_scale != 1.0:
        glb = dataclasses.replace(
            levels[1],
            pj_per_bit_read=levels[1].pj_per_bit_read * glb_scale,
            pj_per_bit_write=levels[1].pj_per_bit_write * glb_scale)
        levels = (levels[0], glb) + levels[2:]
        name += f"+glb{glb_scale:.3g}"
    return dataclasses.replace(arch, name=name, levels=levels)


@dataclasses.dataclass
class CalibrationReport:
    """The full loop's outcome: fit quality + re-search drift."""

    rows: list[CalibRow]
    scale: float                    # fitted energy-coefficient scalar
    max_rel_err: float              # worst |measured/predicted − 1| pre-fit
    max_residual: float             # worst residual AFTER applying the fit
    baseline_energy: float          # Σ predicted op energy, original arch
    calibrated_energy: float        # same under the calibrated arch re-search
    calibrated_plan: ExecPlan
    kinds_changed: dict[str, tuple[str, str]]   # role → (before, after)
    glb_scale: float = 1.0          # fitted GLB scalar (refetch residual)
    max_stream_rel_err: float = 0.0   # worst stream-bits error pre-fit
    max_refetch_residual: float = 0.0   # worst refetch residual AFTER fit

    @property
    def energy_drift(self) -> float:
        """Relative predicted-energy change after calibration."""
        if self.baseline_energy == 0.0:
            return 0.0
        return self.calibrated_energy / self.baseline_energy - 1.0


def calibrate(cfg: ModelConfig, plan: ExecPlan,
              counters: dict[str, OpCounters],
              search_cfg: Optional[CoSearchConfig] = None
              ) -> CalibrationReport:
    """Fit the energy coefficient and re-run the search calibrated.

    ``plan`` must have been built for ``cfg``; ``counters`` come from a
    :func:`repro_torch.exec.dispatch.instrument` run of its compressed model.
    The re-search reuses the plan's own workload knobs (tokens,
    activation density, value width)."""
    with otr.span("calibrate", arch=plan.arch, roles=len(plan.ops)):
        with otr.span("calibrate.compare"):
            rows = compare(plan, counters)
        if not rows:
            raise ValueError("no measured counters overlap the plan's roles")
        with otr.span("calibrate.fit", rows=len(rows)):
            scale = fit_scale(rows)
            glb_scale = fit_glb_scale(rows)
        otr.event("calibrate.fitted", scale=round(scale, 6),
                  glb_scale=round(glb_scale, 6))
        # plan.hardware() already carries the plan's own scales, so repeated
        # calibration rounds compose multiplicatively at both levels
        arch_cal = calibrated_hardware(plan.hardware(), scale,
                                       glb_scale=glb_scale)
        with otr.span("calibrate.research"):
            plan_cal = build_exec_plan(cfg, plan.sparsity, tokens=plan.tokens,
                                       act_density=plan.act_density,
                                       hardware=arch_cal,
                                       search_cfg=search_cfg,
                                       value_bits=plan.value_bits)
        # keep the BASE arch name (resolvable through arch_by_name after a
        # JSON round trip) + the composed scales on the plan itself
        plan_cal = dataclasses.replace(
            plan_cal, arch=plan.arch, energy_scale=plan.energy_scale * scale,
            glb_energy_scale=plan.glb_energy_scale * glb_scale)
    changed = {}
    for op in plan.ops:
        after = plan_cal.for_role(op.role)
        if after.choice.kind != op.choice.kind:
            changed[op.role] = (op.choice.kind, after.choice.kind)
    return CalibrationReport(
        rows=rows, scale=scale,
        max_rel_err=max(abs(r.rel_err) for r in rows),
        max_residual=max(abs(r.residual(scale)) for r in rows),
        baseline_energy=sum(op.predicted_energy for op in plan.ops),
        calibrated_energy=sum(op.predicted_energy for op in plan_cal.ops),
        calibrated_plan=plan_cal,
        kinds_changed=changed,
        glb_scale=glb_scale,
        max_stream_rel_err=max(abs(r.stream_rel_err) for r in rows),
        max_refetch_residual=max(abs(r.refetch_residual(glb_scale))
                                 for r in rows))
