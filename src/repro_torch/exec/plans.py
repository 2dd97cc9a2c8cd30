"""Execution plans: SnipSnap DSE decisions → whole-model kernel configs.

A copy of the JAX package's ``repro.exec.plans``: it generalizes the
original ``core/codesign.py`` bridge (one layer's FFN pair) into
:class:`ExecPlan`\\ s covering every per-layer projection of a
:class:`~repro_torch.configs.base.ModelConfig` — attention QKV/O, the FFN
triple, and MoE expert fan-out — so a co-search result can drive a
*running* compressed model (``repro_torch.exec.compress`` /
``repro_torch.exec.dispatch``).

Plans are plain data and JSON round-trippable (:meth:`ExecPlan.to_json` /
:meth:`ExecPlan.from_json`, bit-identical): search once, serve many times.
The JSONs shipped under ``src/repro_torch/plans/`` are what the reference's
search wrote for chatglm3-6b (:func:`shipped_plan`); the port's own search
writes the same bytes.
Each :class:`OpPlan` also carries the cost model's predicted fetch/energy
terms for its winning (format, mapping), which is what the calibration loop
(:mod:`repro_torch.exec.calibrate`) compares measured counters against.

Formats whose structure matches the block-bitmap kernel (``B(N₁)-B(K₁)``
with dense leaves) map to ``bitmap_spmm`` with the leaf sizes as the block
shape (MXU-aligned); 2:4-sparse operands map to ``nm_spmm``.  Everything
else stays dense — and the plan now says WHY, as a structured
:class:`FallbackReason` instead of a silent drop.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.arch import TPUV5E, HardwareConfig, arch_by_name
from repro_torch.core.cosearch import CoSearchConfig, SearchResult, cosearch
from repro_torch.core.dataflow import irrelevant_refetch
from repro_torch.core.engine import EngineConfig
from repro_torch.core.costmodel import compile_format
from repro_torch.core.formats import Format
from repro_torch.core.primitives import Prim
from repro_torch.core.sparsity import (NM, Bernoulli, BlockBernoulli, Sparsity,
                                 TensorSpec, analyze)
from repro_torch.core.workload import MatMul, Workload

MXU_ALIGN = 128

#: Current :class:`ExecPlan` JSON schema version.  v1 plans (no ``version``
#: key, no ``checksums``) still load; bumping this requires teaching
#: :meth:`ExecPlan.from_dict` the new layout.
PLAN_VERSION = 2

PLANS_DIR = pathlib.Path(__file__).resolve().parent.parent / "plans"


class PlanVersionError(ValueError):
    """A serialized plan declares a schema version this code cannot read.

    Raised by :meth:`ExecPlan.from_dict` BEFORE any field access, so a
    future-format plan fails with a structured error naming both versions
    instead of a ``KeyError`` deep in ``hardware()`` resolution."""

    def __init__(self, found: int, supported: int = PLAN_VERSION):
        self.found = found
        self.supported = supported
        super().__init__(
            f"ExecPlan schema version {found} is newer than the supported "
            f"version {supported}; refusing to guess at the layout")


class PlanMismatchError(ValueError):
    """A plan's roles do not match the model configuration it is applied
    to (``reduced()`` keeps the model's name, so the name alone cannot
    tell a full-width plan from a reduced one)."""


# ---------------------------------------------------------------------------
# Kernel choices + structured fallbacks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FallbackReason:
    """Why a planned role is (or went) dense instead of a native kernel.

    ``code`` is machine-checkable; ``detail`` carries the human context
    (typically the format string).  Plan-time reasons are recorded on the
    :class:`KernelChoice` so unservable winners are visible instead of
    quietly dropped; the guarded serving path
    (:mod:`repro_torch.runtime.guard`) reuses the same type for RUNTIME demotions, with codes
    ``integrity_violation`` / ``kernel_failure`` / ``nonfinite_logits`` /
    ``deadline_exceeded`` / ``step_failure``."""

    code: str        # plan: "no_tpu_kernel" | "unallocated_leaf"
    #                # runtime: "integrity_violation" | "kernel_failure" |
    #                #   "nonfinite_logits" | "deadline_exceeded" |
    #                #   "step_failure"
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    op_name: str
    kind: str                  # "bitmap" | "nm" | "dense"
    block_n: int = 0           # bitmap_spmm block shape (bn, bk)
    block_k: int = 0
    predicted_ratio: float = 1.0
    format_str: str = "dense"
    fallback: Optional[FallbackReason] = None


@dataclasses.dataclass
class CompressionPlan:
    """Legacy single-layer FFN plan (the original codesign bridge API)."""

    choices: dict[str, KernelChoice]
    search: SearchResult

    def for_op(self, name: str) -> KernelChoice:
        return self.choices[name]


def _align(x: int, extent: int) -> int:
    """Snap a format level size to an MXU-friendly divisor of extent."""
    for cand in (x, MXU_ALIGN, 64, 32, 16, 8):
        if cand and extent % cand == 0 and cand <= extent:
            return cand
    return extent


def translate(op: MatMul, fmt_w: Optional[Format],
              w_sparsity: Sparsity) -> KernelChoice:
    """One searched W-side format → the kernel that can execute it."""
    if isinstance(w_sparsity, NM):
        # n/m values survive + ceil(log2(m))-bit positions per kept value
        idx_bits = max(1, (w_sparsity.m - 1).bit_length())
        ratio = w_sparsity.n / w_sparsity.m * (1 + idx_bits / op.value_bits)
        return KernelChoice(op.name, "nm", predicted_ratio=ratio,
                            format_str=f"CP({w_sparsity.n}:{w_sparsity.m})")
    if fmt_w is None:
        # the search itself chose dense — not a fallback
        return KernelChoice(op.name, "dense")

    # block-bitmap realizable: compressed levels are all B, with dense-leaf
    # (None) block factors determining the executable block shape.
    comp = [l for l in fmt_w.levels if l.prim is not Prim.NONE]
    leaves = {l.dim: int(l.size) for l in fmt_w.levels
              if l.prim is Prim.NONE and l.size is not None}
    if comp and all(l.prim is Prim.B for l in comp):
        bn = _align(leaves.get("N", MXU_ALIGN), op.N)
        bk = _align(leaves.get("K", MXU_ALIGN), op.K)
        spec = TensorSpec(op.w_dims(), w_sparsity, op.value_bits)
        ratio = analyze(fmt_w, spec).total_bits / spec.dense_bits
        return KernelChoice(op.name, "bitmap", bn, bk,
                            predicted_ratio=float(ratio),
                            format_str=str(fmt_w))
    # non-bitmap winner (CSR/RLE-style): no native TPU kernel — dense
    # execution with HBM-side compression only (documented limitation).
    return KernelChoice(op.name, "dense", format_str=str(fmt_w),
                        fallback=FallbackReason("no_tpu_kernel", str(fmt_w)))


# ---------------------------------------------------------------------------
# Workload builders
# ---------------------------------------------------------------------------

def ffn_workload(cfg: ModelConfig, tokens: int, w_sparsity: Sparsity,
                 act_density: float = 1.0) -> Workload:
    """The FFN matmuls of one layer of ``cfg`` as a SnipSnap workload."""
    d = cfg.d_model
    f = cfg.moe.d_expert if cfg.moe else cfg.d_ff
    act = Bernoulli(act_density)
    ops = (
        MatMul("ffn.up", tokens, d, f, act, w_sparsity,
               count=float(cfg.n_layers)),
        MatMul("ffn.down", tokens, f, d, act, w_sparsity,
               count=float(cfg.n_layers)),
    )
    return Workload(f"{cfg.name}.ffn", ops)


def model_workload(cfg: ModelConfig, tokens: int, w_sparsity: Sparsity,
                   act_density: float = 1.0,
                   value_bits: int = 16) -> Workload:
    """EVERY per-layer projection of ``cfg`` as one workload.

    Op names are the dispatch roles (:meth:`ModelConfig.matmul_roles`);
    MoE roles route ``tokens · top_k / n_experts`` tokens to each expert
    and repeat ``n_layers · n_experts`` times (the expert fan-out), dense
    roles repeat ``n_layers`` times.  ``value_bits`` is the serving value
    width — pass the parameter store's real width (32 for fp32 params) so
    predicted fetch terms compare against measured counters 1:1."""
    act = Bernoulli(act_density)
    ops = []
    for r in cfg.matmul_roles():
        m = tokens
        if r.fanout > 1 and cfg.moe:
            m = max(1, int(tokens * cfg.moe.top_k / cfg.moe.n_experts))
        ops.append(MatMul(r.role, m, r.n, r.k, act, w_sparsity, act,
                          count=float(cfg.n_layers * r.fanout),
                          value_bits=value_bits))
    return Workload(f"{cfg.name}.model", tuple(ops))


# ---------------------------------------------------------------------------
# Whole-model execution plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpPlan:
    """One projection role's execution decision + predicted cost terms.

    ``predicted_*_fetch_bits`` are the cost model's expected bits moved in
    ONE full DRAM pass over the operand under the winning (format, tile) —
    the terms the calibration loop compares measured counters against.
    ``predicted_w_stream_bits`` multiplies in the mapping's tile-reuse
    refetch factor (``irrelevant_refetch``): the TOTAL W-side payload the
    memory pipeline streams across all output-stripe passes, compared
    against the measured ``OpCounters.w_stream_bits``.
    ``predicted_dram_bits`` / ``predicted_energy`` are the op's full
    count-scaled :class:`~repro_torch.core.costmodel.CostReport` values."""

    role: str
    m: int
    n: int
    k: int
    count: float
    choice: KernelChoice
    tile: dict[str, int]
    predicted_w_fetch_bits: float
    predicted_i_fetch_bits: float
    predicted_dram_bits: float
    predicted_energy: float
    predicted_w_stream_bits: float = 0.0


def _sparsity_to_dict(sp: Sparsity) -> dict:
    if isinstance(sp, NM):
        return {"kind": "nm", "n": sp.n, "m": sp.m}
    if isinstance(sp, BlockBernoulli):
        return {"kind": "block_bernoulli", "density": sp.density,
                "block_elems": sp.block_elems}
    if isinstance(sp, Bernoulli):
        return {"kind": "bernoulli", "density": sp.density}
    raise TypeError(f"unserializable sparsity model {sp!r}")


def _sparsity_from_dict(d: dict) -> Sparsity:
    kind = d["kind"]
    if kind == "nm":
        return NM(d["n"], d["m"])
    if kind == "block_bernoulli":
        return BlockBernoulli(d["density"], d["block_elems"])
    if kind == "bernoulli":
        return Bernoulli(d["density"])
    raise ValueError(f"unknown sparsity kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A whole model's kernel configuration: search once, serve many times.

    Pure data — everything serializes to JSON and round-trips bit-identically
    (floats go through ``repr`` shortest-round-trip).  ``search`` optionally
    carries the live :class:`SearchResult` in-process; it is NOT serialized
    and does not enter equality."""

    model: str
    arch: str                   # BASE hardware name (arch_by_name-resolvable)
    objective: str
    tokens: int
    n_layers: int
    w_sparsity: dict
    ops: tuple[OpPlan, ...]
    act_density: float = 1.0
    value_bits: int = 16
    energy_scale: float = 1.0   # calibration fit applied to the DRAM pj/bit
    glb_energy_scale: float = 1.0   # calibration fit applied to the GLB
    #                                 pj/bit (refetch-residual fit)
    version: int = PLAN_VERSION
    # per-role sha256 content digests of the compressed payloads, recorded
    # by compress.compress_params and re-checked by CompressedStore.verify
    # (empty for plans that never met real weights)
    checksums: dict = dataclasses.field(default_factory=dict)
    search: Optional[SearchResult] = dataclasses.field(
        default=None, compare=False, repr=False)

    def for_role(self, role: str) -> OpPlan:
        for op in self.ops:
            if op.role == role:
                return op
        raise KeyError(role)

    @property
    def sparsity(self) -> Sparsity:
        return _sparsity_from_dict(self.w_sparsity)

    def hardware(self) -> HardwareConfig:
        """The plan's hardware model: the named base arch with the plan's
        calibration scale (if any) re-applied — calibrated plans stay
        resolvable after a JSON round trip."""
        base = arch_by_name(self.arch)
        if self.energy_scale == 1.0 and self.glb_energy_scale == 1.0:
            return base
        from repro_torch.exec.calibrate import calibrated_hardware
        return calibrated_hardware(base, self.energy_scale,
                                   glb_scale=self.glb_energy_scale)

    def fallbacks(self) -> dict[str, FallbackReason]:
        """Roles whose format winner could not be served natively."""
        return {op.role: op.choice.fallback for op in self.ops
                if op.choice.fallback is not None}

    def fallback_counts(self) -> dict[str, int]:
        """Fallback occurrences by reason code (for bench/serve reporting:
        how many planned roles run dense, and why)."""
        counts: dict[str, int] = {}
        for fb in self.fallbacks().values():
            counts[fb.code] = counts.get(fb.code, 0) + 1
        return counts

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        # drop `search` BEFORE asdict: it is the largest object in the
        # subsystem and asdict would deep-convert it just to be discarded
        out = dataclasses.asdict(dataclasses.replace(self, search=None))
        del out["search"]
        return out

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "ExecPlan":
        version = int(d.get("version", 1))   # v1 predates the version key
        if version > PLAN_VERSION:
            raise PlanVersionError(version)
        ops = []
        for o in d["ops"]:
            fb = o["choice"].get("fallback")
            choice = KernelChoice(
                **{**o["choice"],
                   "fallback": FallbackReason(**fb) if fb else None})
            ops.append(OpPlan(**{**o, "choice": choice,
                                 "tile": dict(o["tile"])}))
        return ExecPlan(model=d["model"], arch=d["arch"],
                        objective=d["objective"], tokens=d["tokens"],
                        n_layers=d["n_layers"], w_sparsity=dict(d["w_sparsity"]),
                        ops=tuple(ops), act_density=d["act_density"],
                        value_bits=d["value_bits"],
                        energy_scale=d.get("energy_scale", 1.0),
                        glb_energy_scale=d.get("glb_energy_scale", 1.0),
                        version=version,
                        checksums=dict(d.get("checksums", {})))

    @staticmethod
    def from_json(s: str) -> "ExecPlan":
        return ExecPlan.from_dict(json.loads(s))


def _tpu_search_cfg(hardware: HardwareConfig,
                    search_cfg: Optional[CoSearchConfig]) -> CoSearchConfig:
    """Hardware-constrained format space (paper §III-A: configurations are
    an input): the TPU execution plane implements B-over-block-grid decoding
    (bitmap_spmm) — so the searchable primitive set is {B} with dense
    leaves, i.e. block-sparse formats the MXU can actually run.  The
    port's CUDA bitmap kernels serve the same block formats, so the port
    searches the same space and writes the same plans."""
    if search_cfg is None:
        return CoSearchConfig(
            objective="energy",
            engine=EngineConfig(max_levels=2, max_allocs_per_pattern=48,
                                prims=(Prim.B,)))
    # calibrated variants keep the base arch's name as a prefix
    if hardware is TPUV5E or hardware.name.startswith(TPUV5E.name):
        return dataclasses.replace(
            search_cfg,
            engine=dataclasses.replace(search_cfg.engine, prims=(Prim.B,)))
    return search_cfg


def plan_for_model(cfg: ModelConfig, w_sparsity: Sparsity,
                   tokens: int = 4096, act_density: float = 1.0,
                   hardware: HardwareConfig = TPUV5E,
                   search_cfg: Optional[CoSearchConfig] = None,
                   ) -> CompressionPlan:
    """Run the co-search on the model's FFN ops against the TPU hardware
    model and translate the winning W-side format into kernel choices.

    The original single-layer bridge, kept for the legacy API; new code
    should use :func:`build_exec_plan`."""
    wl = ffn_workload(cfg, tokens, w_sparsity, act_density)
    res = cosearch(wl, hardware, _tpu_search_cfg(hardware, search_cfg))
    choices: dict[str, KernelChoice] = {}
    for od in res.design.ops:
        choices[od.op.name] = translate(od.op, od.fmt_w, w_sparsity)
    return CompressionPlan(choices, res)


def build_exec_plan(cfg: ModelConfig, w_sparsity: Sparsity,
                    tokens: int = 4096, act_density: float = 1.0,
                    hardware: HardwareConfig = TPUV5E,
                    search_cfg: Optional[CoSearchConfig] = None,
                    value_bits: int = 16) -> ExecPlan:
    """Co-search the WHOLE model's projections and emit an :class:`ExecPlan`.

    One op per :meth:`ModelConfig.matmul_roles` role (identically-shaped
    layers share the memoized per-op search), each translated into a
    :class:`KernelChoice` and annotated with the cost model's predicted
    fetch/energy terms for the calibration loop."""
    wl = model_workload(cfg, tokens, w_sparsity, act_density, value_bits)
    scfg = _tpu_search_cfg(hardware, search_cfg)
    res = cosearch(wl, hardware, scfg)

    ops: list[OpPlan] = []
    for od in res.design.ops:
        op = od.op
        choice = translate(op, od.fmt_w, w_sparsity)
        spec_w = TensorSpec(op.w_dims(), op.sp_w, op.value_bits)
        spec_i = TensorSpec(op.i_dims(), op.sp_i, op.value_bits)
        cf_w = compile_format(od.fmt_w, spec_w)
        cf_i = compile_format(od.fmt_i, spec_i)
        w_fetch = float(cf_w.fetched_bits(od.mapping.tile))
        # tile-reuse refetch factor of the winning loop order: how many
        # times the full W payload streams DRAM→chip across output tiles
        ext = {"M": op.M, "N": op.N, "K": op.K}
        bounds = {d: math.ceil(ext[d] / od.mapping.tile[d]) for d in ext}
        f_w = irrelevant_refetch(od.mapping.order, "W", bounds)
        ops.append(OpPlan(
            role=op.name, m=op.M, n=op.N, k=op.K, count=op.count,
            choice=choice, tile=dict(od.mapping.tile),
            predicted_w_fetch_bits=w_fetch,
            predicted_i_fetch_bits=float(cf_i.fetched_bits(od.mapping.tile)),
            predicted_dram_bits=float(od.cost.dram_bits),
            predicted_energy=float(od.cost.energy),
            predicted_w_stream_bits=w_fetch * f_w))
    return ExecPlan(model=cfg.name, arch=hardware.name,
                    objective=scfg.objective, tokens=tokens,
                    n_layers=cfg.n_layers,
                    w_sparsity=_sparsity_to_dict(w_sparsity),
                    ops=tuple(ops), act_density=act_density,
                    value_bits=value_bits, search=res)


def check_plan(plan: ExecPlan, cfg: ModelConfig) -> ExecPlan:
    """Raise :class:`PlanMismatchError` unless ``plan`` was made for
    ``cfg``: same model name and the same ``(role, n, k)`` for every
    projection role.  Returns the plan."""
    want = {(r.role, r.n, r.k) for r in cfg.matmul_roles()}
    have = {(op.role, op.n, op.k) for op in plan.ops}
    if plan.model != cfg.name or want != have:
        raise PlanMismatchError(
            f"plan for {plan.model!r} with roles {sorted(have)} does not "
            f"fit {cfg.name!r} (d_model={cfg.d_model}) with roles "
            f"{sorted(want)}")
    return plan


def load_plan(path, cfg: ModelConfig) -> ExecPlan:
    """Read a plan JSON and check it against ``cfg``."""
    return check_plan(ExecPlan.from_json(pathlib.Path(path).read_text()), cfg)


def shipped_plan(cfg: ModelConfig, kind: str = "bitmap") -> ExecPlan:
    """The plan shipped under ``plans/`` for ``cfg`` and ``kind`` ("bitmap"
    or "nm"), full-width or reduced, whichever fits ``cfg``."""
    tried = []
    for path in sorted(PLANS_DIR.glob(f"{cfg.name}*.{kind}.json")):
        try:
            return load_plan(path, cfg)
        except PlanMismatchError:
            tried.append(path.name)
    raise FileNotFoundError(
        f"no shipped {kind} plan fits {cfg.name} (d_model={cfg.d_model}); "
        f"tried {tried or 'none'} in {PLANS_DIR}")
