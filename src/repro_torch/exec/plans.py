"""Execution plans, read from JSON.

A copy of the reference's plan schema (``repro.exec.plans``: the
``ExecPlan`` / ``OpPlan`` / ``KernelChoice`` / ``FallbackReason``
dataclasses, schema version 2) with the same ``to_json`` / ``from_json``.
The co-search that MAKES plans is not ported yet: the port serves plans
the reference wrote ("search once, serve many"), such as the ones shipped
under ``src/repro_torch/plans/``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

from repro_torch.configs.base import ModelConfig

#: the :class:`ExecPlan` JSON schema version this module reads and writes
PLAN_VERSION = 2

PLANS_DIR = pathlib.Path(__file__).resolve().parent.parent / "plans"


class PlanVersionError(ValueError):
    """A serialized plan declares a schema version this code cannot read."""

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


@dataclasses.dataclass(frozen=True)
class FallbackReason:
    """Why a planned role is dense instead of a native kernel."""

    code: str
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    op_name: str
    kind: str                  # "bitmap" | "nm" | "dense"
    block_n: int = 0           # bitmap block shape (bn, bk)
    block_k: int = 0
    predicted_ratio: float = 1.0
    format_str: str = "dense"
    fallback: Optional[FallbackReason] = None


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """One projection role's execution decision + predicted cost terms."""

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


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A whole model's kernel configuration (pure data, JSON round trip)."""

    model: str
    arch: str
    objective: str
    tokens: int
    n_layers: int
    w_sparsity: dict
    ops: tuple[OpPlan, ...]
    act_density: float = 1.0
    value_bits: int = 16
    energy_scale: float = 1.0
    glb_energy_scale: float = 1.0
    version: int = PLAN_VERSION
    checksums: dict = dataclasses.field(default_factory=dict)

    def for_role(self, role: str) -> OpPlan:
        for op in self.ops:
            if op.role == role:
                return op
        raise KeyError(role)

    def fallbacks(self) -> dict[str, FallbackReason]:
        """Roles whose format winner could not be served natively."""
        return {op.role: op.choice.fallback for op in self.ops
                if op.choice.fallback is not None}

    def fallback_counts(self) -> dict[str, int]:
        """Fallback occurrences by reason code: how many planned roles run
        dense, and why (the serve CLI's compressed label prints them)."""
        counts: dict[str, int] = {}
        for fb in self.fallbacks().values():
            counts[fb.code] = counts.get(fb.code, 0) + 1
        return counts

    @property
    def sparsity(self) -> dict:
        """The weight sparsity model, as the plan's ``w_sparsity`` dict
        (``kind`` "nm" with ``n``/``m``, or a ``density``)."""
        return dict(self.w_sparsity)

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

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
                        n_layers=d["n_layers"],
                        w_sparsity=dict(d["w_sparsity"]),
                        ops=tuple(ops), act_density=d["act_density"],
                        value_bits=d["value_bits"],
                        energy_scale=d.get("energy_scale", 1.0),
                        glb_energy_scale=d.get("glb_energy_scale", 1.0),
                        version=version,
                        checksums=dict(d.get("checksums", {})))

    @staticmethod
    def from_json(s: str) -> "ExecPlan":
        return ExecPlan.from_dict(json.loads(s))


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
