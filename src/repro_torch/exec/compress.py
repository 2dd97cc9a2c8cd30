"""Apply an :class:`~repro_torch.exec.plans.ExecPlan` to a weight tree.

:func:`prune_params` prunes every planned projection to the plan's
servable structure (block-sparse for bitmap roles, N:M for nm roles);
:func:`compress_params` stores each (layer, role[, expert]) weight in the
plan's chosen representation —
:class:`~repro_torch.kernels.ops.BitmapCompressed`,
:class:`~repro_torch.kernels.ops.NMCompressed` or the dense tensor — on
the weights' own device, with exact achieved-size accounting, and records
each role's content digest in the plan (``ExecPlan.checksums``,
:func:`repro_torch.runtime.integrity.checksum_store`).

MoE roles (``moe.*``) fan out per expert: one entry per (layer, role,
expert), compressed, checksummed and counted in the ratio like any other,
but never dispatched to a kernel: the experts run dense inside the MoE
block over the pruned weights, as in the reference.

The reference also stacks the store along the layer axis for
``lax.scan``; the port serves per-layer entries from a Python layer loop,
so it has no stacked store.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import NM
from repro_torch.exec.plans import ExecPlan, OpPlan, check_plan
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import _unserved
from repro_torch.sparse import masks


def _role_path(role: str) -> tuple[str, str]:
    """Dispatch role → (sub-tree, leaf) inside one layer's param dict."""
    group, leaf = role.split(".", 1)
    if group == "attn":
        return "attn", leaf
    if group in ("ffn", "moe"):
        return "ffn", leaf
    raise KeyError(f"unknown role {role!r}")


def _layer_weight(params: dict, layer: int, role: str, expert: int
                  ) -> torch.Tensor:
    group, leaf = _role_path(role)
    w = params["blocks"][group][leaf][layer]
    return w[expert] if expert >= 0 else w


def _check_uniform(cfg: ModelConfig) -> None:
    """Refuse what the reference's compressed plane refuses, in its words:
    every stack but a uniform attention stack (an unknown family too; a
    uniform stack with a ``window`` compresses).  Then the model's own
    refusal (``models.transformer._unserved``)."""
    if cfg.hybrid is not None or cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"exec plane serves uniform attention stacks; {cfg.name} is "
            f"family={cfg.family!r} hybrid={cfg.hybrid!r}")
    reason = _unserved(cfg)
    if reason:
        raise NotImplementedError(reason)


def _fanout(plan_op: OpPlan, cfg: ModelConfig) -> range:
    if plan_op.role.startswith("moe."):
        assert cfg.moe is not None
        return range(cfg.moe.n_experts)
    return range(-1, 0)          # single entry, expert = -1


def _nm_shape(plan: ExecPlan) -> tuple[int, int]:
    """(n_sel, m_group) of an N:M plan; the reference's 2:4 otherwise."""
    sp = plan.sparsity
    return (sp.n, sp.m) if isinstance(sp, NM) else (2, 4)


@dataclasses.dataclass
class CompressedTensor:
    """One (layer, role) weight in its executable representation."""

    layer: int
    role: str
    expert: int                # -1 for non-MoE roles
    kind: str                  # "bitmap" | "nm" | "dense"
    data: Any                  # BitmapCompressed | NMCompressed | Tensor
    dense_bits: float
    stored_bits: float

    @property
    def achieved_ratio(self) -> float:
        return self.stored_bits / self.dense_bits


@dataclasses.dataclass
class CompressedStore:
    """The compressed parameter store an :class:`ExecPlan` serves from."""

    plan: ExecPlan
    entries: dict[tuple[int, str, int], CompressedTensor]

    def get(self, layer: int, role: str, expert: int = -1
            ) -> Optional[CompressedTensor]:
        return self.entries.get((layer, role, expert))

    def __iter__(self) -> Iterator[CompressedTensor]:
        return iter(self.entries.values())

    def __len__(self) -> int:
        return len(self.entries)

    def achieved_ratio(self, role: Optional[str] = None) -> float:
        """stored/dense bits over the whole store (or one role), exact."""
        es = [e for e in self if role is None or e.role == role]
        dense = sum(e.dense_bits for e in es)
        return sum(e.stored_bits for e in es) / dense if dense else 1.0

    def ratio_report(self) -> dict[str, float]:
        roles = sorted({e.role for e in self})
        out = {r: self.achieved_ratio(r) for r in roles}
        out["total"] = self.achieved_ratio()
        return out

    def verify(self) -> dict[str, str]:
        """Structural invariants + content checksums for every role.

        Raises :class:`repro_torch.runtime.integrity.IntegrityError` on the
        first violation; returns ``{role: "ok"}`` otherwise.  Checksums
        compare against ``plan.checksums`` (recorded by
        :func:`compress_params`); plans without recorded digests get
        structure-only verification."""
        from repro_torch.runtime import integrity
        return integrity.verify(self)

    def without_roles(self, roles) -> "CompressedStore":
        """A new store with the given roles' entries removed.

        Dropping a role makes the dispatcher fall through to the dense
        matmul over the (pruned) params — the guarded serving path's
        per-role demotion after an integrity violation."""
        drop = set(roles)
        return CompressedStore(self.plan, {
            k: e for k, e in self.entries.items() if e.role not in drop})


def _stored_bits(kind: str, data: Any, vb: int) -> float:
    """Exact stored size: payload + metadata of the realized encoding."""
    if kind == "bitmap":
        nnzb = int(data.counts.sum())                # true non-zero blocks
        gn, gk = data.n // data.bn, data.k // data.bk
        return float(nnzb * data.bn * data.bk * vb + gn * gk)
    if kind == "nm":
        idx_bits = max(1, math.ceil(math.log2(data.m_group)))
        return float(data.values.numel() * vb + data.indices.numel() * idx_bits)
    return float(data.numel() * vb)


def compress_params(params: dict, plan: ExecPlan, cfg: ModelConfig
                    ) -> CompressedStore:
    """Compress every planned (layer, role[, expert]) weight of ``params``
    (whose weights already carry the plan's structure, see
    :func:`prune_params`) on the weights' device.  Dense-kind entries keep
    the tensor.  The store's plan is a copy of ``plan`` with every role's
    checksum."""
    _check_uniform(cfg)
    check_plan(plan, cfg)
    n_sel, m_group = _nm_shape(plan)
    entries: dict[tuple[int, str, int], CompressedTensor] = {}
    for op in plan.ops:
        ch = op.choice
        for layer in range(cfg.n_layers):
            for expert in _fanout(op, cfg):
                w = _layer_weight(params, layer, op.role, expert)
                vb = w.element_size() * 8
                if ch.kind == "bitmap":
                    data: Any = kops.compress_bitmap(w, ch.block_n,
                                                     ch.block_k)
                elif ch.kind == "nm":
                    data = kops.compress_nm(w, n_sel, m_group)
                else:
                    data = w
                entries[(layer, op.role, expert)] = CompressedTensor(
                    layer=layer, role=op.role, expert=expert, kind=ch.kind,
                    data=data, dense_bits=float(w.numel() * vb),
                    stored_bits=_stored_bits(ch.kind, data, vb))
    store = CompressedStore(plan, entries)
    # record per-role content digests IN the plan: the plan is the durable
    # artifact (JSON round-tripped), so a store rebuilt or reloaded later
    # verifies against what compression actually produced
    from repro_torch.runtime import integrity
    store.plan = dataclasses.replace(
        plan, checksums=integrity.checksum_store(store))
    return store


def prune_params(params: dict, plan: ExecPlan, cfg: ModelConfig) -> dict:
    """Prune ``params`` to the plan's servable sparsity structure.

    Bitmap roles get block pruning at the plan's block shape and density;
    nm roles N:M pruning; dense roles pass through.  A MoE role's weight
    ``(L, E, n, k)`` is pruned one expert's slice at a time into its new
    tensor.  Returns a new tree (the input is not mutated; untouched
    leaves are shared)."""
    _check_uniform(cfg)
    check_plan(plan, cfg)
    sp = plan.sparsity
    n_sel, m_group = _nm_shape(plan)
    blocks = dict(params["blocks"])          # group dicts copied on write
    out = dict(params)
    out["blocks"] = blocks
    for op in plan.ops:
        ch = op.choice
        if ch.kind == "dense":
            continue
        group, leaf = _role_path(op.role)
        w = blocks[group][leaf]
        pruned = torch.empty(w.shape, dtype=w.dtype, device=w.device)
        flat, out2d = w.reshape(-1, *w.shape[-2:]), \
            pruned.view(-1, *w.shape[-2:])    # (L[·E], n, k)
        for i in range(flat.shape[0]):
            if ch.kind == "bitmap":
                out2d[i] = masks.block_prune(
                    flat[i], ch.block_n, ch.block_k, sp.density)
            else:
                out2d[i] = masks.nm_prune(flat[i], n_sel, m_group)
        blocks[group] = dict(blocks[group])
        blocks[group][leaf] = pruned
    return out
