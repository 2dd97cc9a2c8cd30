"""Model configuration schema + registry for the assigned architectures.

A copy of the JAX package's ``repro.configs.base``, field for field and
method for method, so that the port imports nothing of that package.
Every architecture is a :class:`ModelConfig`; ``reduced()`` returns the
smoke-test size (same family, tiny extents).  Input shapes are the four
assigned cells (train_4k / prefill_32k / decode_32k / long_500k).  The
port serves the uniform attention stacks (``dense``, ``moe`` and ``vlm``
without ``hybrid``; :mod:`repro_torch.models.transformer`); the other
configs are registered so that asking for them raises by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_group: int = 256     # tokens per routing group (GShard dispatch)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """Layer pattern for hybrid/interleaved stacks.

    ``block`` is the repeating unit, e.g. ("rec", "rec", "attn") for
    RecurrentGemma's 1:2 or ("local",)*5 + ("global",) for Gemma3's 5:1.
    ``tail`` covers layers left over after full blocks.
    """
    block: tuple[str, ...]
    tail: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class MatmulRole:
    """One per-layer projection weight: role name + W[N, K] extents.

    ``fanout`` > 1 means the layer holds that many identically-shaped
    weights under the role (MoE experts)."""

    role: str
    n: int                      # contraction extent (weight rows)
    k: int                      # output extent (weight cols)
    fanout: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    # attention details
    window: int = 0             # sliding-window size for local attention
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the head dim
    rope_base: float = 10_000.0
    # encoder-decoder
    enc_layers: int = 0
    enc_seq: int = 0            # fixed encoder length (whisper: 1500 frames)
    frontend: Optional[str] = None   # "audio" | "vision" stub note
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # sparsity hooks (SnipSnap integration)
    sparse_ffn: bool = False    # run FFN matmuls through compressed kernels
    # long-context applicability (full-attention archs skip long_500k)
    sub_quadratic: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer kind sequence for hybrid stacks ('attn' default)."""
        if self.family == "ssm":
            return tuple(["ssm"] * self.n_layers)
        if self.hybrid is None:
            return tuple(["attn"] * self.n_layers)
        out: list[str] = []
        blk = self.hybrid.block
        while len(out) + len(blk) <= self.n_layers - len(self.hybrid.tail):
            out.extend(blk)
        out.extend(self.hybrid.tail)
        assert len(out) == self.n_layers, (len(out), self.n_layers)
        return tuple(out)

    def matmul_roles(self) -> tuple["MatmulRole", ...]:
        """Per-layer projection weights as executable matmul roles.

        Role names match the dispatch hooks in :mod:`repro_torch.models.layers` /
        :mod:`repro_torch.models.attention` (``attn.wq`` … ``ffn.w_down``); MoE
        FFNs fan out ``fanout = n_experts`` (one weight per expert, same
        shape) under ``moe.*`` names.  ``n`` is the contraction extent
        (weight rows), ``k`` the output extent — the execution plane's
        W[N, K] convention."""
        d, h = self.d_model, self.head_dim
        nh = self.n_heads
        nk = max(self.n_kv_heads, 1)
        roles = [
            MatmulRole("attn.wq", d, nh * h),
            MatmulRole("attn.wk", d, nk * h),
            MatmulRole("attn.wv", d, nk * h),
            MatmulRole("attn.wo", nh * h, d),
        ]
        if self.moe:
            e, f = self.moe.n_experts, self.moe.d_expert
            roles += [
                MatmulRole("moe.w_gate", d, f, fanout=e),
                MatmulRole("moe.w_up", d, f, fanout=e),
                MatmulRole("moe.w_down", f, d, fanout=e),
            ]
        elif self.d_ff:
            f = self.d_ff
            roles += [
                MatmulRole("ffn.w_gate", d, f),
                MatmulRole("ffn.w_up", d, f),
                MatmulRole("ffn.w_down", f, d),
            ]
        return tuple(roles)

    def params_count(self) -> float:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, h = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) \
            + (self.n_heads * h) * d
        if self.moe:
            per_ffn = self.moe.n_experts * 3 * d * self.moe.d_expert \
                + d * self.moe.n_experts
        else:
            per_ffn = 3 * d * self.d_ff if self.d_ff else 0
        kinds = self.layer_kinds
        total = float(emb)
        for k in kinds:
            if k in ("attn", "local", "global"):
                total += per_attn + per_ffn
            elif k == "rec":
                dr = d  # RG-LRU width ≈ d_model
                total += 3 * d * dr + per_ffn
            elif k == "ssm":
                di = d * (self.ssm.expand if self.ssm else 2)
                total += 2 * d * di + di * d
        total += self.enc_layers * (per_attn + per_ffn)
        return total

    def active_params_count(self) -> float:
        """Params touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.params_count()
        d = self.d_model
        dense = self.params_count() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.d_expert)
        return dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family, tiny extents."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2 + (len(self.hybrid.block)
                                             if self.hybrid else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            d_head=32,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 16),
            window=min(self.window, 64) if self.window else 0,
        )
        if self.moe:
            changes["moe"] = MoECfg(n_experts=8, top_k=2, d_expert=64,
                                    router_group=16)
        if self.ssm:
            changes["ssm"] = SSMCfg(d_state=16, d_conv=4, expand=2,
                                    head_dim=32, chunk=16)
        if self.hybrid:
            changes["n_layers"] = len(self.hybrid.block) + len(self.hybrid.tail)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populate registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_REGISTRY)
