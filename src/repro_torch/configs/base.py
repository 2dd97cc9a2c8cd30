"""Model configuration schema + registry (dense family).

A copy of the fields of :class:`repro.configs.base.ModelConfig` that the
dense attention stack reads, with the same ``head_dim``,
``matmul_roles()`` and ``reduced()``: the port keeps its own copy so that
it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class MatmulRole:
    """One per-layer projection weight: role name + W[N, K] extents."""

    role: str
    n: int                      # contraction extent (weight rows)
    k: int                      # output extent (weight cols)
    fanout: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # the port serves "dense" only
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    window: int = 0             # sliding-window size (not served by the port)
    rope_fraction: float = 1.0  # chatglm applies RoPE to half the head dim
    rope_base: float = 10_000.0
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    def matmul_roles(self) -> tuple[MatmulRole, ...]:
        """Per-layer projection weights, named like the ``proj`` roles;
        ``n`` is the contraction extent, ``k`` the output extent."""
        d, h = self.d_model, self.head_dim
        nh = self.n_heads
        nk = max(self.n_kv_heads, 1)
        roles = [
            MatmulRole("attn.wq", d, nh * h),
            MatmulRole("attn.wk", d, nk * h),
            MatmulRole("attn.wv", d, nk * h),
            MatmulRole("attn.wo", nh * h, d),
        ]
        if self.d_ff:
            f = self.d_ff
            roles += [
                MatmulRole("ffn.w_gate", d, f),
                MatmulRole("ffn.w_up", d, f),
                MatmulRole("ffn.w_down", f, d),
            ]
        return tuple(roles)

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration: same family, tiny extents (the
        reference's ``reduced()`` for a dense stack)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            d_head=32,
            window=min(self.window, 64) if self.window else 0,
        )


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.chatglm3_6b  # noqa: F401  (populate registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()

