"""Core layers: norms, embeddings, RoPE, MLP, parameter init.

Plain functions on tensors, params as nested dicts in the reference's
layout (weights ``(d_in, d_out)``, stacked layers along a leading axis).

Dtype policy: ``COMPUTE_DTYPE`` / ``PARAM_DTYPE`` mirror the reference
(bf16 compute, fp32 params).  Every function reads them from THIS module
at call time, so one ``monkeypatch.setattr(layers, "COMPUTE_DTYPE",
torch.float32)`` switches the whole port to fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# Projection dispatch hook (execution plane)
# ---------------------------------------------------------------------------
# Every FFN/attention projection routes through :func:`proj`.  With no hook
# installed it is the dense matmul; repro_torch.exec.dispatch installs a
# hook that swaps planned (layer, role) projections for the compressed
# CUDA kernels.

_PROJ_HOOK = None


def set_proj_hook(fn) -> None:
    """Install (or clear, with ``None``) the projection override.

    ``fn(x, w, role) -> Optional[Tensor]``: return the projection output to
    take over the matmul, or ``None`` to fall through to the dense one."""
    global _PROJ_HOOK
    _PROJ_HOOK = fn


def proj(x: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` (w is ``(d_in, d_out)``),
    dispatchable per ``role``."""
    if _PROJ_HOOK is not None:
        y = _PROJ_HOOK(x, w, role)
        if y is not None:
            return y
    return torch.matmul(x, w.to(COMPUTE_DTYPE))


_PROJ = proj


def proj_rebound() -> bool:
    """Whether :func:`proj` has been rebound (fault injection:
    ``repro_torch.runtime.inject.poison_activations``): Python that acts
    at every projection, which a CUDA graph's replay does not run."""
    return proj is not _PROJ


# The layer loops publish the index of the layer they are running here, so
# a hook resolves per-layer operands (compressed weights) without the
# model knowing about them.

_LAYER_CTX: Any = None


@contextlib.contextmanager
def layer_ctx(value: Any):
    """Publish the current layer's index for the proj hook."""
    global _LAYER_CTX
    prev = _LAYER_CTX
    _LAYER_CTX = value
    try:
        yield
    finally:
        _LAYER_CTX = prev


def current_layer_ctx() -> Any:
    return _LAYER_CTX


def _init(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn on ``gen``'s device."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=PARAM_DTYPE)
    return w.div_(math.sqrt(max(fan_in, 1)))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm scaling by ``(1 + weight)`` (zero-initialised weight)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens].to(COMPUTE_DTYPE)


def logits_head(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Decode-time logits for the last position only: (B, V) float32."""
    return torch.matmul(x, table.to(COMPUTE_DTYPE).t()).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device="cuda") -> Optional[torch.Tensor]:
    if cfg.rope_fraction <= 0.0:
        return None
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    return cfg.rope_base ** (
        -torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Rotates the interleaved ``0::2`` / ``1::2`` feature pairs of the first
    ``2·len(freqs)`` features (the tail is left untouched — ChatGLM's
    half-head RoPE); this is not the ``rotate_half`` convention."""
    if freqs is None:
        return x
    rot = 2 * freqs.shape[0]
    ang = positions[..., None].float() * freqs              # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.reshape(xr.shape).to(x.dtype)
    if rot < x.shape[-1]:
        return torch.cat([out, x[..., rot:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# MLP (SwiGLU) + params
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """FFN weights with optional leading (layer) dims, on ``gen.device``."""
    d, f = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "w_gate": _init(gen, lead + (d, f), d),
        "w_up": _init(gen, lead + (d, f), d),
        "w_down": _init(gen, lead + (f, d), f),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · σ(x)`` with ``σ(x) = 1 / (1 + exp(-x))`` as four ops, each
    rounded to ``x``'s dtype: how XLA expands the reference's
    ``jax.nn.silu``.  ``torch.nn.functional.silu`` rounds once, which at
    bf16 leaves many values one ulp away from the reference's."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = proj(x, p["w_gate"], "ffn.w_gate")
    u = proj(x, p["w_up"], "ffn.w_up")
    return proj(silu(g) * u, p["w_down"], "ffn.w_down")


def attn_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """Attention weights with optional leading (layer) dims."""
    d, h, nk, nh = cfg.d_model, cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    lead = tuple(lead)
    return {
        "wq": _init(gen, lead + (d, nh * h), d),
        "wk": _init(gen, lead + (d, nk * h), d),
        "wv": _init(gen, lead + (d, nk * h), d),
        "wo": _init(gen, lead + (nh * h, d), nh * h),
    }
