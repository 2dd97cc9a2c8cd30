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
import functools
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import optflags

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32

TP_DEGREE = 16   # production model-axis size (padheads rounds up to this)


def eff_heads(n: int) -> int:
    """Head count after the optional pad to a multiple of ``TP_DEGREE``
    (optflag ``padheads``)."""
    if optflags.enabled("padheads") and n % TP_DEGREE:
        return ((n // TP_DEGREE) + 1) * TP_DEGREE
    return n


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


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the compute dtype: the reference's plain einsums (the
    recurrent blocks, cross-attention's decode), which no plan dispatches."""
    return torch.matmul(x, w.to(COMPUTE_DTYPE))


def proj(x: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` (w is ``(d_in, d_out)``),
    dispatchable per ``role``."""
    if _PROJ_HOOK is not None:
        y = _PROJ_HOOK(x, w, role)
        if y is not None:
            return y
    return dense(x, w)


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


class _MetaGenerator:
    """Stands for a generator on the meta device, which has none: a draw
    there is a shape and a dtype only."""
    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (on the
    meta device, a stand-in whose draws allocate nothing)."""
    if device.type == "meta":
        return _MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _init(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn on ``gen``'s device."""
    w = torch.randn(shape, device=gen.device, dtype=PARAM_DTYPE,
                    generator=None if gen.device.type == "meta" else gen)
    return w.div_(math.sqrt(max(fan_in, 1)))


def init_scaled(gen: torch.Generator, lead, shape, scale_axis: int = 0
                ) -> torch.Tensor:
    """The reference's ``_init(key, shape, scale_axis)`` under leading
    (layer) dims ``lead``: fan-in is ``shape[scale_axis]`` of the unstacked
    weight (axis 0 by default: ``(d_in, d_out)`` weights and the depthwise
    conv taps ``(K, C)`` alike)."""
    return _init(gen, tuple(lead) + tuple(shape), shape[scale_axis])


@functools.lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies its
    compute-dtype arrays by weakly typed Python constants, which JAX rounds
    to that dtype first; PyTorch would use the fp32 constant."""
    return torch.tensor(value, dtype=dtype).item()


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm scaling by ``(1 + weight)`` (zero-initialised weight)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S: x (B, S, C), w (K, C), each tap's
    product and running sum rounded to ``x``'s dtype in the reference's
    order (the RG-LRU and SSD blocks)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s, :] * w[i]
    return out


def conv_step(conv_state: torch.Tensor, x: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """One decode step of :func:`causal_conv`: the last K - 1 inputs in
    ``conv_state`` (B, K - 1, C) and the new one x (B, C) against w (K,
    C).  The K taps' exact products are summed in fp32 and rounded once,
    as the reference's einsum; ``conv_state`` moves on by one, in place."""
    window = torch.cat([conv_state, x[:, None, :]], dim=1)
    out = (window.float() * w.float()).sum(dim=1).to(x.dtype)
    conv_state.copy_(window[:, 1:, :])
    return out


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens].to(COMPUTE_DTYPE)


def unembed_loss(x: torch.Tensor, table: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy with sequence-chunked logits, as the
    reference's: never more than (B, chunk, V) logits at a time, each a
    compute-dtype product cast to fp32.  ``n_chunks = max(s // chunk, 1)``
    chunks of ``s // n_chunks`` positions: the last ``s mod n_chunks``
    positions are dropped and the mean divides by the positions kept (the
    reference's behaviour, kept).  Returns the fp32 mean loss."""
    b, s, _ = x.shape
    n_chunks = max(s // chunk, 1)
    chunk = s // n_chunks
    tbl = table.to(COMPUTE_DTYPE)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.matmul(x[:, sl], tbl.t()).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        total = total + (lse - gold).sum()
    # a tensor divisor: CUDA multiplies by a Python scalar's reciprocal
    return total / total.new_full((), b * n_chunks * chunk)


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


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1.0 + torch.exp(-x))


class _Logistic(torch.autograd.Function):
    """:func:`_logistic` with ``lax.logistic``'s derivative, ``g · (σ · (1
    - σ))``.  Differentiating the three ops instead gives ``0 · inf = NaN``
    where ``exp(-x)`` overflows (x below about -88)."""

    @staticmethod
    def forward(x):
        return _logistic(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``σ(x) = 1 / (1 + exp(-x))`` as three ops, each rounded to ``x``'s
    dtype: how XLA expands the reference's ``jax.nn.sigmoid``
    (``lax.logistic``).  ``torch.sigmoid`` rounds once, which at bf16
    leaves many values one ulp away from the reference's.  Under autograd
    its derivative is ``lax.logistic``'s (:class:`_Logistic`)."""
    if _differentiated(x):
        return _Logistic.apply(x)
    return _logistic(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · σ(x)`` with :func:`sigmoid`'s rounding: four rounded ops, as
    XLA expands the reference's ``jax.nn.silu``."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default (not
    ``F.gelu``'s), op by op as the reference writes it:
    ``x · 0.5 (1 + tanh(√(2/π) (x + 0.044715 x·x·x)))`` with both
    constants rounded to ``x``'s dtype and every op rounded to it."""
    dt = x.dtype
    inner = x + const(0.044715, dt) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(const(math.sqrt(2 / math.pi), dt)
                                        * inner)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


class _Softplus(torch.autograd.Function):
    """:func:`_softplus` with ``jnp.logaddexp``'s derivative, ``g ·
    exp(x - out)``.  The ops' own derivative is 1 at x = 0 (``clamp``
    passes it whole, ``abs`` gives 0) where the reference's is 1/2."""

    @staticmethod
    def forward(x):
        return _softplus(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``.  ``F.softplus`` returns ``x`` itself above 20.
    Under autograd its derivative is the reference's
    (:class:`_Softplus`)."""
    if _differentiated(x):
        return _Softplus.apply(x)
    return _softplus(x)


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = proj(x, p["w_gate"], "ffn.w_gate")
    u = proj(x, p["w_up"], "ffn.w_up")
    return proj(silu(g) * u, p["w_down"], "ffn.w_down")


def attn_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """Attention weights with optional leading (layer) dims; ``wq`` /
    ``wo`` at the :func:`eff_heads` width."""
    d, h, nk = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    nh = eff_heads(cfg.n_heads)
    lead = tuple(lead)
    return {
        "wq": _init(gen, lead + (d, nh * h), d),
        "wk": _init(gen, lead + (d, nk * h), d),
        "wv": _init(gen, lead + (d, nk * h), d),
        "wo": _init(gen, lead + (nh * h, d), nh * h),
    }


# ---------------------------------------------------------------------------
# Block-sparse FFN (decode only, optflag 'sparseffn')
# ---------------------------------------------------------------------------

def sparse_mlp_params(gen: torch.Generator, cfg: ModelConfig, lead=(),
                      density: float = 0.25, bn: int = 128, bk: int = 128
                      ) -> dict:
    """FFN gate / up weights stored as the reference's block payloads:
    per block-column ``gk = d_ff // bk`` a padded payload of ``T = max(1,
    int(gn · density))`` blocks ``(bn, bk)`` (``gn = d_model // bn``) and
    their block-row ids, which are zeros, as the reference's are; ``w_down``
    stays dense; ``_meta`` holds ``[bn, bk]`` (int32)."""
    d, f = cfg.d_model, cfg.d_ff
    gn, gk = d // bn, f // bk
    t = max(1, int(gn * density))
    lead = tuple(lead)
    dev = gen.device
    rows = torch.zeros(lead + (gk, t), dtype=torch.int32, device=dev)
    return {
        "payload_gate": init_scaled(gen, lead, (gk, t, bn, bk),
                                    scale_axis=2),
        "rows_gate": rows,
        "payload_up": init_scaled(gen, lead, (gk, t, bn, bk),
                                  scale_axis=2),
        "rows_up": rows.clone(),
        "w_down": _init(gen, lead + (f, d), f),
        "_meta": torch.tensor([bn, bk], dtype=torch.int32, device=dev)
        .expand(lead + (2,)).clone(),
    }


def _bsp_matmul(x: torch.Tensor, payload: torch.Tensor, rows: torch.Tensor
                ) -> torch.Tensor:
    """x: (B, N); payload: (gk, T, bn, bk); rows: (gk, T) block-row ids.
    Gathers the ``bn``-wide slices of x at each block's row id and sums
    each block-column's T products: ``bgtn,gtnk->bgk`` with the payload in
    the compute dtype.  Returns (B, gk·bk)."""
    b, n = x.shape
    gk, t, bn, bk = payload.shape
    xsel = x.reshape(b, n // bn, bn).index_select(1, rows.reshape(-1))
    y = torch.einsum("bgtn,gtnk->bgk", xsel.reshape(b, gk, t, bn),
                     payload.to(COMPUTE_DTYPE))
    return y.reshape(b, gk * bk)


def sparse_mlp_decode(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Single-token SwiGLU FFN over block-stored gate / up weights
    (:func:`sparse_mlp_params`); ``w_down`` is a plain dense product,
    which no plan dispatches."""
    g = _bsp_matmul(x, p["payload_gate"], p["rows_gate"])
    u = _bsp_matmul(x, p["payload_up"], p["rows_up"])
    return dense(silu(g) * u, p["w_down"])
