"""Attention: chunked causal online softmax, single-token decode against a
KV cache, and the prefill / decode attention blocks.

Plain PyTorch mirroring the reference's numerics: score products in the
compute dtype, scaled by ``1/√D`` rounded to that dtype (:func:`_scale`),
softmax statistics in fp32, ``NEG_INF = -1e30`` masking, and the
probabilities cast to the compute dtype before the PV product.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import optflags

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hkv·n_rep, D) for GQA."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


@functools.lru_cache(maxsize=None)
def _scale(d: int, dtype: torch.dtype) -> float:
    """``1/√d`` rounded to ``dtype``.  The reference multiplies its scores
    (in the compute dtype) by a weakly typed Python float, which JAX
    rounds to that dtype first; PyTorch would multiply by the fp32
    constant, so at bf16 some scores would land one ulp off."""
    return torch.tensor(1.0 / math.sqrt(d), dtype=dtype).item()


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_chunk: int = 512, kv_chunk: int = 512
                      ) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks (prefill: q[i] and
    k[i] share position i).

    q: (B, Sq, H, D); k/v: (B, Skv, H, D) (same H after GQA repeat)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = _scale(d, q.dtype)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk]
        qc = qi.shape[1]
        qpos = torch.arange(q0, q0 + qc, device=dev)
        m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, d), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, kv_chunk):
            ki = k[:, k0:k0 + kv_chunk]
            vi = v[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki) * scale
            mask = kpos[None, None, None, :] <= qpos[None, None, :, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            p = torch.exp(s.float() - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(L.COMPUTE_DTYPE), vi).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))                 # (B, qc, H, D)
    return torch.cat(outs, dim=1).to(q.dtype)


def _valid_mask(s: int, length: torch.Tensor) -> torch.Tensor:
    """(1 | B, S) validity mask from a scalar or per-row (B,) ``length``."""
    return torch.arange(s, device=length.device)[None, :] \
        < length.reshape(-1, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, H, D); caches: (B, S, H, D); ``length``: number of valid cache
    positions — a scalar, or (B,) per-row lengths."""
    b, s, h, d = k_cache.shape
    scale = _scale(d, q.dtype)
    valid = _valid_mask(s, length)                       # (1 | B, S)
    scores = torch.einsum("bhd,bshd->bhs", q, k_cache) * scale
    scores = torch.where(valid[:, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w.to(L.COMPUTE_DTYPE), v_cache)
    return out.to(q.dtype)


def decode_attention_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length: torch.Tensor
                         ) -> torch.Tensor:
    """Grouped-query decode attention without repeating the cache (optflag
    ``gqagroup``).

    q: (B, H, D); caches (B, S, Hkv, D) with H = r·Hkv, read in their
    stored layout; ``length`` a scalar or (B,) per-row lengths.  Scores
    ``bgrd,bsgd->bgrs`` in the compute dtype scaled by :func:`_scale`, the
    softmax in fp32, its weights cast to the compute dtype, then
    ``bgrs,bsgd->bgrd``: the reference's rounding points.  Each KV head's
    products are one ``bmm`` over the batch, which takes the cache's
    strided (S at Hkv·D) slice as it is: one batched product over (B,
    Hkv) would copy the cache, since no single batch stride spans both."""
    b, s, hk, d = k_cache.shape
    r = q.shape[1] // hk
    qg = q.reshape(b, hk, r, d)
    scores = torch.stack(
        [torch.bmm(qg[:, g], k_cache[:, :, g].transpose(1, 2))
         for g in range(hk)], dim=1) * _scale(d, q.dtype)
    valid = _valid_mask(s, length)[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores.float(), dim=-1).to(L.COMPUTE_DTYPE)
    out = torch.stack([torch.bmm(w[:, g], v_cache[:, :, g])
                       for g in range(hk)], dim=1)
    return out.reshape(b, hk * r, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention blocks (projections + rope + attention + out-proj)
# ---------------------------------------------------------------------------

def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    freqs: Optional[torch.Tensor], positions: torch.Tensor,
                    return_kv: bool = False):
    """Causal prefill self-attention over a full sequence.

    ``return_kv=True`` also returns the post-RoPE, pre-GQA-repeat (K, V):
    what :func:`attention_decode_block` writes into the decode cache."""
    b, s, _ = x.shape
    nh, nk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.proj(x, p["wq"], "attn.wq").reshape(b, s, nh, hd)
    k = L.proj(x, p["wk"], "attn.wk").reshape(b, s, nk, hd)
    v = L.proj(x, p["wv"], "attn.wv").reshape(b, s, nk, hd)
    k = L.apply_rope(k, positions, freqs)
    q = L.apply_rope(q, positions, freqs)
    rep = nh // max(nk, 1)
    o = chunked_attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep))
    out = L.proj(o.reshape(b, s, nh * hd), p["wo"], "attn.wo")
    if return_kv:
        return out, k, v
    return out


def attention_decode_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                           freqs: Optional[torch.Tensor], pos: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor
                           ) -> torch.Tensor:
    """Single-token attention step.

    x: (B, d); caches (B, S, Hkv, D) are written IN PLACE at ``pos`` (the
    reference returns updated copies; writing into the caller's cache saves
    a cache-sized copy per layer per token; with no sliding window the
    cache position is the token position; the reference's ``maskedkv``
    blend writes the same values).  ``pos`` is a scalar (lockstep batch)
    or a (B,) per-row vector.  Under the ``gqagroup`` flag the attention
    is :func:`decode_attention_gqa`, else :func:`decode_attention` over
    the repeated caches.  Returns the block output (B, d)."""
    b, _ = x.shape
    nh, nk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.proj(x, p["wq"], "attn.wq")
    k = L.proj(x, p["wk"], "attn.wk")
    v = L.proj(x, p["wv"], "attn.wv")
    pos1 = pos.reshape(b, 1) if pos.ndim else pos.reshape(1)
    q = L.apply_rope(q.reshape(b, 1, nh, hd), pos1, freqs).reshape(b, nh, hd)
    k = L.apply_rope(k.reshape(b, 1, nk, hd), pos1, freqs).reshape(b, nk, hd)
    v = v.reshape(b, nk, hd)
    rows = torch.arange(b, device=x.device)
    # index_put_, not ``k_cache[rows, pos] = ...``: Python indexing reads a
    # 0-d index tensor back to the host
    k_cache.index_put_((rows, pos), k.to(k_cache.dtype))
    v_cache.index_put_((rows, pos), v.to(v_cache.dtype))
    length = torch.clamp(pos + 1, max=k_cache.shape[1])
    if optflags.enabled("gqagroup"):
        o = decode_attention_gqa(q, k_cache, v_cache, length)
    else:
        rep = nh // max(nk, 1)
        o = decode_attention(q, _repeat_kv(k_cache, rep),
                             _repeat_kv(v_cache, rep), length)
    return L.proj(o.reshape(b, nh * hd), p["wo"], "attn.wo")
