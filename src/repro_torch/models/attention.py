"""Attention: chunked online softmax (causal, sliding-window or
bidirectional), single-token decode against a KV cache or a ring, and the
prefill / decode attention blocks (self- and cross-attention).

Plain PyTorch mirroring the reference's numerics: score products in the
compute dtype, scaled by ``1/√D`` rounded to that dtype (:func:`_scale`),
softmax statistics in fp32, ``NEG_INF = -1e30`` masking, and the
probabilities cast to the compute dtype before the PV product.
"""

from __future__ import annotations

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


def _kv_rep(nh: int, nk: int) -> int:
    """Query heads per KV head.  A count that is no multiple of the KV
    heads (``padheads`` on whisper-tiny: 6 heads padded to 16 over 6 KV
    heads) raises ``ValueError``: the reference's shapes do not meet
    there either."""
    nk = max(nk, 1)
    if nh % nk:
        raise ValueError(f"{nh} query heads do not group over {nk} KV "
                         f"heads")
    return nh // nk


def _scale(d: int, dtype: torch.dtype) -> float:
    """``1/√d`` rounded to ``dtype`` (:func:`layers.const`): the reference
    multiplies its compute-dtype scores by a weakly typed Python float;
    with the fp32 constant some bf16 scores would land one ulp off."""
    return L.const(1.0 / math.sqrt(d), dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 512
                      ) -> torch.Tensor:
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k/v: (B, Skv, H, D) (same H after GQA repeat); q[i]
    and k[i] share position i.  ``causal`` masks later keys; ``window`` > 0
    keeps only the last ``window`` keys of each query (local attention)."""
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
        qpos = torch.arange(q0, q0 + qc, device=dev)[None, None, :, None]
        m = torch.full((b, h, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, d), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, kv_chunk):
            ki = k[:, k0:k0 + kv_chunk]
            vi = v[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + ki.shape[1],
                                device=dev)[None, None, None, :]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki) * scale
            mask = None
            if causal:
                mask = kpos <= qpos
            if window > 0:
                near = kpos > qpos - window
                mask = near if mask is None else mask & near
            if mask is not None:
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
                    causal: bool = True, window: int = 0,
                    kv_override: Optional[tuple] = None,
                    return_kv: bool = False):
    """Prefill attention over a full sequence: self-attention (``causal``,
    a local ``window``), or cross-attention to ``kv_override[0]`` (its
    keys take no RoPE; the encoder-decoder's decoder).

    ``return_kv=True`` also returns the post-RoPE, pre-GQA-repeat (K, V):
    what :func:`attention_decode_block` writes into the decode cache."""
    b, s, _ = x.shape
    nh, nk, hd = L.eff_heads(cfg.n_heads), cfg.n_kv_heads, cfg.head_dim
    rep = _kv_rep(nh, nk)
    q = L.proj(x, p["wq"], "attn.wq").reshape(b, s, nh, hd)
    if kv_override is None:
        k = L.proj(x, p["wk"], "attn.wk").reshape(b, s, nk, hd)
        v = L.proj(x, p["wv"], "attn.wv").reshape(b, s, nk, hd)
        k = L.apply_rope(k, positions, freqs)
    else:
        assert not return_kv, "return_kv only applies to self-attention"
        xkv = kv_override[0]
        skv = xkv.shape[1]
        k = L.proj(xkv, p["wk"], "attn.wk").reshape(b, skv, nk, hd)
        v = L.proj(xkv, p["wv"], "attn.wv").reshape(b, skv, nk, hd)
    q = L.apply_rope(q, positions, freqs)
    o = chunked_attention(q, _repeat_kv(k, rep), _repeat_kv(v, rep),
                          causal=causal, window=window)
    out = L.proj(o.reshape(b, s, nh * hd), p["wo"], "attn.wo")
    if return_kv:
        return out, k, v
    return out


def attention_decode_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                           freqs: Optional[torch.Tensor], pos: torch.Tensor,
                           k_cache: torch.Tensor, v_cache: torch.Tensor,
                           cache_pos: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token attention step.

    x: (B, d); caches (B, S, Hkv, D) are written IN PLACE at ``cache_pos``
    (the reference returns updated copies; writing into the caller's cache
    saves a cache-sized copy per layer per token; the reference's
    ``maskedkv`` blend writes the same values).  ``cache_pos`` is the ring
    slot of a sliding-window cache, ``pos % S``; it defaults to ``pos``
    (a full cache).  ``pos`` / ``cache_pos`` are scalars (lockstep batch)
    or (B,) per-row vectors.  The valid length is ``min(pos + 1, S)``.
    Under the ``gqagroup`` flag the attention is
    :func:`decode_attention_gqa`, else :func:`decode_attention` over the
    repeated caches.  Returns the block output (B, d)."""
    b, _ = x.shape
    nh, nk, hd = L.eff_heads(cfg.n_heads), cfg.n_kv_heads, cfg.head_dim
    rep = _kv_rep(nh, nk)
    if cache_pos is None:
        cache_pos = pos
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
    k_cache.index_put_((rows, cache_pos), k.to(k_cache.dtype))
    v_cache.index_put_((rows, cache_pos), v.to(v_cache.dtype))
    length = torch.clamp(pos + 1, max=k_cache.shape[1])
    if optflags.enabled("gqagroup"):
        o = decode_attention_gqa(q, k_cache, v_cache, length)
    else:
        o = decode_attention(q, _repeat_kv(k_cache, rep),
                             _repeat_kv(v_cache, rep), length)
    return L.proj(o.reshape(b, nh * hd), p["wo"], "attn.wo")
