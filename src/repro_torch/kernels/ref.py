"""Plain PyTorch versions of the kernels, and the compressors.

The sparse plain versions compute the same function as the CUDA kernels
from the same compressed operands, in fp32 (x is converted to fp32
exactly, as ``jnp.dot`` promotes bf16 × f32), and give a NaN or Inf in x
the reference kernels' reach: the bitmap version multiplies the stored
blocks only, the N:M version the dense weight its groups expand to,
pruned zeros included.  The pipelined and naive kernel variants share
them.
:func:`flash_attention_ref` is dense softmax attention with the flash
kernel's masking and rounding.  The wrappers in
:mod:`repro_torch.kernels.ops` use them for CPU tensors; tests and
``chip_smoke.py`` hold the kernels against them.

The compressors run on any device and give arrays equal, element for
element, to the reference's host compressors (``compress_bitmap_host`` /
``compress_nm_host``), including the one zero block padded in when a
weight has no non-zero block, and the stable descending magnitude order.
"""

from __future__ import annotations

import math

import torch

#: the flash kernel's mask value (finite, as the TPU kernel's)
NEG_INF = -1e30


def bitmap_spmm_ref(x: torch.Tensor, blocks: torch.Tensor,
                    counts: torch.Tensor, row_ids: torch.Tensor, n: int,
                    k: int) -> torch.Tensor:
    """Y = X @ W for block-bitmap W, over the stored blocks only.  x: (M, N)
    → (M, K) float32.

    As the kernels (the port's and the reference's) do, each stored block
    multiplies its own block-row of x, and a block-column's products are
    summed: an x entry under no stored block of a block-column never
    reaches it, so a NaN or Inf there leaves that column's outputs alone.
    Slot ``t`` of the CSC payload belongs to block-column ``j`` while
    ``offsets[j] <= t < offsets[j] + counts[j]`` (the kernel's
    ``offsets`` are the exclusive cumsum of ``counts``); a column's slots
    are gathered into a (K/bk, T) table with T = min(N/bn, nnzb), the most
    a valid column holds, and the slots past its count are masked before
    the sum, never multiplied in.  Shapes and counts stay on the device:
    no host read."""
    m = x.shape[0]
    nnzb, bn, bk = blocks.shape
    gn, gk = n // bn, k // bk
    xs = x.float().reshape(m, gn, bn).index_select(1, row_ids.long())
    prod = torch.bmm(xs.transpose(0, 1), blocks.float())    # (nnzb, M, bk)
    t = torch.arange(min(gn, nnzb), device=x.device)
    live = t < counts[:, None]                              # (gk, T)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.where(live, first[:, None] + t, 0)
    y = torch.where(live[..., None, None], prod[slot], 0.0).sum(1)
    return y.transpose(0, 1).reshape(m, k)


def nm_expand_ref(wc: torch.Tensor, idx: torch.Tensor, n_sel: int,
                  m_group: int) -> torch.Tensor:
    """Decompress N:M values + positions to dense.

    wc/idx: (N·n_sel/m_group, K), idx ∈ [0, m_group).  Returns (N, K); like
    the reference's compare-and-sum expand, repeated positions add."""
    rows, k = wc.shape
    groups = rows // n_sel
    dense = wc.new_zeros((groups, m_group, k))
    dense.scatter_add_(1, idx.reshape(groups, n_sel, k).long(),
                       wc.reshape(groups, n_sel, k))
    return dense.reshape(groups * m_group, k)


def nm_spmm_ref(x: torch.Tensor, wc: torch.Tensor, idx: torch.Tensor,
                n_sel: int, m_group: int) -> torch.Tensor:
    """Y = X @ expand(wc, idx).  x: (M, N) → (M, K) float32."""
    return torch.matmul(x.float(),
                        nm_expand_ref(wc, idx, n_sel, m_group).float())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """softmax(Q Kᵀ/√D) V for q (BH, Sq, D), k/v (BH, Skv, D) → q.dtype.

    Scores in fp32; the causal mask is aligned TOP-LEFT, key ``j`` visible
    to query ``i`` iff ``j <= i``, as the flash kernel masks
    (``repro/kernels/flash_attention.py:51-55``) — not the reference
    oracle's bottom-right ``tril(k=Skv-Sq)``; the two agree when Sq == Skv.
    The weights are cast to ``v.dtype`` before the PV product, which
    accumulates in fp32."""
    w = _softmax_weights(q, k, causal).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", w.float(), v.float()).to(q.dtype)


def _softmax_weights(q: torch.Tensor, k: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    """fp32 softmax(Q Kᵀ/√D), causal mask aligned top-left."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = s.shape[-2:]
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return torch.softmax(s, dim=-1)


def flash_attention_bf16_tol(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o_plain: torch.Tensor,
                             causal: bool = True) -> torch.Tensor:
    """Per-element bound on ``|o − o_plain|`` between a bf16 flash kernel
    and :func:`flash_attention_ref` (``o_plain``) on the same inputs:
    ``2⁻⁷·|o_plain| + 2⁻⁵·√(Σⱼ wⱼ² vⱼ²) + 1e-6``, w the fp32 weights.

    bf16 keeps 8 significant bits.  Both versions round the output once,
    so the two outputs differ by at most one ulp, ≤ 2⁻⁷·|o|, beyond what
    they differ before rounding.  Both round every weight once, at
    different places (this version the normalised weight, a flash kernel
    ``exp(s − m)`` against its running max), so a weight's two roundings
    differ by a relative error of at most 2⁻⁷ with a standard deviation
    of at most 0.41·2⁻⁷, independently of the other weights: ``Σ w v``
    moves by at most 0.41·2⁻⁷·√(Σ w² v²) in one standard deviation.  The
    bound allows ten of those, where the worst case, 2⁻⁷·Σ w|v|, would
    allow a typical output's own size at long context."""
    w = _softmax_weights(q, k, causal)
    noise = torch.einsum("bqk,bkd->bqd", w.square(),
                         v.float().square()).sqrt()
    return 2.0 ** -7 * o_plain.float().abs() + 2.0 ** -5 * noise + 1e-6


# ---------------------------------------------------------------------------
# Compressors (any device)
# ---------------------------------------------------------------------------

def compress_bitmap(w: torch.Tensor, bn: int, bk: int):
    """Block-compress a dense matrix: returns (blocks, counts, row_ids,
    offsets, bitmap), CSC over the (N/bn, K/bk) block grid — per
    block-COLUMN lists of non-zero block-rows."""
    n, k = w.shape
    if n % bn or k % bk:
        raise ValueError(f"block ({bn}, {bk}) does not tile {tuple(w.shape)}")
    gn, gk = n // bn, k // bk
    wb = w.reshape(gn, bn, gk, bk).permute(0, 2, 1, 3)      # (gn, gk, bn, bk)
    bitmap = (wb != 0).any(dim=3).any(dim=2)                 # (gn, gk)
    counts = bitmap.sum(dim=0).to(torch.int32)
    offsets = torch.zeros(gk, dtype=torch.int32, device=w.device)
    offsets[1:] = torch.cumsum(counts, 0)[:-1].to(torch.int32)
    cols, rows = torch.nonzero(bitmap.t(), as_tuple=True)    # column-major
    if rows.numel():
        blocks = wb[rows, cols].contiguous()
        row_ids = rows.to(torch.int32)
    else:
        blocks = w.new_zeros((1, bn, bk))
        row_ids = torch.zeros(1, dtype=torch.int32, device=w.device)
    return blocks, counts, row_ids, offsets, bitmap


def compress_nm(w: torch.Tensor, n_sel: int = 2, m_group: int = 4):
    """Compress along the first axis: keep the ``n_sel`` largest-magnitude
    entries of each ``m_group`` (ties → first), returning (values
    (N·n/m, K), positions int8) in ascending position order."""
    n, k = w.shape
    if n % m_group:
        raise ValueError(f"m_group {m_group} does not divide N={n}")
    groups = n // m_group
    wg = w.reshape(groups, m_group, k)
    order = torch.argsort(-wg.abs(), dim=1, stable=True)[:, :n_sel, :]
    order = torch.sort(order, dim=1).values
    vals = torch.gather(wg, 1, order)
    return (vals.reshape(groups * n_sel, k).contiguous(),
            order.reshape(groups * n_sel, k).to(torch.int8))
