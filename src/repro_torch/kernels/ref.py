"""Plain PyTorch versions of the sparse kernels, and the compressors.

The plain versions compute the same function as the CUDA kernels from the
same compressed operands, by decompressing to a dense weight and running
one fp32 matmul (x is converted to fp32 exactly, as ``jnp.dot`` promotes
bf16 × f32).  The wrappers in :mod:`repro_torch.kernels.ops` use them for
CPU tensors; tests and ``chip_smoke.py`` hold the kernels against them.

The compressors run on any device and give arrays equal, element for
element, to the reference's host compressors (``compress_bitmap_host`` /
``compress_nm_host``), including the one zero block padded in when a
weight has no non-zero block, and the stable descending magnitude order.
"""

from __future__ import annotations

import torch


def bitmap_dense(blocks: torch.Tensor, counts: torch.Tensor,
                 row_ids: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Scatter CSC-ordered payload blocks back into the dense (N, K)."""
    _, bn, bk = blocks.shape
    gn, gk = n // bn, k // bk
    dense = blocks.new_zeros((gn, gk, bn, bk))
    cols = torch.repeat_interleave(
        torch.arange(gk, device=blocks.device), counts.long())
    total = cols.shape[0]
    dense[row_ids[:total].long(), cols] = blocks[:total]
    return dense.permute(0, 2, 1, 3).reshape(n, k)


def bitmap_spmm_ref(x: torch.Tensor, blocks: torch.Tensor,
                    counts: torch.Tensor, row_ids: torch.Tensor, n: int,
                    k: int) -> torch.Tensor:
    """Y = X @ W for block-bitmap W.  x: (M, N) → (M, K) float32.  (The
    kernel's ``offsets`` are the exclusive cumsum of ``counts``.)"""
    w = bitmap_dense(blocks, counts, row_ids, n, k)
    return torch.matmul(x.float(), w.float())


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
