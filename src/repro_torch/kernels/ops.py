"""Public wrappers of the sparse kernels.

``bitmap_spmm(x, w)`` / ``nm_spmm(x, w)`` launch the hand-written CUDA
kernel when ``x`` lies on a CUDA device — or raise, there is no fallback —
and run the plain PyTorch version of :mod:`repro_torch.kernels.ref` when
``x`` lies on the CPU.  Each wrapper adds one to its launch count where it
launches its kernel, and nowhere else (:func:`launch_counts`), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import bitmap_spmm as _bitmap_cuda
from repro_torch.kernels import nm_spmm as _nm_cuda
from repro_torch.kernels import ref

_LAUNCHES = {"bitmap_spmm": 0, "nm_spmm": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Bitmap block-sparse
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BitmapCompressed:
    """`B(N₁)-B(K₁)-None(N₂,K₂)` weights: payload + pre-decoded metadata."""

    blocks: torch.Tensor       # (nnzb, bn, bk)
    counts: torch.Tensor       # (K/bk,) int32
    row_ids: torch.Tensor      # (nnzb,) int32
    offsets: torch.Tensor      # (K/bk,) int32
    n: int
    k: int
    bn: int
    bk: int
    max_per_col: int

    @property
    def compression_ratio(self) -> float:
        dense = self.n * self.k
        stored = self.blocks.shape[0] * self.bn * self.bk
        meta = (self.n // self.bn) * (self.k // self.bk) / 8 / 2  # bits→bytes/2B
        return (stored + meta) / dense


def compress_bitmap(w: torch.Tensor, bn: int = 128, bk: int = 128
                    ) -> BitmapCompressed:
    """Compress on ``w``'s own device."""
    blocks, counts, row_ids, offsets, _ = ref.compress_bitmap(w, bn, bk)
    return BitmapCompressed(
        blocks=blocks, counts=counts, row_ids=row_ids, offsets=offsets,
        n=w.shape[0], k=w.shape[1], bn=bn, bk=bk,
        max_per_col=int(counts.max()) if counts.numel() else 1)


def bitmap_spmm(x: torch.Tensor, w: BitmapCompressed) -> torch.Tensor:
    """Y = X @ W_blocksparse, (M, K) float32."""
    if x.device.type == "cpu":
        return ref.bitmap_spmm_ref(x, w.blocks, w.counts, w.row_ids, w.n,
                                   w.k)
    y = _bitmap_cuda.launch(x, w.blocks, w.counts, w.row_ids, w.offsets, w.k)
    _LAUNCHES["bitmap_spmm"] += 1
    return y


# ---------------------------------------------------------------------------
# N:M structured
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NMCompressed:
    values: torch.Tensor       # (N·n/m, K)
    indices: torch.Tensor      # (N·n/m, K) int8 ∈ [0, m)
    n: int
    k: int
    n_sel: int = 2
    m_group: int = 4

    @property
    def compression_ratio(self) -> float:
        # values halve; 2-bit indices ≈ n_sel/m_group · 2/16 of dense bits
        return self.n_sel / self.m_group * (1 + 2 / 16)


def compress_nm(w: torch.Tensor, n_sel: int = 2, m_group: int = 4
                ) -> NMCompressed:
    """Compress on ``w``'s own device."""
    vals, idx = ref.compress_nm(w, n_sel, m_group)
    return NMCompressed(values=vals, indices=idx, n=w.shape[0], k=w.shape[1],
                        n_sel=n_sel, m_group=m_group)


def nm_spmm(x: torch.Tensor, w: NMCompressed) -> torch.Tensor:
    """Y = X @ expand(values, indices), (M, K) float32."""
    if x.device.type == "cpu":
        return ref.nm_spmm_ref(x, w.values, w.indices, w.n_sel, w.m_group)
    y = _nm_cuda.launch(x, w.values, w.indices, w.n_sel, w.m_group)
    _LAUNCHES["nm_spmm"] += 1
    return y
