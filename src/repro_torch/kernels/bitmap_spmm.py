"""Launch wrapper of the block-bitmap CUDA kernels (``csrc/bitmap_spmm.cu``).

Ports of the two Pallas TPU kernels of ``repro.kernels.bitmap_spmm``:
``pipeline=True`` launches the port of ``_pipelined_kernel`` (walks
``counts[kj]`` blocks), ``pipeline=False`` the port of the naive ``_kernel``
(walks the static bound ``t_max``).  The wrapper checks device, dtype,
shape and contiguity, allocates the output and launches on PyTorch's
current stream; the source's note states the kernels' design and bound.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: output columns of one CUDA thread block (``TK`` in the source)
MAX_TILE_K = 64

_PTRS = [ctypes.c_void_p] * 6


def _fn(x_dtype: torch.dtype, pipeline: bool):
    lib = build.library("bitmap_spmm")
    name = "bitmap_spmm" if pipeline else "bitmap_spmm_naive"
    fn = getattr(lib, f"{name}_bf16" if x_dtype == torch.bfloat16
                 else f"{name}_f32")
    fn.argtypes = _PTRS + [ctypes.c_int] * (6 if pipeline else 8) \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_k(bk: int) -> int:
    """Largest divisor of ``bk`` that is ≤ 64: one CUDA tile lies in one
    block-column."""
    t = min(bk, MAX_TILE_K)
    while bk % t:
        t -= 1
    return t


def launch(x: torch.Tensor, blocks: torch.Tensor, counts: torch.Tensor,
           row_ids: torch.Tensor, offsets: torch.Tensor, k: int,
           t_max: int = 1, pipeline: bool = True) -> torch.Tensor:
    """Y = X @ W on the card.  x: (M, N) fp32 or bf16; blocks (nnzb, bn, bk)
    fp32; counts / offsets (K/bk,) and row_ids (nnzb,) int32.  Returns
    (M, K) fp32.  ``pipeline=False`` launches the naive entry, which walks
    ``t_max`` (≥ 1) steps per block-column; the pipelined entry ignores
    ``t_max``."""
    m, n = x.shape
    nnzb, bn, bk = blocks.shape
    if t_max < 1:
        raise ValueError(f"bitmap_spmm: t_max must be >= 1, got {t_max}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bitmap_spmm: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if blocks.dtype != torch.float32:
        raise TypeError(f"bitmap_spmm: blocks must be float32, "
                        f"got {blocks.dtype}")
    for name, t in (("counts", counts), ("row_ids", row_ids),
                    ("offsets", offsets)):
        if t.dtype != torch.int32:
            raise TypeError(f"bitmap_spmm: {name} must be int32")
    ts = (x, blocks, counts, row_ids, offsets)
    if any(t.device != x.device for t in ts):
        raise ValueError("bitmap_spmm: operands on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bitmap_spmm: operands must be contiguous")
    if n % bn or k % bk or counts.shape != (k // bk,) \
            or offsets.shape != counts.shape or row_ids.shape != (nnzb,) \
            or nnzb < 1:
        raise ValueError(f"bitmap_spmm: x {tuple(x.shape)} / blocks "
                         f"{tuple(blocks.shape)} / counts "
                         f"{tuple(counts.shape)} do not fit K={k}")
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    args = [x.data_ptr(), blocks.data_ptr(), counts.data_ptr(),
            row_ids.data_ptr(), offsets.data_ptr(), y.data_ptr(), m, n, k,
            bn, bk, tile_k(bk)]
    if not pipeline:
        args += [nnzb, t_max]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype, pipeline)(*args, stream)
    if err:
        raise RuntimeError(f"bitmap_spmm kernel launch failed: CUDA error "
                           f"{err}")
    return y
