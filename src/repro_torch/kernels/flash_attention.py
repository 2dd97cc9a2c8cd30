"""Launch wrapper of the flash attention CUDA kernel
(``csrc/flash_attention.cu``).

Port of the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_kernel`` via ``flash_attention_pallas``).  The wrapper checks device,
dtype, shape and contiguity, allocates the output and launches on
PyTorch's current stream; the source's note states the kernel's design
and bound.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: largest head dimension the kernel takes
MAX_HEAD_DIM = 256
#: largest BH (the grid's second dimension)
MAX_BH = 65535

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _fn(dtype: torch.dtype):
    lib = build.library("flash_attention")
    fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 \
        else lib.flash_attention_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """softmax(Q Kᵀ/√D) V on the card.  q (BH, Sq, D), k / v (BH, Skv, D),
    all fp32 or all bf16, contiguous.  Returns (BH, Sq, D) in q's type."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    ts = (q, k, v)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention: operands on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: operands must be contiguous")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(BH, Sq, D), (BH, Skv, D), (BH, Skv, D)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= bh <= MAX_BH and sq >= 1
            and skv >= 1):
        raise ValueError(f"flash_attention: the kernel takes 1 <= D <= "
                         f"{MAX_HEAD_DIM} and 1 <= BH <= {MAX_BH}, got "
                         f"q {tuple(q.shape)}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), bh, sq, skv, d, int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o
