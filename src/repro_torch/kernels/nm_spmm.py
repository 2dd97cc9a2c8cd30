"""Launch wrapper of the N:M CUDA kernels (``csrc/nm_spmm.cu``).

Ports of the two Pallas TPU kernels of ``repro.kernels.nm_spmm``:
``pipeline=True`` launches the port of ``_pipelined_kernel`` +
``_decode_tile`` (decodes next to the FMA), ``pipeline=False`` the port of
the naive ``_kernel`` (expands each stripe to a dense tile, then multiplies
it densely).  The wrapper checks device, dtype, shape and contiguity,
allocates the output and launches on PyTorch's current stream; the
source's note states the designs and bound.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: largest group the kernels stage (``XC`` in the source)
MAX_M_GROUP = 32

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _fn(x_dtype: torch.dtype, pipeline: bool):
    lib = build.library("nm_spmm")
    name = "nm_spmm" if pipeline else "nm_spmm_naive"
    fn = getattr(lib, f"{name}_bf16" if x_dtype == torch.bfloat16
                 else f"{name}_f32")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n_sel: int, m_group: int, pipeline: bool = True) -> torch.Tensor:
    """Y = X @ expand(values, indices) on the card.  x: (M, N) fp32 or
    bf16; values (N·n_sel/m_group, K) fp32; indices the same shape, int8.
    Returns (M, K) fp32.  ``pipeline=False`` launches the naive entry."""
    m, n = x.shape
    rows, k = values.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nm_spmm: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if values.dtype != torch.float32 or indices.dtype != torch.int8:
        raise TypeError("nm_spmm: values must be float32 and indices int8")
    ts = (x, values, indices)
    if any(t.device != x.device for t in ts):
        raise ValueError("nm_spmm: operands on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("nm_spmm: operands must be contiguous")
    if not 1 <= n_sel <= m_group <= MAX_M_GROUP or n % m_group \
            or rows * m_group != n * n_sel or indices.shape != values.shape:
        raise ValueError(f"nm_spmm: {n_sel}:{m_group} with x "
                         f"{tuple(x.shape)} and values "
                         f"{tuple(values.shape)}")
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype, pipeline)(x.data_ptr(), values.data_ptr(),
                                     indices.data_ptr(), y.data_ptr(), m, n,
                                     k, n_sel, m_group, stream)
    if err:
        raise RuntimeError(f"nm_spmm kernel launch failed: CUDA error {err}")
    return y
