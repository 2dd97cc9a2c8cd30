"""Launch wrapper of the flash attention CUDA kernels
(``csrc/flash_attention.cu``).

Port of the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_kernel`` via ``flash_attention_pallas``).  Two entries compute the same
function:

* ``tensor_core`` (C entry ``flash_attention_bf16_tc``): bf16 operands with
  D = 64 or 128, every operand 16-byte aligned; bf16 tiles in shared
  memory, both products on the tensor cores;
* ``fma`` (``flash_attention_f32`` / ``flash_attention_bf16``): every other
  call the kernel takes, fp32 FMAs on CUDA cores.

:func:`select_entry` picks the entry on the host from the dtype, D and the
operands' alignment (no device read, no sync).  The wrapper checks device,
dtype, shape and contiguity, allocates the output and launches on
PyTorch's current stream; an entry that fails to build or launch raises,
nothing gives way to the other entry.  The source's note states the
designs and bounds.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: largest head dimension the kernel takes
MAX_HEAD_DIM = 256
#: largest BH (the grid dimension of the FMA entry)
MAX_BH = 65535
#: head dimensions the tensor-core entry takes
TENSOR_CORE_HEAD_DIMS = (64, 128)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SYMBOLS = {("tensor_core", torch.bfloat16): "flash_attention_bf16_tc",
            ("fma", torch.bfloat16): "flash_attention_bf16",
            ("fma", torch.float32): "flash_attention_f32"}

#: launches per entry since the last :func:`reset_entry_counts`
_ENTRY_LAUNCHES = {"tensor_core": 0, "fma": 0}


def entry_counts() -> dict[str, int]:
    """Launches of each entry since the last :func:`reset_entry_counts`."""
    return dict(_ENTRY_LAUNCHES)


def reset_entry_counts() -> None:
    for name in _ENTRY_LAUNCHES:
        _ENTRY_LAUNCHES[name] = 0


def select_entry(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The entry for operands of ``dtype`` and head dimension ``d``:
    ``"tensor_core"`` for bf16 with D in :data:`TENSOR_CORE_HEAD_DIMS` and
    every operand's base 16-byte aligned (its 16-byte copies), else
    ``"fma"``.  Reads host values only."""
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS and aligned:
        return "tensor_core"
    return "fma"


def _fn(entry: str, dtype: torch.dtype):
    fn = getattr(build.library("flash_attention"), _SYMBOLS[entry, dtype])
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
    entry = select_entry(q.dtype, d,
                         all(t.data_ptr() % 16 == 0 for t in ts))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn(entry, q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), bh, sq, skv, d, int(causal),
                                  stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed ({entry} "
                           f"entry): CUDA error {err}")
    _ENTRY_LAUNCHES[entry] += 1
    return o
