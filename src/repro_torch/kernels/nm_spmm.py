"""Launch wrapper of the N:M CUDA kernels (``csrc/nm_spmm.cu``).

Ports of the two Pallas TPU kernels of ``repro.kernels.nm_spmm``:
``pipeline=True`` launches the port of ``_pipelined_kernel`` +
``_decode_tile`` (decodes next to the FMA: the small-M entry at decode,
the prefill entry else), ``pipeline=False`` the port of the naive
``_kernel`` (expands each group to dense rows, then multiplies them
densely, zeros included: a decode kernel at decode, a tiled kernel else,
:func:`naive_kernel`).  Both follow one summation order,
:func:`split_plan`: at decode (M ≤ 16, K % 4 == 0) the reduction is split
into slices whose partials a second kernel adds in order, so the naive
result equals the pipelined one bit for bit.  The wrapper picks the entry
and the order, checks device, dtype, shape, contiguity and alignment,
allocates the output and the workspace (:func:`workspace_numel`: the
partials at decode, a column-major copy of x at prefill) and launches on
PyTorch's current stream; the source's note states the designs and
bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: largest group the kernels stage (``XC`` in the source)
MAX_M_GROUP = 32
#: largest M that takes the small-M entry and the split reduction
SPLIT_MAX_M = 16
#: output columns of one small-M thread block, pipelined or naive
#: (``SK_TK``)
SMALL_M_TILE_K = 256
#: output rows and columns of one naive prefill tile (``TM``, ``TK``)
NAIVE_TILE = 64
#: thread blocks the split aims at: four per SM of the H100's 132
SPLIT_MIN_BLOCKS = 4 * 132
#: x columns of one slice at most: 48 KB of fp32 at 16 rows (``SK_SMEM``)
SPLIT_MAX_SLICE_COLS = 768
#: the prefill entry pads its copy of x to a multiple of this many rows
#: (``PF_MT``)
PREFILL_TILE_M = 128

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def small_m(m: int, k: int) -> bool:
    """Whether (M, K) is a decode shape: it takes the pipelined small-M
    entry or the naive decode kernel, and the reduction may be split; its
    rows are whole float4s."""
    return m <= SPLIT_MAX_M and k % 4 == 0


@functools.lru_cache(maxsize=None)
def split_plan(m: int, n: int, k: int, n_sel: int, m_group: int
               ) -> tuple[int, int]:
    """``(slices, groups_per_slice)``: the summation order of both N:M
    entries.  The N/m_group groups are cut into ``slices`` consecutive
    slices of ``groups_per_slice`` groups (the last one ragged), a multiple
    of ``32 // m_group`` (the naive tiled kernel's run); each slice's
    partial is summed in ascending n, and the partials are added left to
    right.

    Above ``SPLIT_MAX_M`` rows (prefill), or for K not a multiple of 4,
    there is one slice.  At decode the slices are as long as possible
    while the small-M grid, ``ceil(K/256) x slices``, reaches
    ``SPLIT_MIN_BLOCKS``; at most ``kept rows / (16 M)`` slices keep the
    partials' round trip (``2·S·M·K·4`` bytes) within 10 % of the payload
    (``5·K`` bytes per kept row), and a slice stages at most
    ``SPLIT_MAX_SLICE_COLS`` x columns.  Roles with few output columns
    (K = 256) stay under the block target: the partials' share caps their
    slices."""
    groups = n // m_group
    run = MAX_M_GROUP // m_group
    if not small_m(m, k):
        return 1, _cdiv(groups, run) * run
    want = _cdiv(SPLIT_MIN_BLOCKS, _cdiv(k, SMALL_M_TILE_K))
    most = max(1, groups * n_sel // (16 * m))
    length = run * max(1, groups // (want * run))
    if _cdiv(groups, length) > most:
        length = _cdiv(_cdiv(groups, most), run) * run
    length = min(length, SPLIT_MAX_SLICE_COLS // (m_group * run) * run)
    return _cdiv(groups, length), length


def naive_kernel(m: int, n: int, k: int, n_sel: int, m_group: int
                 ) -> tuple[str, tuple[int, int]]:
    """The kernel the naive C entry launches for x (M, N) and a (·, K)
    payload, and its grid, as ``launch`` in the source picks them from the
    shape alone: at decode (:func:`small_m`) ``nm_spmm_naive_small_m_kernel``
    on (ceil(K / 256), S) with :func:`split_plan`'s S, whatever the
    alignment (operands off 16 / 4 bytes take its plain loads); else
    ``nm_spmm_naive_kernel`` on 64 x 64 tiles, (ceil(K / 64), ceil(M /
    64)), with one slice."""
    if small_m(m, k):
        return "nm_spmm_naive_small_m_kernel", (
            _cdiv(k, SMALL_M_TILE_K), split_plan(m, n, k, n_sel, m_group)[0])
    return "nm_spmm_naive_kernel", (_cdiv(k, NAIVE_TILE),
                                    _cdiv(m, NAIVE_TILE))


def _fn(x_dtype: torch.dtype, entry: str):
    lib = build.library("nm_spmm")
    fn = getattr(lib, f"{entry}_bf16" if x_dtype == torch.bfloat16
                 else f"{entry}_f32")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def select_entry(x: torch.Tensor, values: torch.Tensor,
                 indices: torch.Tensor, n_sel: int, m_group: int,
                 pipeline: bool = True) -> tuple[str, int, int]:
    """``(entry, slices, groups_per_slice)`` of one call: the C entry's
    name without its dtype suffix and :func:`split_plan`'s order.  Raises
    on operands no entry takes; the small-M entry's float4 and 32-bit
    loads need values 16-byte and indices 4-byte aligned.  The naive entry
    (``pipeline=False``) takes any contiguous view, with the same order."""
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
    entry = "nm_spmm_naive" if not pipeline else \
        "nm_spmm_small_m" if small_m(m, k) else "nm_spmm"
    if entry == "nm_spmm_small_m" \
            and (values.data_ptr() % 16 or indices.data_ptr() % 4):
        raise ValueError("nm_spmm: the small-M entry needs values 16-byte "
                         "and indices 4-byte aligned")
    return (entry, *split_plan(m, n, k, n_sel, m_group))


def workspace_numel(entry: str, m: int, n: int, k: int, slices: int) -> int:
    """fp32 elements of the workspace ``entry`` needs: the (S, M, K)
    partials of a split reduction (either entry at decode), room for the
    prefill entry's (N, M rounded up to ``PREFILL_TILE_M``) column-major
    copy of x in x's own type (fp32 or bf16), else none."""
    if slices > 1:
        return slices * m * k
    if entry == "nm_spmm":
        return n * _cdiv(m, PREFILL_TILE_M) * PREFILL_TILE_M
    return 0


def launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n_sel: int, m_group: int, pipeline: bool = True) -> torch.Tensor:
    """Y = X @ expand(values, indices) on the card.  x: (M, N) fp32 or
    bf16; values (N·n_sel/m_group, K) fp32; indices the same shape, int8.
    Returns (M, K) fp32.  ``pipeline=False`` launches the naive entry,
    whose kernel :func:`naive_kernel` names."""
    entry, slices, length = select_entry(x, values, indices, n_sel, m_group,
                                         pipeline)
    m, n = x.shape
    k = values.shape[1]
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    numel = workspace_numel(entry, m, n, k, slices)
    ws = torch.empty(numel, dtype=torch.float32, device=x.device) \
        if numel else y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype, entry)(x.data_ptr(), values.data_ptr(),
                                  indices.data_ptr(), y.data_ptr(),
                                  ws.data_ptr(), m, n, k, n_sel, m_group,
                                  slices, length, stream)
    if err:
        raise RuntimeError(f"nm_spmm kernel launch failed: CUDA error {err}")
    return y
