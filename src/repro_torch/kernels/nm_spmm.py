"""Launch wrapper of the N:M CUDA kernels (``csrc/nm_spmm.cu``).

Ports of the two Pallas TPU kernels of ``repro.kernels.nm_spmm``:
``pipeline=True`` launches the port of ``_pipelined_kernel`` +
``_decode_tile`` (decodes next to the FMA: the small-M entry at decode,
the prefill entry else), ``pipeline=False`` the port of the naive
``_kernel`` (expands each group to dense rows, then multiplies them
densely, zeros included: a decode kernel at decode, a register-blocked
prefill kernel else, :func:`naive_kernel`).  Both follow one summation
order, :func:`split_plan`: at decode (M ≤ 16, K % 4 == 0) the reduction is
split into slices whose partials a second kernel adds in order, so the
naive result equals the pipelined one bit for bit.  The wrapper picks the
entry and the order, checks device, dtype, shape, contiguity and
alignment, allocates the output and the workspace (:func:`workspace_numel`:
the partials at decode, a column-major copy of x at prefill, for either
entry) and launches on PyTorch's current stream; the source's note states
the designs and bound.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: largest group the kernels stage (``XC`` in the source)
MAX_M_GROUP = 32
#: largest M that takes the small-M entry and the split reduction
SPLIT_MAX_M = 16
#: output columns of one small-M thread block, pipelined or naive
#: (``SK_TK``)
SMALL_M_TILE_K = 256
#: (rows, columns) of the naive prefill kernel's tiles, by index:
#: ``NaiveBig`` (8 x 8 outputs a thread), ``NaiveSmall`` (2 x 4)
NAIVE_PREFILL_TILES = ((128, 128), (32, 32))
#: a naive prefill grid of at least this many big tiles takes the big tile
#: (``NV_MIN_GRID``)
NAIVE_PREFILL_MIN_BLOCKS = 64
#: thread blocks the split aims at: four per SM of the H100's 132
SPLIT_MIN_BLOCKS = 4 * 132
#: x columns of one slice at most: 48 KB of fp32 at 16 rows (``SK_SMEM``)
SPLIT_MAX_SLICE_COLS = 768
#: the prefill entry pads its copy of x to a multiple of this many rows
#: (``PF_MT``)
PREFILL_TILE_M = 128
#: (rows, columns) of the pipelined prefill kernel's tiles: ``BigTile``,
#: and ``SmallTile`` where the big tiles' grid has fewer blocks than the
#: card's 132 SMs
PREFILL_TILES = ((128, 64), (8, 64))

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
    of ``32 // m_group`` (the naive prefill kernel's run); each slice's
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


class NaivePrefillPlan(NamedTuple):
    """The naive prefill kernel's tile (an index of
    :data:`NAIVE_PREFILL_TILES`), its rows and columns, and its grid (M
    tiles, K tiles)."""

    tile: int
    tm: int
    tk: int
    grid: tuple[int, int]


def naive_prefill_plan(m: int, k: int) -> NaivePrefillPlan:
    """The naive prefill kernel's tile and grid for (M, K), as ``launch``
    in the source picks them: the big tile where its grid has at least
    :data:`NAIVE_PREFILL_MIN_BLOCKS` blocks, else the small one (the K =
    256 roles at M = 512).  Ragged tiles are masked."""
    big, small = (NaivePrefillPlan(tile, tm, tk, (_cdiv(m, tm), _cdiv(k, tk)))
                  for tile, (tm, tk) in enumerate(NAIVE_PREFILL_TILES))
    return big if big.grid[0] * big.grid[1] >= NAIVE_PREFILL_MIN_BLOCKS \
        else small


def prefill_tile(m: int, k: int) -> tuple[int, int]:
    """The pipelined prefill kernel's tile (rows, columns) for (M, K), as
    ``launch`` in the source picks it."""
    big, small = PREFILL_TILES
    return big if _cdiv(m, big[0]) * _cdiv(k, big[1]) >= 132 else small


def stream_passes(m: int, k: int, pipeline: bool) -> int:
    """How many times the kernels the wrapper picks for x of M rows stream
    the whole payload: once at decode (:func:`small_m`: a block stages all
    M rows of its slice), else once per row of tiles of the prefill
    kernel's grid (:func:`prefill_tile` pipelined, :func:`naive_prefill_plan`
    naive)."""
    if small_m(m, k):
        return 1
    tm = prefill_tile(m, k)[0] if pipeline else naive_prefill_plan(m, k).tm
    return _cdiv(m, tm)


def prefill_rows(m: int) -> int:
    """Rows of the prefill kernels' column-major copy of x: M rounded up to
    :data:`PREFILL_TILE_M`."""
    return _cdiv(m, PREFILL_TILE_M) * PREFILL_TILE_M


def naive_kernel(m: int, n: int, k: int, n_sel: int, m_group: int
                 ) -> tuple[tuple[str, tuple[int, int]], ...]:
    """The kernels the naive C entry launches for x (M, N) and a (·, K)
    payload, in order, each with its grid, as ``launch`` in the source
    picks them from the shape alone.  At decode (:func:`small_m`)
    ``nm_spmm_naive_small_m_kernel`` on (ceil(K / 256), S) with
    :func:`split_plan`'s S, then, for S > 1, ``nm_reduce_kernel`` on
    (ceil(M·K / 1024), 1), whatever the alignment (operands off 16 / 4 bytes
    take the decode kernel's plain loads).  Else ``nm_transpose_x_kernel`` on
    (ceil(N / 32), :func:`prefill_rows` / 32), then
    ``nm_spmm_naive_prefill_kernel`` on :func:`naive_prefill_plan`'s grid,
    with one slice (operands off 16 bytes, or K % 16 != 0, take its plain
    staging)."""
    if small_m(m, k):
        slices = split_plan(m, n, k, n_sel, m_group)[0]
        launches = [("nm_spmm_naive_small_m_kernel",
                     (_cdiv(k, SMALL_M_TILE_K), slices))]
        if slices > 1:
            launches.append(("nm_reduce_kernel", (_cdiv(m * k // 4, 256), 1)))
        return tuple(launches)
    return (("nm_transpose_x_kernel", (_cdiv(n, 32), prefill_rows(m) // 32)),
            ("nm_spmm_naive_prefill_kernel", naive_prefill_plan(m, k).grid))


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


def nonfinite_flags(m: int, n: int) -> int:
    """int32 flags the pipelined prefill entry keeps beside its copy of x:
    one per 32 x 32 tile of the (N, :func:`prefill_rows`) copy, set where
    the tile holds a NaN or an Inf."""
    return _cdiv(n, 32) * (prefill_rows(m) // 32)


def workspace_numel(entry: str, m: int, n: int, k: int, slices: int) -> int:
    """fp32 elements of the workspace ``entry`` needs: the (S, M, K)
    partials of a split reduction (either entry at decode), room for the
    prefill kernels' (N, :func:`prefill_rows`) column-major copy of x where
    the pipelined or the naive entry takes a prefill shape (in x's own type
    for the pipelined entry, followed by its :func:`nonfinite_flags`;
    widened to fp32 for the naive one), else none."""
    if slices > 1:
        return slices * m * k
    if entry == "nm_spmm":
        return n * prefill_rows(m) + nonfinite_flags(m, n)
    if entry == "nm_spmm_naive" and not small_m(m, k):
        return n * prefill_rows(m)
    return 0


def launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
           n_sel: int, m_group: int, pipeline: bool = True) -> torch.Tensor:
    """Y = X @ expand(values, indices) on the card.  x: (M, N) fp32 or
    bf16; values (N·n_sel/m_group, K) fp32; indices the same shape, int8.
    Returns (M, K) fp32.  ``pipeline=False`` launches the naive entry,
    whose kernels :func:`naive_kernel` names."""
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
