"""Launch wrapper of the block-bitmap CUDA kernels (``csrc/bitmap_spmm.cu``).

Ports of the two Pallas TPU kernels of ``repro.kernels.bitmap_spmm``:
``pipeline=True`` launches the port of ``_pipelined_kernel`` (walks
``counts[kj]`` blocks: the decode entry at M ≤ 16, the prefill entry
above, the tiled entry for operands neither takes), ``pipeline=False`` the
port of the naive ``_kernel`` (walks the static bound ``t_max``: the same
kernel the pipelined entry takes for those operands, whose masked steps
are read and not multiplied, :func:`naive_kernel`).  All entries follow
one summation order, :func:`split_plan`: at decode the reduction over each
block-column's kept rows is split into slices whose partials a second
kernel adds in order.  The wrapper picks the entry and the order
(:func:`select_entry`) and the prefill tile (:func:`prefill_plan`), checks
device, dtype, shape and contiguity, allocates the output and the
workspace (the partials, :func:`workspace_numel`, or the prefill kernels'
transposed x, :func:`xt_numel`) and launches on PyTorch's current stream;
the source's note states the designs and bound.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: output columns of one tiled-entry thread block (``TK`` in the source)
MAX_TILE_K = 64
#: kept rows of one piece, the unit of a slice (``BC``)
PIECE_ROWS = 32
#: largest M that takes the decode entry and the split reduction
SPLIT_MAX_M = 16
#: output columns of one decode thread block (``SK_TK``)
SMALL_M_TILE_K = 256
#: thread blocks the split aims at: four per SM of the H100's 132
SPLIT_MIN_BLOCKS = 4 * 132
#: kept rows of one slice at most: 48 KB of fp32 x at 16 rows (``SK_SMEM``)
SPLIT_MAX_SLICE_ROWS = 768
#: (rows, columns) of the prefill entry's tiles, by index: ``BigTile``
#: (8 x 8 outputs a thread), ``SmallTile`` (4 x 4)
PREFILL_TILES = ((64, 128), (32, 32))
#: a prefill grid of at least this many big tiles, one per SM of the
#: H100's 132, takes the big tile
PREFILL_MIN_BLOCKS = 132
#: the prefill entry pads its transposed copy of x to a multiple of this
#: many rows (``PF_MT``)
PREFILL_PAD_M = 128

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_k(bk: int) -> int:
    """Largest divisor of ``bk`` that is ≤ 64: one tiled- or naive-entry
    CUDA tile lies in one block-column."""
    t = min(bk, MAX_TILE_K)
    while bk % t:
        t -= 1
    return t


def small_m(m: int, bk: int) -> bool:
    """Whether (M, bk) may take the decode entry and a split reduction:
    decode shapes whose block rows are whole float4s."""
    return m <= SPLIT_MAX_M and bk % 4 == 0


@functools.lru_cache(maxsize=None)
def split_plan(m: int, bn: int, bk: int, k: int, max_per_col: int
               ) -> tuple[int, int]:
    """``(slices, pieces_per_slice)``: the summation order of every bitmap
    entry.  Each kept block's ``bn`` rows are cut into pieces of
    ``PIECE_ROWS`` (the last one ragged), and a block-column's pieces, in
    stored order, into ``slices`` slices of ``pieces_per_slice`` pieces;
    the longest column (``max_per_col`` kept blocks, at least its
    ``counts.max()``) fills them, shorter columns leave trailing slices
    empty.  Each slice's partial is summed in ascending kept-row order, and
    the partials are added left to right.  Reads host integers only.

    Above ``SPLIT_MAX_M`` rows (prefill), or for bk not a multiple of 4,
    there is one slice.  At decode the slices are as long as possible while
    the decode grid, ``K/bk · ceil(bk/256) x slices``, reaches
    ``SPLIT_MIN_BLOCKS``; at most ``kept rows / (20 M)`` slices keep the
    partials' round trip (``2·S·M·K·4`` bytes) within 10 % of the payload
    (``4·K`` bytes per kept row), and a slice holds at most
    ``SPLIT_MAX_SLICE_ROWS`` kept rows.  Roles with few output columns
    (K = 256) stay under the block target: the partials' share caps their
    slices."""
    rows = max(1, max_per_col) * bn
    pieces = max(1, max_per_col) * _cdiv(bn, PIECE_ROWS)
    if not small_m(m, bk):
        return 1, pieces
    want = _cdiv(SPLIT_MIN_BLOCKS, k // bk * _cdiv(bk, SMALL_M_TILE_K))
    most = max(1, rows // (20 * m))
    length = max(1, pieces // want)
    if _cdiv(pieces, length) > most:
        length = _cdiv(pieces, most)
    length = min(length, SPLIT_MAX_SLICE_ROWS // PIECE_ROWS)
    return _cdiv(pieces, length), length


class PrefillPlan(NamedTuple):
    """The prefill entry's tile (an index of :data:`PREFILL_TILES`), its
    rows and columns, and the grid: (M tiles, column tiles of a
    block-column, block-columns)."""

    tile: int
    tm: int
    tk: int
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def prefill_plan(m: int, bk: int, k: int) -> PrefillPlan | None:
    """The prefill entry's tile and grid for (M, bk, K), or None where its
    16-byte payload copies cannot take bk (``bk % 4 != 0``).  The big tile
    where its grid has at least :data:`PREFILL_MIN_BLOCKS` blocks, else the
    small one.  A tile never crosses a block-column: a ragged last column
    tile is masked.  Reads host integers only."""
    if bk % 4:
        return None
    big, small = (PrefillPlan(tile, tm, tk, (_cdiv(m, tm), _cdiv(bk, tk),
                                             k // bk))
                  for tile, (tm, tk) in enumerate(PREFILL_TILES))
    return big if math.prod(big.grid) >= PREFILL_MIN_BLOCKS else small


def route(m: int, bk: int, aligned: bool) -> str:
    """The kernel family an operand takes, pipelined or naive: "decode"
    (M ≤ 16, bk % 4 == 0, blocks 16-byte aligned), "prefill" (M > 16, the
    same operands) or "tiled" (bk % 4 != 0 or blocks off 16 bytes)."""
    if bk % 4 or not aligned:
        return "tiled"
    return "decode" if m <= SPLIT_MAX_M else "prefill"


def stream_passes(m: int, bk: int, k: int, aligned: bool) -> int:
    """How many times the kernels either entry picks for x of M rows
    stream the whole payload (:func:`route`): once at decode (a block
    stages all M rows of its slice), else once per row of tiles of the
    prefill grid (:func:`prefill_plan`) or of the tiled kernel's (64 rows a
    tile)."""
    kind = route(m, bk, aligned)
    if kind == "decode":
        return 1
    if kind == "prefill":
        return prefill_plan(m, bk, k).grid[0]
    return _cdiv(m, 64)


def naive_kernel(m: int, n: int, k: int, bn: int, bk: int, max_per_col: int,
                 aligned: bool) -> tuple[tuple[str, tuple[int, ...]], ...]:
    """The kernels the naive C entry launches for x (M, N) and a
    (nnzb, bn, bk) payload of K columns, in order, each with its grid, as
    ``launch`` in the source picks them from the shape and the alignment
    of ``blocks`` (:func:`route`).  At decode ``bitmap_spmm_small_m_kernel``
    on (K/bk · ceil(bk/256), S) with :func:`split_plan`'s S, then, for S >
    1, ``bitmap_reduce_kernel`` on (ceil(M·K / 1024), 1).  At prefill
    ``bitmap_transpose_x_kernel`` on (ceil(N / 32), M rounded up to 128 /
    32), then ``bitmap_spmm_prefill_kernel`` on :func:`prefill_plan`'s
    grid.  Else ``bitmap_spmm_kernel`` on (K / :func:`tile_k`, ceil(M /
    64)), one slice.  Each is the pipelined entry's kernel for the same
    operands, instantiated with the naive switch."""
    kind = route(m, bk, aligned)
    if kind == "decode":
        slices = split_plan(m, bn, bk, k, max_per_col)[0]
        launches = [("bitmap_spmm_small_m_kernel",
                     (k // bk * _cdiv(bk, SMALL_M_TILE_K), slices))]
        if slices > 1:
            launches.append(("bitmap_reduce_kernel",
                             (_cdiv(m * k // 4, 256), 1)))
        return tuple(launches)
    if kind == "prefill":
        return (("bitmap_transpose_x_kernel",
                 (_cdiv(n, 32), xt_numel(m, n) // n // 32)),
                ("bitmap_spmm_prefill_kernel", prefill_plan(m, bk, k).grid))
    return (("bitmap_spmm_kernel", (k // tile_k(bk), _cdiv(m, 64))),)


def _fn(x_dtype: torch.dtype, entry: str):
    lib = build.library("bitmap_spmm")
    fn = getattr(lib, f"{entry}_bf16" if x_dtype == torch.bfloat16
                 else f"{entry}_f32")
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def select_entry(x: torch.Tensor, blocks: torch.Tensor, counts: torch.Tensor,
                 row_ids: torch.Tensor, offsets: torch.Tensor, k: int,
                 max_per_col: int, pipeline: bool = True
                 ) -> tuple[str, int, int]:
    """``(entry, slices, pieces_per_slice)`` of one call: the C entry's
    name without its dtype suffix and :func:`split_plan`'s order.  Raises
    on operands no entry takes.  The decode entry (M ≤ 16) and the prefill
    entry (above) need ``blocks`` 16-byte aligned and bk a multiple of 4
    (16-byte payload loads): other operands take the tiled entry, with one
    slice."""
    m, n = x.shape
    nnzb, bn, bk = blocks.shape
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
    kind = route(m, bk, blocks.data_ptr() % 16 == 0)
    entry = "bitmap_spmm_naive" if not pipeline else {
        "decode": "bitmap_spmm_small_m", "prefill": "bitmap_spmm",
        "tiled": "bitmap_spmm_tiled"}[kind]
    if kind == "decode":
        return (entry, *split_plan(m, bn, bk, k, max_per_col))
    return entry, 1, max(1, max_per_col) * _cdiv(bn, PIECE_ROWS)


def workspace_numel(m: int, k: int, slices: int) -> int:
    """fp32 elements of the workspace: the (S, M, K) partials of a split
    reduction, else none."""
    return slices * m * k if slices > 1 else 0


def xt_numel(m: int, n: int) -> int:
    """fp32 elements of the prefill kernels' workspace, pipelined or naive:
    x transposed to (N, M rounded up to :data:`PREFILL_PAD_M`)."""
    return n * _cdiv(m, PREFILL_PAD_M) * PREFILL_PAD_M


def launch(x: torch.Tensor, blocks: torch.Tensor, counts: torch.Tensor,
           row_ids: torch.Tensor, offsets: torch.Tensor, k: int,
           max_per_col: int, t_max: int = 1,
           pipeline: bool = True) -> torch.Tensor:
    """Y = X @ W on the card.  x: (M, N) fp32 or bf16; blocks (nnzb, bn, bk)
    fp32; counts / offsets (K/bk,) and row_ids (nnzb,) int32; max_per_col
    at least ``counts.max()`` (it sets the summation order, read on the
    host: no sync).  Returns (M, K) fp32.  ``pipeline=False`` launches the
    naive entry, which walks ``t_max`` (≥ 1) steps per block-column with
    the kernels :func:`naive_kernel` names; the pipelined entries ignore
    ``t_max``."""
    if t_max < 1:
        raise ValueError(f"bitmap_spmm: t_max must be >= 1, got {t_max}")
    entry, slices, pieces = select_entry(x, blocks, counts, row_ids, offsets,
                                         k, max_per_col, pipeline)
    m, n = x.shape
    nnzb, bn, bk = blocks.shape
    y = torch.empty((m, k), dtype=torch.float32, device=x.device)
    prefill = route(m, bk, blocks.data_ptr() % 16 == 0) == "prefill"
    numel = xt_numel(m, n) if prefill else workspace_numel(m, k, slices)
    ws = torch.empty(numel, dtype=torch.float32, device=x.device) \
        if numel else y
    tile = prefill_plan(m, bk, k).tile if prefill else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn(x.dtype, entry)(
            x.data_ptr(), blocks.data_ptr(), counts.data_ptr(),
            row_ids.data_ptr(), offsets.data_ptr(), y.data_ptr(),
            ws.data_ptr(), m, n, k, bn, bk, tile_k(bk), nnzb, t_max, slices,
            pieces, tile, stream)
    if err:
        raise RuntimeError(f"bitmap_spmm kernel launch failed: CUDA error "
                           f"{err}")
    return y
