"""The naive bitmap kernel's design (the ``NAIVE = true`` instances of the
decode, prefill and tiled kernels in ``src/repro_torch/csrc/bitmap_spmm.cu``),
emulated with torch on the CPU, and the host function that names its
kernels, ``repro_torch.kernels.bitmap_spmm.naive_kernel``.

The reference's naive kernel walks the grid (M/bm, K/bk, t_max) and
multiplies only under ``t < counts[kj]``, while its index maps still fetch
the block at ``min(offsets[kj] + t, nnzb - 1)`` and its x columns on every
masked step.  The port runs the pipelined kernel's walk over the live steps
(the same sums in the same order, so the result equals the pipelined one
bit for bit) and then reads the masked steps without an FMA.  At decode
the masked steps are cut into pieces as the live ones are: slice s takes
the masked pieces in its range [s·P, (s+1)·P), the last slice also those
from S·P up to t_max·q.  These tests hold that emulation, slice by slice
over ``split_plan``, to the reference's naive Pallas kernel in interpret
mode and to the plain version, and the reads to the reference's index
maps; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import bitmap_spmm as bm
from repro_torch.kernels import ops, ref

PIECE = bm.PIECE_ROWS
ROW_TEMPLATES = (1, 2, 4, 8, 16)               # MT, the kernel's row counts


def _cdiv(a, b):
    return -(-a // b)


def _naive_decode(x, c, t_max):
    """The decode kernel's arithmetic in its order, and the masked pieces
    it reads.  x padded with zero rows to MT; per block-column and slice an
    accumulator from 0 over the slice's live kept rows, ascending (kept row
    (t, r) times x column ``row_ids[off + t]·bn + r``); masked pieces add
    nothing and are listed as (kj, slice, block read, piece p);
    the partials added left to right; rows from M on dropped."""
    m, n = x.shape
    bn, bk, k = c.bn, c.bk, c.k
    nnzb = c.blocks.shape[0]
    slices, pieces = bm.split_plan(m, bn, bk, k, c.max_per_col)
    q = _cdiv(bn, PIECE)
    mt = next(t for t in ROW_TEMPLATES if m <= t)
    xp = torch.zeros(mt, n)
    xp[:m] = x.float()
    flat = c.blocks.reshape(-1, bk)
    parts = torch.zeros(slices, mt, k)
    reads = []
    for kj in range(k // bk):
        cnt, off = int(c.counts[kj]), int(c.offsets[kj])
        pend, mend = cnt * q, t_max * q
        for s in range(slices):
            acc = torch.zeros(mt, bk)
            for p in range(min(s * pieces, pend), min(s * pieces + pieces,
                                                      pend)):
                t, r0 = p // q, p % q * PIECE
                for r in range(r0, min(r0 + PIECE, bn)):
                    col = int(c.row_ids[off + t]) * bn + r
                    acc = acc + xp[:, col, None] * flat[(off + t) * bn + r]
            top = mend if s == slices - 1 else min(s * pieces + pieces, mend)
            for p in range(max(s * pieces, pend), top):
                reads.append((kj, s, min(off + p // q, nnzb - 1), p))
            parts[s, :, kj * bk:(kj + 1) * bk] = acc
    y = parts[0]
    for s in range(1, slices):
        y = y + parts[s]
    return y[:m], reads


def _block_sparse(rng, n, k, bn, bk, keep):
    """``keep``: (N/bn, K/bk) bool, or a density.  Weights at the models'
    1/sqrt(N) scale."""
    if not isinstance(keep, np.ndarray):
        keep = rng.random((n // bn, k // bk)) < keep
    mask = np.repeat(np.repeat(keep, bn, 0), bk, 1)
    return (rng.normal(size=(n, k)) / np.sqrt(n) * mask).astype(np.float32)


UNEQUAL = np.array([[1, 0, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1],
                    [1, 0, 1, 1], [1, 0, 0, 1], [0, 0, 0, 1], [0, 0, 0, 1]],
                   dtype=bool)

# m, n, k, bn, bk, keep, extra steps above the longest column: MT 1 / 4 /
# 16 and a ragged M (3, 11); bn not a multiple of 32 (40, 107, 24);
# unequal columns with an empty one; density 0 (one padded block, every
# count 0); t_max at and above the longest column
DESIGN_CASES = [
    (4, 512, 32, 64, 16, 0.6, 3), (1, 640, 128, 40, 64, 0.5, 0),
    (3, 1712, 64, 107, 32, 0.7, 2), (11, 768, 96, 96, 24, UNEQUAL, 0),
    (11, 768, 96, 96, 24, UNEQUAL, 5), (16, 256, 64, 32, 16, 0.0, 0),
    (4, 256, 64, 32, 16, 0.0, 2), (2, 384, 48, 24, 12, 0.5, 1)]


@pytest.mark.parametrize("m,n,k,bn,bk,keep,extra", DESIGN_CASES)
def test_decode_design_matches_reference_naive_kernel(m, n, k, bn, bk, keep,
                                                      extra):
    """Slice by slice over ``split_plan``, live kept rows only, partials
    added left to right: within 1e-5 · max|y| of the reference's naive
    Pallas kernel (interpret mode, the same ``t_max``) and of the plain
    version; only the summation order differs."""
    rng = np.random.default_rng(m + n + k + extra)
    w = _block_sparse(rng, n, k, bn, bk, keep)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = ops.compress_bitmap(torch.from_numpy(w), bn, bk)
    t_max = max(c.max_per_col, 1) + extra
    y, _ = _naive_decode(torch.from_numpy(x), c, t_max)
    pallas = np.asarray(rops.bitmap_spmm(
        jnp.asarray(x), rops.compress_bitmap(w, bn, bk), bm=m, t_max=t_max,
        pipeline=False))
    plain = ref.bitmap_spmm_ref(torch.from_numpy(x), c.blocks, c.counts,
                                c.row_ids, n, k).numpy()
    assert y.shape == (m, k)
    for want in (pallas, plain):
        err = np.abs(y.numpy() - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("m,n,k,bn,bk,keep,extra", DESIGN_CASES)
def test_masked_pieces_are_the_reference_index_maps_reads(m, n, k, bn, bk,
                                                          keep, extra):
    """Each block-column reads (t_max - counts[kj]) masked steps, every
    piece of each once, each at the block the reference's index maps fetch
    (``min(off + t, nnzb - 1)``), in the slice whose range holds it or, past
    S·P, in the last slice."""
    rng = np.random.default_rng(m + n + k + extra)
    c = ops.compress_bitmap(torch.from_numpy(
        _block_sparse(rng, n, k, bn, bk, keep)), bn, bk)
    t_max = max(c.max_per_col, 1) + extra
    _, reads = _naive_decode(torch.zeros(m, n), c, t_max)
    slices, pieces = bm.split_plan(m, bn, bk, k, c.max_per_col)
    q = _cdiv(bn, PIECE)
    nnzb = c.blocks.shape[0]
    for kj in range(k // bk):
        cnt, off = int(c.counts[kj]), int(c.offsets[kj])
        got = sorted((blk, p % q) for j, _, blk, p in reads if j == kj)
        want = sorted((min(off + t, nnzb - 1), piece)
                      for t in range(cnt, t_max) for piece in range(q))
        assert got == want
    for _, s, _, p in reads:
        assert s == min(p // pieces, slices - 1)
    if extra:                       # the bound reaches past the slices
        assert any(p >= slices * pieces for _, _, _, p in reads)


def _operands(m, n, k, bn, bk, off=0, nnzb=2):
    """x, blocks, counts, row_ids, offsets; blocks a contiguous view
    starting ``off`` elements into its storage."""
    gk = k // bk
    blocks = torch.zeros(nnzb * bn * bk + off)[off:].view(nnzb, bn, bk)
    counts = torch.zeros(gk, dtype=torch.int32)
    counts[0] = nnzb
    return (torch.zeros(m, n), blocks, counts,
            torch.zeros(nnzb, dtype=torch.int32),
            torch.zeros(gk, dtype=torch.int32))


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("bn,bk,k", [(1024, 4096, 4096), (856, 256, 256),
                                     (1024, 13696, 13696), (64, 512, 2048)])
def test_naive_kernel_at_decode(m, bn, bk, k):
    """M ≤ 16, bk % 4 == 0, aligned blocks: the decode kernel on the
    pipelined decode entry's grid (K/bk · ceil(bk/256), S), then the reduce
    on (ceil(M·K/1024), 1) where S > 1; the entry's order is the
    pipelined one's."""
    n, mpc = 4 * bn, 2
    args = _operands(m, n, k, bn, bk)
    entry, slices, pieces = bm.select_entry(*args, k, mpc, pipeline=False)
    assert (entry, slices, pieces) == ("bitmap_spmm_naive",
                                       *bm.split_plan(m, bn, bk, k, mpc))
    assert bm.select_entry(*args, k, mpc)[0] == "bitmap_spmm_small_m"
    want = [("bitmap_spmm_small_m_kernel",
             (k // bk * _cdiv(bk, 256), slices))]
    if slices > 1:
        want.append(("bitmap_reduce_kernel", (_cdiv(m * k, 1024), 1)))
    assert bm.naive_kernel(m, n, k, bn, bk, mpc, True) == tuple(want)


@pytest.mark.parametrize("m", [17, 64, 512])
@pytest.mark.parametrize("bn,bk,k", [(1024, 4096, 4096), (856, 256, 256),
                                     (1024, 13696, 13696), (100, 200, 400)])
def test_naive_kernel_at_prefill(m, bn, bk, k):
    """M > 16, bk % 4 == 0, aligned blocks: the transpose on (ceil(N/32),
    M rounded up to 128 / 32), then the prefill kernel on
    ``prefill_plan``'s grid, one slice."""
    n = 4 * bn
    args = _operands(m, n, k, bn, bk)
    assert bm.select_entry(*args, k, 2, pipeline=False)[:2] == \
        ("bitmap_spmm_naive", 1)
    assert bm.select_entry(*args, k, 2)[0] == "bitmap_spmm"
    assert bm.naive_kernel(m, n, k, bn, bk, 2, True) == (
        ("bitmap_transpose_x_kernel", (_cdiv(n, 32), _cdiv(m, 128) * 4)),
        ("bitmap_spmm_prefill_kernel", bm.prefill_plan(m, bk, k).grid))


@pytest.mark.parametrize("m", [4, 16, 17, 512])
@pytest.mark.parametrize("bk,off", [(64, 1), (64, 3), (30, 0), (21, 0),
                                    (102, 0), (30, 2)])
def test_naive_kernel_takes_the_tiled_kernel_for_the_rest(m, bk, off):
    """Blocks off 16 bytes, or bk % 4 != 0, at decode and at prefill: the
    tiled kernel on (K / tile_k(bk), ceil(M / 64)), one slice, as the
    pipelined entry's tiled route."""
    k, bn, n = 2 * bk, 1024, 2048
    args = _operands(m, n, k, bn, bk, off)
    aligned = args[1].data_ptr() % 16 == 0
    assert aligned == (off == 0)
    assert bm.route(m, bk, aligned) == "tiled"
    assert bm.select_entry(*args, k, 2)[0] == "bitmap_spmm_tiled"
    assert bm.select_entry(*args, k, 2, pipeline=False)[:2] == \
        ("bitmap_spmm_naive", 1)
    assert bm.naive_kernel(m, n, k, bn, bk, 2, aligned) == (
        ("bitmap_spmm_kernel", (k // bm.tile_k(bk), _cdiv(m, 64))),)


@pytest.mark.parametrize("m,bk,off,numel", [
    (4, 4096, 0, "partials"), (16, 256, 0, "partials"), (1, 64, 0, "partials"),
    (17, 4096, 0, "xt"), (512, 256, 0, "xt"), (4, 4096, 1, None),
    (512, 4096, 1, None), (512, 30, 0, None)])
def test_naive_workspace_follows_the_kernel(m, bk, off, numel):
    """The naive decode kernel gets the (S, M, K) partials where S > 1, the
    naive prefill kernel x transposed to (N, M rounded up to 128) fp32, the
    tiled kernel none: the pipelined entry's workspace for the same
    operands."""
    k, bn, n = 2 * bk, 1024, 2048
    args = _operands(m, n, k, bn, bk, off)
    kind = bm.route(m, bk, args[1].data_ptr() % 16 == 0)
    _, slices, _ = bm.select_entry(*args, k, 2, pipeline=False)
    if numel == "partials":
        assert kind == "decode" and slices > 1
        assert bm.workspace_numel(m, k, slices) == slices * m * k
    elif numel == "xt":
        assert kind == "prefill" and slices == 1
        assert bm.xt_numel(m, n) == n * _cdiv(m, 128) * 128
    else:
        assert slices == 1 and bm.workspace_numel(m, k, slices) == 0
        assert kind in ("tiled", "decode")
