"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the reference, so it runs on a machine with a GPU
and no JAX:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips: the kernels have no CPU mode.
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest
import torch

import _bf16_serving as fx
from repro_torch.kernels import bitmap_spmm as bm_cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
    fa.reset_entry_counts()
    return torch.device("cuda", 0)


def _close(y, y_plain):
    torch.cuda.synchronize()
    err = (y - y_plain).abs().max().item()
    assert err <= 1e-4 * y_plain.abs().max().item() + 1e-5, err


def _block_sparse(rng, n, k, bn, bk, density):
    keep = np.repeat(np.repeat(rng.random((n // bn, k // bk)) < density,
                               bn, 0), bk, 1)
    return torch.from_numpy((rng.normal(size=(n, k)) * keep)
                            .astype(np.float32))


# m, n, k, bn, bk, density.  M <= 16 with bk % 4 == 0 takes the decode
# entry and, where split_plan gives S > 1, the split reduction: M 1 / 2 / 4
# / 8 / 16 (each row template) at chatglm3-6b widths (bn 1024 x bk 4096,
# bn 856 x bk 4096 with ragged pieces, bk 256, bk 13696 with a half-dead
# last column tile), several block-columns with unequal counts (empty
# trailing slices), density 0 and 1.  bk % 4 != 0 (30, 21) takes the
# tiled entry with one slice.  M > 16 takes the prefill entry: M 17, 70,
# 128, 129, 200 and 512 (ragged against both tiles' rows), chatglm3-6b's
# roles (bn 1024 x bk 4096 / 13696 / 256, bn 856 x bk 4096), an odd bn
# (100) with bk 200 (a ragged small-tile column), bk 1000 (a ragged
# big-tile column) over three block-columns, unequal counts, density 0
# and 1; bk 30 at M 129 takes the tiled entry.
BITMAP_CASES = [
    (1, 48, 40, 12, 20, 0.5), (70, 856 * 2, 192, 856, 96, 0.5),
    (5, 64, 32, 16, 8, 0.0), (3, 64, 64, 16, 16, 1.0),
    (1, 4096, 4096, 1024, 4096, 0.5), (2, 13696, 4096, 856, 4096, 0.5),
    (4, 4096, 256, 1024, 256, 0.5), (4, 13696, 4096, 856, 4096, 0.5),
    (8, 4096, 13696, 1024, 13696, 0.5), (16, 4096, 4096, 1024, 4096, 0.5),
    (16, 13696, 256, 856, 256, 0.5), (4, 4096, 1024, 128, 256, 0.4),
    (8, 2048, 2048, 64, 512, 0.3), (4, 2048, 512, 256, 512, 0.0),
    (2, 2048, 512, 256, 512, 1.0), (4, 96, 60, 24, 30, 0.5),
    (5, 80, 42, 16, 21, 0.5), (17, 4096, 4096, 1024, 4096, 0.5),
    (512, 4096, 4096, 1024, 4096, 0.5), (512, 4096, 256, 1024, 256, 0.5),
    (128, 4096, 13696, 1024, 13696, 0.5), (129, 13696, 4096, 856, 4096, 0.5),
    (17, 13696, 256, 856, 256, 0.5), (33, 1000, 400, 100, 200, 0.5),
    (512, 2048, 3000, 256, 1000, 0.5), (200, 800, 384, 100, 128, 0.0),
    (129, 512, 256, 64, 64, 1.0), (512, 1024, 1024, 128, 256, 0.4),
    (129, 96, 60, 24, 30, 0.5)]


@pytest.mark.parametrize("m,n,k,bn,bk,density", BITMAP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitmap_kernel_matches_plain(card, m, n, k, bn, bk, density, dtype):
    rng = np.random.default_rng(m + n + k)
    c = ops.compress_bitmap(_block_sparse(rng, n, k, bn, bk, density)
                            .to(card), bn, bk)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y = ops.bitmap_spmm(x, c)
    assert ops.launch_counts()["bitmap_spmm"] == 1
    _close(y, ref.bitmap_spmm_ref(x, c.blocks, c.counts, c.row_ids, c.n,
                                  c.k))


# m, n, k, n_sel, m_group.  M <= 16 takes the small-M entry (the naive
# decode kernel with pipeline=False) and, where split_plan gives S > 1, the
# split reduction: M 1 / 2 / 4 / 8 / 16 (each row template; M 3 ragged
# against its 4), chatglm3-6b widths (N 4096 at 2:4; N 13696 with a ragged
# last slice; K 256, K 4096, K 13696 with a half-dead last tile, ragged K
# 100), 1:4 and 3:8, and 16:32 (the naive decode kernel's run-time loop).
# M > 16 takes the prefill entry: serving's M 512 with wk/wv's
# K 256, M ragged against its 128-row tile (17, 33, 70, 129, 200), a long N,
# K ragged against its 128-column tile or not a multiple of 16 (100, 130,
# 384, 1000: staged by plain loads), 13 groups of 8 (a ragged last run) and
# the largest group, 16:32.  The naive entry's prefill kernel takes the same
# shapes (its 32 x 32 tile where the 128 x 128 grid has fewer than 64
# blocks) and a decode-sized M with K % 4 != 0 (M 4, K 102).
NM_CASES = [
    (1, 32, 24, 2, 4), (70, 128, 100, 1, 4), (4, 96, 64, 3, 8),
    (1, 4096, 256, 2, 4), (4, 4096, 4096, 2, 4), (4, 13696, 4096, 2, 4),
    (16, 13696, 256, 2, 4), (2, 4096, 13696, 2, 4), (8, 4096, 256, 1, 4),
    (4, 4096, 100, 1, 4), (4, 2048, 256, 3, 8), (17, 4096, 100, 2, 4),
    (512, 4096, 256, 2, 4), (200, 13696, 384, 2, 4), (129, 1024, 1000, 1, 4),
    (64, 104, 64, 3, 8), (33, 256, 130, 16, 32), (4, 2048, 256, 16, 32),
    (16, 4096, 4096, 2, 4), (3, 4096, 13696, 2, 4), (4, 1024, 102, 2, 4)]


@pytest.mark.parametrize("m,n,k,n_sel,m_group", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_kernel_matches_plain(card, m, n, k, n_sel, m_group, dtype):
    rng = np.random.default_rng(m + n + k)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, n_sel, m_group)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y = ops.nm_spmm(x, c)
    assert ops.launch_counts()["nm_spmm"] == 1
    _close(y, ref.nm_spmm_ref(x, c.values, c.indices, n_sel, m_group))


@pytest.mark.parametrize("m,n,k,bn,bk,density", BITMAP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitmap_naive_equals_pipelined(card, m, n, k, bn, bk, density,
                                       dtype):
    """Same slices, same FMA order in each, same sum of partials: bit for
    bit, with a static bound above the longest block-column too."""
    rng = np.random.default_rng(m + n + k + 1)
    c = ops.compress_bitmap(_block_sparse(rng, n, k, bn, bk, density)
                            .to(card), bn, bk)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y = ops.bitmap_spmm(x, c)
    for t_max in (None, c.max_per_col + 3):
        y_naive = ops.bitmap_spmm(x, c, t_max=t_max, pipeline=False)
        torch.cuda.synchronize()
        assert torch.equal(y_naive, y)
    assert ops.launch_counts()["bitmap_spmm"] == 1
    assert ops.launch_counts()["bitmap_spmm_naive"] == 2


def _unequal_columns(card):
    """Four block-columns of bn 128 x bk 256 keeping 3, 0, 1 and 8 of 8
    blocks: empty trailing slices, and a column with none."""
    keep = np.zeros((8, 4), dtype=bool)
    keep[[0, 3, 5], 0] = True
    keep[6, 2] = True
    keep[:, 3] = True
    rng = np.random.default_rng(11)
    mask = np.repeat(np.repeat(keep, 128, 0), 256, 1)
    w = torch.from_numpy((rng.normal(size=(1024, 1024)) * mask)
                         .astype(np.float32)).to(card)
    return ops.compress_bitmap(w, 128, 256), rng


@pytest.mark.parametrize("m", [1, 4, 16, 17, 129, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitmap_unequal_columns_and_an_empty_one(card, m, dtype):
    c, rng = _unequal_columns(card)
    assert c.counts.tolist() == [3, 0, 1, 8]
    x = torch.from_numpy(rng.normal(size=(m, 1024)).astype(np.float32)) \
        .to(card, dtype)
    y = ops.bitmap_spmm(x, c)
    _close(y, ref.bitmap_spmm_ref(x, c.blocks, c.counts, c.row_ids, c.n,
                                  c.k))
    for t_max in (None, 11):
        assert torch.equal(ops.bitmap_spmm(x, c, t_max=t_max,
                                           pipeline=False), y)
    assert ops.launch_counts()["bitmap_spmm"] == 1
    assert ops.launch_counts()["bitmap_spmm_naive"] == 2


@pytest.mark.parametrize("off", [1, 3])
@pytest.mark.parametrize("m", [4, 17, 129, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitmap_takes_misaligned_blocks(card, off, m, dtype):
    """A blocks view off 16 bytes takes the tiled entry with one slice;
    the naive entry follows it bit for bit, and above 16 rows so does the
    prefill entry on the aligned blocks."""
    n, k, bn, bk = 4096, 256, 1024, 256
    rng = np.random.default_rng(m + off)
    c = ops.compress_bitmap(_block_sparse(rng, n, k, bn, bk, 0.5).to(card),
                            bn, bk)
    nb = c.blocks.numel()
    v = torch.empty(nb + off, device=card)[off:].view(c.blocks.shape)
    v.copy_(c.blocks)
    assert v.data_ptr() % 16
    c_off = dataclasses.replace(c, blocks=v)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    assert bm_cuda.select_entry(x, v, c.counts, c.row_ids, c.offsets, k,
                                c.max_per_col)[0] == "bitmap_spmm_tiled"
    y = ops.bitmap_spmm(x, c_off)
    _close(y, ref.bitmap_spmm_ref(x, c.blocks, c.counts, c.row_ids, c.n,
                                  c.k))
    assert torch.equal(ops.bitmap_spmm(x, c_off, pipeline=False), y)
    if m > 16:
        assert torch.equal(ops.bitmap_spmm(x, c), y)
    assert ops.launch_counts()["bitmap_spmm"] == 1 + (m > 16)


@pytest.mark.parametrize("m", [17, 129, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitmap_prefill_takes_an_untileable_bk_by_the_tiled_entry(card, m,
                                                                 dtype):
    """bk = 30 (not whole 16-byte payload copies) takes the tiled entry;
    its outputs equal, bit for bit, those of the prefill entry on the same
    weight with each block-column padded by two zero columns (bk = 32):
    the same kept blocks, the same kept rows in the same order."""
    n, k, bn, bk = 1024, 120, 64, 30
    rng = np.random.default_rng(m)
    w = _block_sparse(rng, n, k, bn, bk, 0.5).to(card)
    w32 = torch.nn.functional.pad(w.view(n, k // bk, bk), (0, 2)) \
        .reshape(n, k // bk * 32)
    c, c32 = ops.compress_bitmap(w, bn, bk), ops.compress_bitmap(w32, bn, 32)
    assert torch.equal(c.counts, c32.counts)
    assert torch.equal(c.row_ids, c32.row_ids)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    for cc, entry in ((c, "bitmap_spmm_tiled"), (c32, "bitmap_spmm")):
        assert bm_cuda.select_entry(x, cc.blocks, cc.counts, cc.row_ids,
                                    cc.offsets, cc.k,
                                    cc.max_per_col)[0] == entry
    y, y32 = ops.bitmap_spmm(x, c), ops.bitmap_spmm(x, c32)
    _close(y, ref.bitmap_spmm_ref(x, c.blocks, c.counts, c.row_ids, c.n,
                                  c.k))
    assert torch.equal(y32.view(m, k // bk, 32)[:, :, :bk].reshape(m, k), y)
    assert torch.equal(ops.bitmap_spmm(x, c, pipeline=False), y)
    assert ops.launch_counts()["bitmap_spmm"] == 2


def _launched(fn, path):
    """(kernel name, grid) of every kernel ``fn()`` launches, from the
    first complete CUDA-only profiler trace of it between marker kernels
    (``repro_torch.kernels.trace``: the profiler loses whole traces or
    their first kernel, never a kernel between two it kept)."""
    from repro_torch.kernels import trace
    return [(e.name, e.grid) for e in trace.traced(fn, path)
            if e.cat == "kernel"]


@pytest.mark.parametrize("m,n,k,bn,bk,off", [
    (4, 4096, 4096, 1024, 4096, 0), (1, 13696, 256, 856, 256, 0),
    (16, 1024, 1024, 128, 256, 0), (17, 4096, 256, 1024, 256, 0),
    (512, 13696, 4096, 856, 4096, 0), (129, 1000, 400, 100, 200, 0),
    (4, 4096, 256, 1024, 256, 1), (512, 4096, 256, 1024, 256, 3),
    (4, 96, 60, 24, 30, 0)])
def test_bitmap_naive_trace_equals_naive_kernel(card, tmp_path, m, n, k, bn,
                                                bk, off):
    """A naive call launches the kernels ``naive_kernel`` names, in order,
    on its grids, the bitmap kernels as their NAIVE = true instances: the
    decode kernel (and the reduce where S > 1), the transpose and the
    prefill kernel, or the tiled kernel for blocks off 16 bytes or bk % 4
    != 0; with t_max above the longest column the same launches."""
    rng = np.random.default_rng(m + n + k + off)
    c = ops.compress_bitmap(_block_sparse(rng, n, k, bn, bk, 0.5).to(card),
                            bn, bk)
    if off:
        v = torch.empty(c.blocks.numel() + off, device=card)[off:] \
            .view(c.blocks.shape)
        v.copy_(c.blocks)
        c = dataclasses.replace(c, blocks=v)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, torch.bfloat16)
    want = bm_cuda.naive_kernel(m, n, k, bn, bk, c.max_per_col,
                                c.blocks.data_ptr() % 16 == 0)
    assert (len(want) == 1) == bool(off or bk % 4)

    def same(ran):
        return len(ran) == len(want) and all(
            name in r and g == tuple(grid) + (1,) * (3 - len(grid))
            and ("transpose" in name or "reduce" in name
                 or re.search(r"\btrue>", r))
            for (name, grid), (r, g) in zip(want, ran))

    calls = []

    def call(t_max):
        calls.append(t_max)
        ops.bitmap_spmm(x, c, t_max=t_max, pipeline=False)

    for t_max in (None, c.max_per_col + 2):
        # the first complete trace must show exactly the kernels
        # naive_kernel names
        ran = _launched(lambda: call(t_max), tmp_path / "trace.json")
        assert same(ran), (ran, want)
    assert ops.launch_counts()["bitmap_spmm_naive"] == len(calls)


def test_bf16_serving_holds_to_the_reference_fixture(card):
    """Reduced chatglm3-6b on the shipped bitmap plan, bf16, greedy: the
    tokens of the reference's run (``tests/fixtures``, regenerated from
    the reference by ``tests/test_torch_bf16_fixture.py``) and each step's
    top logits within ``tests/test_torch_bf16.py``'s bound."""
    tokens, steps = fx.port_run("cuda")
    assert fx.misses(fx.load(), tokens, steps) == []
    assert ops.launch_counts()["bitmap_spmm"] == 7 * 2 * fx.GEN


@pytest.mark.parametrize("m,n,k,n_sel,m_group", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_naive_equals_pipelined(card, m, n, k, n_sel, m_group, dtype):
    """Ascending n, kept values and exact zeros, the same slices and the
    same sum of partials: bit for bit."""
    rng = np.random.default_rng(m + n + k + 1)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, n_sel, m_group)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y_naive = ops.nm_spmm(x, c, pipeline=False)
    _close(y_naive, ref.nm_spmm_ref(x, c.values, c.indices, n_sel, m_group))
    assert torch.equal(y_naive, ops.nm_spmm(x, c))
    assert ops.launch_counts()["nm_spmm_naive"] == 1


@pytest.mark.parametrize("v_off,i_off", [(1, 0), (0, 1), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_prefill_takes_misaligned_operands(card, v_off, i_off, dtype):
    """Values and indices at offsets off 16 bytes take the prefill entry's
    plain-load staging; the result equals the 16-byte staging's bit for
    bit."""
    m, n, k = 70, 512, 256
    rng = np.random.default_rng(m + n + k + v_off + i_off)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, 2, 4)
    rows = c.values.shape[0]
    v = torch.empty(rows * k + v_off, device=card)[v_off:].view(rows, k)
    i = torch.empty(rows * k + i_off, dtype=torch.int8,
                    device=card)[i_off:].view(rows, k)
    v.copy_(c.values)
    i.copy_(c.indices)
    assert v.data_ptr() % 16 or i.data_ptr() % 16
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y = ops.nm_spmm(x, c)
    y_off = ops.nm_spmm(x, dataclasses.replace(c, values=v, indices=i))
    torch.cuda.synchronize()
    assert torch.equal(y_off, y)
    assert ops.launch_counts()["nm_spmm"] == 2


@pytest.mark.parametrize("v_off,i_off", [(1, 0), (0, 1), (3, 5)])
@pytest.mark.parametrize("n_sel,m_group", [(2, 4), (1, 4), (3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_naive_decode_takes_misaligned_operands(card, v_off, i_off, n_sel,
                                                   m_group, dtype):
    """At M = 4 values off 16 bytes or indices off 4 take the naive decode
    kernel's plain loads; the result equals, bit for bit, the naive and the
    pipelined results on aligned copies."""
    m, n, k = 4, 4096, 4096
    rng = np.random.default_rng(m + n + v_off + i_off + n_sel)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, n_sel, m_group)
    rows = c.values.shape[0]
    v = torch.empty(rows * k + v_off, device=card)[v_off:].view(rows, k)
    i = torch.empty(rows * k + i_off, dtype=torch.int8,
                    device=card)[i_off:].view(rows, k)
    v.copy_(c.values)
    i.copy_(c.indices)
    assert v.data_ptr() % 16 or i.data_ptr() % 4
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y_off = ops.nm_spmm(x, dataclasses.replace(c, values=v, indices=i),
                        pipeline=False)
    y_naive = ops.nm_spmm(x, c, pipeline=False)
    y = ops.nm_spmm(x, c)
    torch.cuda.synchronize()
    _close(y_off, ref.nm_spmm_ref(x, c.values, c.indices, n_sel, m_group))
    assert torch.equal(y_off, y_naive)
    assert torch.equal(y_off, y)
    assert ops.launch_counts()["nm_spmm_naive"] == 2
    assert ops.launch_counts()["nm_spmm"] == 1


@pytest.mark.parametrize("v_off,i_off", [(1, 0), (0, 1), (0, 4), (3, 5)])
@pytest.mark.parametrize("m", [33, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_naive_prefill_takes_misaligned_operands(card, v_off, i_off, m,
                                                    dtype):
    """Above 16 rows values off 16 bytes, or indices off 4 or 16, take the
    naive prefill kernel's plain staging (M 33: the small tile, M 512: the
    big one); the result equals, bit for bit, the naive and the pipelined
    results on aligned copies."""
    n, k = 1024, 4096
    rng = np.random.default_rng(m + n + v_off + i_off)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, 2, 4)
    rows = c.values.shape[0]
    v = torch.empty(rows * k + v_off, device=card)[v_off:].view(rows, k)
    i = torch.empty(rows * k + i_off, dtype=torch.int8,
                    device=card)[i_off:].view(rows, k)
    v.copy_(c.values)
    i.copy_(c.indices)
    assert v.data_ptr() % 16 or i.data_ptr() % 16
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)) \
        .to(card, dtype)
    y_off = ops.nm_spmm(x, dataclasses.replace(c, values=v, indices=i),
                        pipeline=False)
    y_naive = ops.nm_spmm(x, c, pipeline=False)
    y = ops.nm_spmm(x, c)
    torch.cuda.synchronize()
    _close(y_off, ref.nm_spmm_ref(x, c.values, c.indices, 2, 4))
    assert torch.equal(y_off, y_naive)
    assert torch.equal(y_off, y)
    assert ops.launch_counts()["nm_spmm_naive"] == 2
    assert ops.launch_counts()["nm_spmm"] == 1


# bh, sq, skv, d: the reference's test shapes, Sq != Skv, ragged tiles,
# D up to 256.  At bf16, D 64 and 128 take the tensor-core entry: the
# second row's cases are ragged against its 128-row query and 128-key
# tiles, Sq != Skv both ways under the top-left causal mask, Skv >= 1024
# (the two-stage K / V ring wraps four times or more), and BH > 1 with
# several query tiles (heaviest first).  The last rows are ragged against
# the FMA entry's tiles, Sq and Skv one past a multiple of BQ and BKV (128
# and 128 (fp32) or 64 (bf16) at D <= 128, 128 and 64 at D <= 64 and
# D <= 32, 64 and 64 (fp32) or 32 (bf16) at D <= 256), with D = 256, 1
@pytest.mark.parametrize("bh,sq,skv,d", [
    (2, 64, 64, 32), (4, 128, 128, 64), (1, 32, 32, 128), (3, 96, 96, 16),
    (2, 32, 64, 32), (3, 100, 70, 48), (1, 130, 130, 200),
    (2, 100, 70, 128), (3, 70, 200, 64), (2, 200, 130, 128),
    (1, 1100, 1100, 128), (2, 33, 1030, 64), (6, 300, 300, 128),
    (5, 257, 1024, 128),
    (2, 129, 65, 128), (1, 257, 129, 128), (1, 257, 129, 64),
    (2, 65, 33, 256), (1, 129, 321, 256), (2, 129, 65, 1), (3, 65, 193, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, bh, sq, skv, d, causal, dtype):
    """fp32 to 1e-4·max + 1e-5; bf16 per element to
    ``ref.flash_attention_bf16_tol`` (both round the output and every
    softmax weight to bf16 once, at different places)."""
    rng = np.random.default_rng(bh + sq + skv + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d))
                                .astype(np.float32)).to(card, dtype)
               for s in (sq, skv, skv))
    o = ops.flash_attention(q, k, v, causal=causal, bq=sq, bk=skv)
    assert o.dtype == dtype and o.shape == q.shape
    assert ops.launch_counts()["flash_attention"] == 1
    entry = fa.select_entry(dtype, d, True)
    assert fa.entry_counts()[entry] == 1
    o_plain = ref.flash_attention_ref(q, k, v, causal)
    diff = (o.float() - o_plain.float()).abs()
    if dtype == torch.float32:
        tol = 1e-4 * o_plain.abs().max() + 1e-5
    else:
        tol = ref.flash_attention_bf16_tol(q, k, v, o_plain, causal)
    assert bool((diff <= tol).all()), (diff - tol).max().item()


def test_flash_routes_bf16_to_the_tensor_core_entry(card):
    """bf16 at D = 128 launches the tensor-core entry, fp32 and a bf16
    operand off a 16-byte boundary the FMA entry; each result holds to the
    plain version."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2, 256, 128))
                         .astype(np.float32)).to(card)
    q, k, v = x
    o = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert fa.entry_counts() == {"tensor_core": 1, "fma": 0}
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    o_plain = ref.flash_attention_ref(qb, kb, vb, True)
    tol = ref.flash_attention_bf16_tol(qb, kb, vb, o_plain, True)
    assert bool(((o.float() - o_plain.float()).abs() <= tol).all())
    o32 = ops.flash_attention(q, k, v)
    assert fa.entry_counts() == {"tensor_core": 1, "fma": 1}
    _close(o32, ref.flash_attention_ref(q, k, v, True))
    off = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                      device=card)[1:].view(q.shape)
    off.copy_(qb)
    assert off.data_ptr() % 16
    o_off = ops.flash_attention(off, kb, vb)
    assert fa.entry_counts() == {"tensor_core": 1, "fma": 2}
    assert bool(((o_off.float() - o_plain.float()).abs() <= tol).all())
    assert ops.launch_counts()["flash_attention"] == 3


def test_flash_wrapper_refuses_bad_operands(card):
    q = torch.ones(1, 8, 16, device=card)
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, ::2], q[:, ::2], q[:, ::2])
    with pytest.raises(ValueError):
        ops.flash_attention(torch.ones(1, 8, 300, device=card),
                            torch.ones(1, 8, 300, device=card),
                            torch.ones(1, 8, 300, device=card))
    assert ops.launch_counts()["flash_attention"] == 0


def test_wrappers_refuse_bad_operands(card):
    c = ops.compress_nm(torch.ones(8, 4, device=card))
    with pytest.raises(TypeError):
        ops.nm_spmm(torch.ones(2, 8, device=card, dtype=torch.float16), c)
    with pytest.raises(ValueError):
        ops.nm_spmm(torch.ones(2, 12, device=card), c)
    assert ops.launch_counts()["nm_spmm"] == 0


def test_serving_entry_points_accept_the_default_device(card):
    """``device="cuda"`` (no index) must match tensors on ``cuda:N``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b").reduced()
    params = Model(cfg).init(seed=0)
    cm, pruned = serve.compressed_model(cfg, params)
    toks, _, _ = cm.generate(pruned, torch.zeros(2, 4, dtype=torch.long), 2)
    assert toks.shape == (2, 2) and toks.device.type == "cuda"
    assert ops.launch_counts()["bitmap_spmm"] == 7 * cfg.n_layers * 3


def test_kernel_guard_raises_when_a_kernel_fails_to_build(card,
                                                          monkeypatch):
    """The guard demotes only injected faults: on the card a kernel that
    does not build raises, and nothing is served by the plain matmul."""
    from repro_torch import exec as texec
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b").reduced()
    cm, pruned = serve.compressed_model(cfg, Model(cfg).init(seed=0))

    def no_build(name):
        raise RuntimeError(f"{name}: nvcc failed")

    monkeypatch.setattr(build, "library", no_build)
    ops.reset_launch_counts()
    failed = []
    with texec.kernel_guard(lambda role, e: failed.append(role)), \
            pytest.raises(RuntimeError, match="nvcc failed"):
        cm.generate(pruned, torch.zeros(2, 4, dtype=torch.long), 2)
    assert failed == []
    assert sum(ops.launch_counts().values()) == 0


def test_naive_serving_launches_only_the_naive_kernel(card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b").reduced()
    cm, pruned = serve.compressed_model(cfg, Model(cfg).init(seed=0))
    prompts = torch.zeros(2, 4, dtype=torch.long)
    toks, _, _ = cm.generate(pruned, prompts, 2)
    ops.reset_launch_counts()
    with ops.pipeline_default(False):
        toks_naive, _, _ = cm.generate(pruned, prompts, 2)
    assert torch.equal(toks_naive, toks)
    assert ops.launch_counts() == {
        "bitmap_spmm": 0, "bitmap_spmm_naive": 7 * cfg.n_layers * 3,
        "nm_spmm": 0, "nm_spmm_naive": 0, "flash_attention": 0}


# ---------------------------------------------------------------------------
# The compiled decode step: a CUDA graph of decode_step
# ---------------------------------------------------------------------------

def _as_nm(plan):
    """The same plan with every sparse role 2:4 (the reduced config ships
    a bitmap plan only)."""
    return dataclasses.replace(
        plan, w_sparsity={"kind": "nm", "n": 2, "m": 4},
        ops=tuple(dataclasses.replace(op, choice=dataclasses.replace(
            op.choice, kind="nm", block_n=0, block_k=0,
            format_str="CP(2:4)")) for op in plan.ops))


def _served(kind, full_width=False):
    """(cfg, compressed model, pruned params) on the card: reduced
    chatglm3-6b, or full width cut to 2 layers."""
    from repro_torch.configs import get_config
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b")
    cfg = dataclasses.replace(cfg, n_layers=2) if full_width \
        else cfg.reduced()
    plan = shipped_plan(cfg, "bitmap")
    if kind == "nm":
        plan = _as_nm(plan) if not full_width else shipped_plan(cfg, "nm")
    cm, pruned = serve.compressed_model(cfg, Model(cfg).init(seed=0), plan)
    return cfg, cm, pruned


def _prompts(cfg, b=2, s=6, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")


def _graph_equals_eager(model, params, prompts, gen, per_row=False):
    """The graph's greedy tokens and each decode step's logits are
    ``torch.equal`` to the eager step's (``model.decode_step``)."""
    from repro_torch.launch import compiled
    toks, steps = compiled.greedy(compiled.CompiledStep(model), model,
                                  params, prompts, gen, per_row)
    toks_e, steps_e = compiled.greedy(model.decode_step, model, params,
                                      prompts, gen, per_row)
    assert torch.equal(toks, toks_e)
    for i, (lg, lg_e) in enumerate(zip(steps, steps_e)):
        assert torch.equal(lg, lg_e), \
            (i, (lg - lg_e).abs().max().item())


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_graph_equals_eager(card, kind, pipeline, per_row):
    """Reduced chatglm3-6b, bf16: the graph's tokens and every step's
    logits equal the eager step's; the first step captures, the rest
    replay."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served(kind)
    with ops.pipeline_default(pipeline):
        _graph_equals_eager(cm, pruned, _prompts(cfg), 6, per_row)
    (g,) = compiled.graphs(cm).values()
    assert g.replays == 4 and g.pos.shape == ((2,) if per_row else ())


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_graph_equals_eager_at_full_width(card, kind):
    """chatglm3-6b at full width, 2 layers, batch 4: both variants, a
    scalar and a per-row position."""
    cfg, cm, pruned = _served(kind, full_width=True)
    prompts = _prompts(cfg, b=4, s=16)
    for pipeline in (True, False):
        with ops.pipeline_default(pipeline):
            for per_row in (False, True):
                _graph_equals_eager(cm, pruned, prompts, 5, per_row)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_graph_equals_eager(card, dtype, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    monkeypatch.setattr(L, "COMPUTE_DTYPE", dtype)
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    _graph_equals_eager(model, model.init(seed=0), _prompts(cfg), 6)
    assert ops.launch_counts()["bitmap_spmm"] == 0


def test_a_second_generate_replays_the_cached_graph(card):
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served("bitmap")
    cm.generate(pruned, _prompts(cfg), 6)    # 6 steps: a capture, 5 replays
    (g,) = compiled.graphs(cm).values()
    assert g.replays == 5
    prompts = _prompts(cfg, seed=1)
    toks, _, _ = cm.generate(pruned, prompts, 6)
    assert list(compiled.graphs(cm).values())[0] is g and g.replays == 11
    with compiled.disable():
        eager, _, _ = cm.generate(pruned, prompts, 6)
    assert torch.equal(toks, eager)
    _graph_equals_eager(cm, pruned, _prompts(cfg, seed=2), 6)
    assert len(compiled.graphs(cm)) == 1 and g.replays == 16


def test_the_variant_and_the_dtype_each_get_their_own_graph(card,
                                                             monkeypatch):
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    cfg, cm, pruned = _served("nm")
    prompts = _prompts(cfg)
    _graph_equals_eager(cm, pruned, prompts, 6)
    ops.reset_launch_counts()
    with ops.pipeline_default(False):
        _graph_equals_eager(cm, pruned, prompts, 6)
    assert ops.launch_counts()["nm_spmm"] == 0
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    for pipeline in (True, False):
        with ops.pipeline_default(pipeline):
            _graph_equals_eager(cm, pruned, prompts, 6)
    keys = list(compiled.graphs(cm))
    assert {(k[3], k[4]) for k in keys} == {
        (dt, p) for dt in (torch.bfloat16, torch.float32)
        for p in (True, False)}
    assert all(g.replays == 4 for g in compiled.graphs(cm).values())


def test_two_caches_at_one_key_take_turns_only_by_a_copy(card):
    """One graph serves one sequence at a time: a second sequence's cache
    is copied into the graph's own, and the first sequence's cache,
    handed out before that copy, then raises instead of decoding the
    second's K / V.  Each step equals the eager step on its own cache."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served("bitmap")
    step = compiled.CompiledStep(cm)
    seqs = []
    for seed in (1, 2):
        prompts = _prompts(cfg, seed=seed)
        logits, cache = cm.prefill(pruned, prompts, 10)
        _, eager = cm.prefill(pruned, prompts, 10)
        seqs.append([logits[:, -1].argmax(dim=-1), cache, eager])

    def both(i, p):
        tok, cache, eager = seqs[i]
        pos = torch.full((), p, dtype=torch.long, device=card)
        got, cache = step(pruned, cache, tok, pos)
        want, eager = cm.decode_step(pruned, eager, tok, pos)
        assert torch.equal(got, want)
        assert torch.equal(cache["self"]["k"], eager["self"]["k"])
        seqs[i] = [got.argmax(dim=-1), cache, eager]

    both(0, 6)                            # the capture
    both(1, 6)                            # the second cache copied in
    with pytest.raises(RuntimeError, match="another cache"):
        step(pruned, seqs[0][1], seqs[0][0],
             torch.full((), 7, dtype=torch.long, device=card))
    both(1, 7)                            # the second goes on
    (g,) = compiled.graphs(cm).values()
    assert g.replays == 2 and g.serial == 1


def test_a_model_holds_at_most_max_graphs(card, monkeypatch):
    """Past ``MAX_GRAPHS`` keys the least recently used graph goes."""
    from repro_torch.launch import compiled
    monkeypatch.setattr(compiled, "MAX_GRAPHS", 2)
    cfg, cm, pruned = _served("bitmap")
    prompts = _prompts(cfg)

    def lengths():
        return [k[1] for k in compiled.graphs(cm)]

    for gen in (3, 4, 5):
        cm.generate(pruned, prompts, gen)
    assert lengths() == [10, 11]
    cm.generate(pruned, prompts, 4)       # a replay: now the most recent
    assert lengths() == [11, 10]
    toks, _, _ = cm.generate(pruned, prompts, 3)
    assert lengths() == [10, 9]
    with compiled.disable():
        eager, _, _ = cm.generate(pruned, prompts, 3)
    assert torch.equal(toks, eager)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_launch_counts_are_exact_after_replays(card, kind):
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served(kind)
    for pipeline in (True, False):
        name = ("bitmap_spmm" if kind == "bitmap" else "nm_spmm") + \
            ("" if pipeline else "_naive")
        with ops.pipeline_default(pipeline):
            for run in range(2):          # the capture, then replays only
                ops.reset_launch_counts()
                cm.generate(pruned, _prompts(cfg, seed=run), 5)
                counts = ops.launch_counts()
                assert counts[name] == 7 * cfg.n_layers * (1 + 5)
                assert sum(counts.values()) == counts[name]
    for g in compiled.graphs(cm).values():
        assert sum(g.launches.values()) == 7 * cfg.n_layers


def _hooked(name, calls):
    from repro_torch import exec as texec
    if name == "instrument":
        return texec.instrument()
    if name == "kernel_guard":
        return texec.kernel_guard(lambda role, e: calls.append(role))
    if name == "kernel_fault_hook":
        return ops.kernel_fault_hook(calls.append)
    return ops.kernel_dispatch_hook(lambda kind, s: calls.append(kind))


@pytest.mark.parametrize("name", ["instrument", "kernel_guard",
                                  "kernel_fault_hook",
                                  "kernel_dispatch_hook"])
def test_a_hook_is_called_at_every_step(card, name):
    """With a hook active every step runs eagerly: the hook hears each
    dispatch of every step, and no graph is captured."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served("bitmap")
    calls = []
    with _hooked(name, calls) as counters:
        toks, _, _ = cm.generate(pruned, _prompts(cfg), 5)
    assert compiled.graphs(cm) == {}
    per_run = 7 * cfg.n_layers * (1 + 5)
    if name == "instrument":
        assert sum(c.calls for c in counters.values()) == per_run
    elif name == "kernel_guard":
        assert calls == []                # nothing failed
    else:
        assert len(calls) == per_run
    assert ops.launch_counts()["bitmap_spmm"] == per_run
    with compiled.disable():
        eager, _, _ = cm.generate(pruned, _prompts(cfg), 5)
    assert torch.equal(toks, eager)


def test_kernel_timer_reads_device_seconds_once_at_exit(card):
    """On the card ``kernel_timer`` records a CUDA event pair around each
    dispatch and reads none of them before the context exits: inside it
    the trace's kernel events have no duration and the histogram holds
    nothing; after it there is one positive device duration per dispatch,
    and the counts equal the launches."""
    from repro_torch.obs import metrics as omet
    from repro_torch.obs import trace as otr
    from repro_torch.obs.profile import kernel_timer
    cfg, cm, pruned = _served("bitmap")
    reg, tracer = omet.MetricsRegistry(), otr.Tracer()
    with kernel_timer(registry=reg, tracer=tracer):
        cm.generate(pruned, _prompts(cfg), 5)
        inside = [e for e in tracer.events if e["ph"] == "X"]
        assert inside and all(e["dur"] == 0.0 for e in inside)
        assert reg.snapshot()["histograms"] == {}
    n = 7 * cfg.n_layers * (1 + 5)
    assert ops.launch_counts()["bitmap_spmm"] == n
    assert reg.value("kernel_dispatch_total", kind="bitmap") == n
    xs = [e for e in tracer.events if e["ph"] == "X"]
    assert len(xs) == n and all(e["dur"] > 0 for e in xs)
    assert all(e["name"] == "kernel:bitmap" for e in xs)
    hist = reg.snapshot()["histograms"][
        "kernel_dispatch_seconds{kind=bitmap}"]
    assert hist["count"] == n and hist["sum"] > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_gqagroup_graph_equals_eager(card, kind, dtype, monkeypatch):
    """Under the ``gqagroup`` flag the graph's tokens and every decode
    step's logits are ``torch.equal`` to the eager step's, both variants,
    a scalar and a per-row position."""
    from repro_torch.models import layers as L
    from repro_torch.models import optflags
    monkeypatch.setattr(L, "COMPUTE_DTYPE", dtype)
    cfg, cm, pruned = _served(kind)
    with optflags.optimizations(("gqagroup",)):
        for pipeline in (True, False):
            with ops.pipeline_default(pipeline):
                for per_row in (False, True):
                    _graph_equals_eager(cm, pruned, _prompts(cfg), 6,
                                        per_row)


def test_a_graph_is_never_replayed_across_a_flag_change(card):
    """A graph captured with ``gqagroup`` off is not replayed with it on:
    the flags are part of the key, so each setting captures its own graph
    and replays only under it, each step equal to the eager step under
    the same flags."""
    from repro_torch.launch import compiled
    from repro_torch.models import optflags
    cfg, cm, pruned = _served("bitmap")
    prompts = _prompts(cfg)
    _graph_equals_eager(cm, pruned, prompts, 6)
    (off,) = compiled.graphs(cm).values()
    with optflags.optimizations(("gqagroup",)):
        _graph_equals_eager(cm, pruned, prompts, 6)
    on = [g for g in compiled.graphs(cm).values() if g is not off]
    assert len(on) == 1 and off.replays == 4 and on[0].replays == 4
    assert {k[-1] for k in compiled.graphs(cm)} == {
        frozenset(), frozenset({"gqagroup"})}
    _graph_equals_eager(cm, pruned, prompts, 6)   # 5 steps, all replays
    assert off.replays == 9 and on[0].replays == 4


def test_memory_returns_after_the_model_is_deleted(card):
    import gc
    from repro_torch.launch import compiled

    def serve_once():
        cfg, cm, pruned = _served("bitmap", full_width=True)
        cm.generate(pruned, _prompts(cfg, b=4, s=16), 5)
        assert len(compiled.graphs(cm)) == 1
        return torch.cuda.memory_allocated()

    serve_once()          # the capture stream's cuBLAS workspace persists
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    held = serve_once()
    gc.collect()
    torch.cuda.empty_cache()
    assert held > base + (1 << 30)
    assert torch.cuda.memory_allocated() == base


@pytest.mark.parametrize("pipeline", [True, False])
def test_prefill_kernels_capture_into_a_graph(card, pipeline):
    """The prefill entries call cudaFuncSetAttribute at every launch (the
    decode entries of the serving path do not): a CUDA graph's capture
    takes that call, and the replay equals the eager call."""
    rng = np.random.default_rng(11)
    cb = ops.compress_bitmap(
        _block_sparse(rng, 4096, 1024, 256, 256, 0.5).to(card), 256, 256)
    cn = ops.compress_nm(torch.from_numpy(
        rng.normal(size=(4096, 1024)).astype(np.float32)).to(card))
    x = torch.from_numpy(rng.normal(size=(512, 4096)).astype(np.float32)) \
        .to(card, torch.bfloat16)

    def both():
        return (ops.bitmap_spmm(x, cb, pipeline=pipeline),
                ops.nm_spmm(x, cn, pipeline=pipeline))

    want = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = both()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The continuous-batching mixer and ragged serving on the card
# ---------------------------------------------------------------------------

MIX_PLENS = [3, 5, 7, 9, 11, 4, 6, 13]
MIX_NEW = [6, 7, 8, 6, 7, 8, 6, 7]


def _mix_requests(cfg, seed=0):
    """``tests/test_mixer.py``'s stream: 8 prompts into 3 slots."""
    from repro_torch.launch.mixer import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=f"r{i}", prompt=rng.integers(1, cfg.vocab, (p,)),
                    max_new=n)
            for i, (p, n) in enumerate(zip(MIX_PLENS, MIX_NEW))]


def _mix(model, params, reqs, record=False):
    """(mixer, tokens per request, logits per request or None) of one
    stream, 3 slots, max_len 48."""
    from repro_torch.launch.mixer import Mixer
    from repro_torch.launch.record import record_logits
    mx = Mixer(model, params, slots=3, max_len=48)
    logits = record_logits(mx, lambda t: t.float().cpu()) if record \
        else None
    return mx, [torch.from_numpy(r.tokens) for r in mx.run(reqs)], logits


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_mixer_graph_equals_eager(card, kind, pipeline):
    """Reduced chatglm3-6b, bf16: a stream through the graph gives every
    request the eager stream's tokens; each stream launches the served
    kernel 7 x layers x (admissions + decode steps) times, nothing else."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served(kind)
    name = ("bitmap_spmm" if kind == "bitmap" else "nm_spmm") + \
        ("" if pipeline else "_naive")
    runs = []
    with ops.pipeline_default(pipeline):
        for mode in ("graph", "eager"):
            ops.reset_launch_counts()
            with compiled.disable() if mode == "eager" \
                    else contextlib.nullcontext():
                mx, toks, _ = _mix(cm, pruned, _mix_requests(cfg))
            st, counts = mx.stats(), ops.launch_counts()
            assert counts[name] == sum(counts.values()) == \
                7 * cfg.n_layers * (st["admits"] + st["steps"])
            assert st["slot_reuse_admits"] >= 1
            runs.append(toks)
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), (i, a, b)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_mixer_stream_keeps_one_graph_without_a_copy(card, kind):
    """The stream that captures the mixer's graph leaves ``serial`` 0: its
    admissions after the capture write into the graph's own K / V through
    the handle, which stays valid.  A second stream copies its first
    cache in once (serial 1)."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served(kind)
    mx, toks, _ = _mix(cm, pruned, _mix_requests(cfg))
    steps = mx.stats()["steps"]
    (g,) = compiled.graphs(cm).values()
    assert g.serial == 0 and g.replays == steps - 1
    assert g.pos.shape == (3,) and g.tokens.shape == (3,)
    assert mx.cache.graph() is g
    assert mx.cache["self"]["k"] is g.cache["self"]["k"]
    assert any(e["event"] == "admit" and e["step"] > 0 for e in mx.events)
    _, again, _ = _mix(cm, pruned, _mix_requests(cfg))
    assert list(compiled.graphs(cm).values()) == [g]
    assert g.serial == 1 and g.replays == 2 * steps - 1
    for a, b in zip(toks, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_stale_mixer_cannot_write_another_streams_cache(card, kind):
    """Two mixers at one key, interleaved: the first one's step captures
    the graph, the second one's copies its cache in.  An admission through
    the first mixer's handle then raises and leaves the second stream's
    K / V as they were, and the second stream decodes on."""
    from repro_torch.launch import compiled
    from repro_torch.launch.mixer import Mixer
    cfg, cm, pruned = _served(kind)
    reqs = _mix_requests(cfg)
    first = Mixer(cm, pruned, slots=3, max_len=48)
    second = Mixer(cm, pruned, slots=3, max_len=48)
    for mx, batch in ((first, reqs[:2]), (second, reqs[2:5])):
        for req in batch:
            mx.admit(req)
        mx._step()
    (g,) = compiled.graphs(cm).values()
    assert g.serial == 1 and second.cache.graph() is g
    before = {name: t.clone() for name, t in g.cache["self"].items()}
    with pytest.raises(RuntimeError, match="taken another cache"):
        first.admit(reqs[5])
    for name, t in g.cache["self"].items():
        assert torch.equal(t, before[name])
    second._step()
    assert g.serial == 1 and g.replays == 2


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_ragged_generate_graph_equals_eager(card, kind):
    """Left-padded rows decode with a (B,) position through the graph:
    tokens equal the eager run's."""
    from repro_torch.launch import compiled
    cfg, cm, pruned = _served(kind)
    rng = np.random.default_rng(4)
    rows = [rng.integers(1, cfg.vocab, (p,)) for p in (3, 7, 5)]
    batch = torch.tensor(np.stack([np.concatenate([np.zeros(7 - len(r),
                                                            np.int64), r])
                                   for r in rows]), device=card)
    toks, _, _ = cm.generate(pruned, batch, 6, prompt_pad_id=0)
    ((key, g),) = compiled.graphs(cm).items()
    assert key[2] == 1 and g.replays == 5 and toks.dtype == torch.int32
    with compiled.disable():
        eager, _, _ = cm.generate(pruned, batch, 6, prompt_pad_id=0)
    assert torch.equal(toks, eager)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_mixer_fp32_on_the_card_holds_to_the_cpu(card, kind, monkeypatch):
    """The reduced stream at fp32 (TF32 off) on the card against the same
    stream on the CPU, same pruned weights and plan: each request, up to
    and including its first step whose top-2 logit gap on the CPU is
    within twice the bound, has logits within 1e-4 max|logits| and equal
    tokens (the kernels sum in another order than the plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    cfg = get_config("chatglm3-6b").reduced()
    plan = shipped_plan(cfg, "bitmap")
    if kind == "nm":
        plan = _as_nm(plan)
    cm_cpu, pruned_cpu = serve.compressed_model(
        cfg, Model(cfg).init(seed=0, device="cpu"), plan, device="cpu")
    cm, pruned = serve.compressed_model(
        cfg, params_from_numpy(params_to_numpy(pruned_cpu), card), plan,
        device=card)
    for group in ("attn", "ffn"):
        for leaf, w in pruned["blocks"][group].items():
            assert torch.equal(w.cpu(), pruned_cpu["blocks"][group][leaf])
    _, toks_cpu, lg_cpu = _mix(cm_cpu, pruned_cpu, _mix_requests(cfg),
                               record=True)
    _, toks, lg = _mix(cm, pruned, _mix_requests(cfg), record=True)
    compared = 0
    for i, uid in enumerate(lg_cpu):
        for j, (a, b) in enumerate(zip(lg[uid], lg_cpu[uid])):
            bound = 1e-4 * b.abs().max().item()
            assert (a - b).abs().max().item() <= bound, (uid, j)
            compared += 1
            top2 = b.topk(2).values
            if (top2[0] - top2[1]).item() <= 2 * bound:
                break                     # a near tie: tokens may part
            assert toks[i][j] == toks_cpu[i][j], (uid, j)
    assert compared >= len(MIX_PLENS)


# ---------------------------------------------------------------------------
# The guarded serving runtime on the compiled decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_a_healthy_guarded_run_replays_the_graph(card, kind):
    """The guarded decode replays the unguarded run's graph: the same
    launches, the same tokens, one replay a step."""
    from repro_torch.launch import compiled
    from repro_torch.runtime import guard
    cfg, cm, pruned = _served(kind)
    prompts = _prompts(cfg)
    toks, _, _ = cm.generate(pruned, prompts, 6)
    (g,) = compiled.graphs(cm).values()
    assert g.replays == 5
    launches = ops.launch_counts()
    ops.reset_launch_counts()
    got, rep = guard.guarded_generate(cm, pruned, prompts, 6)
    assert rep.healthy and set(rep.verify.values()) == {"ok"}
    assert torch.equal(got, toks)
    assert ops.launch_counts() == launches
    (g2,) = compiled.graphs(cm).values()
    assert g2 is g and g.replays == 11


def test_guarded_poisoned_activations_serve_eagerly(card):
    """While ``poison_activations`` rebinds ``layers.proj`` no graph
    replays (a replay would skip the poison) or is captured (it would keep
    poisoning): the prefill fails twice, the dense model serves eagerly
    and gives its own tokens."""
    from repro_torch.launch import compiled, serve
    from repro_torch.runtime import guard, inject
    cfg, cm, pruned = _served("bitmap")
    prompts = _prompts(cfg)
    cm.generate(pruned, prompts, 6)
    (g,) = compiled.graphs(cm).values()
    ops.reset_launch_counts()
    with inject.poison_activations("ffn.w_up"):
        toks, rep = guard.guarded_generate(cm, pruned, prompts, 6)
    assert g.replays == 5 and compiled.graphs(cm.model) == {}
    assert ops.launch_counts()["bitmap_spmm"] == 2 * 7 * cfg.n_layers
    assert rep.switched_to_dense_at == -1 and rep.dense_steps == 6
    assert rep.fallback_counts() == {"nonfinite_logits": 1}
    want, _, _ = serve.generate(cm.model, pruned, prompts, 6, 12)
    assert torch.equal(toks, want)


def test_guarded_dense_switch_adopts_the_graphs_cache(card, monkeypatch):
    """A data fault at decode position p (NaN logits and K / V after a
    replay; the plain versions over the store give NaN too) is retried by
    another replay, then the dense model's graph is captured on the
    compressed graph's cache and re-steps p: positions before p are as the
    compressed graph wrote them, the NaN K / V that the step enqueued
    ahead wrote at p + 1 are cleared, and the tokens are the compressed
    steps' before p and the dense steps' from p on, as the eager steps
    give them."""
    from repro_torch.exec import dispatch
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import guard
    cfg, cm, pruned = _served("bitmap")
    prompts = _prompts(cfg)
    plen, gen = prompts.shape[1], 6
    p = plen + 3
    seen = []

    class PoisonAt(compiled.CompiledStep):
        def __call__(self, params, cache, tokens, pos):
            at = int(pos) == p
            if at:
                seen.append((self.model, [cache["self"][n][:, :, :p].clone()
                                          for n in ("k", "v")]))
            logits, cache = super().__call__(params, cache, tokens, pos)
            if at and self.model is cm:
                logits = torch.full_like(logits, float("nan"))
                for kv in cache["self"].values():
                    kv[:, :, p] = float("nan")
            return logits, cache

    step = Model.decode_step

    def witness_sees_it(self, params, cache, tokens, pos):
        # the plain-version witness steps eagerly: the same data fault
        logits, cache = step(self, params, cache, tokens, pos)
        hook = L._PROJ_HOOK
        if isinstance(hook, dispatch._Dispatcher) and hook.plain and \
                int(pos) == p:
            logits = torch.full_like(logits, float("nan"))
        return logits, cache

    monkeypatch.setattr(compiled, "CompiledStep", PoisonAt)
    monkeypatch.setattr(Model, "decode_step", witness_sees_it)
    toks, rep = guard.guarded_generate(cm, pruned, prompts, gen)
    assert rep.switched_to_dense_at == p and rep.retries == 1
    assert rep.dense_steps == gen - 3
    (g,) = compiled.graphs(cm).values()
    (gd,) = compiled.graphs(cm.model).values()
    # plen + 1, plen + 2, then p and p + 1 twice: each attempt at p
    # enqueues p + 1 before its check
    assert g.replays == 6
    assert gd.replays == gen - 4 and gd.serial == 0
    assert [m is cm for m, _ in seen] == [True, True, False]
    for _, kv in seen[1:]:
        assert all(torch.equal(a, b) for a, b in zip(kv, seen[0][1]))
    with compiled.disable():
        logits, cache = cm.prefill(pruned, prompts, plen + gen)
        tok, want = logits[:, -1].argmax(-1), []
        for t in range(plen, plen + gen):
            want.append(tok)
            model = cm if t < p else cm.model
            logits, cache = model.decode_step(
                pruned, cache, tok, torch.tensor(t, device=card))
            tok = logits.argmax(-1)
    assert torch.equal(toks, torch.stack(want, 1).int())


def test_guarded_generate_raises_when_a_kernel_fails_to_build(card,
                                                              monkeypatch):
    """The guard retries non-finite logits and injected faults only: a
    kernel that does not build raises through ``guarded_generate``, and
    nothing is served by the plain matmul."""
    from repro_torch.kernels import build
    from repro_torch.runtime import guard
    cfg, cm, pruned = _served("bitmap")

    def no_build(name):
        raise RuntimeError(f"{name}: nvcc failed")

    monkeypatch.setattr(build, "library", no_build)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        guard.guarded_generate(cm, pruned, _prompts(cfg), 4)
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_guarded_generate_raises_when_a_kernel_gives_nan_on_good_data(
        card, monkeypatch, where):
    """A kernel whose output turns NaN on a verified store (a race or an
    uninitialised read; here its output overwritten, inside the graph at
    decode) is not served around by the dense model: the retry fails,
    the plain versions over the same store give finite logits, and
    ``guarded_generate`` raises."""
    from repro_torch.launch import compiled
    from repro_torch.runtime import guard
    cfg, cm, pruned = _served("bitmap")
    prompts = _prompts(cfg)
    kernel = ops._bitmap

    def nan_at(x, w, t_max, pipeline):
        y = kernel(x, w, t_max, pipeline)
        if where == "prefill" or x.shape[0] == prompts.shape[0]:
            y = torch.full_like(y, float("nan"))
        return y

    monkeypatch.setattr(ops, "_bitmap", nan_at)
    ops.reset_launch_counts()
    with pytest.raises(guard.KernelNonFiniteError, match="plain versions"):
        guard.guarded_generate(cm, pruned, prompts, 4)
    assert ops.launch_counts()["bitmap_spmm"] > 0
    assert compiled.graphs(cm.model) == {}      # the dense model never ran


def _nan_column_weight(kind, n, k):
    """(dense (n, k) weight, output columns whose weights on input row 0
    are pruned).  bitmap: a 4 x 4 grid of (n/4, k/4) blocks, two stored a
    block-column (so no column walks padding), block-row 0 stored in
    block-columns 0 and 2 only.  2:4: in each column the first group's
    two largest magnitudes are rows 0 and 1 in even columns, rows 2 and 3
    in odd ones."""
    gen = torch.Generator().manual_seed(7)
    w = torch.randn(n, k, generator=gen)
    if kind == "bitmap":
        bn, bk = n // 4, k // 4
        stored = {0: (0, 1), 1: (1, 2), 2: (0, 3), 3: (2, 3)}
        keep = torch.zeros(4, 4, dtype=torch.bool)
        for col, rows in stored.items():
            keep[list(rows), col] = True
        w = w * keep.repeat_interleave(bn, 0).repeat_interleave(bk, 1)
        pruned = torch.cat([torch.arange(c * bk, (c + 1) * bk)
                            for c in (1, 3)])
    else:
        w = w.clamp(-1.5, 1.5)
        big = torch.tensor([4.0, 3.0, 0.1, 0.2])
        w[:4, 0::2] = big[:, None]
        w[:4, 1::2] = big.flip(0)[:, None]
        pruned = torch.arange(1, k, 2)
    return w, pruned


def _same_masks(y, want):
    """y is NaN, +Inf and -Inf exactly where ``want`` is."""
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(y), mask(want)), mask.__name__


@pytest.mark.parametrize("bad", ["nan", "inf"])
@pytest.mark.parametrize("m", [4, 512])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_a_non_finite_input_meeting_a_pruned_weight_is_dropped_by_the_kernel(
        card, kind, pipeline, m, bad):
    """A NaN or Inf in input column 0 reaches the outputs the reference's
    kernels give it.  The bitmap kernels (both variants) and their plain
    version read stored blocks only, as the reference's do: an output
    whose weights on that column are pruned stays finite, equal to the
    product with the column zeroed.  The N:M kernels (both variants) and
    their plain version expand each group densely, as the reference's
    do: an output whose group does not keep input 0 is NaN, the others NaN
    or +Inf with x; the pipelined kernel equals the naive one, NaN for
    NaN."""
    n, k = 1024, 512
    w, pruned = _nan_column_weight(kind, n, k)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(m, n, generator=gen).to(torch.bfloat16)
    x[:, 0] = float(bad)
    x = x.to(card)
    kept = torch.ones(k, dtype=torch.bool)
    kept[pruned] = False
    kept, pruned = kept.to(card), pruned.to(card)
    if kind == "bitmap":
        wc = ops.compress_bitmap(w.to(card), n // 4, k // 4)
        y = ops.bitmap_spmm(x, wc, pipeline=pipeline)
        y_plain = ref.bitmap_spmm_ref(x, wc.blocks, wc.counts, wc.row_ids,
                                      wc.n, wc.k)
        torch.cuda.synchronize()
        assert not torch.isfinite(y[:, kept]).any()
        _same_masks(y, y_plain)
        x0 = x.clone()
        x0[:, 0] = 0
        want = ref.bitmap_spmm_ref(x0, wc.blocks, wc.counts, wc.row_ids,
                                   wc.n, wc.k)
        _close(y[:, pruned], want[:, pruned])
        _close(y[:, pruned], y_plain[:, pruned])
        return
    wc = ops.compress_nm(w.to(card))
    y = ops.nm_spmm(x, wc, pipeline=pipeline)
    y_naive = ops.nm_spmm(x, wc, pipeline=False)
    y_plain = ref.nm_spmm_ref(x, wc.values, wc.indices, 2, 4)
    torch.cuda.synchronize()
    assert torch.isnan(y[:, pruned]).all()
    assert (torch.isnan(y) if bad == "nan"
            else torch.isposinf(y[:, kept])).all()
    _same_masks(y, y_plain)
    torch.testing.assert_close(y, y_naive, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("m,n,k,n_sel,m_group", NM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_pipelined_equals_naive_on_non_finite_x(card, m, n, k, n_sel,
                                                   m_group, dtype):
    """NaN, +Inf and -Inf in x: the pipelined kernel (decode and prefill
    entries) gives the naive one's result, the same NaN / +-Inf masks and
    the same finite values bit for bit, and the plain version's masks."""
    rng = np.random.default_rng(m + n + k + 2)
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    c = ops.compress_nm(w, n_sel, m_group)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    x[0, 1] = float("nan")
    x[m - 1, n // 2] = float("inf")
    x[m // 2, n - 1] = float("-inf")
    x = x.to(card, dtype)
    y = ops.nm_spmm(x, c)
    y_naive = ops.nm_spmm(x, c, pipeline=False)
    y_plain = ref.nm_spmm_ref(x, c.values, c.indices, n_sel, m_group)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_naive, rtol=0, atol=0, equal_nan=True)
    _same_masks(y, y_naive)
    _same_masks(y, y_plain)
    fin = torch.isfinite(y_plain)
    assert not fin.all()
    if fin.any():
        _close(y[fin], y_plain[fin])


# ---------------------------------------------------------------------------
# The search plane on the card's host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_full_width_search_equals_the_shipped_plan(card, kind):
    """On the machine with the card, which has no JAX, the port's own
    search (the serve CLI's ``_fast_plan``) writes the shipped full-width
    plan byte for byte, and its compressed model serves it."""
    from repro_torch.configs import get_config
    from repro_torch.exec.plans import PLANS_DIR, check_plan
    from repro_torch.launch import serve
    cfg = get_config("chatglm3-6b")
    plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
    shipped = (PLANS_DIR / f"chatglm3-6b.{kind}.json").read_text()
    assert plan.to_json() == shipped.rstrip("\n")
    assert check_plan(plan, cfg) is plan
