"""The bitmap kernels' summation order, ``repro_torch.kernels.bitmap_spmm.split_plan``.

Every CUDA entry follows the plan: each kept block's rows are cut into
pieces of 32 rows (the last one ragged), a block-column's pieces, in stored
order, into slices, each slice is summed on its own and the partials are
added left to right.  These tests hold the plan to that shape and to its
two aims at chatglm3-6b's decode shapes (batch 4): at least two thread
blocks per SM on the large roles, and a partials' round trip within 10 %
of the payload.  The slice-by-slice plain sum, taken as the decode kernel
takes it, catches a dropped or doubled slice without a card, against the
unsplit plain version and the reference's Pallas kernel in interpret mode.
``select_entry`` picks the C entry; the naive entry follows the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.configs import get_config
from repro_torch.exec.plans import shipped_plan
from repro_torch.kernels import bitmap_spmm as bm
from repro_torch.kernels import ops, ref

PIECE = bm.PIECE_ROWS

SHAPES = [(m, bn, bk, k, max_per_col)
          for m in (1, 4, 16, 17)
          for bn, bk, k, max_per_col in (
              (12, 20, 40, 4), (64, 16, 32, 5), (40, 64, 256, 3),
              (1024, 4096, 4096, 2), (1024, 256, 256, 2),
              (1024, 13696, 13696, 2), (856, 4096, 4096, 8),
              (856, 4096, 4096, 0), (128, 256, 1024, 16))]


def _cdiv(a, b):
    return -(-a // b)


def _slice_rows(s, count, bn, pieces):
    """Kept rows [r0, r1) of slice ``s`` in a column of ``count`` kept
    blocks, as the decode kernel takes them (``piece_row``)."""
    q = _cdiv(bn, PIECE)
    end = count * q
    p0 = min(s * pieces, end)
    p1 = min(p0 + pieces, end)
    row = lambda p: p // q * bn + p % q * PIECE     # noqa: E731
    return row(p0), row(p1)


@pytest.mark.parametrize("m,bn,bk,k,max_per_col", SHAPES)
def test_slices_cover_every_kept_row_once_on_piece_boundaries(
        m, bn, bk, k, max_per_col):
    slices, pieces = bm.split_plan(m, bn, bk, k, max_per_col)
    q = _cdiv(bn, PIECE)
    assert slices >= 1 and pieces >= 1
    longest = max(1, max_per_col) * q
    assert (slices - 1) * pieces < longest <= slices * pieces
    if slices > 1:                      # the decode entry's x slice
        assert pieces * PIECE <= bm.SPLIT_MAX_SLICE_ROWS
    for count in range(max_per_col + 1):
        covered = np.zeros(count * bn, dtype=int)
        for s in range(slices):
            r0, r1 = _slice_rows(s, count, bn, pieces)
            assert r0 <= r1
            covered[r0:r1] += 1
            if r1 > r0:                 # starts on a piece of some block
                assert r0 % bn % PIECE == 0
            if s * pieces >= count * q:
                assert r0 == r1         # an empty trailing slice
        assert (covered == 1).all()


@pytest.mark.parametrize("m", [17, 64, 512])
def test_one_slice_above_sixteen_rows(m):
    """Prefill keeps the unsplit order, so its outputs do not move."""
    for bn, bk, k, mpc in ((1024, 4096, 4096, 2), (856, 4096, 4096, 8),
                           (1024, 13696, 13696, 2), (1024, 256, 256, 2)):
        assert bm.split_plan(m, bn, bk, k, mpc) == (1, mpc * _cdiv(bn, 32))
    assert bm.split_plan(16, 1024, 4096, 4096, 2)[0] > 1
    assert bm.split_plan(4, 1024, 4098, 4098, 2)[0] == 1     # bk % 4 != 0


def _roles():
    """(role, bn, bk, max_per_col) of the shipped bitmap plan at its block
    density 0.5 (block pruning keeps half the blocks of the one
    block-column)."""
    cfg = get_config("chatglm3-6b")
    plan = shipped_plan(cfg, "bitmap")
    for role in cfg.matmul_roles():
        ch = plan.for_role(role.role).choice
        assert ch.block_k == role.k           # one block-column per role
        yield role, ch.block_n, ch.block_k, role.n // ch.block_n // 2


@pytest.mark.parametrize("m", [1, 2, 4])
def test_decode_grid_fills_the_card_on_the_large_roles(m):
    """K/bk · ceil(bk/256) x S ≥ 2 x 132 blocks wherever K ≥ 4096 (wq,
    wo, w_gate, w_up, w_down); wk / wv (K = 256) stay latency-bound."""
    for role, bn, bk, mpc in _roles():
        if role.k < 4096:
            continue
        slices, _ = bm.split_plan(m, bn, bk, role.k, mpc)
        blocks = role.k // bk * _cdiv(bk, bm.SMALL_M_TILE_K) * slices
        assert blocks >= 2 * 132, (role.role, blocks)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_decode_partials_round_trip_within_a_tenth_of_the_payload(m):
    for role, bn, bk, mpc in _roles():
        slices, pieces = bm.split_plan(m, bn, bk, role.k, mpc)
        assert slices > 1, role.role
        payload = mpc * bn * role.k * 4
        assert 2 * slices * m * role.k * 4 <= 0.1 * payload, role.role
        # a slice's staged x (fp32, M rounded up to a power of two) fits
        assert pieces * PIECE * 16 * 4 <= 48 * 1024


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


@pytest.mark.parametrize("m,bk,pipeline,entry,split", [
    (4, 64, True, "bitmap_spmm_small_m", True),
    (16, 64, True, "bitmap_spmm_small_m", True),
    (17, 64, True, "bitmap_spmm", False),
    (4, 30, True, "bitmap_spmm_tiled", False),
    (4, 64, False, "bitmap_spmm_naive", True),
    (17, 64, False, "bitmap_spmm_naive", False),
    (4, 30, False, "bitmap_spmm_naive", False)])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_entry_and_order_follow_shape_and_alignment(m, bk, pipeline, entry,
                                                   split, off):
    """The decode entry takes M ≤ 16, bk % 4 == 0 and 16-byte aligned
    blocks, the prefill entry M > 16 with the same; other operands (a
    misaligned view, bk % 4 != 0) take the tiled entry, and the naive entry
    follows the pipelined entry's order on the same operands."""
    ops_ = _operands(m, 2048, 2 * bk, 1024, bk, off)
    got = bm.select_entry(*ops_, 2 * bk, 2, pipeline)
    other = bm.select_entry(*ops_, 2 * bk, 2, not pipeline)
    assert got[1:] == other[1:]
    one = (1, 2 * _cdiv(1024, PIECE))
    if off:
        assert ops_[1].data_ptr() % 16
        want = "bitmap_spmm_naive" if not pipeline else "bitmap_spmm_tiled"
        assert got == (want, *one)
        return
    plan = bm.split_plan(m, 1024, bk, 2 * bk, 2)
    assert got == (entry, *(plan if split else one))
    assert (got[1] > 1) == split


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("bad,err", [
    (lambda x, b, c, r, o: (x.half(), b, c, r, o), TypeError),
    (lambda x, b, c, r, o: (x, b.double(), c, r, o), TypeError),
    (lambda x, b, c, r, o: (x, b, c.long(), r, o), TypeError),
    (lambda x, b, c, r, o: (x, b, c, r, o.long()), TypeError),
    (lambda x, b, c, r, o: (x.t().contiguous().t(), b, c, r, o), ValueError),
    (lambda x, b, c, r, o: (x[:, :-4].contiguous(), b, c, r, o), ValueError),
    (lambda x, b, c, r, o: (x, b, c[:-1], r, o), ValueError),
    (lambda x, b, c, r, o: (x, b, c, r[:-1], o), ValueError)])
def test_both_entries_refuse_bad_operands(pipeline, bad, err):
    args = bad(*_operands(4, 256, 128, 64, 64))
    with pytest.raises(err):
        bm.select_entry(*args, 128, 2, pipeline)


@pytest.mark.parametrize("m,bk,off,pipeline", [
    (4, 256, 0, True), (16, 512, 0, True), (4, 256, 0, False),
    (4, 256, 1, True), (4, 30, 0, True), (512, 256, 0, True)])
def test_workspace_holds_the_partials(m, bk, off, pipeline):
    """A split reduction gets its (S, M, K) fp32 partials, one slice
    none."""
    k = 2 * bk
    _, slices, _ = bm.select_entry(*_operands(m, 2048, k, 1024, bk, off),
                                   k, 2, pipeline)
    assert (slices > 1) == (m <= 16 and bk % 4 == 0 and not off)
    assert bm.workspace_numel(m, k, slices) == \
        (slices * m * k if slices > 1 else 0)


def _block_sparse(rng, n, k, bn, bk, keep):
    """``keep``: (N/bn, K/bk) bool, or a density.  Weights at the models'
    1/sqrt(N) scale, so outputs are O(1) and the reference's absolute
    1e-5 measures the order of the sums, not the outputs' size."""
    if not isinstance(keep, np.ndarray):
        keep = rng.random((n // bn, k // bk)) < keep
    mask = np.repeat(np.repeat(keep, bn, 0), bk, 1)
    return (rng.normal(size=(n, k)) / np.sqrt(n) * mask).astype(np.float32)


def _slice_by_slice(x, c, slices, pieces):
    """Σ over slices, left to right, of each slice's plain product, taken
    as the decode kernel takes it: a slice's kept rows are one run of the
    payload viewed as (nnzb·bn, bk), and kept row (t, r) reads x column
    ``row_ids[off + t]·bn + r``."""
    m, bn, bk = x.shape[0], c.bn, c.bk
    flat = c.blocks.reshape(-1, bk)
    parts = torch.zeros(slices, m, c.k)
    for kj in range(c.k // bk):
        cnt, off = int(c.counts[kj]), int(c.offsets[kj])
        for s in range(slices):
            r0, r1 = _slice_rows(s, cnt, bn, pieces)
            rows = torch.arange(r0, r1)
            t = rows // bn
            cols = c.row_ids[off + t].long() * bn + rows - t * bn
            parts[s, :, kj * bk:(kj + 1) * bk] = \
                x[:, cols] @ flat[off * bn + r0:off * bn + r1]
    y = parts[0]
    for s in range(1, slices):
        y = y + parts[s]
    return y


@pytest.mark.parametrize("m,n,k,bn,bk,keep", [
    (4, 512, 32, 64, 16, 0.6),
    (1, 640, 128, 40, 64, 0.5),            # ragged pieces: 40 = 32 + 8
    (16, 1712, 64, 107, 32, 0.7),          # 107 = 3·32 + 11
    (4, 768, 96, 48, 24,                   # unequal columns, an empty one
     np.array([[1, 0, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1],
               [1, 0, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1],
               [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1],
               [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1]],
              dtype=bool))])
def test_slice_by_slice_plain_sum_matches_unsplit_and_reference(m, n, k, bn,
                                                               bk, keep):
    """Σ over slices, in order, equals the unsplit plain product and the
    reference's Pallas kernel (interpret mode) to its own 1e-5
    (tests/test_kernels.py:41)."""
    rng = np.random.default_rng(m + n + k)
    w = _block_sparse(rng, n, k, bn, bk, keep)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = ops.compress_bitmap(torch.from_numpy(w), bn, bk)
    slices, pieces = bm.split_plan(m, bn, bk, k, c.max_per_col)
    assert slices > 1
    if isinstance(keep, np.ndarray):
        assert int(c.counts.min()) == 0 < int(c.counts.max())
        assert len(set(c.counts.tolist())) > 2
    y = _slice_by_slice(torch.from_numpy(x), c, slices, pieces)
    want = ref.bitmap_spmm_ref(torch.from_numpy(x), c.blocks, c.counts,
                               c.row_ids, n, k)
    assert y.shape == want.shape == (m, k)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    pallas = rops.bitmap_spmm(jnp.asarray(x), rops.compress_bitmap(w, bn, bk),
                              bm=min(128, m))
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
