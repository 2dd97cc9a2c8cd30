"""The bitmap kernel's prefill entry: ``repro_torch.kernels.bitmap_spmm``'s
``prefill_plan``, its transposed-x workspace and the entry choice.

Above 16 rows the pipelined bitmap kernel transposes x into a workspace and
runs register-blocked tiles over each block-column's kept rows; the host
function ``prefill_plan`` picks the tile and grid from host integers.  These
tests hold the plan to covering every output exactly once without a tile
crossing a block-column, to filling the card at chatglm3-6b's prefill
(batch 4 x prompt 128), and ``select_entry`` to its routes: the prefill
entry above 16 rows, the decode entry and its order unchanged at 16 or
fewer, the tiled entry with one slice for operands the 16-byte copies
cannot take.  A plain emulation of the tiles' walk (kept row (t, r) reads x
column ``row_ids[off + t]·bn + r`` of the transposed copy) is held against
the plain version and the reference's Pallas kernel in interpret mode.
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

SMS = 132


def _cdiv(a, b):
    return -(-a // b)


def _coverage(m, bk, k, plan):
    """How often each output is written: tile (bx, by, bz) stores rows
    ``bx·tm + [0, tm)`` below M and columns ``by·tk + [0, tk)`` below bk of
    block-column bz, as the kernel masks its store."""
    seen = np.zeros((m, k), dtype=int)
    gx, gy, gz = plan.grid
    for bz in range(gz):
        for by in range(gy):
            c0 = by * plan.tk
            c1 = min(c0 + plan.tk, bk)
            assert c0 < c1                      # no dead column tile
            for bx in range(gx):
                r0 = bx * plan.tm
                assert r0 < m                   # no dead row tile
                seen[r0:r0 + plan.tm, bz * bk + c0:bz * bk + c1] += 1
    return seen


@pytest.mark.parametrize("m,bk,k", [
    (17, 4096, 4096), (512, 4096, 4096), (512, 256, 256),
    (512, 13696, 13696), (129, 100, 300), (33, 64, 256), (200, 13696, 13696),
    (1000, 60, 180), (512, 4, 8), (70, 96, 192)])
def test_prefill_plan_tiles_every_output_once(m, bk, k):
    plan = bm.prefill_plan(m, bk, k)
    assert (plan.tm, plan.tk) == bm.PREFILL_TILES[plan.tile]
    assert plan.grid == (_cdiv(m, plan.tm), _cdiv(bk, plan.tk), k // bk)
    assert (_coverage(m, bk, k, plan) == 1).all()
    big = bm.PREFILL_TILES[0]
    big_blocks = _cdiv(m, big[0]) * _cdiv(bk, big[1]) * (k // bk)
    assert (plan.tile == 0) == (big_blocks >= bm.PREFILL_MIN_BLOCKS)


@pytest.mark.parametrize("bk", [30, 21, 2, 102])
def test_prefill_plan_refuses_a_bk_the_copies_cannot_take(bk):
    """The payload rows are copied 16 bytes at a time."""
    assert bm.prefill_plan(512, bk, 2 * bk) is None


def _roles():
    """(role, bk) of the shipped bitmap plan: one block-column per role."""
    cfg = get_config("chatglm3-6b")
    plan = shipped_plan(cfg, "bitmap")
    for role in cfg.matmul_roles():
        ch = plan.for_role(role.role).choice
        assert ch.block_k == role.k
        yield role, ch.block_k


def test_large_roles_fill_one_wave_at_prefill():
    """At M = 512 (batch 4 x prompt 128) wq, wo, w_gate, w_up and w_down
    take the big tile with at least one block per SM; wk / wv (K = 256)
    take the small tile, which gives them 128 blocks."""
    for role, bk in _roles():
        plan = bm.prefill_plan(512, bk, role.k)
        blocks = int(np.prod(plan.grid))
        if role.k >= 4096:
            assert plan.tile == 0 and blocks >= SMS, (role.role, plan)
        else:
            assert plan.tile == 1 and blocks == 128, (role.role, plan)


def _operands(m, n, k, bn, bk, off=0, nnzb=2, dtype=torch.float32):
    """x, blocks, counts, row_ids, offsets; blocks a contiguous view
    starting ``off`` elements into its storage."""
    gk = k // bk
    blocks = torch.zeros(nnzb * bn * bk + off)[off:].view(nnzb, bn, bk)
    counts = torch.zeros(gk, dtype=torch.int32)
    counts[0] = nnzb
    return (torch.zeros(m, n, dtype=dtype), blocks, counts,
            torch.zeros(nnzb, dtype=torch.int32),
            torch.zeros(gk, dtype=torch.int32))


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 17, 64, 129, 512])
@pytest.mark.parametrize("bk", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entry_by_rows(m, bk, dtype):
    """Above 16 rows the prefill entry, one slice; at 16 or fewer the
    decode entry with split_plan's order, as before the prefill entry
    existed; the naive entry follows the same order."""
    k = 2 * bk
    args = _operands(m, 2048, k, 1024, bk, dtype=dtype)
    got = bm.select_entry(*args, k, 2)
    naive = bm.select_entry(*args, k, 2, pipeline=False)
    assert naive[0] == "bitmap_spmm_naive" and naive[1:] == got[1:]
    if m > 16:
        assert got == ("bitmap_spmm", 1, 2 * _cdiv(1024, bm.PIECE_ROWS))
    else:
        assert got == ("bitmap_spmm_small_m",
                       *bm.split_plan(m, 1024, bk, k, 2))


@pytest.mark.parametrize("m", [4, 17, 512])
@pytest.mark.parametrize("bk,off", [(64, 1), (64, 3), (30, 0), (21, 0),
                                    (30, 1)])
def test_tiled_entry_takes_what_the_copies_cannot(m, bk, off):
    """Blocks off 16 bytes, or bk not a multiple of 4, take the tiled entry
    with one slice, at decode and at prefill, and the naive entry the same
    order."""
    k = 2 * bk
    args = _operands(m, 2048, k, 1024, bk, off)
    assert (args[1].data_ptr() % 16 != 0) == (off != 0)
    one = (1, 2 * _cdiv(1024, bm.PIECE_ROWS))
    assert bm.select_entry(*args, k, 2) == ("bitmap_spmm_tiled", *one)
    assert bm.select_entry(*args, k, 2, pipeline=False) == \
        ("bitmap_spmm_naive", *one)


@pytest.mark.parametrize("m,n,rows", [
    (17, 4096, 128), (128, 4096, 128), (129, 100, 256), (512, 13696, 512),
    (513, 64, 640)])
def test_xt_workspace_is_x_transposed_and_padded(m, n, rows):
    """(N, M rounded up to 128) fp32: 28 MB for w_down at M = 512."""
    assert bm.xt_numel(m, n) == n * rows
    assert rows % bm.PREFILL_PAD_M == 0 and m <= rows < m + 128


@pytest.mark.parametrize("bad,err", [
    (lambda x, b, c, r, o: (x.half(), b, c, r, o), TypeError),
    (lambda x, b, c, r, o: (x, b.double(), c, r, o), TypeError),
    (lambda x, b, c, r, o: (x, b, c.long(), r, o), TypeError),
    (lambda x, b, c, r, o: (x, b, c, r.long(), o), TypeError),
    (lambda x, b, c, r, o: (x.t().contiguous().t(), b, c, r, o), ValueError),
    (lambda x, b, c, r, o: (x[:, :-4].contiguous(), b, c, r, o), ValueError),
    (lambda x, b, c, r, o: (x, b, c[:-1], r, o), ValueError),
    (lambda x, b, c, r, o: (x, b, c, r, o[:-1]), ValueError)])
def test_prefill_refuses_bad_operands(bad, err):
    args = bad(*_operands(512, 256, 128, 64, 64))
    with pytest.raises(err):
        bm.select_entry(*args, 128, 2)


def _block_sparse(rng, n, k, bn, bk, keep):
    """``keep``: (N/bn, K/bk) bool.  Weights at the models' 1/sqrt(N)
    scale."""
    mask = np.repeat(np.repeat(keep, bn, 0), bk, 1)
    return (rng.normal(size=(n, k)) / np.sqrt(n) * mask).astype(np.float32)


def _prefill_walk(x, c, plan):
    """The prefill entry's walk, in plain numpy: x transposed and padded,
    then for every tile of the plan the column's kept rows in stored order,
    kept row (t, r) reading x column ``row_ids[off + t]·bn + r``, masked at
    M and bk as the kernel masks its store."""
    m, n = x.shape
    bn, bk, k = c.bn, c.bk, c.k
    xt = np.zeros((n, bm.xt_numel(m, n) // n), dtype=np.float64)
    xt[:, :m] = x.T
    flat = c.blocks.reshape(-1, bk).numpy().astype(np.float64)
    row_ids = c.row_ids.numpy()
    y = np.full((m, k), np.nan)
    gx, gy, gz = plan.grid
    for bz in range(gz):
        off, cnt = int(c.offsets[bz]), int(c.counts[bz])
        r = np.arange(cnt * bn)
        t = r // bn
        xcols = row_ids[off + t].astype(np.int64) * bn + r - t * bn
        for by in range(gy):
            c0, c1 = by * plan.tk, min(by * plan.tk + plan.tk, bk)
            w = flat[off * bn + r, c0:c1]
            for bx in range(gx):
                r0, r1 = bx * plan.tm, min(bx * plan.tm + plan.tm, m)
                acc = xt[xcols, bx * plan.tm:(bx + 1) * plan.tm].T @ w
                y[r0:r1, bz * bk + c0:bz * bk + c1] = acc[:r1 - r0]
    return y


@pytest.mark.parametrize("m,n,k,bn,bk,keep", [
    (17, 512, 128, 64, 64, 0.6),           # small tile
    (70, 640, 192, 40, 96, 0.5),           # ragged bn (40), ragged M
    (200, 1712, 64, 107, 32, 0.7),         # odd bn, several M tiles
    (33, 768, 96, 48, 24,                  # unequal columns, an empty one
     np.array([[1, 0, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1],
               [1, 0, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1], [0, 0, 0, 1],
               [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1],
               [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1], [1, 0, 0, 1]],
              dtype=bool))])
def test_prefill_walk_matches_plain_and_reference(m, n, k, bn, bk, keep):
    """The tiles' walk over the transposed x equals the plain version and
    the reference's Pallas kernel (interpret mode) to the reference's own
    1e-5 (tests/test_kernels.py:41)."""
    rng = np.random.default_rng(m + n + k)
    if not isinstance(keep, np.ndarray):
        keep = rng.random((n // bn, k // bk)) < keep
    w = _block_sparse(rng, n, k, bn, bk, keep)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = ops.compress_bitmap(torch.from_numpy(w), bn, bk)
    plan = bm.prefill_plan(m, bk, k)
    y = _prefill_walk(x, c, plan)
    assert not np.isnan(y).any()
    want = ref.bitmap_spmm_ref(torch.from_numpy(x), c.blocks, c.counts,
                               c.row_ids, n, k)
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-5)
    pallas = rops.bitmap_spmm(jnp.asarray(x), rops.compress_bitmap(w, bn, bk),
                              bm=m)
    np.testing.assert_allclose(y, np.asarray(pallas), rtol=1e-5, atol=1e-5)
