"""A NaN or Inf in the input reaches the same outputs in the port's plain
sparse versions as in the reference's kernels (interpret mode).

The reference's bitmap kernels walk the stored blocks only
(``repro/kernels/bitmap_spmm.py:44-110``): an input under no stored block
of a block-column never reaches it.  Its N:M kernels expand every group
densely and multiply (``_decode_tile``, ``repro/kernels/nm_spmm.py:37-50``):
a non-finite input meets the pruned zeros and gives NaN.  The port's CPU
wrappers run :mod:`repro_torch.kernels.ref`, which the card's kernels are
held to, so the masks (NaN, +Inf, -Inf) must be equal, element for
element, and the finite values within the kernels' tolerance, 1e-4 ·
max|y| + 1e-5 (summation order only), for both ``pipeline`` values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops


def _assert_same(y: np.ndarray, want: np.ndarray) -> None:
    for mask in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(mask(y), mask(want)), mask.__name__
    fin = np.isfinite(want)
    assert fin.any() and not fin.all()
    tol = 1e-4 * np.abs(want[fin]).max() + 1e-5
    assert np.abs(y[fin] - want[fin]).max() <= tol


def _poison(x: np.ndarray, cols) -> np.ndarray:
    """NaN, +Inf and -Inf in rows 0, 1 and 2 at the given columns; the
    other rows stay finite."""
    x = x.copy()
    for row, (col, bad) in enumerate(zip(cols, (np.nan, np.inf, -np.inf))):
        x[row, col] = bad
    return x


def _x(rng, m, n, dtype):
    """x drawn in fp32 and, for bf16, rounded to it on both sides."""
    x = rng.normal(size=(m, n)).astype(np.float32)
    if dtype == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _as(x: np.ndarray, dtype):
    t = torch.from_numpy(x)
    return (t.bfloat16(), jnp.asarray(x, jnp.bfloat16)) if dtype == "bf16" \
        else (t, jnp.asarray(x))


# m, n, k, bn, bk, the poisoned columns.  The first: ROADMAP Queue 3.2's
# probe, x (4, 256) against a (256, 128) weight whose first (64, 32) block
# is zero, NaN in column 0; the second a 0.5-dense block grid, the third
# one whose bk is no multiple of 4
BITMAP_CASES = [(4, 256, 128, 64, 32, (0, 70, 200)),
                (16, 512, 384, 128, 128, (5, 130, 400)),
                (5, 96, 60, 24, 30, (1, 30, 95))]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m,n,k,bn,bk,cols", BITMAP_CASES)
def test_plain_bitmap_masks_equal_the_reference_kernels(m, n, k, bn, bk,
                                                        cols, pipeline,
                                                        dtype):
    rng = np.random.default_rng(m + n + k)
    keep = rng.random((n // bn, k // bk)) < 0.5
    keep[0, 0] = False
    keep[0, 1:] = True                 # row-block 0 elsewhere stored
    w = (rng.normal(size=(n, k)) *
         np.repeat(np.repeat(keep, bn, 0), bk, 1)).astype(np.float32)
    x = _poison(_x(rng, m, n, dtype), cols)
    xt, xj = _as(x, dtype)
    y = ops.bitmap_spmm(xt, ops.compress_bitmap(torch.from_numpy(w), bn, bk),
                        pipeline=pipeline).numpy()
    want = np.asarray(rops.bitmap_spmm(xj, rops.compress_bitmap(w, bn, bk),
                                       bm=m, pipeline=pipeline))
    # the probe's finding: the block-column without a block on x's NaN
    # column stays finite in row 0
    assert np.isfinite(want[0, :bk]).all() and np.isnan(want[0, bk:]).all()
    _assert_same(y, want)


# m, n, k, n_sel, m_group, the poisoned columns
NM_CASES = [(4, 256, 128, 2, 4, (0, 5, 9)),
            (16, 512, 96, 1, 4, (3, 100, 511)),
            (8, 64, 40, 3, 8, (7, 8, 63))]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m,n,k,n_sel,m_group,cols", NM_CASES)
def test_plain_nm_masks_equal_the_reference_kernels(m, n, k, n_sel, m_group,
                                                    cols, pipeline, dtype):
    rng = np.random.default_rng(m + n + k)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = _poison(_x(rng, m, n, dtype), cols)
    xt, xj = _as(x, dtype)
    y = ops.nm_spmm(xt, ops.compress_nm(torch.from_numpy(w), n_sel,
                                        m_group), pipeline=pipeline).numpy()
    want = np.asarray(rops.nm_spmm(xj, rops.compress_nm(w, n_sel, m_group),
                                   bm=m, bn=n, bk=k, pipeline=pipeline))
    # every output of the NaN row, and where the Inf meets a pruned slot
    assert np.isnan(want[0]).all() and np.isnan(want[1]).any()
    assert np.isinf(want[1]).any()
    _assert_same(y, want)
