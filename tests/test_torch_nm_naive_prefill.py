"""The naive N:M kernel's prefill design (``nm_spmm_naive_prefill_kernel`` in
``src/repro_torch/csrc/nm_spmm.cu``), emulated with torch on the CPU.

Above 16 rows (or for K % 4 != 0) the naive entry copies x column-major and
walks runs of 32 x columns (32 / m_group groups; zeros past the last group):
each run is expanded once into a dense 32 x K tile by position compares (row
g·m_group + p of the tile is, per column, the sum from 0 over group g's kept
rows of ``value if index == p else 0``), and each output has one fp32
accumulator from 0 that takes ``fmaf(x, dense, acc)`` over every dense row
in ascending n, zeros included, with one slice.  These tests hold that order
to the reference's naive Pallas kernel in interpret mode, to the pipelined
entry's order over the kept entries only (``torch.equal``: the reason the
two CUDA entries agree bit for bit), and the host rule that picks the tile,
the grid and the workspace.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.configs import get_config
from repro_torch.kernels import nm_spmm as nm
from repro_torch.kernels import ops, ref

XC = 32                                       # x columns of a run (``XC``)


def _cdiv(a, b):
    return -(-a // b)


def _fma(acc, x_col, w_row):
    """fmaf(x, w, acc) for every output: the product is exact in float64,
    the sum is rounded to float32 once more."""
    return (acc.double() + x_col.double()[:, None] * w_row.double()[None, :]
            ).float()


def _expand_run(values, indices, g0, gcur, n_sel, m_group):
    """The run's dense XC x K tile: rows past its groups are zero."""
    dense = torch.zeros(XC, values.shape[1])
    for g in range(gcur):
        for p in range(m_group):
            w = torch.zeros(values.shape[1])
            for s in range(n_sel):
                q = (g0 + g) * n_sel + s
                w = w + torch.where(indices[q].long() == p, values[q],
                                    torch.zeros(()))
            dense[g * m_group + p] = w
    return dense


def _naive_prefill(x, values, indices, n_sel, m_group):
    """The kernel's arithmetic in its order: run by run, the dense tile's
    XC rows ascending, each times its x column (zeros past the last group),
    into one accumulator per output from 0."""
    m, n = x.shape
    run_groups, groups = XC // m_group, n // m_group
    xf = x.float()
    acc = torch.zeros(m, values.shape[1])
    for g0 in range(0, groups, run_groups):
        gcur = min(run_groups, groups - g0)
        dense = _expand_run(values, indices, g0, gcur, n_sel, m_group)
        for c in range(XC):
            x_col = xf[:, g0 * m_group + c] if c < gcur * m_group \
                else torch.zeros(m)
            acc = _fma(acc, x_col, dense[c])
    return acc


def _kept_order(x, values, indices, n_sel, m_group):
    """The pipelined prefill entry's order: the kept entries only, in
    stored (ascending n) order, each gathering its own x column; an
    out-of-range position adds value 0 at the group's first column."""
    m, n = x.shape
    xf = x.float()
    acc = torch.zeros(m, values.shape[1])
    for q in range(values.shape[0]):
        p = indices[q].long()
        ok = (p >= 0) & (p < m_group)
        base = q // n_sel * m_group
        x_cols = xf[:, base + torch.where(ok, p, torch.zeros_like(p))]
        b = torch.where(ok, values[q], torch.zeros(()))
        acc = (acc.double() + x_cols.double() * b.double()[None, :]).float()
    return acc


# m, n, k, n_sel, m_group: M ragged against both tiles (17, 33, 70, 129) and
# 512; ragged last runs (34, 26, 25 groups of 4; 13 of 8); K ragged against
# the 32- and 128-column tiles, K % 4 != 0 (130, 102: the prefill path at
# M = 4 too); 2:4, 1:4, 3:8, 16:32
ORDER_CASES = [(17, 136, 40, 2, 4), (33, 136, 130, 1, 4),
               (129, 104, 36, 2, 4), (70, 104, 64, 3, 8),
               (33, 160, 130, 16, 32), (512, 72, 20, 2, 4),
               (4, 100, 102, 1, 4), (512, 64, 36, 16, 32)]


@pytest.mark.parametrize("m,n,k,n_sel,m_group", ORDER_CASES)
def test_design_order_matches_reference_naive_kernel(m, n, k, n_sel,
                                                     m_group):
    """Within 1e-5 · max|y| of the reference's naive Pallas kernel
    (interpret mode) and of the plain version: only the summation order
    differs."""
    rng = np.random.default_rng(m + n + k + n_sel)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = ops.compress_nm(torch.from_numpy(w), n_sel, m_group)
    y = _naive_prefill(torch.from_numpy(x), c.values, c.indices, n_sel,
                       m_group)
    pallas = np.asarray(rops.nm_spmm(
        jnp.asarray(x), rops.compress_nm(w, n_sel, m_group), bm=m, bn=n,
        bk=k, pipeline=False))
    plain = ref.nm_spmm_ref(torch.from_numpy(x), c.values, c.indices, n_sel,
                            m_group).numpy()
    assert y.shape == (m, k)
    for want in (pallas, plain):
        err = np.abs(y.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


@pytest.mark.parametrize("m,n,k,n_sel,m_group", ORDER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_order_equals_the_kept_entries_order(m, n, k, n_sel, m_group,
                                                   dtype):
    """Every dense row is 0 or one kept value, and fmaf(x, 0, acc) is acc:
    the dense walk equals the walk over the kept entries bit for bit, with
    zero weight rows and positions outside the group (dropped by the
    expansion, masked to value 0 by the pipelined entry) too."""
    rng = np.random.default_rng(m + n + k + n_sel + 1)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[: n // 4] = 0.0
    c = ops.compress_nm(torch.from_numpy(w), n_sel, m_group)
    indices = c.indices.clone()
    indices[1::5, ::3] = -1
    indices[2::7, 1::4] = m_group
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dtype)
    assert torch.equal(_naive_prefill(x, c.values, indices, n_sel, m_group),
                       _kept_order(x, c.values, indices, n_sel, m_group))


def _coverage(m, k, plan):
    """How often each output is stored: tile (bx, by) stores rows bx·tm +
    [0, tm) below M and columns by·tk + [0, tk) below K."""
    seen = np.zeros((m, k), dtype=int)
    gx, gy = plan.grid
    for bx in range(gx):
        assert bx * plan.tm < m                  # no dead row tile
        for by in range(gy):
            assert by * plan.tk < k              # no dead column tile
            seen[bx * plan.tm:(bx + 1) * plan.tm,
                 by * plan.tk:(by + 1) * plan.tk] += 1
    return seen


PREFILL_SHAPES = [(m, k) for m in (17, 33, 512)
                  for k in (100, 130, 256, 4096, 13696)] + [
    (4, 102), (16, 13698), (1, 30)]


@pytest.mark.parametrize("m,k", PREFILL_SHAPES)
def test_prefill_shapes_take_the_transpose_and_the_prefill_kernel(m, k):
    """M > 16 or K % 4 != 0: x copied column-major into the workspace (N
    rows of M rounded up to 128, the pipelined entry's copy), then the
    naive prefill kernel on its plan's grid, one slice; the tiles cover
    every output once."""
    n = 4096
    plan = nm.naive_prefill_plan(m, k)
    mp = _cdiv(m, 128) * 128
    assert (plan.tm, plan.tk) == nm.NAIVE_PREFILL_TILES[plan.tile]
    assert plan.grid == (_cdiv(m, plan.tm), _cdiv(k, plan.tk))
    big = nm.NAIVE_PREFILL_TILES[0]
    big_blocks = _cdiv(m, big[0]) * _cdiv(k, big[1])
    assert plan.tile == (0 if big_blocks >= nm.NAIVE_PREFILL_MIN_BLOCKS
                         else 1)
    assert nm.naive_kernel(m, n, k, 2, 4) == (
        ("nm_transpose_x_kernel", (n // 32, mp // 32)),
        ("nm_spmm_naive_prefill_kernel", plan.grid))
    assert nm.split_plan(m, n, k, 2, 4)[0] == 1
    assert nm.prefill_rows(m) == mp
    assert nm.workspace_numel("nm_spmm_naive", m, n, k, 1) == n * mp == \
        nm.workspace_numel("nm_spmm", m, n, k, 1) - nm.nonfinite_flags(m, n)
    assert (_coverage(m, k, plan) == 1).all()


def test_serving_prefill_tiles():
    """chatglm3-6b at M = 512 (batch 4 x prompt 128): the 128 x 128 tile
    for every role but wk / wv (K = 256, 8 big blocks), which take the
    32 x 32 tile on 16 x 8 = 128 blocks."""
    cfg = get_config("chatglm3-6b")
    for role in cfg.matmul_roles():
        plan = nm.naive_prefill_plan(512, role.k)
        if role.k == 256:
            assert (plan.tile, plan.grid) == (1, (16, 8)), role.role
        else:
            assert plan.tile == 0, role.role
            assert plan.grid[0] * plan.grid[1] >= 128, role.role
