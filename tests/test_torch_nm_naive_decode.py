"""The naive N:M kernel's decode design (``nm_spmm_naive_small_m_kernel`` in
``src/repro_torch/csrc/nm_spmm.cu``), emulated with torch on the CPU.

At decode (M ≤ 16, K % 4 == 0) the naive entry expands each group of the
payload to its dense rows by position compares, position by position (row
p of a group is, per column, the sum from 0 over the group's kept rows s,
in ascending s, of ``value if index == p else 0``), and adds x column p
times row p to the MT x 4 accumulators of a thread, in ascending n, slice
by slice of ``split_plan``, the partials added left to right.  These tests
hold the expansion to the reference's ``_decode_tile`` element for element,
the order to the reference's naive Pallas kernel in interpret mode, and the
host rule that picks the kernel from the shape alone.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.nm_spmm import _decode_tile
from repro_torch.kernels import nm_spmm as nm
from repro_torch.kernels import ops, ref

ROW_TEMPLATES = (1, 2, 4, 8, 16)               # MT, the kernel's row counts


def _expand_group(values, indices, p):
    """Dense row p of one group: (n_sel, K) kept rows -> (K,), summed from
    0 in ascending s, a select per kept row and column."""
    w = torch.zeros(values.shape[1])
    for s in range(values.shape[0]):
        w = w + torch.where(indices[s].long() == p, values[s],
                            torch.zeros(()))
    return w


def _expand(values, indices, n_sel, m_group):
    rows, k = values.shape
    dense = torch.empty(rows // n_sel * m_group, k)
    for g in range(rows // n_sel):
        kept = slice(g * n_sel, (g + 1) * n_sel)
        for p in range(m_group):
            dense[g * m_group + p] = _expand_group(values[kept],
                                                   indices[kept], p)
    return dense


def _naive_decode(x, values, indices, n_sel, m_group):
    """The kernel's arithmetic in its order: x padded with zero rows to MT,
    per slice an accumulator from 0, per group and position ascending one
    dense row times x column; the partials added left to right; rows from
    M on dropped at the store."""
    m, n = x.shape
    k = values.shape[1]
    slices, length = nm.split_plan(m, n, k, n_sel, m_group)
    mt = next(t for t in ROW_TEMPLATES if m <= t)
    xp = torch.zeros(mt, n)
    xp[:m] = x.float()
    groups = n // m_group
    y = None
    for s in range(slices):
        acc = torch.zeros(mt, k)
        for g in range(s * length, min((s + 1) * length, groups)):
            kept = slice(g * n_sel, (g + 1) * n_sel)
            for p in range(m_group):
                w = _expand_group(values[kept], indices[kept], p)
                acc = acc + xp[:, g * m_group + p, None] * w
        y = acc[:m] if y is None else y + acc[:m]
    return y


def _payload(rng, n, k, n_sel, m_group, zero_rows=0):
    """A compressed random weight, its first ``zero_rows`` rows zero."""
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[:zero_rows] = 0.0
    return ops.compress_nm(torch.from_numpy(w), n_sel, m_group)


@pytest.mark.parametrize("n_sel,m_group", [(2, 4), (1, 4), (3, 8), (16, 32)])
@pytest.mark.parametrize("n,k,zero_rows", [(64, 12, 0), (256, 40, 96),
                                           (192, 4, 0)])
def test_expansion_equals_decode_tile(n_sel, m_group, n, k, zero_rows):
    """Group by group and position by position, the expansion gives the
    reference's dense tile element for element."""
    rng = np.random.default_rng(n + k + n_sel + m_group)
    c = _payload(rng, n, k, n_sel, m_group, zero_rows)
    dense = _expand(c.values, c.indices, n_sel, m_group)
    want = np.asarray(_decode_tile(jnp.asarray(c.values.numpy()),
                                   jnp.asarray(c.indices.numpy()),
                                   n_sel=n_sel, m_group=m_group))
    assert dense.shape == want.shape == (n, k)
    assert np.array_equal(dense.numpy(), want)


def test_expansion_drops_a_position_outside_the_group():
    """A position no group has (the kernel's mask for rows past a slice)
    expands to zeros, as in ``_decode_tile``."""
    values = torch.tensor([[1.5, -2.0, 3.0, 4.0], [0.5, 6.0, -7.0, 8.0]])
    indices = torch.tensor([[0, 4, -1, 1], [3, 2, 1, 127]], dtype=torch.int8)
    dense = _expand(values, indices, 2, 4)
    want = np.asarray(_decode_tile(jnp.asarray(values.numpy()),
                                   jnp.asarray(indices.numpy()),
                                   n_sel=2, m_group=4))
    assert np.array_equal(dense.numpy(), want)
    assert dense[:, 1].tolist() == [0.0, 0.0, 6.0, 0.0]


# m, n, k, n_sel, m_group: MT 1 / 2 / 4 / 16, a ragged M (3, 11), every
# shape with a ragged last slice; 2:4, 1:4 (the compile-time bodies) and
# 3:8, 16:32 (the run-time loop)
ORDER_CASES = [(1, 132, 64, 2, 4), (2, 388, 64, 1, 4), (3, 388, 128, 2, 4),
               (4, 1024, 128, 3, 8), (11, 1280, 128, 2, 4),
               (11, 1280, 128, 16, 32)]


@pytest.mark.parametrize("m,n,k,n_sel,m_group", ORDER_CASES)
def test_design_order_matches_reference_naive_kernel(m, n, k, n_sel,
                                                     m_group):
    """Slice by slice over ``split_plan``, partials added left to right:
    within 1e-5 · max|y| of the reference's naive Pallas kernel (interpret
    mode) and of the plain version; only the summation order differs."""
    slices, length = nm.split_plan(m, n, k, n_sel, m_group)
    assert slices > 1 and (n // m_group) % length, "want a ragged slice"
    rng = np.random.default_rng(m + n + k)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    c = ops.compress_nm(torch.from_numpy(w), n_sel, m_group)
    y = _naive_decode(torch.from_numpy(x), c.values, c.indices, n_sel,
                      m_group)
    bn = 128 if n % 128 == 0 else n
    pallas = np.asarray(rops.nm_spmm(
        jnp.asarray(x), rops.compress_nm(w, n_sel, m_group), bm=m, bn=bn,
        bk=k, pipeline=False))
    plain = ref.nm_spmm_ref(torch.from_numpy(x), c.values, c.indices, n_sel,
                            m_group).numpy()
    assert y.shape == (m, k)
    for want in (pallas, plain):
        err = np.abs(y.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def _operands(m, n, k, v_off=0, i_off=0, n_sel=2, m_group=4):
    """x, values, indices; values and indices contiguous views starting
    ``v_off`` / ``i_off`` elements into their storage."""
    rows = n * n_sel // m_group
    v = torch.zeros(rows * k + v_off)[v_off:].view(rows, k)
    i = torch.zeros(rows * k + i_off, dtype=torch.int8)[i_off:].view(rows, k)
    return torch.zeros(m, n), v, i


@pytest.mark.parametrize("m,n,k", [(1, 256, 64), (4, 4096, 4096),
                                   (4, 13696, 4096), (4, 4096, 13696),
                                   (16, 4096, 256), (3, 4096, 100)])
@pytest.mark.parametrize("v_off,i_off", [(0, 0), (1, 0), (0, 1), (3, 5)])
def test_decode_shapes_take_the_decode_kernel_aligned_or_not(m, n, k, v_off,
                                                            i_off):
    """M ≤ 16 with K % 4 == 0 takes the decode kernel on (ceil(K/256), S)
    with ``split_plan``'s order, whatever the operands' alignment (the naive
    entry refuses none of them)."""
    slices, length = nm.split_plan(m, n, k, 2, 4)
    operands = _operands(m, n, k, v_off, i_off)
    assert nm.select_entry(*operands, 2, 4, False) == ("nm_spmm_naive",
                                                       slices, length)
    launches = nm.naive_kernel(m, n, k, 2, 4)
    assert launches[0] == ("nm_spmm_naive_small_m_kernel",
                           (-(-k // nm.SMALL_M_TILE_K), slices))
    assert launches[1:] == ((("nm_reduce_kernel", (-(-m * k // 1024), 1)),)
                            if slices > 1 else ())
    assert nm.workspace_numel("nm_spmm_naive", m, n, k, slices) == \
        (slices * m * k if slices > 1 else 0)


@pytest.mark.parametrize("m,k", [(17, 64), (17, 4096), (512, 256), (4, 102),
                                 (16, 13698), (1, 30)])
def test_other_shapes_take_the_tiled_kernel_with_one_slice(m, k):
    """M = 17 or K % 4 != 0: x copied column-major, then the naive
    prefill kernel's register-blocked tiles, one slice; the workspace holds
    the copy (N rows of M rounded up to 128)."""
    n = 4096
    mp = -(-m // 128) * 128
    assert nm.select_entry(*_operands(m, n, k), 2, 4, False) == (
        "nm_spmm_naive", 1, nm.split_plan(m, n, k, 2, 4)[1])
    assert nm.naive_kernel(m, n, k, 2, 4) == (
        ("nm_transpose_x_kernel", (n // 32, mp // 32)),
        ("nm_spmm_naive_prefill_kernel", nm.naive_prefill_plan(m, k).grid))
    assert nm.workspace_numel("nm_spmm_naive", m, n, k, 1) == n * mp
