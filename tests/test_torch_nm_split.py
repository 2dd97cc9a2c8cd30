"""The N:M kernels' summation order, ``repro_torch.kernels.nm_spmm.split_plan``.

Both CUDA entries follow the plan: the groups along N are cut into slices
of a whole number of the naive entry's runs, each slice is summed on its
own and the partials are added left to right.  These tests hold the plan
to that shape and to its two aims at chatglm3-6b's decode shapes (batch 4):
at least two thread blocks per SM on the large roles, and a partials'
round trip within 10 % of the payload.  The slice-by-slice plain sum
catches a dropped or doubled slice without a card.  ``select_entry``
picks the C entry, and only the small-M one needs aligned operands.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import nm_spmm as nm
from repro_torch.kernels import ops, ref

SHAPES = [(m, n, k, n_sel, m_group)
          for m in (1, 4, 16, 17)
          for n, k in ((32, 24), (96, 64), (4096, 100), (4096, 256),
                       (4096, 13696), (13696, 4096))
          for n_sel, m_group in ((2, 4), (1, 4), (3, 8))
          if n % m_group == 0]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("m,n,k,n_sel,m_group", SHAPES)
def test_slices_cover_every_group_once_on_run_boundaries(m, n, k, n_sel,
                                                         m_group):
    slices, length = nm.split_plan(m, n, k, n_sel, m_group)
    groups = n // m_group
    run = 32 // m_group
    assert slices >= 1 and length >= 1 and length % run == 0
    assert (slices - 1) * length < groups <= slices * length
    covered = np.zeros(groups, dtype=int)
    for s in range(slices):
        covered[s * length:min((s + 1) * length, groups)] += 1
    assert (covered == 1).all()
    if slices > 1:                            # the small-M entry's x slice
        assert length * m_group <= nm.SPLIT_MAX_SLICE_COLS


@pytest.mark.parametrize("m", [17, 64, 512])
def test_one_slice_above_sixteen_rows(m):
    """Prefill keeps the unsplit order, so its outputs do not move."""
    for n, k in ((4096, 4096), (13696, 4096), (4096, 13696)):
        assert nm.split_plan(m, n, k, 2, 4)[0] == 1
    assert nm.split_plan(16, 4096, 4096, 2, 4)[0] > 1
    assert nm.split_plan(4, 4096, 102, 2, 4)[0] == 1     # K % 4 != 0


def _roles():
    return get_config("chatglm3-6b").matmul_roles()


@pytest.mark.parametrize("m", [1, 2, 4])
def test_decode_grid_fills_the_card_on_the_large_roles(m):
    """ceil(K/256) x S ≥ 2 x 132 blocks wherever K ≥ 4096 (wq, wo,
    w_gate, w_up, w_down) at 2:4; wk / wv (K = 256) are launch-bound."""
    for role in _roles():
        if role.k < 4096:
            continue
        slices, _ = nm.split_plan(m, role.n, role.k, 2, 4)
        blocks = _cdiv(role.k, nm.SMALL_M_TILE_K) * slices
        assert blocks >= 2 * 132, (role.role, blocks)


@pytest.mark.parametrize("n_sel", [2, 1])
def test_decode_partials_round_trip_within_a_tenth_of_the_payload(n_sel):
    m = 4
    for role in _roles():
        slices, _ = nm.split_plan(m, role.n, role.k, n_sel, 4)
        assert slices > 1, role.role
        payload = role.n * n_sel // 4 * role.k * 5      # fp32 + int8
        assert 2 * slices * m * role.k * 4 <= 0.1 * payload, role.role


def _operands(m, n, k, v_off=0, i_off=0, n_sel=2, m_group=4):
    """x, values, indices; values and indices contiguous views starting
    ``v_off`` / ``i_off`` elements into their storage."""
    rows = n * n_sel // m_group
    v = torch.zeros(rows * k + v_off)[v_off:].view(rows, k)
    i = torch.zeros(rows * k + i_off, dtype=torch.int8)[i_off:].view(rows, k)
    return torch.zeros(m, n), v, i


@pytest.mark.parametrize("m,k,pipeline,entry", [
    (4, 64, True, "nm_spmm_small_m"), (16, 64, True, "nm_spmm_small_m"),
    (17, 64, True, "nm_spmm"), (4, 102, True, "nm_spmm"),
    (4, 64, False, "nm_spmm_naive"), (17, 64, False, "nm_spmm_naive")])
@pytest.mark.parametrize("v_off,i_off", [(1, 0), (0, 1)])
def test_only_the_small_m_entry_refuses_misaligned_operands(m, k, pipeline,
                                                           entry, v_off,
                                                           i_off):
    """The small-M entry loads a float4 of values and a word of indices
    per row; every other entry takes any contiguous view, on the same
    summation order."""
    aligned = nm.select_entry(*_operands(m, 256, k), 2, 4, pipeline)
    assert aligned == (entry, *nm.split_plan(m, 256, k, 2, 4))
    misaligned = _operands(m, 256, k, v_off, i_off)
    assert misaligned[1].data_ptr() % 16 or misaligned[2].data_ptr() % 4
    if entry == "nm_spmm_small_m":
        with pytest.raises(ValueError, match="aligned"):
            nm.select_entry(*misaligned, 2, 4, pipeline)
    else:
        assert nm.select_entry(*misaligned, 2, 4, pipeline) == aligned


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("bad,err", [
    (lambda x, v, i: (x.half(), v, i), TypeError),
    (lambda x, v, i: (x, v.double(), i), TypeError),
    (lambda x, v, i: (x, v, i.int()), TypeError),
    (lambda x, v, i: (x.t().contiguous().t(), v, i), ValueError),
    (lambda x, v, i: (x[:, :-4].contiguous(), v, i), ValueError),
    (lambda x, v, i: (x, v, i[:-1]), ValueError)])
def test_both_entries_refuse_bad_operands(pipeline, bad, err):
    x, v, i = bad(*_operands(4, 256, 64))
    with pytest.raises(err):
        nm.select_entry(x, v, i, 2, 4, pipeline)


@pytest.mark.parametrize("m,n,k,n_sel,m_group", [
    (16, 13696, 256, 2, 4), (4, 13696, 4096, 2, 4), (4, 2048, 256, 3, 8),
    (4, 4096, 100, 1, 4), (1, 4096, 256, 2, 4)])
def test_slice_by_slice_plain_sum_matches_unsplit(m, n, k, n_sel, m_group):
    """Σ over slices, in order, of the plain product of each slice's x
    columns and kept rows equals the unsplit plain product."""
    slices, length = nm.split_plan(m, n, k, n_sel, m_group)
    assert slices > 1
    rng = np.random.default_rng(m + n + k)
    c = ops.compress_nm(torch.from_numpy(
        rng.normal(size=(n, k)).astype(np.float32)), n_sel, m_group)
    x = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    y = None
    for s in range(slices):
        g0, g1 = s * length, min((s + 1) * length, n // m_group)
        rows = slice(g0 * n_sel, g1 * n_sel)
        part = ref.nm_spmm_ref(x[:, g0 * m_group:g1 * m_group],
                               c.values[rows], c.indices[rows], n_sel,
                               m_group)
        y = part if y is None else y + part
    want = ref.nm_spmm_ref(x, c.values, c.indices, n_sel, m_group)
    assert y.shape == want.shape
    err = (y - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("m,n,k,pipeline", [
    (4, 4096, 256, True), (16, 1024, 64, True), (17, 256, 100, True),
    (512, 1024, 256, True), (129, 512, 1000, True), (128, 256, 64, True),
    (512, 1024, 256, False), (4, 1024, 256, False)])
def test_workspace_holds_the_partials_or_a_column_major_x(m, n, k,
                                                         pipeline):
    """A split reduction gets its (S, M, K) partials; a prefill shape, on
    the pipelined or the naive entry, its (N, M rounded up to the 128-row
    tile) copy of x, so every tile's x columns are whole, and on the
    pipelined entry the copy's non-finite flags after it; an unsplit
    decode shape none."""
    x, v, i = _operands(m, n, k)
    entry, slices, _ = nm.select_entry(x, v, i, 2, 4, pipeline)
    numel = nm.workspace_numel(entry, m, n, k, slices)
    if slices > 1:
        assert numel == slices * m * k
    elif not nm.small_m(m, k):
        # the pipelined entry keeps one non-finite flag per 32 x 32 tile
        flags = nm.nonfinite_flags(m, n) if entry == "nm_spmm" else 0
        mp = (numel - flags) // n
        assert numel == n * mp + flags and mp % nm.PREFILL_TILE_M == 0
        assert m <= mp < m + nm.PREFILL_TILE_M
        assert flags in (0, -(-n // 32) * mp // 32)
        assert numel - flags == nm.workspace_numel(
            "nm_spmm", m, n, k, 1) - nm.nonfinite_flags(m, n)
    else:
        assert numel == 0
