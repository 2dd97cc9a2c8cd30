"""Port kernels vs the reference kernels, on identical numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances are the reference's own: 1e-5 for bitmap
(tests/test_kernels.py:41), 1e-4 for N:M (:108).  The CUDA kernels run only
on the card: tests/test_torch_cuda.py and ``chip_smoke.py`` hold them
against the plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec.dispatch import _tile
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import build, ops, ref


def _block_sparse_w(rng, n, k, bn, bk, density):
    gn, gk = n // bn, k // bk
    bitmap = rng.random((gn, gk)) < density
    w = rng.normal(size=(n, k)).astype(np.float32)
    return (w * np.repeat(np.repeat(bitmap, bn, 0), bk, 1)).astype(
        np.float32)


# m, n, k, bn, bk, density — non-power-of-two blocks, M = 1, density 0 / 1
BITMAP_CASES = [
    (1, 48, 40, 12, 20, 0.5),
    (3, 96, 60, 24, 12, 0.4),
    (16, 64, 32, 16, 8, 0.0),
    (8, 64, 64, 16, 16, 1.0),
    (5, 84, 56, 28, 14, 0.6),
]

# m, n, k, n_sel (m_group 4)
NM_CASES = [
    (1, 32, 24, 2),
    (5, 64, 40, 1),
    (16, 128, 64, 2),
    (3, 48, 20, 1),
]


@pytest.mark.parametrize("m,n,k,bn,bk,density", BITMAP_CASES)
def test_compress_bitmap_matches_host(m, n, k, bn, bk, density):
    rng = np.random.default_rng(n * 100 + k)
    w = _block_sparse_w(rng, n, k, bn, bk, density)
    want = rref.compress_bitmap_host(w, bn, bk)
    got = ref.compress_bitmap(torch.from_numpy(w), bn, bk)
    for name, g, r in zip(("blocks", "counts", "row_ids", "offsets",
                           "bitmap"), got, want):
        assert g.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize("n_sel,m_group", [(1, 4), (2, 4), (3, 8)])
def test_compress_nm_matches_host(n_sel, m_group):
    rng = np.random.default_rng(n_sel * 10 + m_group)
    # small integers: many equal magnitudes, so the tie order is exercised
    w = rng.integers(-2, 3, size=(8 * m_group, 12)).astype(np.float32)
    vals, idx = rref.compress_nm_host(w, n_sel, m_group)
    tv, ti = ref.compress_nm(torch.from_numpy(w), n_sel, m_group)
    np.testing.assert_array_equal(tv.numpy(), vals)
    assert ti.dtype == torch.int8
    np.testing.assert_array_equal(ti.numpy(), idx)


@pytest.mark.parametrize("m,n,k,bn,bk,density", BITMAP_CASES)
def test_bitmap_spmm_matches_reference(m, n, k, bn, bk, density):
    rng = np.random.default_rng(m * 1000 + n + k)
    w = _block_sparse_w(rng, n, k, bn, bk, density)
    x = rng.normal(size=(m, n)).astype(np.float32)
    want = rops.bitmap_spmm(jnp.asarray(x), rops.compress_bitmap(w, bn, bk),
                            bm=min(128, m))
    comp = ops.compress_bitmap(torch.from_numpy(w), bn, bk)
    got = ops.bitmap_spmm(torch.from_numpy(x), comp)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # and the reference's dense masked oracle
    bitmap = rref.compress_bitmap_host(w, bn, bk)[4]
    oracle = rref.bitmap_spmm_ref(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(bitmap), bn, bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,k,n_sel", NM_CASES)
def test_nm_spmm_matches_reference(m, n, k, n_sel):
    rng = np.random.default_rng(m * 1000 + n + k + n_sel)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    want = rops.nm_spmm(jnp.asarray(x), rops.compress_nm(w, n_sel, 4),
                        bm=min(128, m), bn=_tile(n, multiple=4),
                        bk=_tile(k))
    comp = ops.compress_nm(torch.from_numpy(w), n_sel, 4)
    got = ops.nm_spmm(torch.from_numpy(x), comp)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_sel", [1, 2])
def test_nm_expand_ref_takes_n_sel(n_sel):
    """The plain expand is lossless for any n_sel (the reference's oracle
    hard-codes 2)."""
    rng = np.random.default_rng(5 + n_sel)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    vals, idx = rref.compress_nm_host(w, n_sel, 4)
    pruned = np.zeros_like(w).reshape(8, 4, 16)
    np.put_along_axis(pruned, idx.astype(np.int64).reshape(8, n_sel, 16),
                      vals.reshape(8, n_sel, 16), axis=1)
    dense = ref.nm_expand_ref(torch.from_numpy(vals), torch.from_numpy(idx),
                              n_sel, 4)
    np.testing.assert_array_equal(dense.numpy(), pruned.reshape(32, 16))


def test_compression_ratios_match_reference():
    rng = np.random.default_rng(3)
    w = _block_sparse_w(rng, 96, 64, 24, 16, 0.3)
    assert ops.compress_bitmap(torch.from_numpy(w), 24, 16) \
        .compression_ratio == rops.compress_bitmap(w, 24, 16) \
        .compression_ratio
    for n_sel in (1, 2):
        assert ops.compress_nm(torch.from_numpy(w), n_sel, 4) \
            .compression_ratio == rops.compress_nm(w, n_sel, 4) \
            .compression_ratio


def test_cpu_path_launches_no_kernel():
    """The plain versions run for CPU tensors and are not counted."""
    ops.reset_launch_counts()
    w = torch.from_numpy(_block_sparse_w(np.random.default_rng(0), 32, 16,
                                         8, 8, 0.5))
    x = torch.ones(2, 32)
    for pipeline in (True, False):
        ops.bitmap_spmm(x, ops.compress_bitmap(w, 8, 8), pipeline=pipeline)
        ops.nm_spmm(x, ops.compress_nm(w), pipeline=pipeline)
    q = torch.ones(1, 4, 8)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {
        "bitmap_spmm": 0, "bitmap_spmm_naive": 0, "nm_spmm": 0,
        "nm_spmm_naive": 0, "flash_attention": 0}


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
