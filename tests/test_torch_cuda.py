"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the reference, so it runs on a machine with a GPU
and no JAX:  ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Without a CUDA device every test skips: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launch_counts()
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


# m, n, k, bn, bk, density: ragged M and reduction chunks, density 0 / 1
@pytest.mark.parametrize("m,n,k,bn,bk,density", [
    (1, 48, 40, 12, 20, 0.5), (70, 856 * 2, 192, 856, 96, 0.5),
    (5, 64, 32, 16, 8, 0.0), (3, 64, 64, 16, 16, 1.0)])
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


@pytest.mark.parametrize("m,n,k,n_sel,m_group", [
    (1, 32, 24, 2, 4), (70, 128, 100, 1, 4), (4, 96, 64, 3, 8)])
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
