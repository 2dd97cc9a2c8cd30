"""The port's ``kernels.ops`` against the reference's ``repro.kernels.ops``,
on identical numpy inputs: the naive (``pipeline=False``) sparse paths,
flash attention, the ``pipeline`` knob and the dispatch hook.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances: the reference's own for the sparse kernels (1e-5 bitmap,
1e-4 N:M, tests/test_kernels.py:41,108); flash at fp32 1e-5, and at bf16
the per-element bound of ``repro_torch.kernels.ref.flash_attention_bf16_tol``.
The CUDA kernels run only on the card (tests/test_torch_cuda.py,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec.dispatch import _tile
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _block_sparse_w(rng, n, k, bn, bk, density):
    keep = np.repeat(np.repeat(rng.random((n // bn, k // bk)) < density,
                               bn, 0), bk, 1)
    return (rng.normal(size=(n, k)) * keep).astype(np.float32)


# ---------------------------------------------------------------------------
# naive sparse paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("extra", [0, 2], ids=["t_max=max", "t_max=max+2"])
def test_bitmap_naive_matches_reference(density, extra):
    """``pipeline=False`` with a static bound equal to, or above, the
    longest block-column."""
    rng = np.random.default_rng(int(density * 10) + extra)
    m, n, k, bn, bk = 8, 64, 48, 16, 12
    w = _block_sparse_w(rng, n, k, bn, bk, density)
    x = rng.normal(size=(m, n)).astype(np.float32)
    rcomp = rops.compress_bitmap(w, bn, bk)
    comp = ops.compress_bitmap(torch.from_numpy(w), bn, bk)
    assert comp.max_per_col == rcomp.max_per_col
    t_max = max(comp.max_per_col, 1) + extra
    want = rops.bitmap_spmm(jnp.asarray(x), rcomp, bm=m, t_max=t_max,
                            pipeline=False)
    got = ops.bitmap_spmm(torch.from_numpy(x), comp, t_max=t_max,
                          pipeline=False)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bitmap_naive_refuses_a_bound_below_the_longest_column():
    w = _block_sparse_w(np.random.default_rng(1), 32, 16, 8, 8, 1.0)
    comp = ops.compress_bitmap(torch.from_numpy(w), 8, 8)
    assert comp.max_per_col == 4
    x = torch.ones(2, 32)
    with pytest.raises(ValueError, match="t_max=3"):
        ops.bitmap_spmm(x, comp, t_max=3, pipeline=False)
    # the pipelined variant walks counts[kj] and ignores the bound
    ops.bitmap_spmm(x, comp, t_max=3, pipeline=True)


@pytest.mark.parametrize("m,n,k,n_sel", [(8, 64, 40, 2), (5, 48, 20, 1),
                                         (16, 128, 64, 2), (3, 32, 24, 1)])
def test_nm_naive_matches_reference(m, n, k, n_sel):
    rng = np.random.default_rng(m + n + k + n_sel)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    want = rops.nm_spmm(jnp.asarray(x), rops.compress_nm(w, n_sel, 4),
                        bm=m, bn=_tile(n, multiple=4), bk=_tile(k),
                        pipeline=False)
    got = ops.nm_spmm(torch.from_numpy(x),
                      ops.compress_nm(torch.from_numpy(w), n_sel, 4),
                      pipeline=False)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(rng, bh, sq, skv, d):
    return [rng.normal(size=(bh, s, d)).astype(np.float32)
            for s in (sq, skv, skv)]


# the shapes of tests/test_kernels.py:141-146
@pytest.mark.parametrize("bh,sq,skv,d,bq,bk", [
    (2, 64, 64, 32, 16, 16),
    (4, 128, 128, 64, 32, 64),
    (1, 32, 32, 128, 32, 32),
    (3, 96, 96, 16, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(bh, sq, skv, d, bq, bk, causal):
    q, k, v = _qkv(np.random.default_rng(sq + d), bh, sq, skv, d)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=bq, bk=bk)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, bq=bq,
                              bk=bk)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_causal_mask_is_top_left():
    """Sq ≠ Skv: the port follows the reference KERNEL (key j visible to
    query i iff j <= i), not the reference oracle's bottom-right
    ``tril(k=Skv-Sq)``; the two conventions differ here."""
    q, k, v = _qkv(np.random.default_rng(7), 2, 32, 64, 32)
    kernel = np.asarray(rops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, bq=16,
        bk=16))
    oracle = np.asarray(rref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, bq=16,
                              bk=16).numpy()
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-5)
    assert np.abs(got - oracle).max() > 0.1


def test_flash_attention_bf16_matches_reference():
    """The case of tests/test_kernels.py:172-181, per element to
    ``ref.flash_attention_bf16_tol``: both round the output to bf16 once,
    and both round every softmax weight to bf16 once before the PV
    product, but at different places — the port's plain version the
    normalised weight, the reference kernel ``exp(s − m)`` against its
    running max."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 64, 32)) for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(rops.flash_attention(jq, jk, jv, causal=True, bq=32,
                                           bk=32), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv, causal=True, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    tol = tref.flash_attention_bf16_tol(tq, tk, tv, got, causal=True)
    assert (np.abs(got.float().numpy() - want) <= tol.numpy()).all()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_bound_holds_rounding_and_catches_a_dropped_tile(causal):
    """The bf16 bound admits a kernel's rounding (``exp(s − m)`` rounded to
    bf16, divided by the unrounded sum) and rejects a kernel that drops
    one 64-key tile of 512."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 512, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    o_plain = tref.flash_attention_ref(q, k, v, causal)
    tol = tref.flash_attention_bf16_tol(q, k, v, o_plain, causal)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / 8.0
    if causal:
        s = s.masked_fill(~torch.ones(512, 512, dtype=torch.bool).tril(),
                          -1e30)
    p = (s - s.amax(-1, keepdim=True)).exp()
    o = ((p.to(torch.bfloat16).float() @ v.float())
         / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    assert bool(((o.float() - o_plain.float()).abs() <= tol).all())
    if causal:                    # rows past the first tile lose keys 0..63
        dropped = tref.flash_attention_ref(
            q[:, 64:], k[:, 64:], v[:, 64:], True)
        o_plain, tol = o_plain[:, 64:], tol[:, 64:]
    else:
        dropped = tref.flash_attention_ref(q, k[:, 64:], v[:, 64:], False)
    caught = (dropped.float() - o_plain.float()).abs() > tol
    assert caught.float().mean().item() > 0.8


@pytest.mark.parametrize("sq,skv,bq,bk", [(48, 64, 32, 32), (64, 40, 32, 16),
                                          (48, 40, 16, 8)])
def test_flash_attention_refuses_what_the_reference_refuses(sq, skv, bq,
                                                            bk):
    q, k, v = _qkv(np.random.default_rng(sq), 1, sq, skv, 16)
    refused = sq % min(bq, sq) or skv % min(bk, skv)
    args = dict(causal=True, bq=bq, bk=bk)
    if refused:
        with pytest.raises(AssertionError):
            rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **args)
        with pytest.raises(ValueError, match="multiples of the tiles"):
            ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **args)
    else:
        want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **args)
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# knobs and hooks
# ---------------------------------------------------------------------------

def test_pipeline_default_override():
    """The semantics tests/test_memory_pipeline.py:127-133 pins."""
    for mod in (ops, rops):
        assert mod.resolve_pipeline(None) is True
        assert mod.resolve_pipeline(False) is False
        with mod.pipeline_default(False):
            assert mod.resolve_pipeline(None) is False
            assert mod.resolve_pipeline(True) is True
        assert mod.resolve_pipeline(None) is True


def test_dispatch_hook_sees_every_kind():
    """``fn(kind, seconds)`` after every dispatch, kinds as the
    reference's hook reports them for the same calls."""
    rng = np.random.default_rng(3)
    w = _block_sparse_w(rng, 32, 16, 8, 8, 0.5)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    q = rng.normal(size=(1, 16, 8)).astype(np.float32)
    seen = {"port": [], "ref": []}

    def calls(mod, conv, wconv, who):
        def hook(kind, seconds):
            assert seconds >= 0.0
            seen[who].append(kind)
        bc, nc = mod.compress_bitmap(wconv(w), 8, 8), mod.compress_nm(wconv(w))
        with mod.kernel_dispatch_hook(hook):
            mod.bitmap_spmm(conv(x), bc)
            mod.nm_spmm(conv(x), nc, pipeline=False)
            mod.flash_attention(conv(q), conv(q), conv(q), bq=16, bk=16)
        mod.bitmap_spmm(conv(x), bc)                          # hook off

    calls(ops, torch.from_numpy, torch.from_numpy, "port")
    calls(rops, jnp.asarray, np.asarray, "ref")
    assert seen["port"] == seen["ref"] == ["bitmap", "nm", "flash"]


def test_fault_hook_fires_before_either_device_path():
    """``fn(kind)`` at every sparse dispatch, before the plain version or
    the kernel runs; flash dispatches do not call it (as the
    reference's)."""
    w = torch.from_numpy(_block_sparse_w(np.random.default_rng(4), 32, 16,
                                         8, 8, 0.5))
    x = torch.ones(2, 32)
    kinds = []

    def hook(kind):
        kinds.append(kind)
        if kind == "nm":
            raise RuntimeError("injected")

    with ops.kernel_fault_hook(hook):
        ops.bitmap_spmm(x, ops.compress_bitmap(w, 8, 8), pipeline=False)
        with pytest.raises(RuntimeError, match="injected"):
            ops.nm_spmm(x, ops.compress_nm(w))
        ops.flash_attention(torch.ones(1, 4, 8), torch.ones(1, 4, 8),
                            torch.ones(1, 4, 8))
    ops.nm_spmm(x, ops.compress_nm(w))                # hook restored: off
    assert kinds == ["bitmap", "nm"]
