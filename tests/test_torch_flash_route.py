"""The flash kernel's entry choice and both entries' rounding plans, on the
CPU.

``repro_torch.kernels.flash_attention.select_entry`` picks the entry on the
host from the dtype, D and the operands' 16-byte alignment: the tensor-core
entry for bf16 at D = 64 or 128 on aligned operands, the FMA entry for
everything else.  Both entries run only on the card
(tests/test_torch_cuda.py); here a plain PyTorch emulation of their
common rounding plan (key tiles, ``2^(s·log2(e)/√D − m)`` against the
running max in log2 units, P rounded to v's type once per tile against
that max, the running sum of the unrounded p, the output rounded once to
q's type) is held against the reference's Pallas kernel in interpret mode
and against the port's plain version, on the same numpy inputs: fp32 to
1e-4·max + 1e-5, bf16 per element to ``ref.flash_attention_bf16_tol``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

NEG_INF = -1e30


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 100, 128, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_entry(dtype, d, aligned):
    want = "tensor_core" if (dtype == torch.bfloat16 and d in (64, 128)
                             and aligned) else "fma"
    assert fa.select_entry(dtype, d, aligned) == want


def test_cpu_tensors_launch_no_entry():
    """On the CPU the wrapper runs the plain version: no entry counts."""
    fa.reset_entry_counts()
    q = torch.ones(1, 8, 64, dtype=torch.bfloat16)
    ops.flash_attention(q, q, q)
    assert fa.entry_counts() == {"tensor_core": 0, "fma": 0}


def exp2_rounding(q, k, v, causal, bkv):
    """Both entries' arithmetic in plain PyTorch: per ``bkv``-key tile,
    fp32 scores, masked scores -1e30 (top-left causal), running max m in
    log2 units, ``p = 2^(s·c − m)`` with ``c = log2(e)/√D``, ``corr =
    2^(m_old − m)``, ``l = l·corr + Σ p`` of the unrounded p, ``acc =
    acc·corr + p·V`` in fp32 with p rounded to v's type, ``o = acc /
    max(l, 1e-30)`` rounded to q's type."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    c = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    qpos = torch.arange(sq)[:, None]
    for kv0 in range(0, skv, bkv):
        kt, vt = kf[:, kv0:kv0 + bkv], vf[:, kv0:kv0 + bkv]
        s = torch.einsum("bqd,bkd->bqk", qf, kt)
        if causal:
            kpos = torch.arange(kv0, kv0 + kt.shape[1])[None, :]
            s = s.masked_fill(kpos > qpos, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqk,bkd->bqd", p.to(v.dtype).float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _pallas(q, k, v, causal):
    """The reference's Pallas kernel in interpret mode on numpy inputs, at
    the largest tiles (up to 64) that divide Sq and Skv."""
    bq, bk = math.gcd(q.shape[1], 64), math.gcd(k.shape[1], 64)
    return np.array(flash_attention_pallas(
        q, k, v, causal=causal, bq=bq, bk=bk, interpret=True), np.float32)


# Sq, Skv ragged against the 64-key tile, Sq != Skv, several tiles, D of
# both tensor-core instances
@pytest.mark.parametrize("bh,sq,skv,d", [
    (2, 128, 128, 64), (1, 100, 192, 128), (2, 192, 130, 64),
    (1, 320, 320, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_is_within_the_bf16_bound(bh, sq, skv, d,
                                                       causal):
    rng = np.random.default_rng(bh * 1000 + sq + skv + d)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = torch.from_numpy(_pallas(jq, jk, jv, causal))
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (jq, jk, jv))
    got = exp2_rounding(tq, tk, tv, causal, 64)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    tol = ref.flash_attention_bf16_tol(tq, tk, tv, want, causal)
    assert bool(((got.float() - want).abs() <= tol).all())
    o_plain = ref.flash_attention_ref(tq, tk, tv, causal)
    tol = ref.flash_attention_bf16_tol(tq, tk, tv, o_plain, causal)
    assert bool(((got.float() - o_plain.float()).abs() <= tol).all())


# The FMA entry's key tile per operand type and class of D
# (csrc/flash_attention.cu, fma_entry::F32Tile32 ... Bf16Tile256)
FMA_BKV = {torch.float32: {16: 64, 48: 64, 128: 128, 200: 64},
           torch.bfloat16: {16: 64, 48: 64, 128: 64, 200: 32}}


# Sq and Skv ragged against the FMA entry's tiles, Sq < Skv and Sq > Skv
# under the top-left causal mask
@pytest.mark.parametrize("sq,skv", [(96, 176), (176, 96)])
@pytest.mark.parametrize("d", [16, 48, 128, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fma_rounding_is_within_the_bound(dtype, causal, d, sq, skv):
    rng = np.random.default_rng(sq + 2 * skv + d)
    q, k, v = (rng.normal(size=(1, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = torch.from_numpy(_pallas(jq, jk, jv, causal))
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(dtype)
                  for a in (jq, jk, jv))
    got = exp2_rounding(tq, tk, tv, causal, FMA_BKV[dtype][d])
    assert got.dtype == dtype and got.shape == tq.shape
    o_plain = ref.flash_attention_ref(tq, tk, tv, causal)
    for other in (want, o_plain.float()):
        diff = (got.float() - other).abs()
        if dtype == torch.float32:
            assert diff.max() <= 1e-4 * other.abs().max() + 1e-5
        else:
            tol = ref.flash_attention_bf16_tol(tq, tk, tv, other, causal)
            assert bool((diff <= tol).all())
