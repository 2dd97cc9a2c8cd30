"""The port's recurrent and attention building blocks against the
reference's, on the same numpy inputs and reduced-config weights.

* ``models/rglru.py``: ``_gates``, ``rglru_scan`` (the reference's
  associative scan against the port's sequential fp32 loop),
  ``rglru_block`` and ``rglru_decode`` over several steps (its ``h`` and
  conv tail advanced in place);
* ``models/ssm.py``: ``ssd_chunked`` over several chunks, ``ssm_block``
  and ``ssm_decode`` over several steps (state and conv tail in place),
  and the chunk multiple the reference needs;
* ``models/attention.py``: ``chunked_attention`` causal with a window
  (chunks that the window masks whole), bidirectional and with fewer
  queries than keys, ``attention_block`` with a window and as
  cross-attention (``kv_override``), ``attention_decode_block`` writing a
  ring slot (scalar and per-row ``cache_pos``).

fp32 (every module's compute dtype patched): within 1e-5 · max|want|.
bf16: within the reference's own jit-vs-eager spread on the same inputs
plus one bf16 ulp of max|want|, as ``tests/test_torch_bf16.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod

B = 2

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(params=["fp32", "bf16"])
def dtype(request, monkeypatch):
    if request.param == "fp32":
        for mod in (RL, rattn, rrg, rssm):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _held(dtype: str, got, jit, eager) -> None:
    """``got`` (the port) within the tolerance of ``jit`` (the reference
    as it serves, jitted); ``eager`` is the reference op by op (bf16
    only)."""
    got, want = _np(got), _np(jit)
    scale = float(np.abs(want).max())
    if dtype == "fp32":
        tol = 1e-5 * scale
    else:
        tol = float(np.abs(want - _np(eager)).max()) + _bf16_ulp(scale)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def _ref(dtype: str, fn, *args):
    """The reference's result jitted and (bf16) op by op."""
    jit = jax.jit(fn)(*args)
    if dtype == "fp32":
        return jit, jit
    with jax.disable_jit():
        eager = fn(*args)
    return jit, eager


def _to_torch(x, dtype: str) -> torch.Tensor:
    """A reference array as the port's tensor, bf16 arrays kept bf16."""
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(torch.bfloat16) if jnp.asarray(x).dtype == jnp.bfloat16 \
        else t


def _act(rng, shape, dtype: str):
    """A compute-dtype activation for both packages."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    return x.astype(jnp.bfloat16) if dtype == "bf16" else x


def _weights(init, key, cfg):
    return jax.tree.map(np.asarray, init(jax.random.key(key), cfg))


def _tree(p: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rec_cfg():
    return rget_config("recurrentgemma-2b").reduced(), \
        get_config("recurrentgemma-2b").reduced()


def test_rglru_gates_and_scan(rec_cfg, dtype):
    rcfg, _ = rec_cfg
    rp = _weights(rrg.rglru_params, 1, rcfg)
    rng = np.random.default_rng(0)
    x = _act(rng, (B, 24, rcfg.d_model), dtype)
    jit, eager = _ref(dtype, lambda x_: rrg._gates(x_, rp), x)
    got = rg._gates(_to_torch(x, dtype), _tree(rp))
    for g, j, e in zip(got, jit, eager):
        _held(dtype, g, j, e)
    a, beta, _ = jit
    h0 = _act(rng, (B, rcfg.d_model), dtype)
    jit, eager = _ref(dtype, rrg.rglru_scan, x, a, beta, h0)
    got = rg.rglru_scan(_to_torch(x, dtype), _to_torch(a, dtype),
                        _to_torch(beta, dtype), _to_torch(h0, dtype))
    for g, j, e in zip(got, jit, eager):
        _held(dtype, g, j, e)


def test_rglru_block_and_decode(rec_cfg, dtype):
    rcfg, cfg = rec_cfg
    rp = _weights(rrg.rglru_params, 2, rcfg)
    p = _tree(rp)
    rng = np.random.default_rng(1)
    x = _act(rng, (B, 24, rcfg.d_model), dtype)
    jit, eager = _ref(dtype, lambda x_: rrg.rglru_block(x_, rp, rcfg), x)
    got = rg.rglru_block(_to_torch(x, dtype), p, cfg)
    for g, j, e in zip(got, jit, eager):
        _held(dtype, g, j, e)
    # decode: h and the conv tail advance in place
    h = _act(rng, (B, rcfg.d_model), dtype)
    conv = _act(rng, (B, 3, rcfg.d_model), dtype)
    th, tconv = _to_torch(h, dtype), _to_torch(conv, dtype)
    rh, rconv, eh, econv = h, conv, h, conv
    step = jax.jit(lambda *a: rrg.rglru_decode(a[0], rp, rcfg, a[1], a[2]))
    for t in range(3):
        xt = _act(rng, (B, rcfg.d_model), dtype)
        ry, rh, rconv = step(xt, rh, rconv)
        ey, eh, econv = ry, rh, rconv
        if dtype == "bf16":
            with jax.disable_jit():
                ey, eh, econv = rrg.rglru_decode(xt, rp, rcfg, eh, econv)
        y = rg.rglru_decode(_to_torch(xt, dtype), p, cfg, th, tconv)
        _held(dtype, y, ry, ey)
        _held(dtype, th, rh, eh)
        _held(dtype, tconv, rconv, econv)


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_cfg():
    return rget_config("mamba2-780m").reduced(), \
        get_config("mamba2-780m").reduced()


def test_ssd_chunked_over_several_chunks(ssm_cfg, dtype):
    rcfg, _ = ssm_cfg
    s = rcfg.ssm
    nh = rcfg.d_model * s.expand // s.head_dim
    rng = np.random.default_rng(2)
    xh = _act(rng, (B, 3 * s.chunk, nh, s.head_dim), dtype)
    dt = jnp.asarray(np.abs(rng.standard_normal(
        (B, 3 * s.chunk, nh))).astype(np.float32) * 0.2)
    A = -jnp.exp(jnp.log(jnp.arange(1, nh + 1, dtype=jnp.float32)))
    Bm = _act(rng, (B, 3 * s.chunk, s.d_state), dtype)
    Cm = _act(rng, (B, 3 * s.chunk, s.d_state), dtype)
    jit, eager = _ref(dtype, lambda *a: rssm.ssd_chunked(*a, s.chunk),
                      xh, dt, A, Bm, Cm)
    got = ssm_mod.ssd_chunked(*(_to_torch(v, dtype)
                                for v in (xh, dt, A, Bm, Cm)), s.chunk)
    for g, j, e in zip(got, jit, eager):
        _held(dtype, g, j, e)


def test_ssd_needs_whole_chunks(ssm_cfg):
    """The reference reshapes S into chunks without padding and fails when
    S is not a multiple of the chunk; the port raises as well."""
    rcfg, _ = ssm_cfg
    s = rcfg.ssm
    nh = rcfg.d_model * s.expand // s.head_dim
    args = (np.zeros((1, s.chunk + 1, nh, s.head_dim), np.float32),
            np.zeros((1, s.chunk + 1, nh), np.float32),
            -np.ones(nh, np.float32),
            np.zeros((1, s.chunk + 1, s.d_state), np.float32),
            np.zeros((1, s.chunk + 1, s.d_state), np.float32))
    with pytest.raises(TypeError):
        rssm.ssd_chunked(*map(jnp.asarray, args), s.chunk)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm_mod.ssd_chunked(*map(torch.from_numpy, args), s.chunk)


def test_ssm_block_and_decode(ssm_cfg, dtype):
    rcfg, cfg = ssm_cfg
    s = rcfg.ssm
    rp = _weights(rssm.ssm_params, 3, rcfg)
    p = _tree(rp)
    rng = np.random.default_rng(3)
    x = _act(rng, (B, 2 * s.chunk, rcfg.d_model), dtype)
    jit, eager = _ref(dtype, lambda x_: rssm.ssm_block(x_, rp, rcfg), x)
    got = ssm_mod.ssm_block(_to_torch(x, dtype), p, cfg)
    for g, j, e in zip(got, jit, eager):
        _held(dtype, g, j, e)
    d_in = rcfg.d_model * s.expand
    nh = d_in // s.head_dim
    state = _act(rng, (B, nh, s.head_dim, s.d_state), dtype)
    conv = _act(rng, (B, s.d_conv - 1, d_in + 2 * s.d_state), dtype)
    tstate, tconv = _to_torch(state, dtype), _to_torch(conv, dtype)
    rstate, rconv, estate, econv = state, conv, state, conv
    step = jax.jit(lambda *a: rssm.ssm_decode(a[0], rp, rcfg, a[1], a[2]))
    for t in range(3):
        xt = _act(rng, (B, rcfg.d_model), dtype)
        ry, rstate, rconv = step(xt, rstate, rconv)
        ey, estate, econv = ry, rstate, rconv
        if dtype == "bf16":
            with jax.disable_jit():
                ey, estate, econv = rssm.ssm_decode(xt, rp, rcfg, estate,
                                                    econv)
        y = ssm_mod.ssm_decode(_to_torch(xt, dtype), p, cfg, tstate, tconv)
        _held(dtype, y, ry, ey)
        _held(dtype, tstate, rstate, estate)
        _held(dtype, tconv, rconv, econv)


# ---------------------------------------------------------------------------
# windowed, bidirectional and cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,sq", [
    (True, 5, 20), (True, 0, 20), (False, 0, 20), (False, 0, 7)],
    ids=["window", "causal", "bidirectional", "fewer-queries"])
def test_chunked_attention(dtype, causal, window, sq):
    """KV chunks of 4 over 20 keys: with a window of 5 the later queries
    meet chunks that the window masks whole."""
    rng = np.random.default_rng(4)
    q = _act(rng, (B, sq, 4, 32), dtype)
    k = _act(rng, (B, 20, 4, 32), dtype)
    v = _act(rng, (B, 20, 4, 32), dtype)

    def ref(q_, k_, v_):
        return rattn.chunked_attention(q_, k_, v_, causal=causal,
                                       window=window, q_chunk=8,
                                       kv_chunk=4)
    jit, eager = _ref(dtype, ref, q, k, v)
    got = attn.chunked_attention(*(_to_torch(t, dtype) for t in (q, k, v)),
                                 causal=causal, window=window, q_chunk=8,
                                 kv_chunk=4)
    _held(dtype, got, jit, eager)


@pytest.fixture(scope="module")
def attn_cfg():
    return rget_config("gemma3-27b").reduced(), \
        get_config("gemma3-27b").reduced()


@pytest.mark.parametrize("case", ["window", "cross"])
def test_attention_block(attn_cfg, dtype, case):
    rcfg, cfg = attn_cfg
    rp = jax.tree.map(np.asarray, RL.attn_params(jax.random.key(5), rcfg))
    p = _tree(rp)
    rng = np.random.default_rng(5)
    x = _act(rng, (B, 12, rcfg.d_model), dtype)
    enc = _act(rng, (B, 16, rcfg.d_model), dtype)
    freqs = RL.rope_freqs(rcfg)
    pos = jnp.arange(12)
    if case == "window":
        def ref(x_):
            return rattn.attention_block(x_, rp, rcfg, freqs, pos, window=5)
        got = attn.attention_block(_to_torch(x, dtype), p, cfg,
                                   L.rope_freqs(cfg, "cpu"),
                                   torch.arange(12), window=5)
    else:
        def ref(x_):
            return rattn.attention_block(x_, rp, rcfg, None, pos,
                                         causal=False,
                                         kv_override=(enc, enc))
        te = _to_torch(enc, dtype)
        got = attn.attention_block(_to_torch(x, dtype), p, cfg, None,
                                   torch.arange(12), causal=False,
                                   kv_override=(te, te))
    jit, eager = _ref(dtype, ref, x)
    _held(dtype, got, jit, eager)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_attention_decode_writes_the_ring_slot(attn_cfg, dtype, per_row):
    """A ring of 8 past its wrap: the step at position ``pos`` writes slot
    ``pos % 8`` in place and attends to ``min(pos + 1, 8)`` slots."""
    rcfg, cfg = attn_cfg
    rp = jax.tree.map(np.asarray, RL.attn_params(jax.random.key(6), rcfg))
    p = _tree(rp)
    rng = np.random.default_rng(6)
    nk, hd, ring = rcfg.n_kv_heads, rcfg.head_dim, 8
    x = _act(rng, (B, rcfg.d_model), dtype)
    kc = _act(rng, (B, ring, nk, hd), dtype)
    vc = _act(rng, (B, ring, nk, hd), dtype)
    pos = np.array([11, 3]) if per_row else np.array(11)
    freqs = RL.rope_freqs(rcfg)

    def ref(x_, kc_, vc_):
        return rattn.attention_decode_block(
            x_, rp, rcfg, freqs, jnp.asarray(pos), kc_, vc_,
            jnp.asarray(pos % ring))
    jit, eager = _ref(dtype, ref, x, kc, vc)
    tk, tv = _to_torch(kc, dtype), _to_torch(vc, dtype)
    tpos = torch.from_numpy(pos)
    got = attn.attention_decode_block(_to_torch(x, dtype), p, cfg,
                                      L.rope_freqs(cfg, "cpu"), tpos, tk, tv,
                                      tpos % ring)
    for g, j, e in zip((got, tk, tv), jit, eager):
        _held(dtype, g, j, e)
