"""Port model vs the reference model on reduced chatglm3-6b, at fp32.

The reference's own ``Model.init`` weights pass to the port through numpy;
logits and caches are held to 1e-4 (tests/test_serve.py:91), layer pieces
tighter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model


@pytest.fixture()
def fp32(monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def reduced():
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = rget_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, rparams)
    return (rcfg, get_config("chatglm3-6b").reduced(), rparams,
            params_from_numpy(np_params, "cpu"))


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_reference(reduce):
    r, p = rget_config("chatglm3-6b"), get_config("chatglm3-6b")
    if reduce:
        r, p = r.reduced(), p.reduced()
    for f in dataclasses.fields(p):
        assert getattr(p, f.name) == getattr(r, f.name), f.name
    assert p.head_dim == r.head_dim
    assert [(m.role, m.n, m.k, m.fanout) for m in p.matmul_roles()] == \
        [(m.role, m.n, m.k, m.fanout) for m in r.matmul_roles()]


def test_params_layout_and_numpy_round_trip(reduced):
    rcfg, cfg, rparams, params = reduced
    own = Model(cfg).init(seed=3, device="cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), rparams)
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       params_to_numpy(own))
    assert got == want
    back = params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, rparams))


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    cfg = get_config("chatglm3-6b").reduced()          # RoPE on half a head
    rfreqs = RL.rope_freqs(rget_config("chatglm3-6b").reduced())
    freqs = L.rope_freqs(cfg, "cpu")
    _close(freqs, rfreqs, 1e-7)
    pos = np.array([0, 3, 7, 100, 4095])
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[None],
                       freqs)
    _close(got, RL.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None],
                              rfreqs), 1e-5)
    # interleaved pairs, tail untouched: not the rotate_half convention
    np.testing.assert_array_equal(got[..., 16:].numpy(), x[..., 16:])


def test_chunked_attention_matches_reference(fp32):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 10, 4, 8)).astype(np.float32)
               for _ in range(3))
    want = rattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_chunk=4, kv_chunk=3)
    got = attn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), q_chunk=4, kv_chunk=3)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("length", [5, [3, 7]], ids=["scalar", "per-row"])
def test_decode_attention_matches_reference(fp32, length):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 8)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 9, 4, 8)).astype(np.float32)
              for _ in range(2))
    want = rattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(length))
    got = attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.tensor(length))
    _close(got, want, 1e-5)


def test_prefill_logits_and_cache_match_reference(fp32, reduced):
    rcfg, cfg, rparams, params = reduced
    toks = _tokens(cfg.vocab, 2, 8)
    rl, rc = RModel(rcfg).prefill(rparams, jnp.asarray(toks, jnp.int32), 12)
    tl, tc = Model(cfg).prefill(params, torch.from_numpy(toks), 12)
    assert tl.shape == (2, 8, cfg.vocab) and tl.dtype == torch.float32
    _close(tl, rl)
    for name in ("k", "v"):
        assert tuple(tc["self"][name].shape) == rc["self"][name].shape
        _close(tc["self"][name], rc["self"][name])
    # the logits head is tied to the embedding
    _close(Model(cfg).logits(params, torch.from_numpy(toks)), rl)


@pytest.mark.parametrize("pos", ["scalar", "per-row"])
def test_decode_step_matches_reference(fp32, reduced, pos):
    """Three decode steps after a 6-token prefill; per-row positions put
    row 1 behind row 0, overwriting its own prefilled cache entries."""
    rcfg, cfg, rparams, params = reduced
    toks = _tokens(cfg.vocab, 2, 9, seed=4)
    rmodel, model = RModel(rcfg), Model(cfg)
    _, rc = rmodel.prefill(rparams, jnp.asarray(toks[:, :6], jnp.int32), 12)
    _, tc = model.prefill(params, torch.from_numpy(toks[:, :6]), 12)
    for i in range(3):
        p = 6 + i if pos == "scalar" else np.array([6 + i, 4 + i])
        rl, rc = rmodel.decode_step(rparams, rc,
                                    jnp.asarray(toks[:, 6 + i], jnp.int32),
                                    jnp.asarray(p, jnp.int32))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(toks[:, 6 + i]),
                                   torch.as_tensor(p))
        _close(tl, rl)
    _close(tc["self"]["k"], rc["self"]["k"])


def test_unserved_families_raise():
    """The one refusal left is the port's own (a MoE family without a MoE
    block).  A uniform stack with a window constructs and serves by token
    ingest: its one-pass prefill raises the reference's error."""
    cfg = get_config("chatglm3-6b").reduced()
    with pytest.raises(NotImplementedError, match="moe"):
        Model(dataclasses.replace(cfg, family="moe"))
    windowed = Model(dataclasses.replace(cfg, window=16))
    params = windowed.init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="uniform full-attention stacks only"):
        windowed.prefill(params, torch.zeros((1, 4), dtype=torch.long), 8)
    logits, _ = windowed.decode_step(
        params, windowed.init_cache(1, 8, device="cpu"),
        torch.zeros(1, dtype=torch.long), 0)
    assert logits.shape == (1, cfg.vocab) and bool(logits.isfinite().all())


def test_init_default_device_is_cuda_and_raises_here():
    """No device is picked on the caller's behalf: the default is the card,
    and without one the init raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_config("chatglm3-6b").reduced()).init(seed=0)
