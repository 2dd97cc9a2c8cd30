"""Optflag ``padheads`` at the default bf16 compute dtype against the
reference, on the ``reduced()`` configs (4 query heads padded to 16),
with the reference's ``Model.init`` weights drawn under the flag.

The tolerance is ``tests/test_torch_bf16.py``'s: the reference's own
jit-vs-eager spread on the same inputs plus one bf16 ulp of max|logits|.

* chatglm3-6b: the prefill logits, then one decode step from the cache
  the reference's prefill filled, with the same greedy tokens;
* gemma3-27b (ring windows, no prefill): one decode step from a cache the
  reference's jitted steps filled;
* whisper-tiny: the loss, within the spread plus one bf16 ulp of it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import layers as RL
from repro.models import optflags as roptflags
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model

FLAGS = ("padheads",)
B, PROMPT, CACHE = 2, 6, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _held(got, jit, eager) -> None:
    got, want = _np(got), _np(jit)
    tol = np.abs(want - _np(eager)).max() + _bf16_ulp(np.abs(want).max())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def _to_port(tree):
    """A reference tree as CPU tensors (bf16 kept bf16)."""
    def one(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))) \
                .to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(one, tree)


def _weights(arch):
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    assert L.COMPUTE_DTYPE == torch.bfloat16
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    with roptflags.optimizations(FLAGS):
        rparams = RModel(rcfg).init(jax.random.key(0))
    return rcfg, cfg, rparams, params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")


def _tokens(vocab, n):
    return np.random.default_rng(8).integers(0, vocab, (B, n))


def _step(rmodel, rparams, cache, tok, pos):
    """The reference's step jitted and op by op from the same cache."""
    args = (jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32))
    with roptflags.optimizations(FLAGS):
        jit, _ = jax.jit(rmodel.decode_step)(rparams, cache, *args)
        with jax.disable_jit():
            eager, _ = rmodel.decode_step(rparams, cache, *args)
    return jit, eager


def test_prefill_and_decode_match_the_reference():
    rcfg, cfg, rparams, params = _weights("chatglm3-6b")
    toks = _tokens(cfg.vocab, PROMPT + 1)
    rmodel = RModel(rcfg)
    prompt = jnp.asarray(toks[:, :PROMPT], jnp.int32)
    with roptflags.optimizations(FLAGS):
        want, rcache = jax.jit(rmodel.prefill, static_argnums=2)(
            rparams, prompt, CACHE)
        with jax.disable_jit():
            eager, _ = rmodel.prefill(rparams, prompt, CACHE)
    with optflags.optimizations(FLAGS):
        got, _ = Model(cfg).prefill(params, torch.from_numpy(
            toks[:, :PROMPT]), CACHE)
    _held(got, want, eager)
    want, eager = _step(rmodel, rparams, rcache, toks[:, PROMPT], PROMPT)
    with optflags.optimizations(FLAGS):
        got, _ = Model(cfg).decode_step(
            params, _to_port(rcache), torch.from_numpy(toks[:, PROMPT]),
            PROMPT)
    _held(got, want, eager)
    assert np.array_equal(_np(got).argmax(-1), _np(want).argmax(-1))


def test_ring_decode_matches_the_reference():
    rcfg, cfg, rparams, params = _weights("gemma3-27b")
    toks = _tokens(cfg.vocab, 4)
    rmodel = RModel(rcfg)
    with roptflags.optimizations(FLAGS):
        cache = rmodel.init_cache(B, CACHE)
        step = jax.jit(rmodel.decode_step)
        for t in range(3):
            _, cache = step(rparams, cache, jnp.asarray(toks[:, t],
                                                        jnp.int32),
                            jnp.asarray(t, jnp.int32))
    want, eager = _step(rmodel, rparams, cache, toks[:, 3], 3)
    with optflags.optimizations(FLAGS):
        got, _ = Model(cfg).decode_step(
            params, _to_port(cache), torch.from_numpy(toks[:, 3]), 3)
    _held(got, want, eager)
    assert np.array_equal(_np(got).argmax(-1), _np(want).argmax(-1))


def test_whisper_loss_matches_the_reference():
    rcfg, cfg, rparams, params = _weights("whisper-tiny")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (B, 8))
    labels = rng.integers(0, cfg.vocab, (B, 8))
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32),
              "enc_frames": jnp.asarray(enc)}
    with roptflags.optimizations(FLAGS):
        want = jax.jit(RModel(rcfg).loss)(rparams, rbatch)
        with jax.disable_jit():
            eager = RModel(rcfg).loss(rparams, rbatch)
    with optflags.optimizations(FLAGS):
        got = Model(cfg).loss(params, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels),
            "enc_frames": torch.from_numpy(enc)}, remat=False)
    want, eager = float(want), float(eager)
    tol = abs(want - eager) + _bf16_ulp(abs(want))
    assert abs(float(got) - want) <= tol
