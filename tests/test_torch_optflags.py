"""The port's optimization flags against the reference's
(``repro.models.optflags``), on reduced chatglm3-6b (GQA: 4 heads, 2 KV
heads).

Names, defaults and errors equal the reference's.  Under ``gqagroup`` the
port's decode logits are held to the reference's ``gqagroup`` logits on the
same weights (the reference's ``Model.init`` through numpy) and tokens:
at fp32 to 1e-4 (``tests/test_serve.py``'s bound, as
``test_torch_models.py``); at bf16 to ``test_torch_bf16.py``'s bound, the
reference's own jit-vs-eager spread plus one bf16 ulp of max|logits|.
``maskedkv`` is parametrised with ``gqagroup`` as in
``tests/test_optflags.py::test_decode_flags_preserve_logits``.  The flags
the port does not compute raise; the inert ones change nothing.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import optflags as roptflags
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model

STEPS = 6


@pytest.fixture(scope="module")
def reduced():
    rcfg = rget_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, get_config("chatglm3-6b").reduced(), rparams, params


def _positions(per_row: bool, t: int):
    """A scalar position, or per-row ones with row 1 two places behind."""
    return np.array([6 + t, 4 + t]) if per_row else np.asarray(6 + t)


def _reference_logits(rcfg, rparams, toks, flags, per_row, jit=True):
    model = RModel(rcfg)
    with roptflags.optimizations(flags):
        _, cache = model.prefill(rparams, jnp.asarray(toks[:, :6], jnp.int32),
                                 16)
        step = jax.jit(model.decode_step) if jit else model.decode_step
        out = []
        for t in range(STEPS):
            lg, cache = step(rparams, cache,
                             jnp.asarray(toks[:, 6 + t], jnp.int32),
                             jnp.asarray(_positions(per_row, t), jnp.int32))
            out.append(np.asarray(lg))
    return np.stack(out)


def _port_logits(cfg, params, toks, flags, per_row):
    model = Model(cfg)
    with optflags.optimizations(flags):
        _, cache = model.prefill(params, torch.from_numpy(toks[:, :6]), 16)
        out = []
        for t in range(STEPS):
            lg, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, 6 + t]),
                torch.as_tensor(_positions(per_row, t)))
            out.append(lg.numpy())
    return np.stack(out)


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (2, 6 + STEPS))


def test_names_defaults_and_errors_equal_the_reference():
    assert optflags.ALL_FLAGS == roptflags.ALL_FLAGS
    assert optflags.active() == roptflags.active() == frozenset()
    for mod in (optflags, roptflags):
        with pytest.raises(ValueError, match="unknown optimization flags"):
            with mod.optimizations(("nonsense",)):
                pass
        with mod.optimizations(("gqagroup", "maskedkv")):
            assert mod.enabled("gqagroup") and not mod.enabled("padheads")
            assert mod.active() == {"gqagroup", "maskedkv"}
            with mod.optimizations(()):
                assert not mod.enabled("gqagroup")
            assert mod.enabled("maskedkv")
        assert mod.active() == frozenset()


def test_flags_are_thread_local():
    seen = []
    with optflags.optimizations(("gqagroup",)):
        t = threading.Thread(target=lambda: seen.append(optflags.active()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [frozenset()]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("flag", ["gqagroup", "maskedkv"])
def test_decode_flags_match_the_reference_at_fp32(reduced, flag, per_row,
                                                  monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    rcfg, cfg, rparams, params = reduced
    toks = _tokens(cfg.vocab)
    want = _reference_logits(rcfg, rparams, toks, (flag,), per_row)
    got = _port_logits(cfg, params, toks, (flag,), per_row)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the same products in another order: the flag-off run agrees closely
    off = _port_logits(cfg, params, toks, (), per_row)
    np.testing.assert_allclose(got, off, rtol=1e-5, atol=1e-5)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("per_row", [False, True])
def test_gqagroup_matches_the_reference_at_bf16(reduced, per_row):
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    assert L.COMPUTE_DTYPE == torch.bfloat16
    rcfg, cfg, rparams, params = reduced
    toks = _tokens(cfg.vocab)
    flags = ("gqagroup",)
    want = _reference_logits(rcfg, rparams, toks, flags, per_row)
    with jax.disable_jit():
        eager = _reference_logits(rcfg, rparams, toks, flags, per_row,
                                  jit=False)
    got = _port_logits(cfg, params, toks, flags, per_row)
    tol = np.abs(want - eager).max() + _bf16_ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("length", ["scalar", "per-row"])
def test_decode_attention_gqa_equals_the_reference_kernel(length):
    """The function alone, fp32 inputs: q (3, 8, 16) against caches
    (3, 10, 2, 16), 4 query heads a KV head."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 8, 16)).astype(np.float32)
    k = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 10, 2, 16)).astype(np.float32)
    n = np.asarray(7) if length == "scalar" else np.array([10, 3, 1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        want = np.asarray(rattn.decode_attention_gqa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(n)))
        got = attn.decode_attention_gqa(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flag", ["replkv", "seqpar", "saveremat"])
def test_mesh_and_training_flags_are_inert_on_the_serving_path(reduced,
                                                               flag):
    _, cfg, _, params = reduced
    toks = _tokens(cfg.vocab)
    assert np.array_equal(_port_logits(cfg, params, toks, (flag,), True),
                          _port_logits(cfg, params, toks, (), True))


@pytest.mark.parametrize("flag", ["sparseffn", "bf16params"])
def test_flags_the_port_does_not_serve_raise(reduced, flag):
    _, cfg, _, params = reduced
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    with optflags.optimizations((flag,)):
        with pytest.raises(NotImplementedError, match=flag):
            model.init(seed=0, device="cpu")
        with pytest.raises(NotImplementedError, match=flag):
            model.prefill(params, toks, 16)
        with pytest.raises(NotImplementedError, match=flag):
            model.logits(params, toks)
        cache = model.init_cache(2, 16, device="cpu")
        with pytest.raises(NotImplementedError, match=flag):
            model.decode_step(params, cache, toks[:, 0], 0)


def test_padheads_raises_only_where_it_pads(reduced):
    """chatglm3-6b's 32 heads are a multiple of the TP degree (16): padding
    changes nothing, as in the reference's ``eff_heads``; the reduced
    config's 4 heads would be padded to 16, which the port refuses."""
    _, cfg, _, params = reduced
    with optflags.optimizations(("padheads",)), \
            roptflags.optimizations(("padheads",)):
        assert RL.eff_heads(32) == 32 and RL.eff_heads(4) == 16
        optflags.check_served(get_config("chatglm3-6b").n_heads)
        with pytest.raises(NotImplementedError, match="padheads"):
            Model(cfg).prefill(params, torch.zeros((1, 4), dtype=torch.long),
                               8)
