"""Optflag ``padheads`` in the port against the reference, on the
``reduced()`` configs (4 query heads, padded to 16).

The padded heads get real random weights, so the logits change: both
packages get the reference's ``Model.init`` weights through numpy, drawn
under the flag, and every module's compute dtype is patched to fp32.

* ``eff_heads`` and the init layout of every family;
* ``prefill`` and ``decode_step`` logits on every family with attention
  (dense, moe, vlm; gemma3 and recurrentgemma decode, their ring windows
  have no prefill in either package), with ``gqagroup`` too: 1e-5 ·
  max|want|;
* whisper-tiny's loss and gradients (the counterpart of
  ``tests/test_optflags.py::test_padheads_trains_and_rounds_heads``):
  the loss to 1e-5 relative, each gradient leaf to 1e-4 · max|leaf|
  (``test_torch_train.py``'s bounds); its cross-attention decode, which
  reshapes with the unpadded head count, raises ``ValueError`` in both;
* the compressed plane: both packages prune, compress and serve the
  padded ``wq`` / ``wo`` through their sparse kernels (the port's plain
  versions here): the same store checksums, prefill logits to 1e-4 (the
  compressed serving tests' bound) and the same greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.core.cosearch import CoSearchConfig
from repro.core.engine import EngineConfig
from repro.core.sparsity import NM, BlockBernoulli
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import moe as rmoe
from repro.models import optflags as roptflags
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.train import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model

FLAGS = ("padheads",)
B, PROMPT, STEPS, CACHE = 2, 6, 4, 16
PREFILL_ARCHS = ["chatglm3-6b", "granite-moe-3b-a800m", "pixtral-12b"]
RING_ARCHS = ["gemma3-27b", "recurrentgemma-2b"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (RL, rattn, rmoe, rrg, rssm):
            mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol: float = 1e-5) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _layout(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace(
        "torch.", "")), tree)


def _weights(arch, flags=FLAGS):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    with roptflags.optimizations(flags):
        rparams = RModel(rcfg).init(jax.random.key(0))
    return rcfg, cfg, rparams, params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")


def _tokens(vocab, n=PROMPT + STEPS):
    return np.random.default_rng(5).integers(0, vocab, (B, n))


def test_eff_heads_equals_the_references():
    for n in (0, 4, 6, 10, 16, 24, 32, 56, 64):
        assert L.eff_heads(n) == RL.eff_heads(n) == n
        with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
            assert L.eff_heads(n) == RL.eff_heads(n)
    with optflags.optimizations(FLAGS):
        assert (L.eff_heads(56), L.eff_heads(32), L.eff_heads(4)) == \
            (64, 32, 16)
    assert L.TP_DEGREE == RL.TP_DEGREE


@pytest.mark.parametrize("reduced", [True, False])
def test_init_layout_equals_the_references(reduced):
    """Every config of the registry, shapes and dtypes only."""
    from repro_torch.configs import list_archs
    for arch in list_archs():
        rcfg, cfg = rget_config(arch), get_config(arch)
        if reduced:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
            want = jax.eval_shape(lambda: RModel(rcfg).init(
                jax.random.key(0)))
            got = Model(cfg).init(device="meta")
        assert _layout(got) == _layout(want), arch


def _ref_run(rcfg, rparams, toks, flags, prefill: bool):
    model = RModel(rcfg)
    with roptflags.optimizations(flags):
        if prefill:
            logits, cache = model.prefill(
                rparams, jnp.asarray(toks[:, :PROMPT], jnp.int32), CACHE)
            start = PROMPT
        else:
            logits, cache, start = None, model.init_cache(B, CACHE), 0
        step = jax.jit(model.decode_step)
        out = []
        for t in range(start, toks.shape[1]):
            lg, cache = step(rparams, cache,
                             jnp.asarray(toks[:, t], jnp.int32),
                             jnp.asarray(t, jnp.int32))
            out.append(_np(lg))
    return logits, np.stack(out)


def _port_run(cfg, params, toks, flags, prefill: bool):
    model = Model(cfg)
    with optflags.optimizations(flags):
        if prefill:
            logits, cache = model.prefill(
                params, torch.from_numpy(toks[:, :PROMPT]), CACHE)
            start = PROMPT
        else:
            logits, start = None, 0
            cache = model.init_cache(B, CACHE, device="cpu")
        out = []
        for t in range(start, toks.shape[1]):
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[:, t]), t)
            out.append(_np(lg))
    return logits, np.stack(out)


@pytest.mark.parametrize("flags", [FLAGS, FLAGS + ("gqagroup",)],
                         ids=["padheads", "padheads+gqagroup"])
@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_and_decode_match_the_reference(arch, flags):
    rcfg, cfg, rparams, params = _weights(arch)
    assert params["blocks"]["attn"]["wq"].shape[-1] == 16 * cfg.head_dim
    toks = _tokens(cfg.vocab)
    want_pre, want = _ref_run(rcfg, rparams, toks, flags, prefill=True)
    got_pre, got = _port_run(cfg, params, toks, flags, prefill=True)
    _close(got_pre, want_pre)
    _close(got, want)


@pytest.mark.parametrize("arch", RING_ARCHS)
def test_ring_families_decode_as_the_reference(arch):
    rcfg, cfg, rparams, params = _weights(arch)
    toks = _tokens(cfg.vocab)
    _, want = _ref_run(rcfg, rparams, toks, FLAGS, prefill=False)
    _, got = _port_run(cfg, params, toks, FLAGS, prefill=False)
    _close(got, want)
    with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
        with pytest.raises(NotImplementedError, match="uniform"):
            RModel(rcfg).prefill(rparams, jnp.zeros((B, 4), jnp.int32), 8)
        with pytest.raises(NotImplementedError, match="uniform"):
            Model(cfg).prefill(params, torch.zeros((B, 4), dtype=torch.long),
                               8)


def test_whisper_trains_as_the_reference():
    rcfg, cfg, rparams, params = _weights("whisper-tiny")
    assert params["blocks"]["cross"]["wq"].shape[-1] == 16 * cfg.head_dim
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (B, 8))
    labels = rng.integers(0, cfg.vocab, (B, 8))
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    with roptflags.optimizations(FLAGS):
        want_loss, want_grads = jax.jit(jax.value_and_grad(
            RModel(rcfg).loss))(rparams, {
                "tokens": jnp.asarray(toks, jnp.int32),
                "labels": jnp.asarray(labels, jnp.int32),
                "enc_frames": jnp.asarray(enc)})
    with optflags.optimizations(FLAGS):
        loss, grads = value_and_grad(Model(cfg).loss, params, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels),
            "enc_frames": torch.from_numpy(enc)})
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(want_grads)):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_whisper_cross_decode_raises_as_the_reference(batch):
    """The reference reshapes the padded query with the unpadded head
    count; its shapes meet at no batch size."""
    rcfg, cfg, rparams, params = _weights("whisper-tiny")
    with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
        rm, m = RModel(rcfg), Model(cfg)
        with pytest.raises(ValueError):
            rm.decode_step(rparams, rm.init_cache(batch, 8),
                           jnp.arange(batch, dtype=jnp.int32),
                           jnp.asarray(0, jnp.int32))
        with pytest.raises(ValueError, match="cross-attention decode"):
            m.decode_step(params, m.init_cache(batch, 8, device="cpu"),
                          torch.arange(batch), 0)


FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_the_compressed_plane_serves_the_padded_weights(kind):
    rcfg, cfg, rparams, params = _weights("chatglm3-6b")
    plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    toks = _tokens(cfg.vocab, 8)
    with roptflags.optimizations(FLAGS):
        rpruned = rexec.prune_params(rparams, plan, rcfg)
        rcm = rexec.CompressedModel(RModel(rcfg), rexec.compress_params(
            rpruned, plan, rcfg))
        want, _ = rcm.prefill(rpruned, jnp.asarray(toks, jnp.int32), 12)
        want_toks, _, _ = rcm.generate(rpruned, jnp.asarray(toks, jnp.int32),
                                       STEPS)
    with optflags.optimizations(FLAGS):
        cm, pruned = serve.compressed_model(
            cfg, params, texec.ExecPlan.from_json(plan.to_json()),
            device="cpu")
        e = cm.store.entries[(0, "attn.wq", -1)]
        assert (e.data.n, e.data.k) == (cfg.d_model, 16 * cfg.head_dim)
        got, _ = cm.prefill(pruned, torch.from_numpy(toks), 12)
        got_toks, _, _ = serve.generate(cm, pruned, torch.from_numpy(toks),
                                        STEPS, 12, device="cpu")
    assert cm.store.plan.checksums == rcm.store.plan.checksums
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert np.array_equal(got_toks.numpy(), np.asarray(want_toks))
