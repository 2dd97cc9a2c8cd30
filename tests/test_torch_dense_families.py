"""The four families the reference serves only dense, against the
reference at fp32: gemma3-27b (5 local : 1 global attention, ring caches),
recurrentgemma-2b (RG-LRU : local attention), mamba2-780m (SSD) and
whisper-tiny (encoder-decoder), each ``reduced()`` (window 64).

Both packages get the reference's ``Model.init`` weights through numpy;
every module's compute dtype is patched to fp32 (the reference's
``layers``, ``attention``, ``rglru`` and ``ssm`` import it by name).

* ``init_cache``: the reference's tree, shapes and dtypes, with rings
  shorter and longer than the context;
* ``hidden_states`` over 80 tokens (past the window; whisper with encoder
  frames): within 1e-5 · max|want|;
* ``decode_step`` over 72 positions from an empty cache, wrapping the
  rings: every step's logits and the final caches within 1e-5 ·
  max|want|; on the port alone, the decode logits against
  ``hidden_states``' teacher-forced ones (the card's check) to 1e-4;
* ``serve.generate`` greedy tokens, lockstep (token ingest past the wrap)
  and ragged (left-padded rows), equal to the reference's;
* the serve CLI serves each arch, and ``--compressed`` raises the
  reference compressed plane's ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model

ARCHS = ["gemma3-27b", "recurrentgemma-2b", "mamba2-780m", "whisper-tiny"]
B, S, T, MAX_LEN = 2, 80, 72, 80

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
        for mod in (RL, rattn, rrg, rssm):
            mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


class Jitted:
    """The reference model with a jitted ``decode_step``: its ragged
    admission ingests through ``model.decode_step`` itself, op by op
    otherwise (minutes at these sizes).  The same numbers, sooner."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.decode_step = jax.jit(model.decode_step)

    def prefill(self, *args, **kwargs):
        return self.model.prefill(*args, **kwargs)

    def init_cache(self, *args, **kwargs):
        return self.model.init_cache(*args, **kwargs)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request, fp32):
    arch = request.param
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32) if cfg.family == "encdec" else None
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rparams=rparams,
                params=params, enc=enc,
                toks=rng.integers(0, cfg.vocab, (B, S)))


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


@pytest.mark.parametrize("max_len", [32, MAX_LEN])
def test_init_cache_has_the_references_layout(fam, max_len):
    want = RModel(fam["rcfg"]).init_cache(B, max_len)
    got = Model(fam["cfg"]).init_cache(B, max_len, device="cpu")
    assert jax.tree.structure(_layout(got)) == \
        jax.tree.structure(_layout(want))
    assert jax.tree.leaves(_layout(got)) == jax.tree.leaves(_layout(want))
    assert all(not bool(t.any()) for t in jax.tree.leaves(got))


def test_hidden_states_match_the_reference(fam):
    enc = fam["enc"]
    want = RModel(fam["rcfg"]).hidden_states(
        fam["rparams"], jnp.asarray(fam["toks"]),
        None if enc is None else jnp.asarray(enc), remat=False)
    got = Model(fam["cfg"]).hidden_states(
        fam["params"], torch.from_numpy(fam["toks"]),
        None if enc is None else torch.from_numpy(enc))
    _close(got, want)


def test_decode_over_the_wrap_matches_the_reference(fam):
    """72 positions from an empty cache (the rings of 64 wrap at 64): each
    step's logits and every leaf of the final cache."""
    rmodel, model = RModel(fam["rcfg"]), Model(fam["cfg"])
    rcache = rmodel.init_cache(B, MAX_LEN)
    cache = model.init_cache(B, MAX_LEN, device="cpu")
    step = jax.jit(rmodel.decode_step)
    toks = fam["toks"]
    for t in range(T):
        want, rcache = step(fam["rparams"], rcache, jnp.asarray(toks[:, t]),
                            jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(fam["params"], cache,
                                       torch.from_numpy(toks[:, t]),
                                       torch.tensor(t))
        _close(got, want)
    assert len(jax.tree.leaves(cache)) == len(jax.tree.leaves(rcache))
    for got, want in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        if got.ndim:
            _close(got, want)
        else:
            assert int(got) == int(want)


def test_decode_equals_teacher_forcing(fam):
    """What the card checks at full width: each decode step's logits
    against the full-sequence forward's at the same position, past the
    wrap.  Whisper's decode does not compute its forward, in the
    reference either: it cross-attends to the zero ``cross`` cache that
    nothing fills, so its cross weights do not reach the logits (pinned in
    both packages)."""
    if fam["cfg"].family == "encdec":
        _cross_weights_do_not_reach_the_decode(fam)
        return
    model = Model(fam["cfg"])
    toks = torch.from_numpy(fam["toks"])
    want = model.logits(fam["params"], toks)
    cache = model.init_cache(B, MAX_LEN, device="cpu")
    for t in range(T):
        got, cache = model.decode_step(fam["params"], cache, toks[:, t],
                                       torch.tensor(t))
        _close(got, want[:, t], tol=1e-4)


@pytest.mark.parametrize("ragged", [False, True], ids=["lockstep", "ragged"])
def test_generate_tokens_equal_the_references(fam, ragged):
    """Token ingest (the families have no one-pass prefill) through the
    compiled step, past the wrap; ragged rows admitted alone."""
    prompts = np.maximum(fam["toks"][:, :60], 1)
    kw = {}
    if ragged:
        prompts[1, :5] = 0
        kw = dict(prompt_pad_id=0)
    want = rserve.generate(Jitted(RModel(fam["rcfg"])), fam["rparams"],
                           jnp.asarray(prompts, jnp.int32), 8, 68, **kw)[0]
    got, _, _ = serve.generate(Model(fam["cfg"]), fam["params"],
                               torch.from_numpy(prompts), 8, 68,
                               device="cpu", **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_the_cli_serves_dense_and_refuses_compressed(fam, capsys):
    arch = fam["arch"]
    args = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "3", "--device", "cpu"]
    serve.main(args)
    out = capsys.readouterr().out
    assert f"[serve] {arch}" in out and "sample out" in out
    with pytest.raises(NotImplementedError,
                       match="exec plane serves uniform attention stacks; "
                             f"{arch} is family"):
        serve.main(args + ["--compressed"])


def _cross_weights_do_not_reach_the_decode(fam):
    rng = np.random.default_rng(9)
    tok = fam["toks"][:, 0]
    rmodel, model = RModel(fam["rcfg"]), Model(fam["cfg"])
    outs = []
    for scale in (1.0, 3.0):
        rp = jax.tree.map(np.asarray, fam["rparams"])
        rp["blocks"]["cross"] = jax.tree.map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(a.dtype),
            rp["blocks"]["cross"])
        want, _ = rmodel.decode_step(rp, rmodel.init_cache(B, 8),
                                     jnp.asarray(tok), jnp.asarray(3))
        got, _ = model.decode_step(params_from_numpy(rp, "cpu"),
                                   model.init_cache(B, 8, device="cpu"),
                                   torch.from_numpy(tok), torch.tensor(3))
        _close(got, want)
        outs.append(got)
    assert torch.equal(outs[0], outs[1])
