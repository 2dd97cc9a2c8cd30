"""The four dense-only families at their default bf16 compute dtype against
the reference: gemma3-27b, recurrentgemma-2b, mamba2-780m and whisper-tiny,
``reduced()``, with the reference's ``Model.init`` weights.

The tolerance is ``tests/test_torch_bf16.py``'s: the reference's own
jit-vs-eager spread on the same inputs plus one bf16 ulp of max|logits|.
XLA keeps fp32 inside its fusions, so the reference as it serves (jitted)
already sits that far from its op-by-op self, whose rounding points the
port follows (the tanh GELU, the three-op sigmoid, the bf16 conv adds, the
SSD einsums contracted pairwise).

* ``hidden_states`` logits over 16 tokens;
* a decode step at position 66 from a cache the reference filled over
  the 66 positions before it, so the rings of 64 have wrapped: the three
  runs (the port, the reference jitted and op by op) start from the same
  cache, and the port's logits and every cache leaf are held to the
  spread.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model

ARCHS = ["gemma3-27b", "recurrentgemma-2b", "mamba2-780m", "whisper-tiny"]
B, FILLED, MAX_LEN = 2, 66, 80


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _held(got, jit, eager) -> None:
    got, want = _np(got), _np(jit)
    spread = float(np.abs(want - _np(eager)).max())
    scale = float(np.abs(want).max())
    tol = spread + (_bf16_ulp(scale) if scale else 0.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def _to_port(tree):
    """A reference cache as the port's tensors (bf16 leaves kept bf16)."""
    def one(a):
        a = jnp.asarray(a)
        t = torch.from_numpy(np.array(a.astype(jnp.float32)
                                      if a.dtype == jnp.bfloat16 else a))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t
    return jax.tree.map(one, tree)

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    assert L.COMPUTE_DTYPE == torch.bfloat16
    arch = request.param
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, FILLED + 1))
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, params=params,
                toks=toks)


def test_bf16_forward_within_the_spread(fam):
    rcfg, cfg = fam["rcfg"], fam["cfg"]
    toks = fam["toks"][:, :16]
    enc = np.random.default_rng(1).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32) \
        if cfg.family == "encdec" else None
    rmodel = RModel(rcfg)
    table = fam["rparams"]["embed"].astype(jnp.bfloat16)

    def ref(p, t, e):
        x = rmodel.hidden_states(p, t, e, remat=False)
        return jnp.einsum("btd,vd->btv", x, table).astype(jnp.float32)

    args = (fam["rparams"], jnp.asarray(toks),
            None if enc is None else jnp.asarray(enc))
    jit = jax.jit(ref)(*args)
    with jax.disable_jit():
        eager = ref(*args)
    got = Model(cfg).logits(fam["params"], torch.from_numpy(toks),
                            None if enc is None else torch.from_numpy(enc))
    _held(got, jit, eager)


def test_bf16_decode_past_the_wrap_within_the_spread(fam):
    rmodel, model = RModel(fam["rcfg"]), Model(fam["cfg"])
    step = jax.jit(rmodel.decode_step)
    toks = fam["toks"]
    rcache = rmodel.init_cache(B, MAX_LEN)
    for t in range(FILLED):
        _, rcache = step(fam["rparams"], rcache, jnp.asarray(toks[:, t]),
                         jnp.asarray(t, jnp.int32))
    tok, pos = jnp.asarray(toks[:, FILLED]), jnp.asarray(FILLED, jnp.int32)
    cache = _to_port(rcache)
    with jax.disable_jit():
        eager, ecache = rmodel.decode_step(fam["rparams"], rcache, tok, pos)
    jit, rcache = step(fam["rparams"], rcache, tok, pos)
    got, cache = model.decode_step(fam["params"], cache,
                                   torch.from_numpy(toks[:, FILLED]),
                                   torch.tensor(FILLED))
    _held(got, jit, eager)
    for g, j, e in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache),
                       jax.tree.leaves(ecache)):
        _held(g, j, e)
