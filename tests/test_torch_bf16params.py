"""Optflag ``bf16params`` in the port against the reference, on the
``reduced()`` configs.

The reference's dry run alone reads the flag: its decode cell casts every
floating param leaf to bf16.  At the model entry points and in the
compressed plane the flag is inert, in both packages.

* With the flag, ``init``, ``prefill``, ``decode_step``, ``loss`` and the
  compressed plane (store, checksums, logits) give the same tensors.
* ``convert.bf16_params`` is the dry run's cast: the same bf16 values,
  int32 leaves (``sparseffn``'s ``rows_*`` / ``_meta``) kept.
* ``decode_step`` over params cast so equals the reference's over the same
  cast, on every family (and dense under ``sparseffn``): one step from a
  cache the reference's jitted steps filled, within the reference's
  jit-vs-eager spread plus one bf16 ulp of max|logits|
  (``test_torch_bf16.py``'s bound), with the same greedy tokens.
* The reference's block-stored FFN and padded-head trees cross into the
  port through ``convert`` and through a checkpoint written by either
  package, leaf for leaf and dtype for dtype.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.configs import get_config as rget_config
from repro.models import layers as RL
from repro.models import optflags as roptflags
from repro.models.transformer import Model as RModel
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import bf16_params, params_from_numpy, \
    params_to_numpy
from repro_torch.exec.plans import shipped_plan
from repro_torch.launch import serve
from repro_torch.models import optflags
from repro_torch.models.transformer import Model


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    rcfg = rget_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, get_config("chatglm3-6b").reduced(), rparams, params


def _tokens(vocab):
    return np.random.default_rng(3).integers(0, vocab, (2, 12))


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _equal_trees(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_bf16params_is_inert_at_the_entry_points(reduced):
    """init, prefill, decode, loss and the compressed plane (its store
    and checksums, its logits) give the same tensors with the flag."""
    rcfg, cfg, rparams, params = reduced
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    plan = shipped_plan(cfg, "bitmap")

    def run():
        init = model.init(seed=3, device="cpu")
        pre, cache = model.prefill(params, toks[:, :6], 16)
        dec, _ = model.decode_step(params, cache, toks[:, 6], 6)
        loss = model.loss(params, {"tokens": toks, "labels": toks})
        cm, pruned = serve.compressed_model(cfg, params, plan, device="cpu")
        cpre, _ = cm.prefill(pruned, toks[:, :6], 16)
        return (init, pre, dec, loss, cpre,
                {k: e.data if isinstance(e.data, torch.Tensor) else
                 e.data.blocks for k, e in cm.store.entries.items()},
                cm.store.plan.checksums)

    off = run()
    with optflags.optimizations(("bf16params",)):
        on = run()
    for a, b in zip(off[:-1], on[:-1]):
        assert _equal_trees(a, b)
    assert off[-1] == on[-1]
    with roptflags.optimizations(("bf16params",)):
        assert jax.tree.all(jax.tree.map(
            np.array_equal, RModel(rcfg).init(jax.random.key(0)), rparams))


def _dry_run_cast(tree):
    """The reference dry run's cast under ``bf16params``
    (``launch/dryrun.py``)."""
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _as_port(tree):
    """A reference tree as CPU tensors (bf16 kept bf16)."""
    def one(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))) \
                .to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(one, tree)


CAST_CASES = [("chatglm3-6b", ()), ("chatglm3-6b", ("sparseffn",)),
              ("granite-moe-3b-a800m", ()), ("pixtral-12b", ()),
              ("gemma3-27b", ()), ("recurrentgemma-2b", ()),
              ("mamba2-780m", ()), ("whisper-tiny", ())]
FILL = 3


@pytest.mark.parametrize("arch,flags", CAST_CASES,
                         ids=["+".join((a,) + f) for a, f in CAST_CASES])
def test_decode_over_the_dry_runs_cast_matches_the_reference(arch, flags):
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    flags = flags + ("bf16params",)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, FILL + 1))
    rmodel = RModel(rcfg)
    with roptflags.optimizations(flags):
        rparams = rmodel.init(jax.random.key(0))
        cast = _dry_run_cast(rparams)
        step = jax.jit(rmodel.decode_step)
        cache = rmodel.init_cache(2, 16)
        for t in range(FILL):
            _, cache = step(cast, cache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.asarray(t, jnp.int32))
        args = (jnp.asarray(toks[:, FILL], jnp.int32),
                jnp.asarray(FILL, jnp.int32))
        want, want_cache = step(cast, cache, *args)
        with jax.disable_jit():
            eager, _ = rmodel.decode_step(cast, cache, *args)
    params = bf16_params(params_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu"))
    assert _equal_trees(params, _as_port(cast))
    with optflags.optimizations(flags):
        got, got_cache = Model(cfg).decode_step(
            params, _as_port(cache), torch.from_numpy(toks[:, FILL]), FILL)
    want, eager = np.asarray(want), np.asarray(eager)
    tol = np.abs(want - eager).max() + _bf16_ulp(np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= tol
    assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# Block-stored FFN and padded-head trees across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ["sparseffn", "padheads"])
def test_the_references_trees_cross_through_convert_and_checkpoints(
        flag, tmp_path):
    rcfg = rget_config("chatglm3-6b").reduced()
    with roptflags.optimizations((flag,)):
        rparams = RModel(rcfg).init(jax.random.key(2))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    if flag == "sparseffn":
        assert params["blocks"]["ffn"]["rows_gate"].dtype == torch.int32
        assert params["blocks"]["ffn"]["_meta"].dtype == torch.int32
    else:
        assert params["blocks"]["attn"]["wo"].shape[1] == 16 * 32
    back = params_to_numpy(params)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
        back, jax.tree.map(np.asarray, rparams)))
    # the port writes, the reference restores; and back
    ckpt.save(str(tmp_path / "port"), 1, params)
    restored, _ = rckpt.restore(str(tmp_path / "port"), rparams)
    assert jax.tree.all(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
        restored, jax.tree.map(np.asarray, rparams)))
    rckpt.save(str(tmp_path / "ref"), 1, rparams)
    like = Model(get_config("chatglm3-6b").reduced())
    with optflags.optimizations((flag,)):
        like = like.init(seed=5, device="cpu")
    got, _ = ckpt.restore(str(tmp_path / "ref"), like)
    assert _equal_trees(got, params)
