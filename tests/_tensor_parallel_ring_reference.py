"""The reference's serving runs of ring caches under a mesh's ``model``
axis, written to an npz for ``test_torch_tensor_parallel_ring.py``:
reduced gemma3-27b (5 local : 1 global, rings of 64) past its wrap, and a
uniform reduced chatglm3-6b stack with a window of 8.

Run in a process of its own with four forced host devices (the reference
reads the device count when JAX starts)::

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/_tensor_parallel_ring_reference.py OUT.npz

gemma3 at fp32: ``serve.generate`` on (data 1, model 2), (2, 2) and
(1, 4) meshes with equal prompts (40 tokens, then 40 generated: the rings
wrap at 64), whose lockstep path (tokens, and every ingest and decode
step's logits from the same jitted step) runs once more on (1, 2); the
same on (1, 2) with left-padded ragged prompts and EOS (each row ingested
through a jitted step: :class:`_JitStep`); ``guarded_generate`` on (1, 2)
healthy, with a NaN at decode position 70 once (retried) and twice
(switched to another dense model).  gemma3 at bf16: the lockstep run's
tokens and logits on (1, 2), and the full-sequence forward's logits over
its inputs jitted and op by op, whose gap is the reference's own
jit-vs-eager spread.  The windowed stack at fp32: ``serve.generate``
dense, bitmap and 2:4 on (1, 2); the plans' JSON travels with the
results.

A run the reference cannot do on its mesh is run again without the mesh,
and its error is recorded under ``meta["sharded_errors"]`` by the run's
name.
"""

import contextlib
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _data_parallel_reference import FAST, SPARSITY, _sharded
from _tensor_parallel_reference import MESHES, _attempt
from repro import exec as rexec
from repro.configs import get_config
from repro.launch import mesh as rmesh
from repro.launch import serve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.sharding import logical_axis_rules, named_sharding
from repro.models.transformer import Model
from repro.runtime import guard

ARCH = "gemma3-27b"
#: gemma3's batch, prompt and generated tokens: 80 positions, past the
#: rings' wrap at 64
BATCH, PLEN, GEN = 4, 40, 40
#: the decode position of the guarded runs' NaN, past the wrap
NAN_AT = 70
#: the windowed stack: its window, batch, prompt and generated tokens
WINDOW, W_BATCH, W_PLEN, W_GEN = 8, 2, 12, 6


def prompts(vocab: int) -> np.ndarray:
    """gemma3's equal prompts of real tokens (0 pads the ragged ones)."""
    return np.random.default_rng(0).integers(1, vocab, (BATCH, PLEN))


def ragged(vocab: int) -> np.ndarray:
    """Left-padded (pad 0) prompts: the odd rows lose their first token."""
    out = prompts(vocab).copy()
    out[1::2, 0] = 0
    return out


def windowed_prompts(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(1, vocab, (W_BATCH, W_PLEN))


def windowed_cfg(cfg):
    return dataclasses.replace(cfg, window=WINDOW)


class _JitStep:
    """``model`` with its decode step jitted: the reference's ragged
    admission ingests each row through an unjitted ``decode_step``."""

    def __init__(self, model):
        self.model = model
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self.model, name)


class _NanAt:
    """The model with a jitted step whose logits turn NaN the first
    ``times`` calls at position ``at`` (the reference's guard discards a
    failed step's new cache)."""

    def __init__(self, model, at: int, times: int):
        self.cfg, self.model, self.at, self.left = model.cfg, model, at, times
        self._step = jax.jit(model.decode_step)

    def prefill(self, *args, **kwargs):
        return self.model.prefill(*args, **kwargs)

    def init_cache(self, *args, **kwargs):
        return self.model.init_cache(*args, **kwargs)

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = self._step(params, cache, tokens, pos)
        if int(pos) == self.at and self.left:
            self.left -= 1
            logits = jnp.full_like(logits, jnp.nan)
        return logits, cache


class _JitIdentity:
    """``jax`` for the reference's guard, with ``jit`` the identity: the
    fault above is Python that acts per call (the step inside stays
    jitted)."""

    def __getattr__(self, name):
        return (lambda fn, **kw: fn) if name == "jit" else getattr(jax, name)


def _ingest_run(model, params, toks, mesh):
    """The lockstep path of the reference's ``_generate`` for a model
    without a one-pass prefill (under the mesh, where one is given): the
    prompt ingested through the jitted step, then greedy decode; (tokens
    (B, GEN), every step's logits (PLEN + GEN - 1, B, V))."""
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(mesh)
            stack.enter_context(logical_axis_rules(rmesh.axis_map_for(mesh)))
            toks = jax.device_put(toks, named_sharding(mesh, "batch", None))
        step = jax.jit(model.decode_step)
        cache = model.init_cache(toks.shape[0], PLEN + GEN)
        logits = []
        for t in range(PLEN):
            lg, cache = step(params, cache, toks[:, t],
                             jnp.asarray(t, jnp.int32))
            logits.append(lg)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        out = [tok]
        for t in range(PLEN, PLEN + GEN - 1):
            lg, cache = step(params, cache, tok, jnp.asarray(t, jnp.int32))
            logits.append(lg)
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            out.append(tok)
    return np.stack([np.asarray(x) for x in out], 1), \
        np.stack([np.asarray(x) for x in logits])


def _forward(model, params, seq):
    """The full-sequence forward's logits (B, S, V) over ``seq``."""
    x = model.hidden_states(params, seq, remat=False)
    return jnp.einsum("btd,vd->btv", x, params["embed"])


def _fp32() -> None:
    for mod in (RL, rattn):
        mod.COMPUTE_DTYPE = jnp.float32


def _gemma3(out: dict, meta: dict, meshes: dict) -> None:
    tp = meshes["1x2"]
    cfg = get_config(ARCH).reduced()
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    eq = jnp.asarray(prompts(cfg.vocab), jnp.int32)
    rg = jnp.asarray(ragged(cfg.vocab), jnp.int32)

    # bf16 first: the lockstep run
    toks, logits = _sharded(meta, "bf16/gemma3", lambda mh: (
        _ingest_run(model, params, eq, mh)), tp)
    out["bf16/gemma3/tokens"] = toks
    out["bf16/gemma3/logits"] = logits
    # the forward over the run's inputs, jitted and op by op
    seq = jnp.asarray(np.concatenate([np.asarray(eq), toks[:, :-1]], 1),
                      jnp.int32)
    out["bf16/gemma3/fwd_jit"] = np.asarray(jax.jit(
        lambda p, x: _forward(model, p, x))(params, seq))
    with jax.disable_jit():
        out["bf16/gemma3/fwd_eager"] = np.asarray(
            _forward(model, params, seq))

    _fp32()
    for label, mh in meshes.items():
        _attempt(meta, f"gemma3/generate/{label}", lambda: (
            serve.generate(model, params, eq, GEN, PLEN + GEN, mesh=mh)))
    toks, logits = _sharded(meta, "gemma3/logits", lambda mh: (
        _ingest_run(model, params, eq, mh)), tp)
    out["gemma3/tokens"] = toks
    out["gemma3/logits"] = logits
    # EOS: row 0's second token (row 0 is not padded)
    eos = int(toks[0, 1])
    toks, _, _ = _sharded(meta, "gemma3/ragged_eos", lambda mh: (
        serve.generate(_JitStep(model), params, rg, GEN, PLEN + GEN,
                       mesh=mh, prompt_pad_id=0, eos_id=eos, pad_id=-3)), tp)
    out["gemma3/ragged_eos"] = np.asarray(toks)
    out["gemma3/eos_id"] = np.asarray(eos)

    guard.jax = _JitIdentity()
    for name, times in (("healthy", 0), ("transient", 1),
                        ("dense_switch", 2)):
        toks, rep = _sharded(meta, f"guarded/{name}", lambda mh: (
            guard.guarded_generate(
                _NanAt(model, NAN_AT if times else -1, times), params, eq,
                GEN, mesh=mh, dense_model=_NanAt(Model(cfg), -1, 0))), tp)
        out[f"guarded/{name}"] = np.asarray(toks)
        meta["reports"][name] = rep.stable_dict()


def _windowed(out: dict, meta: dict, meshes: dict) -> None:
    cfg = windowed_cfg(get_config("chatglm3-6b").reduced())
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(windowed_prompts(cfg.vocab), jnp.int32)
    served = {"dense": (model, params)}
    for kind, sp in SPARSITY.items():
        plan = rexec.build_exec_plan(cfg, sp, tokens=64, search_cfg=FAST,
                                     value_bits=32)
        pruned = rexec.prune_params(params, plan, cfg)
        served[kind] = (rexec.CompressedModel(
            model, rexec.compress_params(pruned, plan, cfg)), pruned)
        meta["plans"][kind] = plan.to_json()
    for kind, (m, p) in served.items():
        got, _, _ = _sharded(meta, f"windowed/{kind}", lambda mh: (
            serve.generate(m, p, toks, W_GEN, W_PLEN + W_GEN, mesh=mh)),
            meshes["1x2"])
        out[f"windowed/{kind}"] = np.asarray(got)


def main(path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    meshes = {f"{d}x{t}": rmesh.make_small_mesh(d, t) for d, t in MESHES}
    out, meta = {}, {"plans": {}, "reports": {}, "sharded_errors": {}}
    _gemma3(out, meta, meshes)
    _windowed(out, meta, meshes)
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
