"""The reference's sharded serving and training runs on reduced
chatglm3-6b at fp32, written to an npz for ``test_torch_data_parallel.py``.

Run in a process of its own with four forced host devices (the reference
reads the device count when JAX starts)::

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/_data_parallel_reference.py OUT.npz

Serving: dense, bitmap and 2:4 ``serve.generate`` on ``make_serve_mesh``
(batch 8 over four devices: data 4), equal prompts (tokens, and the
prefill's and every decode step's logits from the same jitted calls under
the mesh), and left-padded ragged prompts with EOS;
``guarded_generate`` on the mesh healthy, with one payload bit flipped and
with a NaN payload (verify off).  Training: three steps of the CLI's train
step on ``make_small_mesh(2, 1)`` with and without ``grad_compress``, every
loss and the final params.  The plans' JSON travels with the results, so
the port serves the same plans.

A run the reference cannot do on the mesh (JAX 0.9 refuses the
embedding's gather of a batch sharded over ``data``: a
``ShardingTypeError``) is run again without the mesh, and its error is
recorded under ``meta["sharded_errors"]`` by the run's name.
"""

import contextlib
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import exec as rexec
from repro.configs import get_config
from repro.core.cosearch import CoSearchConfig
from repro.core.engine import EngineConfig
from repro.core.sparsity import NM, BlockBernoulli
from repro.data.pipeline import TokenPipeline
from repro.launch import mesh as rmesh
from repro.launch import serve
from repro.launch import train as rtrain
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.sharding import logical_axis_rules, named_sharding
from repro.models.transformer import Model
from repro.optim import adamw
from repro.runtime import guard, inject

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
BATCH, PLEN, GEN = 8, 8, 4
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, LR = 3, 4, 32, 1e-3


def prompts(vocab: int) -> np.ndarray:
    """Equal prompts of real tokens (1..vocab-1: 0 pads the ragged ones)."""
    return np.random.default_rng(0).integers(1, vocab, (BATCH, PLEN))


def ragged(vocab: int) -> np.ndarray:
    """Left-padded (pad 0) prompts: the odd rows lose their first token."""
    out = prompts(vocab).copy()
    out[1::2, 0] = 0
    return out


def _logits_run(model, params, toks, mesh):
    """The lockstep path of the reference's ``_generate`` (under the mesh,
    where one is given), keeping the prefill's last logits and every
    decode step's."""
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(mesh)
            stack.enter_context(logical_axis_rules(rmesh.axis_map_for(mesh)))
            toks = jax.device_put(toks, named_sharding(mesh, "batch", None))
        all_lg, cache = jax.jit(functools.partial(
            model.prefill, max_len=PLEN + GEN))(params, toks)
        logits = [all_lg[:, -1]]
        step = jax.jit(model.decode_step)
        tok = jnp.argmax(logits[-1], axis=-1).astype(jnp.int32)
        out = [tok]
        for t in range(PLEN, PLEN + GEN - 1):
            lg, cache = step(params, cache, tok, jnp.asarray(t, jnp.int32))
            logits.append(lg)
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            out.append(tok)
    return np.stack([np.asarray(x) for x in out], 1), \
        np.stack([np.asarray(x) for x in logits])


def _sharded(meta, name, run, mesh):
    """``run(mesh)``, or ``run(None)`` where the reference refuses the
    mesh, its error recorded by ``name``."""
    try:
        return run(mesh)
    except Exception as e:                              # noqa: BLE001
        meta["sharded_errors"][name] = \
            f"{type(e).__name__}: {str(e).splitlines()[0]}"
        return run(None)


def main(path: str) -> None:
    RL.COMPUTE_DTYPE = jnp.float32
    rattn.COMPUTE_DTYPE = jnp.float32
    assert len(jax.devices()) == 4, jax.devices()
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    mesh = rmesh.make_serve_mesh(BATCH)
    assert dict(rmesh.mesh_axis_sizes(mesh)) == {"data": 4, "model": 1}
    out, meta = {}, {"plans": {}, "reports": {}, "sharded_errors": {}}
    eq = jnp.asarray(prompts(cfg.vocab), jnp.int32)
    rg = jnp.asarray(ragged(cfg.vocab), jnp.int32)

    served = {"dense": (model, params)}
    for kind, sp in SPARSITY.items():
        plan = rexec.build_exec_plan(cfg, sp, tokens=64, search_cfg=FAST,
                                     value_bits=32)
        pruned = rexec.prune_params(params, plan, cfg)
        store = rexec.compress_params(pruned, plan, cfg)
        served[kind] = (rexec.CompressedModel(model, store), pruned)
        meta["plans"][kind] = plan.to_json()
    for name, (m, p) in served.items():
        toks, _, _ = _sharded(meta, f"{name}/generate", lambda mh: (
            serve.generate(m, p, eq, GEN, PLEN + GEN, mesh=mh)), mesh)
        mine, logits = _sharded(meta, f"{name}/logits", lambda mh: (
            _logits_run(m, p, eq, mh)), mesh)
        assert (np.asarray(toks) == mine).all(), name
        out[f"{name}/tokens"] = np.asarray(toks)
        out[f"{name}/logits"] = logits
        # EOS: row 0's second token (row 0 is not padded)
        eos = int(np.asarray(toks)[0, 1])
        toks, _, _ = _sharded(meta, f"{name}/ragged_eos", lambda mh: (
            serve.generate(m, p, rg, GEN, PLEN + GEN, mesh=mh,
                           prompt_pad_id=0, eos_id=eos, pad_id=-3)), mesh)
        out[f"{name}/ragged_eos"] = np.asarray(toks)
        out[f"{name}/eos_id"] = np.asarray(eos)

    cm, pruned = served["bitmap"]
    role = next(op.role for op in cm.store.plan.ops
                if op.choice.kind == "bitmap")
    meta["role"] = role
    scenarios = {
        "healthy": (cm, {}),
        "bitflip": (rexec.CompressedModel(
            model, inject.bitflip_payload(cm.store, role)), {}),
        "nan_payload": (rexec.CompressedModel(
            model, inject.poison_payload_nan(cm.store, role)),
            {"verify": False}),
    }
    for name, (m, kw) in scenarios.items():
        toks, rep = _sharded(meta, f"guarded/{name}", lambda mh: (
            guard.guarded_generate(m, pruned, eq, GEN, mesh=mh, **kw)), mesh)
        out[f"guarded/{name}"] = np.asarray(toks)
        meta["reports"][name] = rep.stable_dict()

    tmesh = rmesh.make_small_mesh(2, 1)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    for compress in (False, True):
        opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=TRAIN_STEPS,
                                    warmup_steps=min(20, TRAIN_STEPS // 5),
                                    grad_compress=compress)
        step = jax.jit(rtrain.build_train_step(model, opt_cfg))

        def run(mh):
            p, st, losses = params, adamw.init(params, opt_cfg), []
            ctx = (mh, logical_axis_rules(rmesh.axis_map_for(mh))) \
                if mh is not None else ()
            with contextlib.ExitStack() as stack:
                for c in ctx:
                    stack.enter_context(c)
                for i in range(TRAIN_STEPS):
                    loss, p, st = step(p, st, pipe.batch_at(i))
                    losses.append(float(loss))
            return p, losses

        p, losses = _sharded(meta, f"train/{int(compress)}", run, tmesh)
        key = f"train/{int(compress)}"
        out[f"{key}/losses"] = np.asarray(losses)
        for i, leaf in enumerate(jax.tree.leaves(p)):
            out[f"{key}/leaf_{i}"] = np.asarray(leaf)
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
