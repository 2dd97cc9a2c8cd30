"""The reference's tensor-parallel serving runs on reduced
granite-moe-3b-a800m (8 experts, top-2), written to an npz for
``test_torch_tensor_parallel_moe.py``.

Run in a process of its own with four forced host devices (the reference
reads the device count when JAX starts)::

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/_tensor_parallel_moe_reference.py OUT.npz

At fp32: ``serve.generate`` dense, bitmap and 2:4 on (data 1, model 2),
(2, 2) and (1, 4) meshes with equal prompts, whose lockstep path (tokens,
and the prefill's and every decode step's logits from the same jitted
calls) runs once more on (1, 2); ``guarded_generate`` on (1, 2) healthy,
with one bit flipped in the last layer's last expert's ``moe.w_up`` entry
and with one bit flipped in an attention role's payload; the dense
lockstep run of the same config with a vocab of 515, which no model axis
divides (``param_specs`` replicates the embedding).  At bf16: the tokens
and the logits of the lockstep run on (1, 2), and the dense model's
prefill logits jitted and eager, whose gap is the reference's own
jit-vs-eager spread.  The prompts and the plans' search are those of
``tests/_data_parallel_reference.py``.

A run the reference cannot do on its mesh is run again without the mesh,
and its error is recorded under ``meta["sharded_errors"]`` by the run's
name.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _data_parallel_reference import (FAST, GEN, PLEN, SPARSITY, _logits_run,
                                      _sharded, prompts)
from _tensor_parallel_reference import MESHES, _attempt
from repro import exec as rexec
from repro.configs import get_config
from repro.launch import mesh as rmesh
from repro.launch import serve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import moe as rmoe
from repro.models.transformer import Model
from repro.runtime import guard, inject

ARCH = "granite-moe-3b-a800m"
#: the vocab of the config whose embedding no model axis of 2 divides
ODD_VOCAB = 515


def _served(cfg, model, params, meta) -> dict:
    served = {"dense": (model, params)}
    for kind, sp in SPARSITY.items():
        plan = rexec.build_exec_plan(cfg, sp, tokens=64, search_cfg=FAST,
                                     value_bits=32)
        pruned = rexec.prune_params(params, plan, cfg)
        store = rexec.compress_params(pruned, plan, cfg)
        served[kind] = (rexec.CompressedModel(model, store), pruned)
        meta["plans"][kind] = plan.to_json()
    return served


def _fp32() -> None:
    for mod in (RL, rattn, rmoe):
        mod.COMPUTE_DTYPE = jnp.float32


def main(path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    meshes = {f"{d}x{t}": rmesh.make_small_mesh(d, t) for d, t in MESHES}
    tp = meshes["1x2"]
    cfg = get_config(ARCH).reduced()
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    out, meta = {}, {"plans": {}, "reports": {}, "sharded_errors": {}}
    eq = jnp.asarray(prompts(cfg.vocab), jnp.int32)

    # bf16 first, then fp32: the stores hold fp32 weights either way
    served = _served(cfg, model, params, meta)
    for name, (m, p) in served.items():
        toks, logits = _sharded(meta, f"bf16/{name}", lambda mh: (
            _logits_run(m, p, eq, mh)), tp)
        out[f"bf16/{name}/tokens"] = toks
        out[f"bf16/{name}/logits"] = logits
    out["bf16/dense_jit"] = np.asarray(
        jax.jit(lambda p, x: model.prefill(p, x, PLEN + GEN)[0])(params, eq))
    with jax.disable_jit():
        out["bf16/dense_eager"] = np.asarray(
            model.prefill(params, eq, PLEN + GEN)[0])

    _fp32()
    for name, (m, p) in served.items():
        for label, mh in meshes.items():
            _attempt(meta, f"{name}/generate/{label}", lambda: (
                serve.generate(m, p, eq, GEN, PLEN + GEN, mesh=mh)))
        toks, logits = _sharded(meta, f"{name}/logits", lambda mh: (
            _logits_run(m, p, eq, mh)), tp)
        out[f"{name}/tokens"] = toks
        out[f"{name}/logits"] = logits

    cm, pruned = served["bitmap"]
    attn_role = next(op.role for op in cm.store.plan.ops
                     if op.choice.kind == "bitmap"
                     and op.role.startswith("attn."))
    expert = dict(role="moe.w_up", layer=cfg.n_layers - 1,
                  expert=cfg.moe.n_experts - 1)
    meta["attn_role"], meta["expert"] = attn_role, expert
    scenarios = {
        "healthy": cm,
        "expert_bitflip": rexec.CompressedModel(
            model, inject.bitflip_payload(cm.store, **expert)),
        "attn_bitflip": rexec.CompressedModel(
            model, inject.bitflip_payload(cm.store, attn_role)),
    }
    for name, m in scenarios.items():
        toks, rep = _sharded(meta, f"guarded/{name}", lambda mh: (
            guard.guarded_generate(m, pruned, eq, GEN, mesh=mh)), tp)
        out[f"guarded/{name}"] = np.asarray(toks)
        meta["reports"][name] = rep.stable_dict()

    odd = dataclasses.replace(cfg, vocab=ODD_VOCAB)
    omodel = Model(odd)
    oparams = omodel.init(jax.random.key(0))
    oeq = jnp.asarray(prompts(odd.vocab), jnp.int32)
    toks, logits = _sharded(meta, "odd_vocab/logits", lambda mh: (
        _logits_run(omodel, oparams, oeq, mh)), tp)
    out["odd_vocab/tokens"] = toks
    out["odd_vocab/logits"] = logits
    out["odd_vocab/embed"] = np.asarray(oparams["embed"])
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
