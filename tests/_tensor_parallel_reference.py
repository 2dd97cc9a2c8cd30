"""The reference's tensor-parallel serving runs on reduced chatglm3-6b,
written to an npz for ``test_torch_tensor_parallel.py``.

Run in a process of its own with four forced host devices (the reference
reads the device count when JAX starts)::

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/_tensor_parallel_reference.py OUT.npz

At fp32: ``serve.generate`` dense, bitmap and 2:4 on (data 1, model 2),
(2, 2) and (1, 4) meshes with equal prompts, whose lockstep path (tokens,
and the prefill's and every decode step's logits from the same jitted
calls) runs once more on (1, 2), and on (1, 2) with left-padded ragged
prompts and EOS (each row's admission prefill jitted: :class:`_JitPrefill`); ``guarded_generate`` on (1, 2) healthy, with one payload
bit flipped and with a NaN payload (verify off).  At bf16: the tokens and
the logits of the same lockstep run on (1, 2), and the dense model's
prefill logits jitted and eager, whose gap is the reference's own
jit-vs-eager spread.  The prompts, the plans and the runs are those of
``tests/_data_parallel_reference.py``.

A run the reference cannot do on its mesh (JAX 0.9 refuses the
embedding's gather under a mesh: a ``ShardingTypeError``) is run again
without the mesh, and its error is recorded under ``meta["sharded_errors"]``
by the run's name.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _data_parallel_reference import (FAST, GEN, PLEN, SPARSITY, _logits_run,
                                      _sharded, prompts, ragged)
from repro import exec as rexec
from repro.configs import get_config
from repro.launch import mesh as rmesh
from repro.launch import serve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model
from repro.runtime import guard, inject

#: the meshes (data, model) the reference is asked to serve on
MESHES = ((1, 2), (2, 2), (1, 4))


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


class _JitPrefill:
    """``model`` with its one-pass prefill jitted, one trace a prompt
    length: the reference's ragged admission prefills each row through
    an unjitted ``prefill`` (20 s a compressed model here, its kernels in
    interpret mode)."""

    def __init__(self, model):
        self.model = model
        self.prefill = jax.jit(model.prefill, static_argnames=("max_len",))

    def __getattr__(self, name):
        return getattr(self.model, name)


def _attempt(meta, name, run) -> None:
    """``run()`` on a mesh, its error (or ``None``) recorded by ``name``."""
    try:
        run()
        meta["sharded_errors"][name] = None
    except Exception as e:                              # noqa: BLE001
        meta["sharded_errors"][name] = \
            f"{type(e).__name__}: {str(e).splitlines()[0]}"


def main(path: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    meshes = {f"{d}x{t}": rmesh.make_small_mesh(d, t) for d, t in MESHES}
    tp = meshes["1x2"]
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    out, meta = {}, {"plans": {}, "reports": {}, "sharded_errors": {}}
    eq = jnp.asarray(prompts(cfg.vocab), jnp.int32)
    rg = jnp.asarray(ragged(cfg.vocab), jnp.int32)

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

    RL.COMPUTE_DTYPE = jnp.float32
    rattn.COMPUTE_DTYPE = jnp.float32
    for name, (m, p) in served.items():
        for label, mh in meshes.items():
            _attempt(meta, f"{name}/generate/{label}", lambda: (
                serve.generate(m, p, eq, GEN, PLEN + GEN, mesh=mh)))
        # the unsharded run: the lockstep path of ``serve.generate``
        # (``_data_parallel_reference.py`` holds the two to equal tokens)
        toks, logits = _sharded(meta, f"{name}/logits", lambda mh: (
            _logits_run(m, p, eq, mh)), tp)
        out[f"{name}/tokens"] = toks
        out[f"{name}/logits"] = logits
        # EOS: row 0's second token (row 0 is not padded)
        eos = int(np.asarray(toks)[0, 1])
        toks, _, _ = _sharded(meta, f"{name}/ragged_eos", lambda mh: (
            serve.generate(_JitPrefill(m), p, rg, GEN, PLEN + GEN, mesh=mh,
                           prompt_pad_id=0, eos_id=eos, pad_id=-3)), tp)
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
            guard.guarded_generate(m, pruned, eq, GEN, mesh=mh, **kw)), tp)
        out[f"guarded/{name}"] = np.asarray(toks)
        meta["reports"][name] = rep.stable_dict()
    out["meta"] = np.asarray(json.dumps(meta))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
