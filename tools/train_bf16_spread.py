#!/usr/bin/env python3
"""The reference's own bf16 spread on the training loss and gradients,
and the port's distance from it: where ``tests/test_torch_train_bf16.py``
takes its bounds.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/train_bf16_spread.py \
        [ARCH ...]

Runs on the CPU (it needs JAX and the reference).  For each arch's
``reduced()`` config (default: the seven layouts the test holds), on the
reference's ``Model.init(jax.random.key(0))`` weights and batch 3 of
``TokenPipeline(seq_len=80, global_batch=2)``, at the default bf16
compute dtype: the reference's ``jax.value_and_grad(model.loss)`` jitted
and under ``jax.disable_jit()`` (op by op), and the port's
``launch.train.value_and_grad``.  Prints each loss's relative distance
from the jitted one and, over the gradient leaves, the largest max|Δ| /
max|leaf| of eager against jit, the port against jit and the port against
eager.  Takes about a minute an arch (the eager runs).
"""

from __future__ import annotations

import sys

import jax
import numpy as np
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models.transformer import Model as RModel
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.train import value_and_grad
from repro_torch.models.transformer import Model

ARCHS = ("chatglm3-6b", "gemma3-27b", "granite-moe-3b-a800m", "pixtral-12b",
         "mamba2-780m", "recurrentgemma-2b", "whisper-tiny")
B, S, STEP = 2, 80, 3


def _worst(got: list, want: list) -> float:
    out = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        scale = np.abs(w).max()
        if scale:
            out = max(out, float(np.abs(g - w).max() / scale))
    return out


def spread(arch: str) -> dict:
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    enc = cfg.enc_seq if cfg.family == "encdec" else 0
    rbatch = RPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       enc_seq=enc, d_model=cfg.d_model).batch_at(STEP)
    fn = jax.value_and_grad(RModel(rcfg).loss)
    jl, jg = jax.jit(fn)(rparams, rbatch)
    with jax.disable_jit():
        el, eg = fn(rparams, rbatch)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rbatch.items()}
    pl, pg = value_and_grad(Model(cfg).loss, params, batch)
    jg, eg = jax.tree.leaves(jg), jax.tree.leaves(eg)
    pg = [t.float().numpy() for t in tree.leaves(pg)]
    j = float(jl)
    return {"loss eager-jit": abs(float(el) - j) / abs(j),
            "loss port-jit": abs(float(pl) - j) / abs(j),
            "grads eager-jit": _worst(eg, jg),
            "grads port-jit": _worst(pg, jg),
            "grads port-eager": _worst(pg, eg)}


def main() -> None:
    torch.set_num_threads(1)
    for arch in sys.argv[1:] or ARCHS:
        row = spread(arch)
        print(arch + ": " + ", ".join(f"{k} {v:.3e}" for k, v in row.items()),
              flush=True)


if __name__ == "__main__":
    main()
