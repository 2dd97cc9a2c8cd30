"""bf16 serving parity: the port against the reference at their default
bf16 compute dtype, on reduced chatglm3-6b with the bitmap and N:M plans.

* The dense forward is held against the reference run eagerly
  (``jax.disable_jit``), where every op rounds to bf16 where the
  reference's source says.  The port rounds at the same places — the
  attention score scale rounded to bf16, SiLU as XLA expands
  ``jax.nn.silu`` — so the logits agree to fp32 rounding (≤ 1e-6).
* Compressed prefill logits are held against the reference as it serves
  them (jitted).  Tolerance: the reference's own jit-vs-eager spread on
  the dense model, plus one bf16 ulp of max|logits|.  XLA fuses the
  reference's elementwise chains and keeps fp32 inside a fusion, so its
  served logits already sit that far from its eager ones; the kernels'
  fp32 summation order (one matmul here, per-stripe accumulation there)
  may flip one more bf16 rounding.
* Greedy tokens must be identical.
"""

import math

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
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
GEN = 6


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.fixture(scope="module", params=["bitmap", "nm"])
def bf16(request):
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    assert L.COMPUTE_DTYPE == torch.bfloat16
    kind = request.param
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    rpruned = rexec.prune_params(rparams, plan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, plan, rcfg))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    jt = jnp.asarray(toks, jnp.int32)
    rdense_jit = np.asarray(RModel(rcfg).prefill(rpruned, jt, 12)[0])
    with jax.disable_jit():
        rdense_eager = np.asarray(RModel(rcfg).prefill(rpruned, jt, 12)[0])
    rcomp = np.asarray(rcm.prefill(rpruned, jt, 12)[0])
    rgen = np.asarray(rcm.generate(rpruned, jt, GEN)[0])

    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(
        cfg, params, texec.ExecPlan.from_json(plan.to_json()), device="cpu")
    return dict(cfg=cfg, cm=cm, pruned=pruned, toks=torch.from_numpy(toks),
                rdense_jit=rdense_jit, rdense_eager=rdense_eager,
                rcomp=rcomp, rgen=rgen)


def test_bf16_dense_forward_matches_reference_eager(bf16):
    logits, cache = Model(bf16["cfg"]).prefill(bf16["pruned"], bf16["toks"],
                                               12)
    assert cache["self"]["k"].dtype == torch.bfloat16
    assert np.abs(logits.numpy() - bf16["rdense_eager"]).max() <= 1e-6


def test_bf16_compressed_prefill_matches_reference(bf16):
    logits, _ = bf16["cm"].prefill(bf16["pruned"], bf16["toks"], 12)
    want = bf16["rcomp"]
    spread = np.abs(bf16["rdense_jit"] - bf16["rdense_eager"]).max()
    tol = spread + _bf16_ulp(np.abs(want).max())
    assert np.abs(logits.numpy() - want).max() <= tol


def test_bf16_greedy_tokens_match_reference(bf16):
    toks, _, _ = bf16["cm"].generate(bf16["pruned"], bf16["toks"], GEN,
                                     device="cpu")
    np.testing.assert_array_equal(toks.numpy(), bf16["rgen"])
