"""The port's training loss and gradients against the reference's at their
default bf16 compute dtype, on every family's ``reduced()`` config (the
weights and batch of ``tests/test_torch_train.py``).

The reference's own spreads come from ``tools/train_bf16_spread.py``,
which runs its ``jax.value_and_grad(model.loss)`` jitted and under
``jax.disable_jit()`` (op by op) on these inputs; the eager runs take
about a minute a family, too long to repeat here.

* The loss within the reference's own jit-vs-eager spread
  (``LOSS_SPREAD``, relative) plus one bf16 ulp of the loss, as
  ``tests/test_torch_bf16.py`` holds logits.
* Each gradient leaf within ``GRAD_BOUND`` · max|leaf| of the reference's
  jitted gradients.  The bound is twice the reference's own jit-vs-eager
  spread (per leaf, max|Δ| / max|leaf|) on recurrentgemma-2b, 5.748e-2:
  the widest of the families whose jitted and eager runs route alike
  (chatglm3-6b 1.813e-2, pixtral 1.818e-2, whisper 2.030e-2, gemma3
  4.208e-2, mamba2 0.956e-2).  The port sits 1.69e-2 .. 6.05e-2 from the
  jitted gradients (mamba2's ``D``: 4.46e-2, where the reference sums its
  broadcast's transpose in bf16).
* The MoE family: the reference's jitted run routes some tokens to other
  experts than its eager run, and its own spread is 0.3224; its bound is
  twice that (``MOE_GRAD_BOUND``), which still catches a gradient that is
  missing or of the wrong sign (an error of 1 or 2 · max|leaf|).  The
  port sits 0.3224 from the jitted run and 1.034e-2 from the eager one,
  which computes op by op where the port does (an eager reference costs
  about a minute of the suite's time).  Its fp32 gradients are held to
  1e-4 in ``tests/test_torch_train.py``.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.train import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model

B, S = 2, 80
#: |jit - eager| / |jit| of the reference's bf16 loss on these inputs
LOSS_SPREAD = {"chatglm3-6b": 9.370e-6, "gemma3-27b": 2.522e-4,
               "granite-moe-3b-a800m": 1.056e-3, "pixtral-12b": 6.192e-6,
               "mamba2-780m": 0.0, "recurrentgemma-2b": 4.670e-4,
               "whisper-tiny": 3.266e-5}
GRAD_BOUND = 2 * 5.748e-2
MOE_GRAD_BOUND = 2 * 0.3224


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


@pytest.mark.parametrize("arch", sorted(LOSS_SPREAD))
def test_bf16_loss_and_grads_match_the_reference(arch):
    assert RL.COMPUTE_DTYPE == jax.numpy.bfloat16
    assert L.COMPUTE_DTYPE == torch.bfloat16
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    enc = cfg.enc_seq if cfg.family == "encdec" else 0
    rbatch = RPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       enc_seq=enc, d_model=cfg.d_model).batch_at(3)
    want_loss, want = jax.jit(jax.value_and_grad(RModel(rcfg).loss))(
        rparams, rbatch)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in rbatch.items()}
    loss, grads = value_and_grad(Model(cfg).loss, params, batch)

    w = float(want_loss)
    tol = LOSS_SPREAD[arch] * abs(w) + _bf16_ulp(abs(w))
    assert abs(float(loss) - w) <= tol
    bound = MOE_GRAD_BOUND if cfg.moe else GRAD_BOUND
    got, want = tree.leaves(grads), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        g, x = g.float().numpy(), np.asarray(x, np.float32)
        assert g.shape == x.shape and np.isfinite(g).all()
        assert np.abs(g - x).max() <= bound * np.abs(x).max()
