"""The dense-backbone configs beside chatglm3-6b against the reference:
deepseek-coder-33b, internlm2-20b and pixtral-12b (family ``vlm``: a dense
backbone, its vision frontend a stub in the reference too), reduced, plus
a pixtral whose heads are wider than the model (``n_heads · d_head !=
d_model``, as the full config's 32 · 128 against 5,120; the reduced one
has 4 · 32 = 128 = d_model).

Both packages get the reference's ``Model.init`` weights through numpy and
the same plan (the port's search, whose JSON must equal the reference's
``build_exec_plan``).  At fp32 (the reference's ``layers`` and
``attention`` compute dtype patched, the port's ``layers``): dense prefill
and decode logits within 1e-5 · max|logits|, and the compressed model's
greedy tokens equal to the reference's, on a bitmap or a 2:4 plan.
"""

import dataclasses

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
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
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
GEN = 4
#: (name, arch, the changes to its reduced config, the plan served)
CASES = [
    ("deepseek-coder-33b", "deepseek-coder-33b", {}, "bitmap"),
    ("internlm2-20b", "internlm2-20b", {}, "nm"),
    ("pixtral-12b", "pixtral-12b", {}, "bitmap"),
    ("pixtral-12b-wide-heads", "pixtral-12b", {"d_head": 48}, "nm"),
]


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    _, arch, changes, kind = request.param
    rcfg = dataclasses.replace(rget_config(arch).reduced(), **changes)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    return dict(rcfg=rcfg, cfg=cfg, kind=kind, rparams=rparams,
                params=params, toks=toks)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_the_heads_are_what_the_case_says(case):
    cfg = case["cfg"]
    assert (cfg.n_heads * cfg.head_dim != cfg.d_model) == \
        (cfg.head_dim == 48)
    wq = case["params"]["blocks"]["attn"]["wq"]
    wo = case["params"]["blocks"]["attn"]["wo"]
    assert wq.shape[1:] == (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert wo.shape[1:] == (cfg.n_heads * cfg.head_dim, cfg.d_model)


def test_prefill_and_decode_logits_match_the_reference(case):
    rcfg, cfg, toks = case["rcfg"], case["cfg"], case["toks"]
    rmodel, model = RModel(rcfg), Model(cfg)
    want, rcache = rmodel.prefill(case["rparams"],
                                  jnp.asarray(toks, jnp.int32), 12)
    got, cache = model.prefill(case["params"], torch.from_numpy(toks), 12)
    _close(got, want)
    nxt = np.array(jnp.argmax(want[:, -1], -1), np.int32)
    want_d, rcache = rmodel.decode_step(case["rparams"], rcache,
                                        jnp.asarray(nxt),
                                        jnp.asarray(8, jnp.int32))
    got_d, cache = model.decode_step(case["params"], cache,
                                     torch.from_numpy(nxt).long(),
                                     torch.tensor(8))
    _close(got_d, want_d)
    _close(cache["self"]["k"], rcache["self"]["k"])


def test_compressed_greedy_tokens_equal_the_references(case):
    rcfg, cfg, kind = case["rcfg"], case["cfg"], case["kind"]
    plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
    rplan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                  search_cfg=FAST, value_bits=32)
    assert plan.to_json() == rplan.to_json()
    assert {op.choice.kind for op in plan.ops} == {kind}
    rpruned = rexec.prune_params(case["rparams"], rplan, rcfg)
    rstore = rexec.compress_params(rpruned, rplan, rcfg)
    want = rexec.CompressedModel(RModel(rcfg), rstore).generate(
        rpruned, jnp.asarray(case["toks"], jnp.int32), GEN)[0]
    cm, pruned = serve.compressed_model(cfg, case["params"], plan,
                                        device="cpu")
    assert cm.store.plan.checksums == rstore.plan.checksums
    assert cm.store.achieved_ratio() == rstore.achieved_ratio()
    got, _, _ = cm.generate(pruned, torch.from_numpy(case["toks"]), GEN,
                            device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
