"""The port's config registry against the reference's, and what the port
does with each config.

* Every registered config and its ``reduced()`` equal the reference's
  field for field (``dataclasses.asdict``), with ``head_dim``,
  ``layer_kinds``, ``matmul_roles``, ``params_count`` and
  ``active_params_count``; ``list_archs()`` is the reference's.
* The port's search (``serve._fast_plan``, the CLI's budget) writes the
  reference's ``build_exec_plan`` JSON byte for byte for the five servable
  configs beside chatglm3-6b, full width and reduced, bitmap and 2:4.
* The four configs the reference's compressed plane refuses (gemma3-27b,
  mamba2-780m, recurrentgemma-2b, whisper-tiny) construct a ``Model``
  with the reference's init layout, and raise from ``prune_params`` and
  ``compress_params`` with the reference's words; an unknown family
  raises from ``Model`` and the compressed plane, as the reference's
  decode cache and ``compress_params`` do; nothing serves a config as
  another family.  A uniform stack with a window compresses, as in the
  reference.
* Kernel 4's naive decode kernel (Queue 3.3): no 2:4 or 1:4 role of a
  servable config leaves its last slice's groups short of a whole row
  batch at any decode M.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.configs import list_archs as rlist_archs
from repro.core.cosearch import CoSearchConfig
from repro.core.engine import EngineConfig
from repro.core.sparsity import NM, BlockBernoulli
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.exec.plans import check_plan
from repro_torch.configs import MoECfg, get_config, list_archs
from repro_torch.kernels import nm_spmm as nm_cuda
from repro_torch.launch import serve
from repro_torch.models.transformer import Model

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
ARCHS = rlist_archs()
SERVED = ["chatglm3-6b", "deepseek-coder-33b", "internlm2-20b",
          "pixtral-12b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
NEW = SERVED[1:]
REFUSED = ["gemma3-27b", "mamba2-780m", "recurrentgemma-2b", "whisper-tiny"]


def test_list_archs_is_the_references():
    assert list_archs() == ARCHS
    assert sorted(SERVED + REFUSED) == ARCHS


def _roles(cfg):
    return [(r.role, r.n, r.k, r.fanout) for r in cfg.matmul_roles()]


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_references(arch, reduce):
    r, p = rget_config(arch), get_config(arch)
    if reduce:
        r, p = r.reduced(), p.reduced()
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert [f.name for f in dataclasses.fields(p)] == \
        [f.name for f in dataclasses.fields(r)]
    assert p.head_dim == r.head_dim
    assert p.layer_kinds == r.layer_kinds
    assert _roles(p) == _roles(r)
    assert p.params_count() == r.params_count()
    assert p.active_params_count() == r.active_params_count()


def test_the_shapes_equal_the_references():
    from repro.configs import SHAPES as RSHAPES
    from repro_torch.configs import SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RSHAPES.items()}


def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", NEW)
def test_search_writes_the_references_plan(arch, reduce, kind):
    rcfg, cfg = rget_config(arch), get_config(arch)
    if reduce:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    want = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    got = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
    assert got.to_json() == want.to_json()
    assert check_plan(got, cfg) is got
    if cfg.moe:
        moe = [op for op in got.ops if op.role.startswith("moe.")]
        assert len(moe) == 3 and all(
            op.count == cfg.n_layers * cfg.moe.n_experts for op in moe)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

def _any_plan(cfg):
    """A plan whose roles fit ``cfg`` (the refusal comes first)."""
    return serve._fast_plan(dataclasses.replace(
        cfg, family="dense", hybrid=None, window=0, n_heads=4,
        n_kv_heads=2), 64)


@pytest.mark.parametrize("arch", REFUSED)
def test_refused_configs_raise_from_every_entry_point(arch):
    """The compressed plane refuses the four families with the reference's
    words, at ``prune_params`` and ``compress_params``; the dense model
    constructs (they serve dense, as in the reference)."""
    cfg = get_config(arch).reduced()
    rcfg = rget_config(arch).reduced()
    Model(cfg)
    params = {"blocks": {}}
    plan = _any_plan(cfg)
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    for fn, rfn in ((texec.prune_params, rexec.prune_params),
                    (texec.compress_params, rexec.compress_params)):
        with pytest.raises(NotImplementedError) as ei:
            fn(params, plan, cfg)
        with pytest.raises(NotImplementedError) as rei:
            rfn(params, rplan, rcfg)
        assert str(ei.value) == str(rei.value)
        assert "exec plane serves uniform attention stacks" in str(ei.value)


def test_an_unknown_family_raises_the_references_error():
    rcfg = dataclasses.replace(rget_config("chatglm3-6b").reduced(),
                               family="bogus")
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(),
                              family="bogus")
    with pytest.raises(ValueError, match="bogus") as ei:
        Model(cfg)
    with pytest.raises(ValueError, match="bogus") as rei:
        RModel(rcfg).init_cache(1, 4)
    assert str(ei.value) == str(rei.value)
    plan = _any_plan(cfg)
    for fn in (texec.prune_params, texec.compress_params):
        with pytest.raises(NotImplementedError, match="bogus"):
            fn({"blocks": {}}, plan, cfg)


def test_a_moe_family_without_a_moe_block_is_not_served_dense():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    with pytest.raises(NotImplementedError, match="moe"):
        Model(dataclasses.replace(cfg, moe=None))
    Model(dataclasses.replace(cfg, moe=MoECfg(4, 1, 64, router_group=8)))


@pytest.mark.parametrize("arch,change", [
    ("chatglm3-6b", dict(window=8)),
    ("granite-moe-3b-a800m", dict(moe=None))], ids=["window", "moe_no_block"])
def test_the_compressed_plane_refuses_what_the_model_refuses(arch, change):
    """A MoE family without a MoE block is refused by the model and the
    compressed plane alike.  A uniform stack with a window is refused by
    neither: it constructs and compresses, as in the reference."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    plan = _any_plan(cfg)
    if cfg.window:
        model = Model(cfg)
        params = model.init(seed=0, device="cpu")
        pruned = texec.prune_params(params, plan, cfg)
        store = texec.compress_params(pruned, plan, cfg)
        assert len(store) == len(plan.ops) * cfg.n_layers
        with pytest.raises(NotImplementedError,
                           match="uniform full-attention stacks only"):
            texec.CompressedModel(model, store).prefill(
                pruned, torch.zeros((1, 4), dtype=torch.long), 8)
        return
    with pytest.raises(NotImplementedError) as ei:
        Model(cfg)
    for fn in (texec.prune_params, texec.compress_params):
        with pytest.raises(NotImplementedError) as ci:
            fn({"blocks": {}}, plan, cfg)
        assert str(ci.value) == str(ei.value)


@pytest.mark.parametrize("arch", NEW + REFUSED)
def test_init_has_the_references_layout(arch):
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (the expert axis and the router included)."""
    cfg = get_config(arch).reduced()
    rcfg = rget_config(arch).reduced()
    want = jax.eval_shape(RModel(rcfg).init, jax.random.key(0))
    got = Model(cfg).init(seed=0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, want))
    assert jax.tree.leaves(jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
        got)) == jax.tree.leaves(jax.tree.map(
            lambda a: (tuple(a.shape), str(jnp.dtype(a.dtype))), want))


# ---------------------------------------------------------------------------
# Queue 3.3: kernel 4's naive decode kernel and a slice's last row batch
# ---------------------------------------------------------------------------

def _nv_rows(m: int) -> int:
    """Kept rows a batch of the naive decode kernel (``NV_ROWS`` in
    ``csrc/nm_spmm.cu``: 8 at MT <= 4, 4 above; MT is M rounded up to a
    power of two)."""
    return 8 if m <= 4 else 4


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", SERVED)
def test_no_served_nm_role_leaves_a_partial_row_batch(arch, reduce):
    """The naive decode kernel runs its last batch's missing groups against
    a group of zero columns staged after the slice (ROADMAP Queue 3.3,
    repaired: before, they read the slice's last x columns with weight 0,
    which turned an Inf there into NaN).  That path needs a slice whose
    groups do not fill whole batches of ``NV_ROWS / n_sel`` groups; every
    slice but the last is a multiple of 8 groups, so it comes down to the
    last one.  No role that is dispatched to a kernel (the experts are
    not) has one, at any decode M, 2:4 or 1:4, in the whole model or in
    a tensor-parallel shard of it (t = 2 and 4, where a ``model`` axis
    serves the config and t divides it): the card tests hold the path
    itself (``test_nm_naive_decode_keeps_inf_at_a_partial_row_batch``)."""
    from repro_torch.launch import tensor_parallel as tpm
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduce else cfg
    cfgs = [cfg]
    if tpm.unserved(cfg) is None:
        cfgs += [tpm.Layout(cfg, t).shard_cfg() for t in (2, 4)]
    for role in (r for c in cfgs for r in c.matmul_roles()):
        if role.role.startswith("moe."):
            continue
        for n_sel in (2, 1):
            for m in range(1, nm_cuda.SPLIT_MAX_M + 1):
                assert nm_cuda.small_m(m, role.k)
                slices, length = nm_cuda.split_plan(m, role.n, role.k,
                                                    n_sel, 4)
                groups = role.n // 4
                last = groups - (slices - 1) * length
                assert length % 8 == 0 and 0 < last <= length
                assert last % (_nv_rows(m) // n_sel) == 0, \
                    (role, n_sel, m, slices, length, last)
