"""The port's expert parallelism over a mesh's ``model`` axis
(``repro_torch.launch.tensor_parallel`` on a MoE config:
``serve.generate(mesh=)`` and ``guarded_generate(mesh=)``) against the
reference's, on reduced granite-moe-3b-a800m (8 experts, top-2, routing
groups of 16) at fp32 unless said.

The reference runs once, in a subprocess with four forced host devices
(``tests/_tensor_parallel_moe_reference.py``), started when this module's
first test starts so that the tests which need no reference run beside
it: ``serve.generate`` dense, bitmap and 2:4 on (data 1, model 2), (2, 2)
and (1, 4) meshes, ``guarded_generate`` healthy, with a flipped expert
bit and with a flipped attention bit, a bf16 lockstep run and a config
whose vocab (515) no model axis divides.  On this JAX (0.9) the reference
refuses every one of them on its mesh with a ``ShardingTypeError`` at the
embedding's gather, so the port's sharded runs are held to the
reference's unsharded run of the same calls: tokens equal, fp32 logits
within 1e-5 max|logits| (the all-reduces add the shards' partial sums in
another order than one device's contraction), ``stable_dict()`` equal.

A shard routes over every expert and sums over its own, so its gates,
slots and drops are one device's; a token whose top-k gates tie to within
the all-reduces' roundings could route elsewhere, which is why each run
reports its smallest gap between the k-th and the (k+1)-th gate.  The
port's meshes repeat the CPU device.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import partition as rpartition
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.configs import MoECfg, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import data_parallel, serve
from repro_torch.launch import tensor_parallel as tpm
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.transformer import Model
from repro_torch.runtime import guard, inject, integrity

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _data_parallel_reference as ref  # noqa: E402
import _tensor_parallel_moe_reference as mref  # noqa: E402
from _tp_common import (  # noqa: E402,F401
    CPU, KINDS, MESHES, ROOT, assert_within_spread, at as _at, bf16_ulp,
    cpu_mesh, fp32_one_thread, greedy_logits, reference_env,
    walk as _walk)

ARCH = mref.ARCH
EXPERT_ROLES = ("moe.w_gate", "moe.w_up", "moe.w_down")


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test;
    (process, npz path)."""
    path = tmp_path_factory.mktemp("tp_moe") / "reference.npz"
    proc = subprocess.Popen(
        [sys.executable,
         str(ROOT / "tests" / "_tensor_parallel_moe_reference.py"),
         str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=reference_env(), cwd=ROOT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    """The reference's runs (arrays, and ``meta``: plans, reports and the
    errors of its sharded attempts)."""
    proc, path = reference_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


@pytest.fixture(scope="module")
def rparams():
    rcfg = rget_config(ARCH).reduced()
    return jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def served(rparams):
    """The port's dense, bitmap and 2:4 models over the reference's
    weights, on the port's own plans (the reference's search's JSON,
    :func:`test_the_plans_are_the_references`), each with the tree it
    serves."""
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(rparams, "cpu")
    out = {"dense": (Model(cfg), params)}
    for kind in ("bitmap", "nm"):
        plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
        out[kind] = serve.compressed_model(cfg, params, plan, device="cpu")
    return cfg, out


def _prompts(cfg):
    return torch.from_numpy(ref.prompts(cfg.vocab))


def _tensors(entry) -> list:
    """Every tensor of an entry's payload."""
    d = entry.data
    if isinstance(d, torch.Tensor):
        return [d]
    return [getattr(d, f.name) for f in dataclasses.fields(d)
            if isinstance(getattr(d, f.name), torch.Tensor)]


# ---------------------------------------------------------------------------
# what is served, and how it splits (no reference run needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_a_model_axis_serves_the_moe_models(arch, reduce):
    cfg = get_config(arch)
    assert tpm.unserved(cfg.reduced() if reduce else cfg) is None


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_the_full_width_layouts(arch, t):
    """granite's vocab, 49,155 = 3 x 5 x 29 x 113, splits over no t > 1:
    every shard holds the whole embedding; qwen3's 151,936 splits.  The
    experts split in t contiguous ranges, the shard config keeps the whole
    ``moe`` block (the router's width) and ``d_ff``."""
    cfg = get_config(arch)
    layout = tpm.Layout(cfg, t)
    scfg = layout.shard_cfg()
    e = cfg.moe.n_experts // t
    assert layout.vocab_split == (arch == "qwen3-moe-30b-a3b")
    assert scfg.vocab == (49_155 if arch == "granite-moe-3b-a800m"
                          else 151_936 // t)
    assert layout.vocab_rows(t - 1) == ((0, 49_155) if not
                                        layout.vocab_split else
                                        (151_936 - scfg.vocab, 151_936))
    assert scfg.moe == cfg.moe and scfg.d_ff == cfg.d_ff
    assert (scfg.n_heads, scfg.head_dim) == (cfg.n_heads // t, cfg.head_dim)
    assert [layout.experts(s) for s in range(t)] == \
        [(s * e, (s + 1) * e) for s in range(t)]
    assert layout.cut("moe.w_up", t - 1) == (-3, cfg.moe.n_experts - e,
                                             cfg.moe.n_experts)
    assert tpm.unserved(scfg) is None


@pytest.mark.parametrize("t", [2, 4])
def test_shard_params_are_the_partition_spec_slices(t, served, rparams):
    """Each shard's params equal the slices ``param_specs`` gives the
    stacked tree over a (1, t) mesh, leaf for leaf: the expert stacks
    ``(L, E, d, f)`` cut on E, the router whole; at t = 4 the two KV heads
    do not split four ways, and shard s holds KV head s // 2 whole (the
    spec would cut each head in two)."""
    cfg, models = served
    params = models["dense"][1]
    specs = rpartition.param_specs(rparams, {"data": 1, "model": t})
    assert tuple(specs["blocks"]["ffn"]["w_up"]) == \
        (None, "model", None, None)
    assert tuple(specs["blocks"]["ffn"]["router"]) == (None, None, None)
    layout = tpm.Layout(cfg, t)
    hd = cfg.head_dim
    for s in range(t):
        mine = tpm.shard_params(params, layout, s)
        assert sorted(p for p, _ in _walk(mine)) == \
            sorted(p for p, _ in _walk(rparams))
        for path, want in _walk(rparams):
            got = _at(mine, path)
            assert got.is_contiguous()
            assert got.data_ptr() != _at(params, path).data_ptr()
            got = got.numpy()
            if t == 4 and path[-1] in ("wk", "wv"):
                kv = s // 2
                np.testing.assert_array_equal(
                    got, want[..., kv * hd:(kv + 1) * hd])
                continue
            for axis, name in enumerate(tuple(_at(specs, path))):
                if name == "model":
                    size = want.shape[axis] // t
                    want = np.take(want, range(s * size, (s + 1) * size),
                                   axis=axis)
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        e0, e1 = layout.experts(s)
        np.testing.assert_array_equal(mine["blocks"]["ffn"]["w_down"],
                                      rparams["blocks"]["ffn"]["w_down"]
                                      [:, e0:e1])


def test_an_odd_vocab_replicates_the_embedding():
    """A vocab that t does not divide: ``param_specs`` replicates the
    embedding, and so do the shards; the rest splits as before."""
    rcfg = dataclasses.replace(rget_config(ARCH).reduced(),
                               vocab=mref.ODD_VOCAB)
    rp = jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.key(0)))
    assert tuple(rpartition.param_specs(rp, {"data": 1, "model": 2})
                 ["embed"]) == (None, None)
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              vocab=mref.ODD_VOCAB)
    layout = tpm.Layout(cfg, 2)
    assert not layout.vocab_split and layout.shard_cfg().vocab == 515
    params = params_from_numpy(rp, "cpu")
    for s in range(2):
        mine = tpm.shard_params(params, layout, s)
        assert torch.equal(mine["embed"], params["embed"])
        assert mine["embed"].data_ptr() != params["embed"].data_ptr()
    # a dense config whose vocab the axis does not divide splits too
    dense = dataclasses.replace(get_config("chatglm3-6b").reduced(),
                                vocab=mref.ODD_VOCAB)
    assert tpm.Layout(dense, 2).shard_cfg().vocab == 515


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_each_shard_store_holds_its_experts_whole(kind, t, served):
    """A shard's expert entries are the full store's entries of its
    experts, bit for bit, under their global index, in tensors of their
    own; the shards' stored bits of each expert role sum to the full
    store's; the attention entries are cut as a dense stack's; each shard
    verifies against its own checksums."""
    cfg, models = served
    cm, _ = models[kind]
    layout = tpm.Layout(cfg, t)
    bits = dict.fromkeys(EXPERT_ROLES, 0.0)
    for s in range(t):
        shard = tpm.shard_store(cm.store, cm.store.plan, cfg, layout, s)
        e0, e1 = layout.experts(s)
        assert sorted(shard.entries) == sorted(
            k for k, e in cm.store.entries.items()
            if e.expert < 0 or e0 <= e.expert < e1)
        assert shard.verify() == {r: "ok" for r in shard.plan.checksums}
        for key, e in shard.entries.items():
            full = cm.store.entries[key]
            if e.expert < 0:
                assert e.role.startswith("attn."), key
                continue
            assert (e.layer, e.role, e.expert, e.kind) == \
                (full.layer, full.role, full.expert, full.kind)
            assert (e.dense_bits, e.stored_bits) == \
                (full.dense_bits, full.stored_bits)
            for a, b in zip(_tensors(e), _tensors(full), strict=True):
                assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
                assert a.is_contiguous()
            bits[e.role] += e.stored_bits
    for role in EXPERT_ROLES:
        assert bits[role] == sum(e.stored_bits for e in cm.store
                                 if e.role == role), role


@pytest.mark.parametrize("entry", ["generate", "guarded_generate"])
def test_an_expert_count_the_axis_does_not_divide_raises_before_any_copy(
        entry, monkeypatch):
    cfg = dataclasses.replace(
        get_config(ARCH).reduced(),
        moe=MoECfg(n_experts=10, top_k=2, d_expert=64, router_group=16))
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    monkeypatch.setattr(tpm, "_own", lambda *a, **k: pytest.fail(
        "a tensor was copied"))
    with pytest.raises(ValueError, match="n_experts = 10 does not split "
                                         "over 4 shards"):
        serve.generate(model, params, torch.zeros((2, 8), dtype=torch.long),
                       2, 10, mesh=cpu_mesh(1, 4),
                       guarded=entry == "guarded_generate", device="cpu")


def test_moe_block_over_every_expert_is_unchanged_and_shards_sum_to_it(
        served):
    """``experts`` left out and given as every expert give the same bits;
    the shards' partial sums add up to one device's output (within fp32
    reassociation); a range whose width is not the stacks' raises."""
    cfg, models = served
    p = {k: v[0] for k, v in models["dense"][1]["blocks"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y = moe.moe_block(x, p, cfg)
    assert torch.equal(y, moe.moe_block(x, p, cfg,
                                        experts=(0, cfg.moe.n_experts)))
    layout = tpm.Layout(cfg, 4)
    parts = []
    for s in range(4):
        e0, e1 = layout.experts(s)
        ps = {k: (v if k == "router" else v[e0:e1]) for k, v in p.items()}
        parts.append(moe.moe_block(x, ps, cfg, experts=(e0, e1)))
    total = tpm.all_reduce(parts)[0]
    assert (total - y).abs().max() <= 1e-6 * y.abs().max()
    with pytest.raises(ValueError, match=r"experts \[0, 4\) of 8 over "
                                         r"expert stacks of 8"):
        moe.moe_block(x, p, cfg, experts=(0, 4))


def test_the_groups_of_a_mesh_copy_the_first_groups_expert_shards(served):
    """(2, 2): the second group's shards hold copies of the first group's
    expert params and expert entries (the same bytes and checksums,
    tensors of their own)."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    groups = data_parallel.serving_replicas(cm, pruned, cpu_mesh(2, 2), CPU,
                                            "test")
    a, b = groups.models
    assert a.verify() == b.verify() == {r: "ok" for r in
                                        cm.store.plan.checksums}
    for s in range(2):
        ea, eb = (g.shards[s].store for g in (a, b))
        assert sorted(ea.entries) == sorted(eb.entries)
        assert {e.expert for e in ea if e.expert >= 0} == \
            set(range(*a.layout.experts(s)))
        for key, e in ea.entries.items():
            for x, y in zip(_tensors(e), _tensors(eb.entries[key])):
                assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
        assert ea.plan.checksums == eb.plan.checksums
        wa, wb = (groups.params[i][s]["blocks"]["ffn"]["w_up"]
                  for i in (0, 1))
        assert torch.equal(wa, wb) and wa.data_ptr() != wb.data_ptr()
        assert wa.shape[1] == cfg.moe.n_experts // 2


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_the_references_sharded_runs_fail_on_this_jax(reference):
    """Pinned: the reference serves none of these on its mesh here, the
    replicated embedding of the odd vocab included, so its unsharded run
    is what the port's sharded run is held to.  If a later JAX serves
    them, this fails and the port is to be held to the sharded run."""
    errors = reference["meta"]["sharded_errors"]
    serving = [f"{k}/generate/{d}x{t}" for k in KINDS
               for d, t in ((1, 2), (2, 2), (1, 4))] + \
        [f"{k}/logits" for k in KINDS] + [f"bf16/{k}" for k in KINDS] + \
        [f"guarded/{s}" for s in ("healthy", "expert_bitflip",
                                  "attn_bitflip")] + ["odd_vocab/logits"]
    assert sorted(errors) == sorted(serving)
    for name in serving:
        assert errors[name] is not None and \
            errors[name].startswith("ShardingTypeError: "), (name, errors)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_the_plans_are_the_references(kind, served, reference):
    """The reference's plan is written before its store records the
    checksums."""
    _, models = served
    plan = dataclasses.replace(models[kind][0].store.plan, checksums={})
    assert plan.to_json() == reference["meta"]["plans"][kind]


def _smallest_gate_gap(routes: list, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th fp32 gate
    over every MoE call recorded."""
    gap = math.inf
    for gates in routes:
        top = torch.sort(gates, dim=-1, descending=True).values
        gap = min(gap, (top[..., k - 1] - top[..., k]).min().item())
    return gap


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_generate_over_a_model_axis_equals_the_reference(kind, shape, served,
                                                         reference,
                                                         monkeypatch):
    cfg, models = served
    model, params = models[kind]
    m = cpu_mesh(*shape)
    prompts = _prompts(cfg)
    routes = []
    route = moe._route

    def recorded(xg, p, c):
        out = route(xg, p, c)
        routes.append(out[0])
        return out
    monkeypatch.setattr(moe, "_route", recorded)
    toks, _, _ = serve.generate(model, params, prompts, ref.GEN,
                                ref.PLEN + ref.GEN, mesh=m, device="cpu")
    gap = _smallest_gate_gap(routes, cfg.moe.top_k)
    assert toks.dtype == torch.int32 and toks.device == CPU
    np.testing.assert_array_equal(
        toks.numpy(), reference[f"{kind}/tokens"],
        err_msg=f"smallest top-k gate gap of the run {gap:.3e}")
    # every shard of every group routed at every layer of the prefill and
    # of each decode step (``generate`` steps after every token it keeps,
    # the last one's included)
    assert len(routes) == shape[0] * shape[1] * cfg.n_layers * (1 + ref.GEN)

    groups = data_parallel.serving_replicas(model, params, m, CPU, "test")
    assert [len(g.shards) for g in groups.models] == [shape[1]] * shape[0]
    greedy, got = greedy_logits(groups, prompts, ref.GEN,
                                ref.PLEN + ref.GEN)
    np.testing.assert_array_equal(greedy.numpy(),
                                  reference[f"{kind}/tokens"])
    want = reference[f"{kind}/logits"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_over_a_model_axis_is_within_the_references_spread(
        kind, served, reference, monkeypatch):
    """bf16 on (1, 2).  The bound: the reference's own jit-vs-eager spread
    on the dense prefill logits, plus one bf16 ulp of max|logits| for each
    all-reduce of a partial sum (two a layer: attention and the experts;
    the replicated router sees the all-reduced input on every shard).  A
    row's logits are compared while its tokens agree; its tokens must
    agree at every step whose top-2 margin in the reference exceeds twice
    the bound."""
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.bfloat16)
    cfg, models = served
    model, params = models[kind]
    want = reference[f"bf16/{kind}/logits"]
    spread = np.abs(reference["bf16/dense_jit"]
                    - reference["bf16/dense_eager"]).max()
    bound = spread + 2 * cfg.n_layers * bf16_ulp(np.abs(want).max())
    groups = data_parallel.serving_replicas(model, params, cpu_mesh(1, 2),
                                            CPU, "test")
    prompts = _prompts(cfg)
    toks, got = greedy_logits(groups, prompts, ref.GEN, ref.PLEN + ref.GEN)
    assert_within_spread(got, toks, want, reference[f"bf16/{kind}/tokens"],
                         bound)


def _flip_on_shard(groups, where: dict, group: int = 0):
    """``groups`` with one bit of ``where``'s entry flipped in the store of
    the one shard of ``group`` that holds it; that shard's index."""
    tp = groups.models[group]
    shards = list(tp.shards)
    held = [s for s, sh in enumerate(shards) if sh.store.get(
        where["layer"], where["role"], where.get("expert", -1)) is not None]
    s = held[-1]
    shards[s] = texec.CompressedModel(
        shards[s].model, inject.bitflip_payload(shards[s].store, **where))
    groups.models[group] = tpm.TensorParallel(shards, tp.layout, tp.devices)
    return s


@pytest.mark.parametrize("scenario", ["healthy", "expert_bitflip",
                                      "expert_bitflip_shard",
                                      "attn_bitflip"])
def test_guarded_generate_over_a_model_axis_equals_the_reference(
        scenario, served, reference):
    """On (1, 2): healthy; one bit flipped in the last layer's last
    expert's ``moe.w_up`` entry of the full store before it is split (the
    store it was split from is verified too) or in the store of the shard
    that holds that expert; one bit flipped in an attention role's
    payload.  The experts run dense, so an expert role's demotion leaves
    the tokens; the attention role's serves its dense weights."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    expert = reference["meta"]["expert"]
    m = cpu_mesh(1, 2)
    if scenario == "expert_bitflip":
        model = texec.CompressedModel(
            cm.model, inject.bitflip_payload(cm.store, **expert))
    elif scenario == "expert_bitflip_shard":
        model = data_parallel.serving_replicas(cm, pruned, m, CPU, "test")
        s = _flip_on_shard(model, expert)
        assert s == 1 and expert["expert"] >= model.models[0].layout.\
            experts(0)[1]
        pruned = None
    elif scenario == "attn_bitflip":
        model = texec.CompressedModel(cm.model, inject.bitflip_payload(
            cm.store, reference["meta"]["attn_role"]))
    else:
        model = cm
    toks, rep = guard.guarded_generate(model, pruned, _prompts(cfg), ref.GEN,
                                       mesh=m, device="cpu")
    name = "expert_bitflip" if scenario == "expert_bitflip_shard" \
        else scenario
    np.testing.assert_array_equal(toks.numpy(), reference[f"guarded/{name}"])
    assert rep.stable_dict() == reference["meta"]["reports"][name]


def test_an_expert_flipped_on_one_shard_is_demoted_on_every_shard(served):
    """(2, 2): a flipped bit in the expert entry of one shard of replica
    1 fails that shard's store alone, and the guard demotes the role on
    all four shards, as one device demotes it; the tokens are the healthy
    run's (the experts run dense either way)."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    m = cpu_mesh(2, 2)
    groups = data_parallel.serving_replicas(cm, pruned, m, CPU, "test")
    where = dict(role="moe.w_up", layer=cfg.n_layers - 1,
                 expert=cfg.moe.n_experts - 1)
    s = _flip_on_shard(groups, where, group=1)
    reports = [integrity.verify_report(st) for st in data_parallel.stores(
        groups)]
    assert [r["moe.w_up"] for r in reports] == \
        ["ok"] * (2 + s) + ["checksum_mismatch"] + ["ok"] * (1 - s)
    assert all(set(r.values()) == {"ok"} for i, r in enumerate(reports)
               if i != 2 + s) and set(reports[2 + s].values()) == \
        {"ok", "checksum_mismatch"}
    seen = []
    real = guard._drive

    def spy(cm_, dense, *args, **kw):
        seen.append(cm_)
        return real(cm_, dense, *args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(guard, "_drive", spy)
        toks, rep = guard.guarded_generate(groups, None, _prompts(cfg),
                                           ref.GEN, mesh=m, device="cpu")
    shards = data_parallel.shard_models(seen[0])
    assert len(shards) == 4
    assert all("moe.w_up" not in {e.role for e in sh.store} for sh in shards)
    assert all("moe.w_gate" in {e.role for e in sh.store} for sh in shards)
    assert [(f["role"], f["code"]) for f in rep.fallbacks] == \
        [("moe.w_up", "integrity_violation")]
    healthy, _, _ = serve.generate(cm, pruned, _prompts(cfg), ref.GEN,
                                   ref.PLEN + ref.GEN, device="cpu")
    assert torch.equal(toks, healthy)


def test_an_odd_vocab_over_a_model_axis_equals_the_reference(reference,
                                                             monkeypatch):
    """Vocab 515 on (1, 2): each shard looks its rows up in the whole
    embedding, no all-reduce adds the t copies and no all-gather runs;
    the first shard's logits are the model's."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              vocab=mref.ODD_VOCAB)
    rcfg = dataclasses.replace(rget_config(ARCH).reduced(),
                               vocab=mref.ODD_VOCAB)
    params = params_from_numpy(jax.tree.map(
        np.asarray, RModel(rcfg).init(jax.random.key(0))), "cpu")
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  reference["odd_vocab/embed"])
    monkeypatch.setattr(tpm, "all_gather", lambda *a, **k: pytest.fail(
        "the logits were gathered"))
    model = Model(cfg)
    prompts = _prompts(cfg)
    m = cpu_mesh(1, 2)
    toks, _, _ = serve.generate(model, params, prompts, ref.GEN,
                                ref.PLEN + ref.GEN, mesh=m, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), reference["odd_vocab/tokens"])
    groups = data_parallel.serving_replicas(model, params, m, CPU, "test")
    _, got = greedy_logits(groups, prompts, ref.GEN, ref.PLEN + ref.GEN)
    want = reference["odd_vocab/logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
