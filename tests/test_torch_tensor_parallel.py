"""The port's tensor-parallel serving over a mesh's ``model`` axis
(``repro_torch.launch.tensor_parallel``; ``serve.generate(mesh=)`` and
``guarded_generate(mesh=)`` with ``model`` > 1) against the reference's,
on reduced chatglm3-6b at fp32 unless said.

The reference runs once, in a subprocess with four forced host devices
(``tests/_tensor_parallel_reference.py``): ``serve.generate`` dense,
bitmap and 2:4 on (data 1, model 2), (2, 2) and (1, 4) meshes, with equal
prompts and with ragged prompts and EOS, ``guarded_generate`` healthy,
with a flipped payload bit and with a NaN payload, and a bf16 lockstep
run.  On this JAX (0.9) the reference refuses every one of them on its
mesh, with a ``ShardingTypeError`` at the embedding's gather
(:func:`test_the_references_sharded_runs_fail_on_this_jax`); the port's
sharded runs are held to the reference's unsharded run of the same calls,
which its sharded run would compute: tokens equal, fp32 logits within
1e-5 max|logits| (the all-reduces add the row-parallel partial sums in
another order than one product does), ``HealthReport.stable_dict()``
equal.

The port's meshes repeat the CPU device.  Also here: each shard's params
against the slices of the reference's ``partition.param_specs``, each
shard's store against the slice of the full store, the collectives' order,
and what a ``model`` axis does not serve.
"""

import dataclasses
import json
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
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.exec.compress import CompressedStore, CompressedTensor
from repro_torch.kernels import ops, ref as kref
from repro_torch.launch import compiled, data_parallel, mesh, serve
from repro_torch.launch import tensor_parallel as tpm
from repro_torch.models import layers as L
from repro_torch.models import optflags, sharding
from repro_torch.models.transformer import Model, step_writes
from repro_torch.runtime import guard, inject

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _data_parallel_reference as ref  # noqa: E402
from _tp_common import (  # noqa: E402,F401
    CPU, KINDS, MESHES, ROOT, assert_within_spread, at as _at, bf16_ulp,
    cpu_mesh, fp32_one_thread, greedy_logits, reference_env,
    walk as _walk)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs (arrays, and ``meta``: plans, reports and the
    errors of its sharded attempts)."""
    path = tmp_path_factory.mktemp("tp") / "reference.npz"
    run = subprocess.run(
        [sys.executable,
         str(ROOT / "tests" / "_tensor_parallel_reference.py"), str(path)],
        capture_output=True, text=True, env=reference_env(), timeout=600,
        cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(path) as data:
        out = {k: data[k] for k in data.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


@pytest.fixture(scope="module")
def rparams():
    rcfg = rget_config("chatglm3-6b").reduced()
    return jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.key(0)))


@pytest.fixture(scope="module")
def served(reference, rparams):
    """The port's dense, bitmap and 2:4 models over the reference's
    weights and plans, each with the tree it serves."""
    cfg = get_config("chatglm3-6b").reduced()
    params = params_from_numpy(rparams, "cpu")
    out = {"dense": (Model(cfg), params)}
    for kind in ("bitmap", "nm"):
        plan = texec.ExecPlan.from_json(reference["meta"]["plans"][kind])
        out[kind] = serve.compressed_model(cfg, params, plan, device="cpu")
    return cfg, out


def _prompts(cfg, ragged=False):
    return torch.from_numpy(ref.ragged(cfg.vocab) if ragged
                            else ref.prompts(cfg.vocab))


# ---------------------------------------------------------------------------
# the reference's own sharded runs
# ---------------------------------------------------------------------------

def test_the_references_sharded_runs_fail_on_this_jax(reference):
    """Pinned: the reference serves none of these on its mesh here,
    (1, 2) and (2, 2) included, so its unsharded run is what the port's
    sharded run is held to.  If a later JAX serves them, this fails and
    the port is to be held to the sharded run."""
    errors = reference["meta"]["sharded_errors"]
    serving = [f"{k}/generate/{d}x{t}" for k in KINDS
               for d, t in ((1, 2), (2, 2), (1, 4))] + \
        [f"{k}/{run}" for k in KINDS for run in ("logits", "ragged_eos")] + \
        [f"bf16/{k}" for k in KINDS] + \
        [f"guarded/{s}" for s in ("healthy", "bitflip", "nan_payload")]
    assert sorted(errors) == sorted(serving)
    for name in serving:
        assert errors[name] is not None and \
            errors[name].startswith("ShardingTypeError: "), (name, errors)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _layer(tree, i):
    """The params with every stacked leaf at layer ``i``: one layer's
    tree, as the reference's model code meets it inside its scan."""
    return {k: ({g: ({n: a[i] for n, a in v.items()}
                     if isinstance(v, dict) else v[i])
                 for g, v in tree[k].items()} if k == "blocks" else tree[k])
            for k in tree}


@pytest.mark.parametrize("t", [2, 4])
def test_shard_params_are_the_partition_spec_slices(t, served, rparams):
    """Each shard's params equal, layer by layer, the slices
    ``param_specs`` gives one layer's tree over a (1, t) mesh, leaf for
    leaf; at t = 4 the two KV heads do not split four ways, and shard s
    holds KV head s // 2 whole (the spec would cut each head in two).
    On the stacked tree the reference's rule for MoE expert stacks (a
    ``w_gate`` / ``w_up`` / ``w_down`` under ``ffn`` of three or more
    dimensions) takes the dense FFN's layer axis as its expert axis and
    maps it to ``model`` where t divides the layers: pinned here, and not
    followed."""
    cfg, models = served
    params = models["dense"][1]
    stacked = rpartition.param_specs(rparams, {"data": 1, "model": t})
    layer_axis = "model" if cfg.n_layers % t == 0 else None
    assert tuple(stacked["blocks"]["ffn"]["w_gate"]) == \
        (layer_axis, None, None)
    assert tuple(stacked["blocks"]["attn"]["wq"]) == (None, None, "model")
    layout = tpm.Layout(cfg, t)
    hd = cfg.head_dim
    shards = [tpm.shard_params(params, layout, s) for s in range(t)]
    for mine in shards:
        assert sorted(p for p, _ in _walk(mine)) == \
            sorted(p for p, _ in _walk(rparams))
        assert all(v.is_contiguous() for _, v in _walk(mine))
        assert all(v.data_ptr() != _at(params, p).data_ptr()
                   for p, v in _walk(mine))
    for i in range(cfg.n_layers):
        layer = _layer(rparams, i)
        specs = rpartition.param_specs(layer, {"data": 1, "model": t})
        for s in range(t):
            mine = _layer(shards[s], i)
            for path, want in _walk(layer):
                got = _at(mine, path).numpy()
                if t == 4 and path[-1] in ("wk", "wv"):
                    kv = s // 2
                    np.testing.assert_array_equal(
                        got, want[..., kv * hd:(kv + 1) * hd])
                    continue
                for axis, name in enumerate(tuple(_at(specs, path))):
                    if name == "model":
                        size = want.shape[axis] // t
                        want = np.take(want,
                                       range(s * size, (s + 1) * size),
                                       axis=axis)
                np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_a_shards_config_pins_its_head_width():
    cfg = get_config("chatglm3-6b")
    two = tpm.Layout(cfg, 2).shard_cfg()
    assert (two.n_heads, two.n_kv_heads, two.d_ff, two.vocab) == \
        (16, 1, 6848, 32512)
    # d_model // n_heads would be 256: the head width is pinned at 128
    assert two.head_dim == cfg.head_dim == 128
    assert tpm.Layout(cfg, 4).kv_heads(3) == (1, 1)
    assert tpm.Layout(cfg, 2).cut("attn.wk", 1) == (-1, 128, 256)
    assert tpm.Layout(cfg, 2).cut("ffn.w_down", 1) == (-2, 6848, 13696)


def test_an_indivisible_model_axis_raises_value_error():
    cfg = get_config("chatglm3-6b").reduced()
    with pytest.raises(ValueError, match="n_heads = 4 does not split over "
                                         "3 shards"):
        tpm.Layout(cfg, 3)
    odd = dataclasses.replace(cfg, n_heads=12, d_ff=384, vocab=510)
    with pytest.raises(ValueError, match="groups of 6 query heads a KV head "
                                         "straddle shards"):
        tpm.Layout(odd, 3)


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------

def _dense_of(entry) -> torch.Tensor:
    """An entry's weight, decompressed."""
    d = entry.data
    if entry.kind == "nm":
        return kref.nm_expand_ref(d.values, d.indices, d.n_sel, d.m_group)
    w = torch.zeros(d.n, d.k, dtype=d.blocks.dtype)
    for kj in range(d.k // d.bk):
        a, c = int(d.offsets[kj]), int(d.counts[kj])
        for b in range(a, a + c):
            r = int(d.row_ids[b])
            w[r * d.bn:(r + 1) * d.bn, kj * d.bk:(kj + 1) * d.bk] = \
                d.blocks[b]
    return w


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_each_shard_store_is_the_slice_of_the_full_store(kind, t, served):
    cfg, models = served
    cm, _ = models[kind]
    layout = tpm.Layout(cfg, t)
    bits: dict = {}
    for s in range(t):
        shard = tpm.shard_store(cm.store, cm.store.plan, cfg, layout, s)
        assert sorted(shard.entries) == sorted(cm.store.entries)
        assert shard.verify() == {r: "ok" for r in shard.plan.checksums}
        for key, e in shard.entries.items():
            full = cm.store.entries[key]
            axis, lo, hi = layout.cut(e.role, s)
            want = _dense_of(full).narrow(2 + axis, lo, hi - lo)
            assert torch.equal(_dense_of(e), want), key
            tensors = [e.data.values, e.data.indices] if kind == "nm" \
                else [e.data.blocks, e.data.counts, e.data.row_ids,
                      e.data.offsets]
            assert all(x.is_contiguous() and x.data_ptr() % 16 == 0
                       for x in tensors)
            if kind == "bitmap":
                assert e.data.nnzb == int(e.data.counts.sum())
                assert e.data.max_per_col == int(e.data.counts.max())
            bits[e.role] = bits.get(e.role, 0) + e.stored_bits
    if kind == "nm":
        for role in bits:
            full = sum(e.stored_bits for e in cm.store if e.role == role)
            dup = 2 if t == 4 and role in ("attn.wk", "attn.wv") else 1
            assert bits[role] == dup * full, role


def test_an_nm_row_cut_inside_a_group_raises(served):
    cfg, models = served
    cm, _ = models["nm"]
    odd = dataclasses.replace(cfg, d_ff=264)
    w = torch.randn(264, cfg.d_model)
    store = CompressedStore(cm.store.plan, {(0, "ffn.w_down", -1):
                                            CompressedTensor(
        0, "ffn.w_down", -1, "nm", ops.compress_nm(w), 264 * 128 * 32.0,
        0.0)})
    with pytest.raises(ValueError, match=r"rows \[66, 132\) cut an 2:4 "
                                         r"group"):
        tpm.shard_store(store, store.plan, odd, tpm.Layout(odd, 4), 1)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_all_reduce_is_a_left_fold_and_all_gather_keeps_shard_order():
    parts = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    out = tpm.all_reduce(parts)
    # ((1e8 + 1) - 1e8) is 0 in fp32: the fold's order, not (1e8 - 1e8) + 1
    assert [x.item() for x in out] == [0.0] * 3
    assert out[0] is out[1] is out[2]
    g = tpm.all_gather([torch.full((2, 1), float(i)) for i in range(3)], -1)
    assert g.tolist() == [[0.0, 1.0, 2.0]] * 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_generate_over_a_model_axis_equals_the_reference(kind, shape, served,
                                                         reference):
    cfg, models = served
    model, params = models[kind]
    m = cpu_mesh(*shape)
    prompts = _prompts(cfg)
    toks, _, _ = serve.generate(model, params, prompts, ref.GEN,
                                ref.PLEN + ref.GEN, mesh=m, device="cpu")
    assert toks.dtype == torch.int32 and toks.device == CPU
    np.testing.assert_array_equal(toks.numpy(), reference[f"{kind}/tokens"])

    # the prefill's last logits and every decode step's
    groups = data_parallel.serving_replicas(model, params, m, CPU, "test")
    assert [len(g.shards) for g in groups.models] == [shape[1]] * shape[0]
    greedy, got = greedy_logits(groups, prompts, ref.GEN,
                                ref.PLEN + ref.GEN)
    np.testing.assert_array_equal(greedy.numpy(),
                                  reference[f"{kind}/tokens"])
    want = reference[f"{kind}/logits"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_ragged_prompts_with_eos_over_a_model_axis_equal_the_reference(
        kind, shape, served, reference):
    cfg, models = served
    model, params = models[kind]
    eos = int(reference[f"{kind}/eos_id"])
    toks, _, _ = serve.generate(model, params, _prompts(cfg, ragged=True),
                                ref.GEN, ref.PLEN + ref.GEN,
                                mesh=cpu_mesh(*shape), prompt_pad_id=0,
                                eos_id=eos, pad_id=-3, device="cpu")
    want = reference[f"{kind}/ragged_eos"]
    np.testing.assert_array_equal(toks.numpy(), want)
    assert (want[0, 2:] == -3).all()           # row 0 ended on its EOS


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_over_a_model_axis_is_within_the_references_spread(
        kind, served, reference, monkeypatch):
    """bf16 on (1, 2).  The bound: the reference's own jit-vs-eager spread
    on the dense prefill logits, plus one bf16 ulp of max|logits| for each
    all-reduce of a partial sum (two a layer: each rounds the sum of the
    shards' bf16 partial outputs, where one product rounds once; the
    embedding's all-reduce adds zeros and is exact).  A row's logits are
    compared while its tokens agree; its tokens must agree at every step
    whose top-2 margin in the reference exceeds twice the bound."""
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


@pytest.mark.parametrize("scenario", ["healthy", "bitflip", "bitflip_shard",
                                      "nan_payload"])
def test_guarded_generate_over_a_model_axis_equals_the_reference(
        scenario, served, reference):
    """On (1, 2): healthy; one payload bit flipped in the full store before
    it is split (the store it was split from is verified too) or in one
    shard's cut of the role; a NaN payload with verify off (the dense model,
    split as the shards are, serves the rest)."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    role = reference["meta"]["role"]
    m = cpu_mesh(1, 2)
    kw: dict = {}
    if scenario == "bitflip":
        model = texec.CompressedModel(cm.model,
                                      inject.bitflip_payload(cm.store, role))
    elif scenario == "bitflip_shard":
        groups = data_parallel.serving_replicas(cm, pruned, m, CPU, "test")
        tp = groups.models[0]
        shards = list(tp.shards)
        # the shard whose cut of the role's layer 0 holds stored blocks
        s = next(i for i, sh in enumerate(shards)
                 if sh.store.get(0, role).data.nnzb)
        shards[s] = texec.CompressedModel(
            shards[s].model, inject.bitflip_payload(shards[s].store, role))
        assert tp.shards[s].verify() == shards[1 - s].verify()
        groups.models[0] = tpm.TensorParallel(shards, tp.layout, tp.devices)
        model, pruned = groups, None
    elif scenario == "nan_payload":
        model = texec.CompressedModel(
            cm.model, inject.poison_payload_nan(cm.store, role))
        kw = {"verify": False}
    else:
        model = cm
    toks, rep = guard.guarded_generate(model, pruned, _prompts(cfg), ref.GEN,
                                       mesh=m, device="cpu", **kw)
    name = "bitflip" if scenario == "bitflip_shard" else scenario
    np.testing.assert_array_equal(toks.numpy(), reference[f"guarded/{name}"])
    assert rep.stable_dict() == reference["meta"]["reports"][name]
    np.testing.assert_array_equal(toks.numpy(), reference["bitmap/tokens"])


def test_a_role_demoted_on_one_shard_is_demoted_on_every_shard(served):
    """(2, 2): a flipped bit in one shard of replica 1 demotes the role on
    all four shards, and ``dense_model=`` degrades to the dense model split
    as the groups are."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    m = cpu_mesh(2, 2)
    groups = data_parallel.serving_replicas(cm, pruned, m, CPU, "test")
    tp = groups.models[1]
    role = cm.store.plan.ops[0].role
    shards = list(tp.shards)
    s = next(i for i, sh in enumerate(shards)
             if sh.store.get(0, role).data.nnzb)
    shards[s] = texec.CompressedModel(
        shards[s].model, inject.bitflip_payload(shards[s].store, role))
    groups.models[1] = tpm.TensorParallel(shards, tp.layout, tp.devices)
    seen = []
    real = guard._drive

    def spy(cm_, dense, *args, **kw):
        seen.append((cm_, dense))
        return real(cm_, dense, *args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(guard, "_drive", spy)
        toks, rep = guard.guarded_generate(groups, None, _prompts(cfg),
                                           ref.GEN, mesh=m,
                                           dense_model=Model(cfg),
                                           device="cpu")
    served_, dense = seen[0]
    assert all(role not in {e.role for e in s.store}
               for s in data_parallel.shard_models(served_))
    assert all(type(s) is Model for s in data_parallel.shard_models(dense))
    assert [f["code"] for f in rep.fallbacks] == ["integrity_violation"]
    want, _, _ = serve.generate(cm.demoted([role]), pruned, _prompts(cfg),
                                ref.GEN, ref.PLEN + ref.GEN, device="cpu")
    assert torch.equal(toks, want)


def test_a_groups_decode_is_eager_and_its_caches_are_the_shards(served):
    cfg, models = served
    cm, pruned = models["nm"]
    groups = data_parallel.serving_replicas(cm, pruned, cpu_mesh(1, 2), CPU,
                                            "test")
    tp = groups.models[0]
    assert data_parallel.step_of(tp, compiled.CompiledStep) == \
        tp.decode_step
    cache = tp.init_cache(2, 12)
    assert sorted(cache) == [0, 1]
    assert cache[0]["self"]["k"].shape == (cfg.n_layers, 2, 12, 1,
                                           cfg.head_dim)
    # the guard's undo covers every shard's K / V at the step's position
    assert len(step_writes(cache, 5)) == 2 * 2
    assert len({s.store.entries[(0, "attn.wq", -1)].data.values.data_ptr()
                for s in tp.shards}) == 2


def test_the_groups_of_a_mesh_are_copies_of_the_first(served):
    """(2, 2): the second group's shards hold copies of the first group's
    params and stores (the same bytes and checksums, tensors and model
    objects of their own); every shard's store verifies."""
    cfg, models = served
    cm, pruned = models["bitmap"]
    groups = data_parallel.serving_replicas(cm, pruned, cpu_mesh(2, 2), CPU,
                                            "test")
    a, b = groups.models
    assert a.verify() == b.verify() == {r: "ok" for r in
                                        cm.store.plan.checksums}
    for s in range(2):
        wa, wb = (g.shards[s].store.get(0, "ffn.w_gate").data
                  for g in (a, b))
        assert torch.equal(wa.blocks, wb.blocks)
        assert wa.blocks.data_ptr() != wb.blocks.data_ptr()
        assert a.shards[s].store.plan.checksums == \
            b.shards[s].store.plan.checksums
        assert a.shards[s].model is not b.shards[s].model
        ea, eb = (groups.params[i][s]["embed"] for i in (0, 1))
        assert torch.equal(ea, eb) and ea.data_ptr() != eb.data_ptr()


def test_shard_sees_its_local_view_inside_the_driver(served, monkeypatch):
    """A TP mesh with its rules: a bare ``shard(..., "model")`` raises
    outside the driver, and is the identity at every norm inside it."""
    cfg, models = served
    model, params = models["dense"]
    m = cpu_mesh(1, 2)
    x = torch.ones(4, 2)
    calls = []
    norm = L.rms_norm

    def annotated(h, w, eps):
        calls.append(sharding.shard(h, "batch", "model") is h)
        return norm(h, w, eps)
    with m, sharding.logical_axis_rules(mesh.axis_map_for(m)):
        with pytest.raises(NotImplementedError, match="'model' of 2"):
            sharding.shard(x, "batch", "model")
        monkeypatch.setattr(L, "rms_norm", annotated)
        serve.generate(model, params, _prompts(cfg), 2, ref.PLEN + 2, mesh=m,
                       device="cpu")
    assert calls and all(calls)


# ---------------------------------------------------------------------------
# what a model axis does not serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m",
                                  "whisper-tiny"])
@pytest.mark.parametrize("entry", ["generate", "guarded_generate"])
def test_an_unserved_family_raises_before_any_work(arch, entry, monkeypatch):
    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    monkeypatch.setattr(tpm, "shard_params", lambda *a, **k: pytest.fail(
        "the params were split"))
    with pytest.raises(NotImplementedError, match="'model': 2"):
        serve.generate(model, params, torch.zeros((2, 4), dtype=torch.long),
                       2, 8, mesh=cpu_mesh(1, 2),
                       guarded=entry == "guarded_generate", device="cpu")


def test_an_optflag_under_a_model_axis_raises(served):
    cfg, models = served
    model, params = models["nm"]
    with optflags.optimizations({"gqagroup"}), \
            pytest.raises(NotImplementedError, match="optflags"):
        serve.generate(model, params, _prompts(cfg), 2, ref.PLEN + 2,
                       mesh=cpu_mesh(1, 2), device="cpu")


def test_ragged_prompts_under_the_guard_over_a_model_axis_raise(served):
    cfg, models = served
    model, params = models["bitmap"]
    with pytest.raises(NotImplementedError, match="equal-length prompts"):
        serve.generate(model, params, _prompts(cfg, ragged=True), 2,
                       ref.PLEN + 2, mesh=cpu_mesh(1, 2), guarded=True,
                       prompt_pad_id=0, device="cpu")


def test_a_model_axis_of_three_raises_value_error(served):
    cfg, models = served
    model, params = models["dense"]
    with pytest.raises(ValueError, match="n_heads = 4"):
        serve.generate(model, params, _prompts(cfg), 2, ref.PLEN + 2,
                       mesh=cpu_mesh(1, 3), device="cpu")
