"""The port's ring caches under a mesh's ``model`` axis
(``repro_torch.launch.tensor_parallel`` on gemma3-27b's 5 local : 1
global stack and on a uniform stack with a window:
``serve.generate(mesh=)``, ``guarded_generate(mesh=)`` and ``serve
--mesh``) against the reference's, at fp32 unless said.

The reference runs once, in a subprocess with four forced host devices
(``tests/_tensor_parallel_ring_reference.py``), started when this module's
first test starts so that the tests which need no reference run beside
it: reduced gemma3-27b (rings of 64) with 40-token prompts and 40 tokens
generated, so the rings wrap, through ``serve.generate`` on (data 1,
model 2), (2, 2) and (1, 4), with ragged prompts and EOS on (1, 2), at
bf16 on (1, 2), and through ``guarded_generate`` healthy, with a NaN at
decode position 70 once and twice; and a reduced chatglm3-6b stack with a
window of 8, dense, bitmap and 2:4, on (1, 2).  On this JAX (0.9) the
reference refuses every one of them on its mesh with a
``ShardingTypeError`` at the embedding's gather, so the port's sharded
runs are held to the reference's unsharded run of the same calls: tokens
equal, fp32 logits of every ingest and decode step within 1e-5
max|logits| (the all-reduces add the shards' partial sums in another
order than one device's contraction), ``stable_dict()`` equal.

gemma3 and a windowed stack have no one-pass prefill: the group's
``prefill`` raises ``NotImplementedError`` and the serving loop ingests
the prompt token by token through the group's step, as on one device.
The port's meshes repeat the CPU device.
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
from repro_torch.launch import compiled, data_parallel, serve
from repro_torch.launch import tensor_parallel as tpm
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model, step_writes
from repro_torch.runtime import guard

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _tensor_parallel_ring_reference as rref  # noqa: E402
from _tp_common import (  # noqa: E402,F401
    CPU, KINDS, MESHES, ROOT, at as _at, bf16_ulp, cpu_mesh,
    fp32_one_thread, reference_env, walk as _walk)

ARCH = rref.ARCH
PLEN, GEN = rref.PLEN, rref.GEN


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test;
    (process, npz path)."""
    path = tmp_path_factory.mktemp("tp_ring") / "reference.npz"
    proc = subprocess.Popen(
        [sys.executable,
         str(ROOT / "tests" / "_tensor_parallel_ring_reference.py"),
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
def gemma3():
    """Reduced gemma3-27b over the reference's weights: (cfg, reference
    params as numpy, the port's params)."""
    rparams = jax.tree.map(np.asarray, RModel(
        rget_config(ARCH).reduced()).init(jax.random.key(0)))
    return get_config(ARCH).reduced(), rparams, \
        params_from_numpy(rparams, "cpu")


def _prompts(cfg, ragged=False):
    return torch.from_numpy(rref.ragged(cfg.vocab) if ragged
                            else rref.prompts(cfg.vocab))


def _groups(model, params, shape):
    return data_parallel.serving_replicas(model, params, cpu_mesh(*shape),
                                          CPU, "test")


class _StepLog:
    """Every group's decode-step logits over a run, by group (each
    replica's group steps its own rows): :meth:`steps` gives them with
    the rows in batch order."""

    def __init__(self, monkeypatch):
        self.by_group: dict = {}
        real = tpm.TensorParallel.decode_step

        def logged(tp, *args):
            logits, cache = real(tp, *args)
            self.by_group.setdefault(id(tp), []).append(logits.clone())
            return logits, cache
        monkeypatch.setattr(tpm.TensorParallel, "decode_step", logged)

    def steps(self, n: int) -> np.ndarray:
        groups = list(self.by_group.values())
        return torch.stack([torch.cat([g[i] for g in groups])
                            for i in range(n)]).float().numpy()


# ---------------------------------------------------------------------------
# what is served, and how it splits (no reference run needed)
# ---------------------------------------------------------------------------

def _windowed_cfg():
    return rref.windowed_cfg(get_config("chatglm3-6b").reduced())


@pytest.mark.parametrize("which", ["gemma3-27b", "gemma3-27b reduced",
                                   "chatglm3-6b window 8",
                                   "granite-moe-3b-a800m window 8"])
def test_a_model_axis_serves_gemma3_and_windowed_stacks(which):
    """A shard's config keeps ``window`` and ``hybrid``, so its model
    builds the rings and the layer stacks one device builds."""
    arch, _, rest = which.partition(" ")
    cfg = get_config(arch)
    if rest == "reduced":
        cfg = cfg.reduced()
    elif rest:
        cfg = dataclasses.replace(cfg.reduced(), window=8)
    assert tpm.unserved(cfg) is None
    scfg = tpm.Layout(cfg, 2).shard_cfg()
    assert (scfg.window, scfg.hybrid) == (cfg.window, cfg.hybrid)
    assert tpm.unserved(scfg) is None


@pytest.mark.parametrize("t", [2, 4])
def test_the_full_width_gemma3_layouts(t):
    """gemma3-27b: 32 heads over 16 KV heads (groups of 2), ``d_ff``
    21,504, vocab 262,144 and a head width of 128 all divide over 2 and
    4 shards."""
    cfg = get_config(ARCH)
    layout = tpm.Layout(cfg, t)
    scfg = layout.shard_cfg()
    assert (scfg.n_heads, scfg.n_kv_heads, scfg.d_ff, scfg.vocab,
            scfg.head_dim) == (32 // t, 16 // t, 21_504 // t,
                               262_144 // t, 128)
    assert layout.vocab_split
    assert [layout.kv_heads(s) for s in range(t)] == \
        [(s * 16 // t, 16 // t) for s in range(t)]
    assert layout.cut("attn.wk", t - 1) == (-1, (16 - 16 // t) * 128,
                                            16 * 128)
    assert scfg.window == 1024 and scfg.hybrid == cfg.hybrid


def _one_layer(tree: dict, path: tuple, idx: tuple) -> dict:
    """One layer's tree of a stack: every leaf at ``idx`` of its leading
    axes, as the reference's model code meets it inside its scan."""
    stack = _at(tree, path)
    return {k: ({n: a[idx] for n, a in v.items()} if isinstance(v, dict)
                else v[idx]) for k, v in stack.items()}


@pytest.mark.parametrize("t", [2, 4])
def test_shard_params_are_the_partition_spec_slices(t, gemma3):
    """Each shard's ``super/local``, ``super/global`` and ``tail`` equal,
    layer by layer, the slices ``param_specs`` gives one layer's tree over
    a (1, t) mesh, leaf for leaf, the embedding its vocab rows; at t = 4
    the two KV heads do not split four ways, and shard s holds KV head
    s // 2 whole.  On the stacked tree the reference's rule for MoE
    expert stacks takes the FFN stacks' third axis from the end (the
    tail's layer axis) as their expert axis and maps it to ``model``:
    pinned here, and not followed."""
    cfg, rparams, params = gemma3
    stacked = rpartition.param_specs(rparams, {"data": 1, "model": t})
    assert tuple(stacked["tail"]["ffn"]["w_gate"]) == \
        (("model", None, None) if t == 2 else (None, None, None))
    assert tuple(stacked["super"]["local"]["attn"]["wq"]) == \
        (None, None, None, "model")
    layout = tpm.Layout(cfg, t)
    hd = cfg.head_dim
    shards = [tpm.shard_params(params, layout, s) for s in range(t)]
    for mine in shards:
        assert sorted(p for p, _ in _walk(mine)) == \
            sorted(p for p, _ in _walk(rparams))
        assert all(v.is_contiguous() for _, v in _walk(mine))
        assert all(v.data_ptr() != _at(params, p).data_ptr()
                   for p, v in _walk(mine))
    v = cfg.vocab // t
    for s in range(t):
        np.testing.assert_array_equal(shards[s]["embed"].numpy(),
                                      rparams["embed"][s * v:(s + 1) * v])
    n_super = rparams["super"]["global"]["ln1"].shape[0]
    layers = [(("super", "local"), (i, j)) for i in range(n_super)
              for j in range(5)] + \
        [(("super", "global"), (i,)) for i in range(n_super)] + \
        [(("tail",), (i,)) for i in range(len(cfg.hybrid.tail))]
    for path, idx in layers:
        layer = _one_layer(rparams, path, idx)
        specs = rpartition.param_specs(layer, {"data": 1, "model": t})
        for s in range(t):
            mine = _one_layer(shards[s], path, idx)
            for leaf, want in _walk(layer):
                got = _at(mine, leaf).numpy()
                if t == 4 and leaf[-1] in ("wk", "wv"):
                    kv = s // 2
                    np.testing.assert_array_equal(
                        got, want[..., kv * hd:(kv + 1) * hd])
                    continue
                for axis, name in enumerate(tuple(_at(specs, leaf))):
                    if name == "model":
                        size = want.shape[axis] // t
                        want = np.take(want,
                                       range(s * size, (s + 1) * size),
                                       axis=axis)
                np.testing.assert_array_equal(got, want,
                                              err_msg=str((path, idx, leaf)))


def test_shard_params_refuses_any_other_tree():
    """recurrentgemma's stacks (its refusal comes first when served) and
    a stack with an unknown leaf group."""
    cfg = get_config("recurrentgemma-2b").reduced()
    params = Model(cfg).init(seed=0, device="meta")
    layout = tpm.Layout(get_config(ARCH).reduced(), 2)
    with pytest.raises(ValueError, match="no tensor-parallel split for "
                                         r"\['super', 'tail'\]"):
        tpm.shard_params(params, layout, 0)
    g = Model(get_config(ARCH).reduced()).init(seed=0, device="meta")
    g["tail"]["cross"] = g["tail"]["attn"]
    with pytest.raises(ValueError, match=r"split for \['cross'\]"):
        tpm.shard_params(g, layout, 0)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("max_len", [40, 80])
def test_each_shards_cache_holds_rings_of_its_kv_heads(t, max_len, gemma3):
    """gemma3: rings of ``min(window, max_len)`` for the 5 · n_super + 2
    local layers and full ``global`` caches, each over the shard's KV
    heads; a windowed uniform stack: ``self``, ``max_len`` long, as one
    device has it."""
    cfg, _, params = gemma3
    tp, _ = tpm.build(Model(cfg), params, [CPU] * t)
    cache = tp.init_cache(3, max_len)
    assert sorted(cache) == list(range(t))
    nk = tp.layout.kv_heads(0)[1]
    for s in range(t):
        assert sorted(cache[s]) == ["global", "local"]
        for leaf in ("k", "v"):
            assert cache[s]["local"][leaf].shape == \
                (7, 3, min(cfg.window, max_len), nk, cfg.head_dim)
            assert cache[s]["global"][leaf].shape == \
                (1, 3, max_len, nk, cfg.head_dim)
    wcfg = _windowed_cfg()
    wtp, _ = tpm.build(Model(wcfg), Model(wcfg).init(seed=0, device="cpu"),
                       [CPU] * t)
    wcache = wtp.init_cache(3, max_len)
    assert all(sorted(c) == ["self"] and c["self"]["k"].shape ==
               (wcfg.n_layers, 3, max_len, wtp.layout.kv_heads(0)[1],
                wcfg.head_dim) for c in wcache.values())


def test_step_writes_on_a_shards_cache_returns_every_shards_ring_and_global_slot(
        gemma3):
    """The guard's undo: every shard's ring slot ``pos % window`` and its
    global slot ``pos`` (views into the shards' caches)."""
    cfg, _, params = gemma3
    tp, _ = tpm.build(Model(cfg), params, [CPU] * 2)
    cache = tp.init_cache(2, 80)
    pos = 70
    writes = step_writes(cache, pos)
    assert len(writes) == 2 * 4
    for w in writes:
        w.fill_(1.0)
    for s in range(2):
        for leaf in ("k", "v"):
            ring, full = cache[s]["local"][leaf], cache[s]["global"][leaf]
            assert (ring[:, :, pos % cfg.window] == 1).all()
            assert (full[:, :, pos] == 1).all()
            assert ring.sum() == ring[:, :, pos % cfg.window].numel()
            assert full.sum() == full[:, :, pos].numel()


def test_the_kv_heads_a_shard_duplicates_hold_equal_values(gemma3):
    """Pinned divergence, the rings too: at t = 4 over two KV heads the
    reference's ``cache_specs`` splits the rings' and the global caches'
    sequence axis over the shards (sequence parallelism); the port gives
    each shard its query heads' KV head whole, duplicated on two shards
    (``Layout.kv_heads``, as for the uniform stacks).  After the same
    steps the duplicates are equal bit
    for bit, and equal to one device's cache of that head within fp32
    reassociation."""
    cfg, rparams, params = gemma3
    rcache = jax.eval_shape(lambda: RModel(rget_config(ARCH).reduced())
                            .init_cache(2, 80))
    specs = rpartition.cache_specs(rcache, {"data": 1, "model": 4})
    for group in ("local", "global"):
        assert tuple(specs[group]["k"]) == (None, "data", "model", None,
                                            None)
    # 69 positions: the rings of 64 have wrapped
    seq = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 69)))
    one = Model(cfg)
    cache1 = one.init_cache(2, 70, device="cpu")
    tp, ps = tpm.build(one, params, [CPU] * 4)
    cache = tp.init_cache(2, 70)
    for t in range(seq.shape[1]):
        one.decode_step(params, cache1, seq[:, t], t)
        tp.decode_step(ps, cache, seq[:, t], t)
    for group in ("local", "global"):
        for leaf in ("k", "v"):
            whole = cache1[group][leaf]
            for s in range(4):
                mine = cache[s][group][leaf]
                if s % 2:
                    assert torch.equal(mine, cache[s - 1][group][leaf])
                want = whole[..., s // 2:s // 2 + 1, :]
                assert (mine - want).abs().max() <= \
                    1e-5 * want.abs().max()


@pytest.mark.parametrize("which", ["gemma3", "windowed"])
def test_a_groups_prefill_refuses_rings_and_windows(which, gemma3):
    """The one-pass body would attend without the ring: the group's
    ``prefill`` raises, and the serving loop ingests instead."""
    if which == "gemma3":
        cfg, _, params = gemma3
    else:
        cfg = _windowed_cfg()
        params = Model(cfg).init(seed=0, device="cpu")
    tp, ps = tpm.build(Model(cfg), params, [CPU] * 2)
    with pytest.raises(NotImplementedError, match="token by token"):
        tp.prefill(ps, _prompts(cfg)[:, :8], 16)


@pytest.mark.parametrize("entry", ["generate", "guarded_generate"])
def test_gemma3_under_an_optflag_raises_before_any_work(entry, gemma3,
                                                        monkeypatch):
    cfg, _, params = gemma3
    monkeypatch.setattr(tpm, "shard_params", lambda *a, **k: pytest.fail(
        "the params were split"))
    with optflags.optimizations({"gqagroup"}), \
            pytest.raises(NotImplementedError, match="'model': 2.*optflags"):
        serve.generate(Model(cfg), params, _prompts(cfg), 2, PLEN + 2,
                       mesh=cpu_mesh(1, 2),
                       guarded=entry == "guarded_generate", device="cpu")


def test_the_serve_cli_serves_gemma3_over_a_model_axis(capsys, monkeypatch):
    """``serve --mesh`` given a (1, 2) mesh (through the mesh function it
    calls) serves one device's tokens."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen", "4", "--device", "cpu"]
    serve.main(argv)
    plain = capsys.readouterr().out
    monkeypatch.setattr(serve, "make_serve_mesh",
                        lambda *a, **k: cpu_mesh(1, 2))
    serve.main(argv + ["--mesh"])
    meshed = capsys.readouterr().out

    def sample(out):
        return [line for line in out.splitlines() if "sample out" in line]
    assert "devices=2" in meshed
    assert sample(plain) and sample(meshed) == sample(plain)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_the_references_sharded_runs_fail_on_this_jax(reference):
    """Pinned: the reference serves none of these on its mesh here, so its
    unsharded run is what the port's sharded run is held to.  If a later
    JAX serves them, this fails and the port is to be held to the sharded
    run."""
    errors = reference["meta"]["sharded_errors"]
    serving = [f"gemma3/generate/{d}x{t}" for d, t in MESHES] + \
        ["gemma3/logits", "gemma3/ragged_eos", "bf16/gemma3"] + \
        [f"guarded/{s}" for s in ("healthy", "transient", "dense_switch")] + \
        [f"windowed/{k}" for k in KINDS]
    assert sorted(errors) == sorted(serving)
    for name in serving:
        assert errors[name] is not None and \
            errors[name].startswith("ShardingTypeError: "), (name, errors)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_generate_over_a_model_axis_equals_the_reference(shape, gemma3,
                                                         reference,
                                                         monkeypatch):
    """Tokens, and the logits of every ingest step and every decode step
    of the same run (the serving loop's last step, after the last token
    it keeps, has no counterpart in the reference's run)."""
    cfg, _, params = gemma3
    log = _StepLog(monkeypatch)
    toks, _, _ = serve.generate(Model(cfg), params, _prompts(cfg), GEN,
                                PLEN + GEN, mesh=cpu_mesh(*shape),
                                device="cpu")
    assert toks.dtype == torch.int32 and toks.device == CPU
    np.testing.assert_array_equal(toks.numpy(), reference["gemma3/tokens"])
    assert len(log.by_group) == shape[0]
    assert [len(g) for g in log.by_group.values()] == \
        [PLEN + GEN] * shape[0]
    want = reference["gemma3/logits"]
    got = log.steps(PLEN + GEN - 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_ragged_prompts_with_eos_equal_the_reference(gemma3, reference):
    """(1, 2): each row ingested alone at its real length into its row of
    every shard's rings (``write_slot``), then decoded at its own
    position."""
    cfg, _, params = gemma3
    eos = int(reference["gemma3/eos_id"])
    toks, _, _ = serve.generate(Model(cfg), params, _prompts(cfg, True),
                                GEN, PLEN + GEN, mesh=cpu_mesh(1, 2),
                                prompt_pad_id=0, eos_id=eos, pad_id=-3,
                                device="cpu")
    want = reference["gemma3/ragged_eos"]
    np.testing.assert_array_equal(toks.numpy(), want)
    assert (want[0, 2:] == -3).all()           # row 0 ended on its EOS


def test_bf16_over_a_model_axis_is_within_the_references_spread(
        gemma3, reference, monkeypatch):
    """bf16 on (1, 2).  The bound: the reference's own jit-vs-eager spread
    on the full-sequence forward over the same inputs, plus one bf16 ulp
    of max|logits| for each all-reduce of a partial sum (two a layer).
    Every ingest step's logits are held to it; a row's decode logits
    while its tokens agree, and its tokens at every step whose top-2
    margin in the reference exceeds twice the bound."""
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.bfloat16)
    cfg, _, params = gemma3
    want = reference["bf16/gemma3/logits"]
    rtoks = reference["bf16/gemma3/tokens"]
    spread = np.abs(reference["bf16/gemma3/fwd_jit"]
                    - reference["bf16/gemma3/fwd_eager"]).max()
    bound = spread + 2 * cfg.n_layers * bf16_ulp(np.abs(want).max())
    groups = _groups(Model(cfg), params, (1, 2))
    toks, steps = compiled.greedy(groups.step(compiled.CompiledStep),
                                  groups, groups.params, _prompts(cfg), GEN)
    got = torch.stack(steps).float().numpy()
    assert np.abs(got[:PLEN - 1] - want[:PLEN - 1]).max() <= bound
    alive = np.ones(rtoks.shape[0], bool)
    compared = 0
    for i in range(GEN):
        at = PLEN - 1 + i
        err = np.abs(got[at] - want[at]).max(axis=-1)
        assert (err[alive] <= bound).all(), (i, err, bound)
        compared += alive.sum()
        top2 = np.sort(want[at], axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * bound
        same = toks[:, i].numpy() == rtoks[:, i]
        assert same[alive & sure].all(), (i, same, sure)
        alive &= same
    assert compared >= rtoks.size // 2


@dataclasses.dataclass(eq=False)
class _NanGroup(tpm.TensorParallel):
    """A group whose step's logits turn NaN the first ``left`` times at
    position ``at``; the failed step has also written NaN into everything
    it writes on every shard (each ring's slot ``at % window`` and each
    global slot ``at``), so the guard must restart from the caches as
    they were before it."""

    at: int = -1
    left: int = 0

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = super().decode_step(params, cache, tokens, pos)
        if int(pos) == self.at and self.left:
            self.left -= 1
            for t in step_writes(cache, self.at):
                t.fill_(float("nan"))
            logits = torch.full_like(logits, float("nan"))
        return logits, cache


@pytest.mark.parametrize("fault", ["healthy", "transient", "dense_switch"])
def test_guarded_generate_over_a_model_axis_equals_the_reference(
        fault, gemma3, reference):
    """(1, 2), the NaN at decode position 70, past the wrap at 64: once
    (retried), twice (the rest served by the dense model split as the
    group is)."""
    cfg, _, params = gemma3
    times = {"healthy": 0, "transient": 1, "dense_switch": 2}[fault]
    m = cpu_mesh(1, 2)
    groups = _groups(Model(cfg), params, (1, 2))
    tp = groups.models[0]
    groups.models[0] = _NanGroup(tp.shards, tp.layout, tp.devices,
                                 at=rref.NAN_AT if times else -1,
                                 left=times)
    toks, rep = guard.guarded_generate(groups, None, _prompts(cfg), GEN,
                                       mesh=m, dense_model=Model(cfg),
                                       device="cpu")
    np.testing.assert_array_equal(toks.numpy(), reference[f"guarded/{fault}"])
    assert rep.stable_dict() == reference["meta"]["reports"][fault]
    np.testing.assert_array_equal(toks.numpy(), reference["gemma3/tokens"])
    assert rep.switched_to_dense_at == \
        (rref.NAN_AT if fault == "dense_switch" else None)


@pytest.fixture(scope="module")
def windowed(reference):
    """The windowed stack's dense, bitmap and 2:4 models over the
    reference's weights and plans, each with the tree it serves."""
    rcfg = rref.windowed_cfg(rget_config("chatglm3-6b").reduced())
    rparams = jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.key(0)))
    cfg = _windowed_cfg()
    params = params_from_numpy(rparams, "cpu")
    out = {"dense": (Model(cfg), params)}
    for kind in ("bitmap", "nm"):
        plan = texec.ExecPlan.from_json(reference["meta"]["plans"][kind])
        assert {op.choice.kind for op in plan.ops} == {kind}
        out[kind] = serve.compressed_model(cfg, params, plan, device="cpu")
    return cfg, out


@pytest.mark.parametrize("kind", KINDS)
def test_a_windowed_stack_over_a_model_axis_serves_the_references_tokens(
        kind, windowed, reference):
    """(1, 2): the prompt ingested token by token through the group's
    step (each compressed shard on its own store's kernels' plain
    versions), its cache ``max_len`` long as one device's."""
    cfg, models = windowed
    model, params = models[kind]
    prompts = torch.from_numpy(rref.windowed_prompts(cfg.vocab))
    toks, _, _ = serve.generate(model, params, prompts, rref.W_GEN,
                                rref.W_PLEN + rref.W_GEN,
                                mesh=cpu_mesh(1, 2), device="cpu")
    np.testing.assert_array_equal(toks.numpy(),
                                  reference[f"windowed/{kind}"])
