"""The port's mixture-of-experts path against the reference's: the MoE
block, the model around it, its compressed store, guarded serving and the
mixer, on reduced granite-moe-3b-a800m and qwen3-moe-30b-a3b.

Both packages get the same weights (the reference's ``Model.init`` or
``moe_params`` through numpy) and the same plan (the port's search, whose
JSON equals the reference's, ``tests/test_torch_configs.py``).  fp32 runs
patch the compute dtype of the reference's ``layers``, ``attention`` and
``moe`` modules (``moe`` imports the name at import time, so patching
``layers`` alone leaves its einsums in bf16) and of the port's ``layers``;
they are held to 1e-5 · max|y|.  bf16 runs are held to the bound of
``tests/test_torch_bf16.py``: the reference's own jit-vs-eager spread plus
one bf16 ulp.  ``moe_block`` inputs are built so that gates tie (equal
router columns: ``jax.lax.top_k`` puts the lower index first, and so must
the port) and experts overflow their capacity (repeated tokens); the test
asserts that both happen.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.launch import mixer as rmixer
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import moe as rmoe
from repro.models.transformer import Model as RModel
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.runtime import guard as rguard
from repro.runtime import inject as rinject
from repro_torch import exec as texec
from repro_torch.configs import MoECfg, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.launch import mixer, serve
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.transformer import Model
from repro_torch.obs import metrics as ometrics
from repro_torch.obs import trace as otrace
from repro_torch.runtime import guard, inject, integrity

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
GEN = 4
#: the reduced MoE block, and the full configs' expert counts and top-k
#: at the reduced width
MOE_CASES = {
    "reduced": None,
    "granite-e40-k8": MoECfg(n_experts=40, top_k=8, d_expert=64,
                             router_group=16),
    "qwen3-e128-k8": MoECfg(n_experts=128, top_k=8, d_expert=64,
                            router_group=16),
}


@contextlib.contextmanager
def _compute(dtype: str):
    """Both packages' compute dtype: "fp32" or "bf16"."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (RL, rattn, rmoe):
            mp.setattr(mod, "COMPUTE_DTYPE", jdt)
        mp.setattr(L, "COMPUTE_DTYPE", tdt)
        yield


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _held(got: np.ndarray, jit, eager, dtype: str, ulps: int = 1) -> None:
    """``got`` against the reference's jitted output: fp32 within 1e-5 of
    its largest magnitude, bf16 within the reference's jit-vs-eager spread
    (``eager()`` runs it under ``jax.disable_jit``) plus ``ulps`` bf16 ulps
    of it."""
    jit = np.asarray(jit, np.float32)
    scale = np.abs(jit).max()
    if dtype == "fp32":
        tol = 1e-5 * scale
    else:
        with jax.disable_jit():
            spread = np.abs(jit - np.asarray(eager(), np.float32)).max()
        tol = spread + ulps * _bf16_ulp(scale)
    assert np.abs(got - jit).max() <= tol


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block_case(name: str):
    """(reference cfg, port cfg, params, x): router columns 0 to top_k
    equal (their gates tie, inside the top k and across its edge; two
    tokens along that column put them first), ten copies of one token in
    each row's first routing group (its experts overflow)."""
    rcfg = rget_config("granite-moe-3b-a800m").reduced()
    cfg = get_config("granite-moe-3b-a800m").reduced()
    if MOE_CASES[name] is not None:
        m = MOE_CASES[name]
        rcfg = dataclasses.replace(rcfg, moe=type(rcfg.moe)(
            **dataclasses.asdict(m)))
        cfg = dataclasses.replace(cfg, moe=m)
    rp = jax.tree.map(np.array, rmoe.moe_params(jax.random.key(1), rcfg))
    rp["router"][:, 1:cfg.moe.top_k + 1] = rp["router"][:, :1]
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    x[:, 1:10] = x[:, :1]
    # tokens along the tied column: the tied gates lead, top k and beyond
    x[:, 16:18] = 8 * rp["router"][:, 0] / np.linalg.norm(rp["router"][:, 0])
    return rcfg, cfg, rp, x


def _routing(xg: np.ndarray, router: np.ndarray, cfg):
    """What the reference's routing does with fp32 ``xg`` (groups, t, d):
    rows whose k-th and (k+1)-th gates tie, rows with a tie inside the top
    k, and the (token, slot) pairs past their expert's capacity."""
    m = cfg.moe
    grp, k = xg.shape[1], m.top_k
    logits = np.asarray(jnp.einsum("gtd,de->gte", xg, router), np.float32)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    g = -np.sort(-gates, axis=-1)
    boundary = int((g[..., k - 1] == g[..., k]).sum())
    inside = int((g[..., :k - 1] == g[..., 1:k]).any(-1).sum())
    tope = np.asarray(jax.lax.top_k(jnp.asarray(gates), k)[1])
    load = np.zeros((xg.shape[0], m.n_experts), int)
    dropped = 0
    for s in range(k):                       # slot-major, as the block
        for t in range(grp):
            for gi in range(xg.shape[0]):
                e = tope[gi, t, s]
                dropped += load[gi, e] >= rmoe._capacity(grp, cfg)
                load[gi, e] += 1
    return boundary, inside, dropped


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_the_reference(case, dtype):
    rcfg, cfg, rp, x = _block_case(case)
    grp = min(cfg.moe.router_group, x.shape[1])
    boundary, inside, dropped = _routing(
        x.reshape(-1, grp, cfg.d_model), rp["router"], rcfg)
    assert boundary > 0 and dropped > 0, (boundary, inside, dropped)
    if cfg.moe.top_k > 2:
        assert inside > 0
    p = {k: _t(v) for k, v in rp.items()}
    with _compute(dtype):
        xj = jnp.asarray(x).astype(RL.COMPUTE_DTYPE)
        want = jax.jit(lambda x, p: rmoe.moe_block(x, p, rcfg))(xj, rp)
        got = moe.moe_block(_t(x).to(L.COMPUTE_DTYPE), p, cfg)
        assert got.dtype == L.COMPUTE_DTYPE and got.shape == x.shape
        _held(got.float().numpy(), want,
              lambda: rmoe.moe_block(xj, rp, rcfg), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_decode_matches_the_reference(case, dtype):
    """One token a routing group: capacity 4, no drops, every expert runs
    its 4 slots; the tied gates still pick the lower index."""
    rcfg, cfg, rp, x = _block_case(case)
    x = x[:, 0]
    assert moe._capacity(1, cfg) == rmoe._capacity(1, rcfg) == 4
    p = {k: _t(v) for k, v in rp.items()}
    with _compute(dtype):
        xj = jnp.asarray(x).astype(RL.COMPUTE_DTYPE)
        want = jax.jit(lambda x, p: rmoe.moe_decode(x, p, rcfg))(xj, rp)
        got = moe.moe_decode(_t(x).to(L.COMPUTE_DTYPE), p, cfg)
        _held(got.float().numpy(), want,
              lambda: rmoe.moe_decode(xj, rp, rcfg), dtype)


def test_a_token_count_that_splits_a_routing_group_raises():
    """The reference's reshape into whole routing groups raises a
    ``TypeError``; so does the port, and neither pads nor truncates."""
    rcfg, cfg, rp, x = _block_case("reduced")
    x = x[:, :20]                          # 40 tokens, groups of 16
    with pytest.raises(TypeError):
        rmoe.moe_block(jnp.asarray(x), rp, rcfg)
    with pytest.raises(TypeError, match="routing groups"):
        moe.moe_block(_t(x), {k: _t(v) for k, v in rp.items()}, cfg)


# ---------------------------------------------------------------------------
# the model, its store and compressed serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    rcfg, cfg = rget_config(name).reduced(), get_config(name).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    return dict(name=name, rcfg=rcfg, cfg=cfg, rparams=rparams,
                params=params_from_numpy(jax.tree.map(np.asarray, rparams),
                                         "cpu"),
                toks=np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_model_prefill_and_decode_match_the_reference(arch, dtype):
    """Logits of a prefill and a decode step.  bf16: the port rounds where
    the reference run eagerly does, and lies within a bf16 ulp of it at
    most elements; a summation order that flips one rounding before the
    last takes a second ulp, so the bound is the spread plus two."""
    rcfg, cfg, toks = arch["rcfg"], arch["cfg"], arch["toks"]
    rmodel, model = RModel(rcfg), Model(cfg)
    jt = jnp.asarray(toks, jnp.int32)
    with _compute(dtype):
        want, rcache = jax.jit(lambda p, t: rmodel.prefill(p, t, 12))(
            arch["rparams"], jt)
        got, cache = model.prefill(arch["params"], _t(toks), 12)
        _held(got.numpy(), want,
              lambda: rmodel.prefill(arch["rparams"], jt, 12)[0], dtype,
              ulps=2)
        nxt = jnp.asarray(np.asarray(jnp.argmax(want[:, -1], -1), np.int32))
        pos = jnp.asarray(8, jnp.int32)
        want_d, _ = jax.jit(rmodel.decode_step)(arch["rparams"], rcache, nxt,
                                                pos)
        got_d, _ = model.decode_step(arch["params"], cache,
                                     _t(nxt).long(), torch.tensor(8))
        _held(got_d.numpy(), want_d,
              lambda: rmodel.decode_step(arch["rparams"], rcache, nxt,
                                         pos)[0], dtype, ulps=2)


_BUILT: dict = {}


def _compressed(arch: dict, kind: str) -> dict:
    """Both packages' pruned weights, stores and fp32 greedy tokens from
    one plan (the port's search; its JSON is the reference's), built once
    a module for each model and plan."""
    key = (arch["name"], kind)
    if key in _BUILT:
        return _BUILT[key]
    rcfg, cfg = arch["rcfg"], arch["cfg"]
    plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    rpruned = rexec.prune_params(arch["rparams"], rplan, rcfg)
    rstore = rexec.compress_params(rpruned, rplan, rcfg)
    cm, pruned = serve.compressed_model(cfg, arch["params"], plan,
                                        device="cpu")
    with _compute("fp32"):
        rtoks = rexec.CompressedModel(RModel(rcfg), rstore).generate(
            rpruned, jnp.asarray(arch["toks"], jnp.int32), GEN)[0]
        toks, _, _ = cm.generate(pruned, _t(arch["toks"]), GEN,
                                 device="cpu")
    _BUILT[key] = dict(arch, kind=kind, plan=plan, rpruned=rpruned,
                       rstore=rstore, cm=cm, pruned=pruned,
                       rtoks=np.asarray(rtoks), ptoks=toks.numpy())
    return _BUILT[key]


@pytest.fixture(params=["bitmap", "nm"])
def compressed(request, arch):
    return _compressed(arch, request.param)


@pytest.fixture
def bitmap(arch):
    return _compressed(arch, "bitmap")


def test_pruned_weights_equal_the_references(compressed):
    want = jax.tree.map(np.asarray, compressed["rpruned"])
    got = jax.tree.map(lambda t: t.numpy(), compressed["pruned"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    ffn = compressed["pruned"]["blocks"]["ffn"]
    cfg = compressed["cfg"]
    assert ffn["w_gate"].shape == (cfg.n_layers, cfg.moe.n_experts,
                                   cfg.d_model, cfg.moe.d_expert)
    assert ffn["router"] is compressed["params"]["blocks"]["ffn"]["router"]


def test_store_equals_the_references(compressed):
    """Entries, kinds, stored and dense bits, the ratio (whole and per
    role) and the checksums, expert entries included: one entry per
    (layer, role, expert)."""
    store, rstore, cfg = compressed["cm"].store, compressed["rstore"], \
        compressed["cfg"]
    assert set(store.entries) == set(rstore.entries)
    assert len(store) == len(rstore) == cfg.n_layers * (
        4 + 3 * cfg.moe.n_experts)
    for key, r in rstore.entries.items():
        e = store.entries[key]
        assert (e.layer, e.role, e.expert, e.kind) == \
            (r.layer, r.role, r.expert, r.kind)
        assert (e.dense_bits, e.stored_bits) == (r.dense_bits, r.stored_bits)
        assert (e.expert >= 0) == e.role.startswith("moe.")
    assert store.achieved_ratio() == rstore.achieved_ratio()
    assert store.ratio_report() == rstore.ratio_report()
    assert store.plan.checksums == rstore.plan.checksums
    assert set(store.plan.checksums) == {op.role for op in store.plan.ops}
    assert store.verify() == {r: "ok" for r in store.plan.checksums}


def test_experts_take_no_part_in_the_kernels_bound(compressed):
    """The dispatcher's naive bitmap bound covers the attention roles
    only (the reference's ``dispatch.py``: experts never reach a
    kernel)."""
    with texec.dispatch.active(compressed["cm"].store) as disp:
        assert set(disp._t_max) <= {"attn.wq", "attn.wk", "attn.wv",
                                    "attn.wo"}
        if compressed["kind"] == "bitmap":
            assert set(disp._t_max) == {"attn.wq", "attn.wk", "attn.wv",
                                        "attn.wo"}


def test_compressed_greedy_tokens_equal_the_references(compressed):
    assert compressed["ptoks"].dtype == np.int32
    np.testing.assert_array_equal(compressed["ptoks"], compressed["rtoks"])


def test_expert_matmuls_launch_no_kernel(compressed, monkeypatch):
    """Four projections a layer reach a kernel's wrapper, the experts
    none: 4 · L · (1 + GEN) calls of the plan's wrapper in a generate."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("bitmap_spmm", "nm_spmm"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    cfg = compressed["cfg"]
    with _compute("fp32"):
        compressed["cm"].generate(compressed["pruned"],
                                  _t(compressed["toks"]), GEN, device="cpu")
    kname = "bitmap_spmm" if compressed["kind"] == "bitmap" else "nm_spmm"
    assert calls == [kname] * (4 * cfg.n_layers * (1 + GEN))


# ---------------------------------------------------------------------------
# guarded serving: a bit flip in an expert entry
# ---------------------------------------------------------------------------

def test_an_expert_bit_flip_is_caught_and_its_role_demoted(bitmap):
    """A flipped bit in one expert's entry: ``verify`` names its role,
    the guard demotes the role (every expert entry of it goes), and the
    tokens are the healthy run's, since the experts run dense either way;
    the report equals the reference's."""
    rcfg = bitmap["rcfg"]
    rpruned, rstore = bitmap["rpruned"], bitmap["rstore"]
    cm, pruned = bitmap["cm"], bitmap["pruned"]
    where = dict(role="moe.w_up", layer=1, expert=3)
    bad = inject.bitflip_payload(cm.store, **where)
    rbad = rinject.bitflip_payload(rstore, **where)
    assert [k for k in bad.entries
            if not torch.equal(bad.entries[k].data.blocks,
                               cm.store.entries[k].data.blocks)] == \
        [(1, "moe.w_up", 3)]
    with pytest.raises(integrity.IntegrityError) as ei:
        bad.verify()
    assert ei.value.role == "moe.w_up" and \
        ei.value.reason == "checksum_mismatch"
    demoted = texec.CompressedModel(cm.model, bad).demoted(["moe.w_up"])
    assert not any(k[1] == "moe.w_up" for k in demoted.store.entries)
    prompts = bitmap["toks"]
    with _compute("fp32"):
        with rtrace.tracing() as rtr:
            rt, rrep = rguard.guarded_generate(
                rexec.CompressedModel(RModel(rcfg), rbad), rpruned,
                jnp.asarray(prompts, jnp.int32), GEN)
        with otrace.tracing() as tr:
            toks, rep = guard.guarded_generate(
                texec.CompressedModel(cm.model, bad), pruned, prompts, GEN,
                device="cpu")
        healthy, _, _ = cm.generate(pruned, _t(prompts), GEN, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(toks.numpy(), healthy.numpy())
    assert rep.stable_dict() == rrep.stable_dict()
    assert rep.verify["moe.w_up"] == "checksum_mismatch"
    assert [f["role"] for f in rep.fallbacks] == ["moe.w_up"]
    assert tr.stable_trace() == rtr.stable_trace()


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

PLENS = [5, 9, 13, 5, 9, 13]
MAX_NEW = [6, 7, 8, 6, 7, 8]


def test_a_mixer_stream_equals_the_references(bitmap):
    """Six requests (three prompt lengths, each within one routing group)
    over three slots, freed slots reused, through both packages' mixers
    on the compressed model:
    each request's tokens, ``events``, the stable trace and the counters.
    A request's tokens depend on its routing group, so the stream is held
    to the reference's mixer, whose admissions are batch 1 too."""
    rcfg, cfg = bitmap["rcfg"], bitmap["cfg"]
    rpruned, cm, pruned = bitmap["rpruned"], bitmap["cm"], bitmap["pruned"]
    rcm = rexec.CompressedModel(RModel(rcfg), bitmap["rstore"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, (p,)).astype(np.int32)
               for p in PLENS]
    out = {}
    with _compute("fp32"):
        for name, mod, tr, met, model, params, conv in (
                ("ref", rmixer, rtrace, rmetrics, rcm, rpruned,
                 lambda p: jnp.asarray(p, jnp.int32)),
                ("port", mixer, otrace, ometrics, cm, pruned, lambda p: p)):
            reqs = [mod.Request(uid=f"r{i}", prompt=conv(p),
                                max_new=MAX_NEW[i])
                    for i, p in enumerate(prompts)]
            with tr.tracing() as tracer, met.collecting() as reg:
                results, mx = model.serve_mixed(params, reqs, slots=3,
                                                max_len=48)
            counters = {k: v for k, v in reg.snapshot()["counters"].items()
                        if "straggler" not in k}
            out[name] = dict(tokens=[np.asarray(r.tokens) for r in results],
                             events=mx.events, trace=tracer.stable_trace(),
                             counters=counters,
                             reports=[r.report.stable_dict()
                                      for r in results])
    ref_, port = out["ref"], out["port"]
    for want, got in zip(ref_["tokens"], port["tokens"]):
        np.testing.assert_array_equal(got, want)
    assert port["events"] == ref_["events"]
    assert port["trace"] == ref_["trace"]
    assert port["counters"] == ref_["counters"]
    assert port["reports"] == ref_["reports"]


# ---------------------------------------------------------------------------
# the MoE decode step reads nothing back to the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["dense", "compressed"])
@pytest.mark.parametrize("kind", ["scalar", "per-row"])
def test_moe_decode_step_reads_nothing_back_to_the_host(arch, which, kind,
                                                         monkeypatch):
    """``tests/test_torch_compiled.py``'s dispatch mode over a MoE decode
    step: no ``.item()``, ``nonzero``, boolean indexing or host copy
    outside the kernels' CPU branch, so the step captures into a CUDA
    graph like the dense one."""
    from test_torch_compiled import PLAIN_VERSIONS, _HostReads, _unwatched
    cfg = arch["cfg"]
    params = arch["params"]
    model = Model(cfg)
    if which == "compressed":
        built = _compressed(arch, "bitmap")
        model, params = built["cm"], built["pruned"]
    toks = _t(np.random.default_rng(5).integers(0, cfg.vocab, (2, 10)))
    _, cache = model.prefill(params, toks[:, :8], 12)
    model.decode_step(params, cache, toks[:, 8], torch.tensor(8))
    pos = torch.tensor(9 if kind == "scalar" else [9, 9])
    mode = _HostReads()
    for name in PLAIN_VERSIONS:
        monkeypatch.setattr(ref, name, _unwatched(mode, getattr(ref, name)))
    with mode:
        logits, _ = model.decode_step(params, cache, toks[:, 9], pos)
    assert mode.found == []
    assert logits.shape == (2, cfg.vocab)
