"""Port compressed serving vs the reference, on reduced chatglm3-6b at fp32.

Both packages get the same plan (the reference's ``build_exec_plan``
through its JSON) and the same weights (the reference's ``Model.init``
through numpy).  The reference runs as its own serving tests run it
(tests/test_serve.py): Pallas kernels in interpret mode, fp32 compute.
Logits are held to 1e-4 (test_serve.py:91-143); greedy tokens must be
identical.  Both kernel variants are served (``pipeline_default(False)``
switches both packages to the naive kernels), and the kernel-failure
guard is held against the reference's.
"""

import json

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
from repro.exec import dispatch as rdispatch
from repro.kernels import ops as rkops
from repro.models.transformer import Model as RModel
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.exec import dispatch
from repro_torch.exec import plans as tplans
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
GEN = 4


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


def _tokens(vocab, b=2, s=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _fail(kind):
    raise RuntimeError(f"injected kernel failure: {kind}")


@pytest.fixture(scope="module", params=["bitmap", "nm"])
def served(request, fp32):
    """The reference's compressed serving artifacts and the port's model
    built from the same plan JSON and weights."""
    kind = request.param
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    rpruned = rexec.prune_params(rparams, plan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, plan, rcfg))
    toks = _tokens(cfg.vocab)
    rlogits, _ = rcm.prefill(rpruned, jnp.asarray(toks, jnp.int32), 12)
    rgen, _, _ = rcm.generate(rpruned, jnp.asarray(toks, jnp.int32), GEN)
    with rexec.instrument() as rcounters:
        rcm.hidden_states_unrolled(rpruned, jnp.asarray(toks, jnp.int32))
    with rkops.pipeline_default(False):
        rlogits_naive, _ = rcm.prefill(rpruned, jnp.asarray(toks, jnp.int32),
                                       12)
        rgen_naive, _, _ = rcm.generate(rpruned, jnp.asarray(toks, jnp.int32),
                                        GEN)
    rguard = []
    with rkops.kernel_fault_hook(_fail), \
            rexec.kernel_guard(lambda role, e: rguard.append(role)):
        rcm.prefill(rpruned, jnp.asarray(toks, jnp.int32), 12)

    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    tplan = texec.ExecPlan.from_json(plan.to_json())
    cm, pruned = serve.compressed_model(cfg, params, tplan, device="cpu")
    return dict(kind=kind, cfg=cfg, rcm=rcm, rpruned=rpruned, toks=toks,
                rlogits=np.asarray(rlogits), rgen=np.asarray(rgen),
                rcounters=rcounters, plan=plan, cm=cm, pruned=pruned,
                params=params, rlogits_naive=np.asarray(rlogits_naive),
                rgen_naive=np.asarray(rgen_naive), rguard=set(rguard))


def test_prune_params_matches_reference_exactly(served):
    for group in ("attn", "ffn"):
        for leaf, w in served["pruned"]["blocks"][group].items():
            np.testing.assert_array_equal(
                w.numpy(), np.asarray(served["rpruned"]["blocks"][group][leaf]),
                err_msg=f"{group}.{leaf}")


def test_store_matches_reference(served):
    """Same payload arrays, entry for entry, and the same exact accounting."""
    rstore, store = served["rcm"].store, served["cm"].store
    assert set(rstore.entries) == set(store.entries)
    for key, r in rstore.entries.items():
        e = store.entries[key]
        assert (e.kind, e.dense_bits, e.stored_bits) == \
            (r.kind, r.dense_bits, r.stored_bits), key
        names = ("blocks", "counts", "row_ids", "offsets") \
            if e.kind == "bitmap" else ("values", "indices")
        for name in names:
            np.testing.assert_array_equal(
                getattr(e.data, name).numpy(),
                np.asarray(getattr(r.data, name)), err_msg=f"{key} {name}")
    assert store.ratio_report() == rstore.ratio_report()


def test_compressed_prefill_logits_match_reference(served):
    logits, cache = served["cm"].prefill(
        served["pruned"], torch.from_numpy(served["toks"]), 12)
    assert logits.shape == served["rlogits"].shape
    assert tuple(cache["self"]["k"].shape) == (2, 2, 12, 2, 32)
    np.testing.assert_allclose(logits.numpy(), served["rlogits"],
                               rtol=1e-4, atol=1e-4)


def test_greedy_tokens_match_reference(served):
    toks, t_prefill, t_gen = served["cm"].generate(
        served["pruned"], torch.from_numpy(served["toks"]), GEN,
        device="cpu")
    np.testing.assert_array_equal(toks.numpy(), served["rgen"])
    assert t_prefill > 0 and t_gen > 0


def test_decode_matches_prefill_at_every_position(served):
    cm, pruned = served["cm"], served["pruned"]
    toks = torch.from_numpy(served["toks"])
    logits, _ = cm.prefill(pruned, toks, 10)
    cache = cm.init_cache(2, 10, device="cpu")
    for t in range(toks.shape[1]):
        lg, cache = cm.decode_step(pruned, cache, toks[:, t], t)
        np.testing.assert_allclose(lg.numpy(), logits[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"position {t}")


def test_batch_of_3_equals_stacked_batch_of_1(served):
    cm, pruned = served["cm"], served["pruned"]
    prompts = torch.from_numpy(_tokens(served["cfg"].vocab, b=3, seed=5))
    batched, _, _ = cm.generate(pruned, prompts, GEN, device="cpu")
    singles = torch.cat([cm.generate(pruned, prompts[i:i + 1], GEN,
                                     device="cpu")[0] for i in range(3)])
    assert torch.equal(batched, singles), (batched, singles)


def test_compressed_tokens_equal_dense_tokens(served):
    """At fp32 compressed serving changes only the summation order, which
    greedy argmax absorbs (the reference's acceptance on bitmap plans,
    test_serve.py:164; the port holds N:M plans to it too)."""
    prompts = torch.from_numpy(served["toks"])
    dense, _, _ = serve.generate(Model(served["cfg"]), served["pruned"],
                                 prompts, GEN + 2, 8 + GEN + 2,
                                 device="cpu")
    comp, _, _ = served["cm"].generate(served["pruned"], prompts, GEN + 2,
                                       device="cpu")
    assert torch.equal(dense, comp), (dense, comp)


def test_instrument_counters_match_reference(served):
    """Per-role traffic of one forward equals the reference's unrolled
    per-layer counters."""
    with texec.instrument() as counters:
        served["cm"].hidden_states(served["pruned"],
                                   torch.from_numpy(served["toks"]))
    rc = served["rcounters"]
    assert set(counters) == set(rc) == {op.role for op in served["plan"].ops}
    for role, c in counters.items():
        r = rc[role]
        assert c.calls == r.calls == served["cfg"].n_layers
        for f in ("w_fetch_bits", "x_bits", "y_bits", "macs", "decode_ops"):
            assert getattr(c, f) == pytest.approx(getattr(r, f)), (role, f)


def test_eos_pads_after_each_rows_eos(served):
    cm, pruned = served["cm"], served["pruned"]
    prompts = torch.from_numpy(served["toks"])
    free, _, _ = cm.generate(pruned, prompts, GEN, device="cpu")
    eos = int(free[0, 1])
    got, _, _ = cm.generate(pruned, prompts, GEN, device="cpu", eos_id=eos,
                            pad_id=-7)
    want = free.clone()
    for r in range(want.shape[0]):
        hits = (free[r] == eos).nonzero()
        if hits.numel():
            want[r, int(hits[0]) + 1:] = -7
    assert torch.equal(got, want), (got, want)


@pytest.mark.parametrize("with_eos", [False, True])
def test_generate_returns_int32_tokens_equal_to_reference(served, with_eos):
    """Both ``generate``s return int32 tokens, equal, with and without an
    EOS id (rows pad with ``pad_id`` after their EOS)."""
    kw = dict(eos_id=int(served["rgen"][0, 1]), pad_id=-7) if with_eos \
        else {}
    rtoks, _, _ = served["rcm"].generate(
        served["rpruned"], jnp.asarray(served["toks"], jnp.int32), GEN, **kw)
    toks, _, _ = served["cm"].generate(
        served["pruned"], torch.from_numpy(served["toks"]), GEN,
        device="cpu", **kw)
    assert rtoks.dtype == jnp.int32 and toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rtoks))
    if with_eos:
        assert (toks == -7).any()


def test_dispatch_returns_the_activation_dtype(served):
    """Kernels emit fp32; the dispatcher casts back to ``x.dtype``
    (reference dispatch.py:245), here bf16 activations."""
    from repro_torch.exec import dispatch
    w = served["pruned"]["blocks"]["attn"]["wq"][0]
    x = torch.ones(3, w.shape[0], dtype=torch.bfloat16)
    with dispatch.active(served["cm"].store), L.layer_ctx(0):
        y = L.proj(x, w, "attn.wq")
    assert y.dtype == torch.bfloat16 and y.shape == (3, w.shape[1])
    np.testing.assert_allclose(y.float().numpy(),
                               (x.float() @ w).to(torch.bfloat16).float()
                               .numpy(), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# naive kernels, kernel guard
# ---------------------------------------------------------------------------

def test_naive_prefill_logits_match_reference(served):
    with ops.pipeline_default(False):
        logits, _ = served["cm"].prefill(
            served["pruned"], torch.from_numpy(served["toks"]), 12)
    np.testing.assert_allclose(logits.numpy(), served["rlogits_naive"],
                               rtol=1e-4, atol=1e-4)


def test_naive_greedy_tokens_match_reference(served):
    with ops.pipeline_default(False):
        toks, _, _ = served["cm"].generate(
            served["pruned"], torch.from_numpy(served["toks"]), GEN,
            device="cpu")
    np.testing.assert_array_equal(toks.numpy(), served["rgen_naive"])


def test_pipeline_default_reaches_every_kernel_call(served, monkeypatch):
    """Serving never threads the knob: ``pipeline_default`` alone picks
    the variant of every sparse call, and bitmap calls carry the role's
    static bound."""
    calls = []
    bitmap, nm = ops._bitmap, ops._nm
    monkeypatch.setattr(ops, "_bitmap", lambda x, w, t_max, pipeline: (
        calls.append((pipeline, t_max)), bitmap(x, w, t_max, pipeline))[1])
    monkeypatch.setattr(ops, "_nm", lambda x, w, pipeline: (
        calls.append((pipeline, None)), nm(x, w, pipeline))[1])
    cm, pruned = served["cm"], served["pruned"]
    toks = torch.from_numpy(served["toks"])
    with ops.pipeline_default(False):
        cm.prefill(pruned, toks, 12)
    naive = calls[:]
    cm.prefill(pruned, toks, 12)
    sparse = [op for op in served["plan"].ops
              if op.choice.kind in ("bitmap", "nm")]
    assert len(naive) == len(calls) - len(naive) \
        == len(sparse) * served["cfg"].n_layers > 0
    assert {p for p, _ in naive} == {False}
    assert {p for p, _ in calls[len(naive):]} == {True}
    t_max = dispatch._Dispatcher(cm.store)._t_max
    assert {t for _, t in naive} <= set(t_max.values()) | {None}


def test_dispatcher_t_max_matches_reference(served):
    """The per-role max-over-layers bound (reference dispatch.py:200-207)."""
    t_max = dispatch._Dispatcher(served["cm"].store)._t_max
    assert t_max == rdispatch._Dispatcher(served["rcm"].store)._t_max
    assert set(t_max) == {op.role for op in served["plan"].ops
                          if op.choice.kind == "bitmap"}


def test_fault_hook_propagates_without_kernel_guard(served):
    with ops.kernel_fault_hook(_fail), \
            pytest.raises(ops.KernelFault, match="injected kernel failure"):
        served["cm"].prefill(served["pruned"],
                             torch.from_numpy(served["toks"]), 12)


def test_kernel_guard_lets_build_and_launch_failures_raise(served,
                                                           monkeypatch):
    """Only injected faults are demoted to dense: a kernel that fails to
    build or launch raises under the guard too, and the sink hears
    nothing."""
    def broken(*args):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(ops, "_bitmap", broken)
    monkeypatch.setattr(ops, "_nm", broken)
    failed = []
    with texec.kernel_guard(lambda role, e: failed.append(role)), \
            pytest.raises(RuntimeError, match="kernel build failed"):
        served["cm"].prefill(served["pruned"],
                             torch.from_numpy(served["toks"]), 12)
    assert failed == []


def test_kernel_guard_demotes_failing_roles_to_dense(served):
    """Every sparse role fails: the sink hears of the same roles as the
    reference's guard (the port once per layer, the reference once per
    trace, so sets are compared), nothing is recorded for a failed call,
    and the forward is the dense model's bit for bit."""
    cm, pruned = served["cm"], served["pruned"]
    toks = torch.from_numpy(served["toks"])
    failed = []
    with ops.kernel_fault_hook(_fail), texec.instrument() as counters, \
            texec.kernel_guard(lambda role, e: failed.append((role, e))):
        logits, _ = cm.prefill(pruned, toks, 12)
    sparse = {op.role for op in served["plan"].ops
              if op.choice.kind in ("bitmap", "nm")}
    assert {r for r, _ in failed} == served["rguard"] == sparse
    assert len(failed) == len(sparse) * served["cfg"].n_layers
    assert all(isinstance(e, ops.KernelFault)
               and "injected kernel failure" in str(e) for _, e in failed)
    assert not set(counters) & sparse
    dense, _ = Model(served["cfg"]).prefill(pruned, toks, 12)
    assert torch.equal(logits, dense)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,reduce,sparsity", [
    ("chatglm3-6b.bitmap.json", False, "bitmap"),
    ("chatglm3-6b.nm.json", False, "nm"),
    ("chatglm3-6b.reduced.bitmap.json", True, "bitmap"),
])
def test_shipped_plans_equal_a_fresh_search(name, reduce, sparsity):
    """The shipped JSONs are what the reference's search writes with the
    serve CLI's settings (tokens=64, value_bits=32)."""
    rcfg = rget_config("chatglm3-6b")
    if reduce:
        rcfg = rcfg.reduced()
    fresh = rexec.build_exec_plan(rcfg, SPARSITY[sparsity], tokens=64,
                                  search_cfg=FAST, value_bits=32)
    shipped = (tplans.PLANS_DIR / name).read_text()
    assert json.loads(shipped) == json.loads(fresh.to_json())
    cfg = get_config("chatglm3-6b")
    if reduce:
        cfg = cfg.reduced()
    plan = tplans.load_plan(tplans.PLANS_DIR / name, cfg)
    assert plan.to_json() == fresh.to_json()
    assert plan == tplans.shipped_plan(cfg, sparsity)


def test_plan_checks_roles_and_version():
    reduced = get_config("chatglm3-6b").reduced()
    with pytest.raises(tplans.PlanMismatchError):
        tplans.load_plan(tplans.PLANS_DIR / "chatglm3-6b.bitmap.json",
                         reduced)
    with pytest.raises(FileNotFoundError):
        tplans.shipped_plan(reduced, "nm")
    d = json.loads((tplans.PLANS_DIR / "chatglm3-6b.nm.json").read_text())
    d["version"] = tplans.PLAN_VERSION + 1
    with pytest.raises(tplans.PlanVersionError):
        tplans.ExecPlan.from_dict(d)


# ---------------------------------------------------------------------------
# no fallback, serving surface
# ---------------------------------------------------------------------------

def test_default_device_raises_without_cuda():
    """Entry points default to the card and never move to the CPU on
    their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("chatglm3-6b").reduced()
    params = Model(cfg).init(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.compressed_model(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(Model(cfg), params, torch.zeros(1, 4, dtype=torch.long),
                       2, 6)


def test_ragged_prompts_and_overlong_requests_raise():
    """Ragged (left-padded) prompts serve, each row as it is served alone
    (``tests/test_torch_mixer.py`` holds them to the reference); an
    overlong request raises."""
    cfg = get_config("chatglm3-6b").reduced()
    params = Model(cfg).init(seed=0, device="cpu")
    ragged = torch.tensor([[0, 0, 5, 6], [1, 2, 3, 4]])
    toks, _, _ = serve.generate(Model(cfg), params, ragged, 2, 6,
                                prompt_pad_id=0, device="cpu")
    for r, row in enumerate(([5, 6], [1, 2, 3, 4])):
        alone, _, _ = serve.generate(Model(cfg), params, torch.tensor([row]),
                                     2, 6, device="cpu")
        assert torch.equal(toks[r], alone[0]), r
    prompts = torch.ones(2, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="exceeds"):
        serve.generate(Model(cfg), params, prompts, 4, 6, device="cpu")
    assert serve._rate(5, 0.0) == 5 / 1e-9


def test_serve_cli_reduced_on_cpu(capsys):
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--batch", "2",
                "--prompt-len", "4", "--gen", "2", "--compressed",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "compressed: ratio=0.500" in out
    assert "prefill 8 tok" in out and "decode  4 tok" in out
