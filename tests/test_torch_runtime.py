"""The port's serving runtime (integrity, fault injection, the step guard
and guarded generation) vs the reference's, on reduced chatglm3-6b at
fp32.

Both packages get the same weights (the reference's ``Model.init`` through
numpy) and the same plan (the reference's ``build_exec_plan`` through its
JSON), bitmap and 2:4.  Held equal to the reference: each role's sha256
digest and the plan JSON that records them; the bytes each store-level
injector corrupts; ``verify_report`` for every structural corruption, with
and without recorded checksums; and, under every fault class of
``tests/test_runtime.py`` (none, a bit flip caught by verify, a NaN
payload with verify off, a kernel failure, poisoned activations, a zero
deadline, EOS), the guarded greedy tokens, ``HealthReport.stable_dict()``,
the stable trace and the counters of a metrics snapshot.  The reference's
results are built once for the module.  Deliberate divergences pinned
here: the guarded path retries only non-finite logits and injected
kernel faults (any other ``RuntimeError`` propagates); non-finite logits
that the kernels' plain versions over the same store do not give raise
instead of being served by the dense model; and a dense switch at a
decode position re-steps that position over the cache the failed
attempts wrote, leaving every earlier position as it was.
"""

import contextlib
import dataclasses
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
from repro.models.transformer import Model as RModel
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.runtime import fault as rfault
from repro.runtime import guard as rguard
from repro.runtime import inject as rinject
from repro.runtime import integrity as rintegrity
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import compiled, serve
from repro_torch.models import layers as L
from repro_torch.obs import metrics as ometrics
from repro_torch.obs import trace as otrace
from repro_torch.runtime import fault, guard, inject, integrity

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
GEN = 4
BITMAP_MODES = [m for m in inject.STRUCTURAL_MODES if m != "nm_indices_oob"]


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


def _build(kind):
    """Both packages' compressed stores from one plan JSON and the
    reference's own weights."""
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                 search_cfg=FAST, value_bits=32)
    rpruned = rexec.prune_params(rparams, plan, rcfg)
    rstore = rexec.compress_params(rpruned, plan, rcfg)
    tplan = texec.ExecPlan.from_json(plan.to_json())
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(cfg, params, tplan, device="cpu")
    role = next(op.role for op in plan.ops if op.choice.kind == kind)
    return dict(kind=kind, cfg=cfg, rmodel=RModel(rcfg), rpruned=rpruned,
                rstore=rstore, tplan=tplan, cm=cm, pruned=pruned, role=role)


@pytest.fixture(scope="module")
def bitmap(fp32):
    return _build("bitmap")


@pytest.fixture(scope="module")
def nm(fp32):
    return _build("nm")


@pytest.fixture(params=["bitmap", "nm"])
def built(request):
    return request.getfixturevalue(request.param)


def _strip(store, cls):
    return cls(dataclasses.replace(store.plan, checksums={}), store.entries)


def _arrays(entry) -> dict:
    """An entry's payload and metadata as host bytes, by name."""
    d = entry.data
    names = {"bitmap": ("blocks", "counts", "row_ids", "offsets"),
             "nm": ("values", "indices")}.get(entry.kind)
    if names is None:
        return {"w": np.asarray(d).tobytes()}
    return {n: np.asarray(getattr(d, n)).tobytes() for n in names}


# ---------------------------------------------------------------------------
# checksums and the plan that records them
# ---------------------------------------------------------------------------

def test_checksums_equal_the_reference(built):
    rstore, store = built["rstore"], built["cm"].store
    assert set(store.plan.checksums) == {op.role for op in store.plan.ops}
    assert store.plan.checksums == rstore.plan.checksums
    assert integrity.checksum_store(store) == \
        rintegrity.checksum_store(rstore)
    assert built["tplan"].checksums == {}     # compress returns a new plan
    assert json.loads(store.plan.to_json()) == \
        json.loads(rstore.plan.to_json())
    assert texec.ExecPlan.from_json(store.plan.to_json()) == store.plan
    assert store.verify() == {r: "ok" for r in store.plan.checksums}
    assert built["cm"].verify() == store.verify()


# ---------------------------------------------------------------------------
# injectors and verification
# ---------------------------------------------------------------------------

def _injections(kind):
    yield "bitflip seed 0", lambda m, s, r: m.bitflip_payload(s, r)
    yield "bitflip seed 3 layer 1", \
        lambda m, s, r: m.bitflip_payload(s, r, layer=1, seed=3)
    yield "nan seed 5", lambda m, s, r: m.poison_payload_nan(s, r, seed=5)
    for mode in (BITMAP_MODES if kind == "bitmap" else ["nm_indices_oob"]):
        yield mode, lambda m, s, r, mode=mode: m.corrupt_structure(s, r, mode)


@pytest.mark.parametrize("kind,name", [
    (kind, name) for kind in ("bitmap", "nm")
    for name, _ in _injections(kind)])
def test_injectors_corrupt_the_same_bytes(kind, name, request):
    b = request.getfixturevalue(kind)
    inj = dict(_injections(kind))[name]
    rbad = inj(rinject, b["rstore"], b["role"])
    bad = inj(inject, b["cm"].store, b["role"])
    changed = 0
    for key, r in rbad.entries.items():
        got, want = _arrays(bad.entries[key]), _arrays(r)
        assert got == want, (name, key)
        changed += got != _arrays(b["cm"].store.entries[key])
    assert changed == 1                       # one entry, and a copy of it
    assert integrity.checksum_store(bad) == rintegrity.checksum_store(rbad)
    assert integrity.verify_report(bad) == rintegrity.verify_report(rbad)


@pytest.mark.parametrize("stripped", [False, True])
@pytest.mark.parametrize("kind,mode", [("bitmap", m) for m in BITMAP_MODES]
                         + [("nm", "nm_indices_oob")])
def test_verify_report_equals_the_reference(kind, mode, stripped, request):
    """Structural breaks are caught by the invariants alone (checksums
    stripped), with the reference's reason, role and layer."""
    b = request.getfixturevalue(kind)
    rstore, store = b["rstore"], b["cm"].store
    if stripped:
        rstore = _strip(rstore, rexec.CompressedStore)
        store = _strip(store, texec.CompressedStore)
        assert set(store.verify().values()) == {"ok"}
    rbad = rinject.corrupt_structure(rstore, b["role"], mode)
    bad = inject.corrupt_structure(store, b["role"], mode)
    report = integrity.verify_report(bad)
    assert report == rintegrity.verify_report(rbad)
    assert report[b["role"]] == inject.STRUCTURAL_MODES[mode]
    with pytest.raises(integrity.IntegrityError) as ei:
        bad.verify()
    with pytest.raises(rintegrity.IntegrityError) as rei:
        rbad.verify()
    assert (ei.value.role, ei.value.reason, ei.value.layer) == \
        (rei.value.role, rei.value.reason, rei.value.layer) == \
        (b["role"], inject.STRUCTURAL_MODES[mode], 0)


def test_unknown_corruption_mode_rejected(bitmap):
    with pytest.raises(ValueError, match="unknown corruption mode"):
        inject.corrupt_structure(bitmap["cm"].store, bitmap["role"],
                                 "melt_the_weights")


def test_demoted_roles_fall_through_to_dense(bitmap):
    """``CompressedModel.demoted`` drops the roles' store entries: the
    dense matmul over the pruned weights serves them, the rest keeps its
    kernels, and the tokens do not change."""
    cm, pruned, role = bitmap["cm"], bitmap["pruned"], bitmap["role"]
    demoted = cm.demoted([role])
    assert all(key[1] != role for key in demoted.store.entries)
    assert len(demoted.store.entries) == \
        len(cm.store.entries) - bitmap["cfg"].n_layers
    prompts = _prompts(bitmap["cfg"])
    toks, _, _ = demoted.generate(pruned, prompts, GEN, device="cpu")
    want, _, _ = cm.generate(pruned, prompts, GEN, device="cpu")
    assert torch.equal(toks, want)


# ---------------------------------------------------------------------------
# guarded generation vs the reference, under every fault class
# ---------------------------------------------------------------------------

def _prompts(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))


def _scenario(name, rt, model_cls, b, store, dense, eos):
    """(model, guarded_generate kwargs, context) of one scenario for one
    package; ``rt`` is its runtime.inject module."""
    role, none = b["role"], contextlib.nullcontext
    return {
        "healthy": lambda: (model_cls(dense, store), {}, none()),
        "bitflip": lambda: (model_cls(dense, rt.bitflip_payload(store, role)),
                            {}, none()),
        "nan_payload": lambda: (
            model_cls(dense, rt.poison_payload_nan(store, role)),
            {"verify": False}, none()),
        "kernel_failure": lambda: (model_cls(dense, store), {},
                                   rt.kernel_failure()),
        "poison_activations": lambda: (model_cls(dense, store), {},
                                       rt.poison_activations("ffn.w_up")),
        "deadline": lambda: (model_cls(dense, store),
                             {"deadline_s": 0.0, "pad_id": -7}, none()),
        "eos": lambda: (model_cls(dense, store),
                        {"eos_id": eos, "pad_id": -3}, none()),
    }[name]()


SCENARIOS = ["healthy", "bitflip", "nan_payload", "kernel_failure",
             "poison_activations", "deadline", "eos"]


def _observed(tracing, collecting, run):
    with tracing() as tracer, collecting() as reg:
        toks, rep = run()
    snap = reg.snapshot()
    return dict(tokens=np.asarray(toks), report=rep.stable_dict(),
                healthy=rep.healthy, trace=tracer.stable_trace(),
                counters=snap["counters"])


@pytest.fixture(scope="module")
def guarded_runs(bitmap):
    """Every scenario through both packages' ``guarded_generate``."""
    prompts = _prompts(bitmap["cfg"])
    out, eos = {}, None
    for name in SCENARIOS:
        rm, rkw, rctx = _scenario(name, rinject, rexec.CompressedModel,
                                  bitmap, bitmap["rstore"], bitmap["rmodel"],
                                  eos)
        m, kw, ctx = _scenario(name, inject, texec.CompressedModel, bitmap,
                               bitmap["cm"].store, bitmap["cm"].model, eos)
        with rctx:
            want = _observed(rtrace.tracing, rmetrics.collecting,
                             lambda: rguard.guarded_generate(
                                 rm, bitmap["rpruned"],
                                 jnp.asarray(prompts, jnp.int32), GEN,
                                 **rkw))
        with ctx:
            got = _observed(otrace.tracing, ometrics.collecting,
                            lambda: guard.guarded_generate(
                                m, bitmap["pruned"], prompts, GEN,
                                device="cpu", **kw))
        out[name] = (got, want)
        if name == "healthy":
            # EOS: row 0's second healthy token
            eos = int(want["tokens"][0, 1])
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_guarded_generate_equals_the_reference(guarded_runs, name):
    got, want = guarded_runs[name]
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["report"] == want["report"]
    assert got["healthy"] == want["healthy"] == (name in ("healthy", "eos"))
    assert got["trace"] == want["trace"]
    assert got["counters"] == want["counters"]


def test_the_fault_classes_recover_to_the_healthy_tokens(guarded_runs,
                                                         bitmap):
    """What each fault class must do (tests/test_runtime.py), in the
    port's own run: every recovery gives the healthy tokens."""
    healthy = guarded_runs["healthy"][0]["tokens"]
    rep = {n: guarded_runs[n][0]["report"] for n in SCENARIOS}
    assert rep["healthy"]["fallbacks"] == [] and \
        set(rep["healthy"]["verify"].values()) == {"ok"}
    assert rep["bitflip"]["verify"][bitmap["role"]] == "checksum_mismatch"
    assert rep["bitflip"]["switched_to_dense_at"] is None
    for name in ("nan_payload", "poison_activations"):
        assert rep[name]["switched_to_dense_at"] == -1
        assert rep[name]["dense_steps"] == GEN and rep[name]["retries"] == 1
        assert [f["code"] for f in rep[name]["fallbacks"]] == \
            ["nonfinite_logits"]
    kernel_roles = {op.role for op in bitmap["tplan"].ops
                    if op.choice.kind in ("bitmap", "nm")}
    assert {f["role"] for f in rep["kernel_failure"]["fallbacks"]} == \
        kernel_roles
    assert {f["code"] for f in rep["kernel_failure"]["fallbacks"]} == \
        {"kernel_failure"}
    for name in ("bitflip", "nan_payload", "kernel_failure",
                 "poison_activations"):
        np.testing.assert_array_equal(guarded_runs[name][0]["tokens"],
                                      healthy)
    deadline = guarded_runs["deadline"][0]
    assert rep["deadline"]["deadline_hit"] and rep["deadline"]["steps"] < GEN
    assert (deadline["tokens"][:, rep["deadline"]["steps"]:] == -7).all()
    eos = guarded_runs["eos"][0]["tokens"][0]
    assert (eos[list(eos).index(healthy[0, 1]) + 1:] == -3).all()


def test_serve_generate_guarded_passthrough(bitmap, guarded_runs):
    out = serve.generate(bitmap["cm"], bitmap["pruned"],
                         _prompts(bitmap["cfg"]), GEN, 12, guarded=True,
                         device="cpu")
    assert len(out) == 4
    toks, t_prefill, t_decode, rep = out
    assert isinstance(rep, guard.HealthReport) and rep.healthy
    assert t_prefill == rep.t_prefill_s and t_decode == rep.t_decode_s
    np.testing.assert_array_equal(toks.numpy(),
                                  guarded_runs["healthy"][1]["tokens"])
    with pytest.raises(NotImplementedError, match="equal-length"):
        serve.generate(bitmap["cm"], bitmap["pruned"],
                       _prompts(bitmap["cfg"]), GEN, 12, guarded=True,
                       prompt_pad_id=0, device="cpu")
    with pytest.raises(TypeError, match="guarded=True"):
        serve.generate(bitmap["cm"], bitmap["pruned"],
                       _prompts(bitmap["cfg"]), GEN, 12, deadline_s=1.0,
                       device="cpu")


def test_guarded_cli_prints_the_health_line(capsys):
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--compressed",
                "--guarded", "--batch", "2", "--prompt-len", "4", "--gen",
                "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "health: healthy=True" in out and "steps=2/2" in out


# ---------------------------------------------------------------------------
# the port's guarded path: what the card relies on
# ---------------------------------------------------------------------------

class _Recording(compiled.CompiledStep):
    """A compiled step that records, at each call, its model, position
    and whether a graph could serve it (a CUDA device, no hook)."""

    calls: list = []

    def __call__(self, params, cache, tokens, pos):
        self.calls.append((self.model, int(pos),
                           compiled.compiles(torch.device("cuda", 0))))
        return super().__call__(params, cache, tokens, pos)


def test_the_kernel_guard_is_installed_only_with_a_fault_hook(
        bitmap, monkeypatch):
    """A healthy guarded decode runs every step through ``CompiledStep``
    with nothing that keeps it off a graph; an injected kernel failure
    installs the guard, which serves eagerly."""
    monkeypatch.setattr(compiled, "CompiledStep", _Recording)
    monkeypatch.setattr(_Recording, "calls", [])
    cm, pruned = bitmap["cm"], bitmap["pruned"]
    prompts = _prompts(bitmap["cfg"])
    guard.guarded_generate(cm, pruned, prompts, GEN, device="cpu")
    assert [(m is cm, pos, graphed) for m, pos, graphed in
            _Recording.calls] == [(True, 8 + i, True) for i in range(GEN)]
    _Recording.calls.clear()
    with inject.kernel_failure():
        guard.guarded_generate(cm, pruned, prompts, GEN, device="cpu")
    assert [graphed for _, _, graphed in _Recording.calls] == [False] * GEN


class _PoisonAt(compiled.CompiledStep):
    """Every step at position ``at`` records the K / V of the positions
    before ``at`` as its input cache holds them."""

    at: int = 0
    seen: list = []

    def __call__(self, params, cache, tokens, pos):
        p = int(pos)
        if p == self.at:
            self.seen.append((self.model, [cache["self"][n][:, :, :p].clone()
                                           for n in ("k", "v")]))
        return super().__call__(params, cache, tokens, pos)


def _poison_compressed_step_at(monkeypatch, model, at: int) -> None:
    """A data fault at one decode position: whenever a projection hook is
    installed (the compressed model's step, and the plain-version witness
    over its store), never for the dense model alone, the step at ``at``
    writes NaN K / V there and gives NaN logits.  The step enqueued ahead
    on its token reads them, so it writes NaN K / V at ``at + 1``."""
    step = type(model).decode_step

    def poisoned(self, params, cache, tokens, pos):
        logits, cache = step(self, params, cache, tokens, pos)
        if int(pos) == at and L._PROJ_HOOK is not None:
            logits = torch.full_like(logits, float("nan"))
            for kv in cache["self"].values():
                kv[:, :, at] = float("nan")
        return logits, cache

    monkeypatch.setattr(type(model), "decode_step", poisoned)


def test_a_dense_switch_mid_decode_re_steps_over_the_same_cache(
        bitmap, monkeypatch):
    """A step that fails at decode position p is retried, then the dense
    model re-steps p on the cache the failed attempts wrote: every earlier
    position is as the compressed steps left it, and the tokens are the
    compressed model's before p and the dense model's from p on."""
    cm, pruned, cfg = bitmap["cm"], bitmap["pruned"], bitmap["cfg"]
    prompts = torch.from_numpy(_prompts(cfg))
    plen, p = prompts.shape[1], prompts.shape[1] + 2
    monkeypatch.setattr(compiled, "CompiledStep", _PoisonAt)
    monkeypatch.setattr(_PoisonAt, "at", p)
    monkeypatch.setattr(_PoisonAt, "seen", [])
    with monkeypatch.context() as mp:
        _poison_compressed_step_at(mp, cm.model, p)
        with otrace.tracing() as tracer:
            toks, rep = guard.guarded_generate(cm, pruned, prompts, GEN,
                                               device="cpu")
    assert rep.switched_to_dense_at == p and rep.retries == 1
    assert rep.dense_steps == GEN - (p - plen)
    assert [f["code"] for f in rep.fallbacks] == ["nonfinite_logits"]
    assert [e["name"] for e in tracer.stable_trace()
            if e.get("ph") == "i"] == ["retry", "dense_switch"]
    # two compressed attempts, then the dense step, all on one prefix
    assert [m is cm for m, _ in _PoisonAt.seen] == [True, True, False]
    first = _PoisonAt.seen[0][1]
    for _, kv in _PoisonAt.seen[1:]:
        assert all(torch.equal(a, b) for a, b in zip(kv, first))
    # eagerly: the compressed model's steps before p, the dense one's after
    logits, cache = cm.prefill(pruned, prompts, plen + GEN)
    tok, want = logits[:, -1].argmax(-1), []
    for t in range(plen, plen + GEN):
        want.append(tok)
        model = cm if t < p else cm.model
        logits, cache = model.decode_step(pruned, cache, tok, t)
        if t == p - 1:
            assert all(torch.equal(cache["self"][n][:, :, :p], kv) for n, kv
                       in zip(("k", "v"), first))
        tok = logits.argmax(-1)
    assert torch.equal(toks, torch.stack(want, 1).int())


def test_a_runtime_error_propagates_through_the_guard(bitmap, monkeypatch):
    """Deliberate divergence: the reference's step guard retries every
    ``RuntimeError`` and then serves dense.  The port's retries only
    non-finite logits and injected kernel faults, so a launch error (or a
    kernel that does not build) raises instead of being served by the
    plain matmul."""
    def launch_error(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(ops, "_bitmap", launch_error)
    with otrace.tracing() as tracer, \
            pytest.raises(RuntimeError, match="CUDA error"):
        guard.guarded_generate(bitmap["cm"], bitmap["pruned"],
                               _prompts(bitmap["cfg"]), GEN, device="cpu")
    assert not [e for e in tracer.stable_trace()
                if e["name"] in ("retry", "dense_switch", "demote")]


@pytest.mark.parametrize("where", ["prefill", "decode"])
def test_a_kernel_that_gives_nan_on_a_verified_store_raises(
        bitmap, monkeypatch, where):
    """A kernel whose output turns non-finite on good data (a race, an
    uninitialised read) is not served around: the retry fails, the plain
    versions over the same store give finite logits, and the guard raises
    with no dense switch."""
    cm, pruned, cfg = bitmap["cm"], bitmap["pruned"], bitmap["cfg"]
    prompts = _prompts(cfg)
    kernel = ops._bitmap

    def nan_at(x, w, t_max, pipeline):
        y = kernel(x, w, t_max, pipeline)
        if where == "prefill" or x.shape[0] == prompts.shape[0]:
            y = torch.full_like(y, float("nan"))
        return y

    monkeypatch.setattr(ops, "_bitmap", nan_at)
    with otrace.tracing() as tracer, \
            pytest.raises(guard.KernelNonFiniteError, match="plain versions"):
        guard.guarded_generate(cm, pruned, prompts, GEN, device="cpu")
    names = [e["name"] for e in tracer.stable_trace() if e.get("ph") == "i"]
    assert names == ["retry"]


def test_a_model_without_one_pass_prefill_ingests_token_by_token(bitmap):
    """``_NoPrefill``: the guarded path decodes the prompt step by step
    under the same guard; the tokens equal the one-pass prefill's."""
    cm, pruned = bitmap["cm"], bitmap["pruned"]
    prompts = _prompts(bitmap["cfg"])
    no_prefill = texec.CompressedModel(cm.model, cm.store)

    def prefill(*args, **kwargs):
        raise NotImplementedError("no one-pass prefill")

    no_prefill.prefill = prefill
    toks, rep = guard.guarded_generate(no_prefill, pruned, prompts, GEN,
                                       device="cpu")
    want, _ = guard.guarded_generate(cm, pruned, prompts, GEN, device="cpu")
    assert torch.equal(toks, want) and rep.healthy


def test_guard_without_a_dense_fallback_raises(bitmap):
    dense = bitmap["cm"].model
    with inject.poison_activations("ffn.w_up"), \
            pytest.raises(RuntimeError, match="no dense fallback"):
        guard.guarded_generate(bitmap["cm"], bitmap["pruned"],
                               _prompts(bitmap["cfg"]), GEN,
                               dense_model=bitmap["cm"], device="cpu")
    toks, rep = guard.guarded_generate(dense, bitmap["pruned"],
                                       _prompts(bitmap["cfg"]), GEN,
                                       device="cpu")
    assert rep.healthy and rep.verify == {} and toks.shape == (2, GEN)


# ---------------------------------------------------------------------------
# fault primitives (tests/test_runtime.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_step_guard_retries_then_succeeds(pkg):
    calls = {"n": 0}
    nonfinite = (guard if pkg == "port" else rguard).NonFiniteError

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise nonfinite("transient")
        return 42

    g = (fault if pkg == "port" else rfault).StepGuard(max_retries=2)
    assert g.run(7, flaky) == 42
    assert [e.action for e in g.events] == ["retry"]
    assert g.events[0].step == 7 and "transient" in g.events[0].error


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_step_guard_exhaustion_paths(pkg):
    nonfinite = (guard if pkg == "port" else rguard).NonFiniteError

    def failing():
        raise nonfinite("persistent")

    mod = fault if pkg == "port" else rfault
    g = mod.StepGuard(max_retries=1, on_restore=lambda: None)
    assert g.run(0, failing) is None
    assert [e.action for e in g.events] == ["retry", "restore"]
    g2 = mod.StepGuard(max_retries=0)
    with pytest.raises(RuntimeError, match="persistent"):
        g2.run(0, failing)


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("nvcc failed to build bitmap_spmm.cu"),
    OSError("libcuda.so: cannot open shared object file")])
def test_step_guard_retries_only_what_it_is_given(error):
    """Deliberate divergence: the reference's guard retries a
    ``RuntimeError`` or ``OSError`` and then restores; the port's retries
    only non-finite logits and kernel faults, so a launch or build error
    propagates at once with nothing recorded."""
    def failing():
        raise error

    ours = fault.StepGuard(max_retries=3, on_restore=lambda: None)
    with pytest.raises(type(error), match=str(error)[:12]):
        ours.run(0, failing)
    assert ours.events == []
    theirs = rfault.StepGuard(max_retries=3, on_restore=lambda: None)
    assert theirs.run(0, failing) is None
    assert [e.action for e in theirs.events] == ["retry"] * 3 + ["restore"]

    def kernel_fault():
        raise ops.KernelFault("injected")

    assert ours.run(1, kernel_fault) is None
    assert [e.action for e in ours.events] == ["retry"] * 3 + ["restore"]


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_elastic_remesh_proposals_and_replay(pkg):
    mod = fault if pkg == "port" else rfault
    assert mod.elastic_remesh(8, 2) == (4, 2)
    assert mod.elastic_remesh(7, 2) == (3, 2)          # odd survivor count
    assert mod.elastic_remesh(256, 16, pod_size=128) == (2, 8, 16)
    with pytest.raises(ValueError):
        mod.elastic_remesh(1, 2)                       # TP is pinned
    assert mod.replay_steps(4, 9) == range(4, 9)


def test_runtime_exports_the_references_names():
    import repro.runtime as rruntime
    import repro_torch.runtime as truntime
    assert truntime.__all__ == rruntime.__all__
    assert all(hasattr(truntime, n) for n in truntime.__all__)
