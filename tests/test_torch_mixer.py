"""The port's continuous-batching mixer and ragged serving vs the
reference, on reduced chatglm3-6b at fp32.

Both packages get the same weights (the reference's ``Model.init`` through
numpy) and, for the compressed models, the same plan (the reference's
``build_exec_plan`` through its JSON).  The streams are
``tests/test_mixer.py``'s: prompt lengths 3, 5, 7, 9, 11, 4, 6, 13 into 3
slots of max_len 48, with slots reused mid-stream.  Held equal to the
reference, per request: greedy tokens, the ``events`` list, the stable
trace, the counters and gauges of a metrics snapshot (timing histograms
and straggler series left out) and ``HealthReport.stable_dict()``, for the
dense model and both plans.  Sampled draws are the port's own (the
reference keys a JAX PRNG, which the port cannot reproduce): they are held
to two-run determinism.  Logits, where compared, to 1e-4 · max|logits|
(``test_torch_serve.py``'s bound); tokens exactly.
"""

import weakref

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
from repro.launch import mixer as rmixer
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import compiled, mixer, record, serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model
from repro_torch.obs import metrics as ometrics
from repro_torch.obs import trace as otrace

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
PLENS = [3, 5, 7, 9, 11, 4, 6, 13]
MAX_NEW = [6, 7, 8, 6, 7, 8, 6, 7]
SLOTS, MAX_LEN = 3, 48


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


def _prompts(vocab, plens, seed=0):
    """``tests/test_mixer.py::_stream``'s prompts, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (p,)).astype(np.int32) for p in plens]


def _requests(request_cls, prompts, max_new, to_prompt, **kw):
    return [request_cls(uid=f"r{i}", prompt=to_prompt(p),
                        max_new=max_new[i] if isinstance(max_new, list)
                        else max_new, **kw)
            for i, p in enumerate(prompts)]


def _traced_stream(mixer_cls, tracing, collecting, model, params, reqs):
    """Serve ``reqs`` under a tracer and a metrics registry (through
    ``serve_mixed`` for a compressed model) and keep what the reference
    and the port must agree on."""
    with tracing() as tracer, collecting() as reg:
        if hasattr(model, "serve_mixed"):
            results, mx = model.serve_mixed(params, reqs, slots=SLOTS,
                                            max_len=MAX_LEN)
        else:
            mx = mixer_cls(model, params, slots=SLOTS, max_len=MAX_LEN)
            results = mx.run(reqs)
    snap = reg.snapshot()
    return dict(
        tokens=[np.asarray(r.tokens) for r in results],
        events=mx.events, trace=tracer.stable_trace(),
        counters={k: v for k, v in snap["counters"].items()
                  if "straggler" not in k},
        gauges=snap["gauges"], histograms=snap["histograms"],
        reports=[r.report.stable_dict() for r in results],
        stats=mx.stats(), slots=[r.slot for r in results])


@pytest.fixture(scope="module", params=["dense", "bitmap", "nm"])
def streams(request, fp32):
    """One traced, collected stream through each package's mixer, on the
    dense model or a compressed model from the same plan JSON."""
    kind = request.param
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    rmodel, model = RModel(rcfg), Model(cfg)
    if kind != "dense":
        plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                     search_cfg=FAST, value_bits=32)
        rparams = rexec.prune_params(rparams, plan, rcfg)
        rmodel = rexec.CompressedModel(
            rmodel, rexec.compress_params(rparams, plan, rcfg))
        model, params = serve.compressed_model(
            cfg, params, texec.ExecPlan.from_json(plan.to_json()),
            device="cpu")
    prompts = _prompts(cfg.vocab, PLENS, seed=0 if kind == "dense" else 1)
    ref = _traced_stream(
        rmixer.Mixer, rtrace.tracing, rmetrics.collecting, rmodel, rparams,
        _requests(rmixer.Request, prompts, MAX_NEW,
                  lambda p: jnp.asarray(p, jnp.int32)))
    port = _traced_stream(
        mixer.Mixer, otrace.tracing, ometrics.collecting, model, params,
        _requests(mixer.Request, prompts, MAX_NEW, lambda p: p))
    return dict(kind=kind, cfg=cfg, model=model, params=params,
                prompts=prompts, ref=ref, port=port)


def test_greedy_tokens_equal_the_reference(streams):
    ref, port = streams["ref"], streams["port"]
    assert len(port["tokens"]) == len(PLENS)
    for i, (want, got) in enumerate(zip(ref["tokens"], port["tokens"])):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"r{i}")


def test_events_equal_the_reference(streams):
    """The same slots, admission steps and eviction reasons; the stream
    reuses freed slots."""
    ref, port = streams["ref"], streams["port"]
    assert port["events"] == ref["events"]
    assert port["slots"] == ref["slots"]
    st = port["stats"]
    assert st["admits"] == st["evictions"] == len(PLENS)
    assert st["slot_reuse_admits"] >= 1
    assert st["tokens"] == sum(MAX_NEW)
    assert {k: st[k] for k in ("steps", "tokens", "admits", "evictions",
                               "slot_reuse_admits")} == \
        {k: ref["stats"][k] for k in ("steps", "tokens", "admits",
                                      "evictions", "slot_reuse_admits")}


def test_stable_trace_equals_the_reference(streams):
    ref, port = streams["ref"], streams["port"]
    assert port["trace"] == ref["trace"]
    names = {ev["name"] for ev in port["trace"]}
    assert {"admit", "prefill", "slot_write", "decode_step", "token",
            "evict"} <= names


def test_metrics_snapshot_equals_the_reference(streams):
    """Counters and gauges equal; the decode-latency histogram counts the
    same steps (its buckets are wall-clock)."""
    ref, port = streams["ref"], streams["port"]
    assert port["counters"] == ref["counters"]
    assert port["gauges"] == ref["gauges"]
    assert port["counters"]["serve_tokens_generated_total"] == sum(MAX_NEW)
    (h,) = port["histograms"].values()
    (rh,) = ref["histograms"].values()
    assert h["count"] == rh["count"] == port["stats"]["steps"]


def test_health_reports_equal_the_reference(streams):
    ref, port = streams["ref"], streams["port"]
    assert port["reports"] == ref["reports"]
    assert port["reports"][0]["trace_id"] == "t:r0"


def test_each_request_equals_it_served_alone(streams):
    """The acceptance contract: a request decoded in the mixer gives the
    tokens it gets served alone at batch 1 through ``serve.generate``."""
    model, params = streams["model"], streams["params"]
    for i, (p, got) in enumerate(zip(streams["prompts"],
                                     streams["port"]["tokens"])):
        alone, _, _ = serve.generate(model, params,
                                     torch.from_numpy(p)[None, :],
                                     MAX_NEW[i], MAX_LEN, device="cpu")
        np.testing.assert_array_equal(alone[0].numpy(), got,
                                      err_msg=f"r{i}")


# ---------------------------------------------------------------------------
# the port's mixer alone: isolation, EOS, deadline, validation, sampling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense(fp32):
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


def _stream(cfg, plens, max_new, seed=0, **kw):
    return _requests(mixer.Request, _prompts(cfg.vocab, plens, seed),
                     max_new, lambda p: p, **kw)


def test_slot_reuse_isolation(dense):
    """A long predecessor fills its slot's KV deep; the successor admitted
    into the same slot decodes as if the cache were fresh."""
    cfg, model, params = dense
    long_req, short_req = _stream(cfg, [20, 4], [3, 8], seed=2)
    results = mixer.Mixer(model, params, slots=1, max_len=40).run(
        [long_req, short_req])
    assert results[0].slot == results[1].slot == 0
    assert results[1].admit_step > 0
    alone = mixer.Mixer(model, params, slots=1, max_len=40).run(
        [short_req])[0]
    np.testing.assert_array_equal(results[1].tokens, alone.tokens)


def test_eos_and_validation(dense):
    cfg, model, params = dense
    reqs = _stream(cfg, [4, 4], 6, seed=3)
    toks0 = mixer.Mixer(model, params, slots=2, max_len=24).run(
        reqs)[0].tokens
    eos = int(toks0[2])
    res = mixer.Mixer(model, params, slots=2, max_len=24, eos_id=eos,
                      pad_id=-7).run(reqs)[0]
    stop = int(np.nonzero(toks0 == eos)[0][0])
    np.testing.assert_array_equal(res.tokens[:stop + 1], toks0[:stop + 1])
    assert (res.tokens[stop + 1:] == -7).all()
    assert res.report.eos_hit and res.n_tokens == stop + 1

    with pytest.raises(ValueError, match="unique"):
        mixer.Mixer(model, params, slots=2, max_len=24).run(
            [reqs[0], reqs[0]])
    with pytest.raises(ValueError, match="exceeds max_len"):
        mixer.Mixer(model, params, slots=1, max_len=6).admit(
            _stream(cfg, [5], 6)[0])
    with pytest.raises(ValueError, match="at least one slot"):
        mixer.Mixer(model, params, slots=0, max_len=24)
    mx = mixer.Mixer(model, params, slots=1, max_len=24)
    mx.admit(reqs[0])
    with pytest.raises(RuntimeError, match="no free slot"):
        mx.admit(reqs[1])
    with pytest.raises(ValueError, match="max_new must be >= 1"):
        mixer.Mixer(model, params, slots=1, max_len=24).admit(
            mixer.Request(uid="z", prompt=[1, 2], max_new=0))


def test_deadline_evicts_with_report(dense):
    cfg, model, params = dense
    mx = mixer.Mixer(model, params, slots=1, max_len=24, deadline_s=0.0)
    res = mx.run(_stream(cfg, [4], 6, seed=4))[0]
    # prefill emits the first token; the first decode step hits the
    # zero-second budget and evicts
    assert res.n_tokens == 1
    assert (res.tokens[1:] == -1).all()
    assert res.report.deadline_hit
    assert res.report.fallback_counts() == {"deadline_exceeded": 1}
    assert mx.events[-1]["reason"] == "deadline"


def test_sample_token_greedy_and_top_k():
    logits = torch.tensor([0.1, 3.0, 2.0, -1.0])
    greedy = mixer.Request(uid="g", prompt=[1], max_new=1)
    assert mixer.sample_token(logits, greedy, 0) == 1
    # greedy takes the first maximum
    assert mixer.sample_token(torch.tensor([1.0, 4.0, 4.0]), greedy, 0) == 1
    # top-1 sampling can only ever pick the argmax, at any temperature
    top1 = mixer.Request(uid="t", prompt=[1], max_new=1, temperature=5.0,
                         top_k=1, seed=9)
    assert all(mixer.sample_token(logits, top1, i) == 1 for i in range(8))
    # top-k keeps every logit tied with the k-th
    tied = torch.tensor([0.0, 2.0, 2.0, -3.0])
    draws = {mixer.sample_token(tied, top1, i) for i in range(64)}
    assert draws == {1, 2}


def test_sample_token_is_a_function_of_logits_seed_and_index():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=64)
                              .astype(np.float32))
    req = mixer.Request(uid="s", prompt=[1], max_new=1, temperature=1.5,
                        top_k=0, seed=3)
    draws = [mixer.sample_token(logits, req, i) for i in range(16)]
    assert draws == [mixer.sample_token(logits.clone(), req, i)
                     for i in range(16)]
    # the uid plays no part; the seed and the index do
    other_uid = mixer.Request(uid="x", prompt=[2], max_new=9,
                              temperature=1.5, seed=3)
    assert draws == [mixer.sample_token(logits, other_uid, i)
                     for i in range(16)]
    other_seed = mixer.Request(uid="s", prompt=[1], max_new=1,
                               temperature=1.5, seed=4)
    assert draws != [mixer.sample_token(logits, other_seed, i)
                     for i in range(16)]
    assert len(set(draws)) > 1


def test_sampled_stream_replays_exactly(dense):
    cfg, model, params = dense

    def one_run():
        reqs = [mixer.Request(uid=r.uid, prompt=r.prompt, max_new=5,
                              temperature=0.8, top_k=16, seed=i)
                for i, r in enumerate(_stream(cfg, [3, 6, 4, 8], 5))]
        return [res.tokens for res in mixer.Mixer(
            model, params, slots=2, max_len=32).run(reqs)]

    a, b = one_run(), one_run()
    for ta, tb in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
    # sampling is on: different seeds draw different tokens somewhere
    assert any(not np.array_equal(a[i], a[j])
               for i in range(len(a)) for j in range(i + 1, len(a)))


class _NoPrefill:
    """The serving surface of a model without a one-pass prefill."""

    def __init__(self, model):
        self._m = model
        self.cfg = model.cfg

    def prefill(self, params, tokens, max_len):
        raise NotImplementedError("no one-pass prefill")

    def init_cache(self, *args, **kwargs):
        return self._m.init_cache(*args, **kwargs)

    def decode_step(self, *args):
        return self._m.decode_step(*args)


def test_prefill_request_falls_back_to_token_ingest(dense):
    """A model whose ``prefill`` raises ``NotImplementedError`` is
    admitted by decoding its prompt token by token: the last logits equal
    the one-pass prefill's and the reference's, the cache its K / V, and
    a stream over it the tokens of a stream over the model."""
    cfg, model, params = dense
    prompt = _prompts(cfg.vocab, [7], seed=6)[0]
    last, cache = mixer.prefill_request(model, params,
                                        torch.from_numpy(prompt)[None], 16)
    ingest_last, ingest_cache = mixer.prefill_request(
        _NoPrefill(model), params, torch.from_numpy(prompt)[None], 16)
    scale = float(last.abs().max())
    np.testing.assert_allclose(ingest_last.numpy(), last.numpy(),
                               rtol=0, atol=1e-4 * scale)
    for name in ("k", "v"):
        np.testing.assert_allclose(ingest_cache["self"][name].numpy(),
                                   cache["self"][name].numpy(), rtol=0,
                                   atol=1e-4)
    rparams = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), params))
    rlast, _ = rmixer.prefill_request(RModel(rget_config("chatglm3-6b")
                                             .reduced()), rparams,
                                      jnp.asarray(prompt)[None], 16)
    np.testing.assert_allclose(ingest_last.numpy(), np.asarray(rlast),
                               rtol=0, atol=1e-4 * scale)
    with pytest.raises(ValueError, match=r"\(1, plen>=1\)"):
        mixer.prefill_request(model, params, torch.ones(2, 3,
                                                        dtype=torch.long), 8)
    reqs = _stream(cfg, [3, 5, 4], [4, 3, 5], seed=7)
    want = mixer.Mixer(model, params, slots=2, max_len=16).run(reqs)
    got = mixer.Mixer(_NoPrefill(model), params, slots=2, max_len=16).run(
        reqs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def _graph(kv):
    """A graph's bookkeeping over the static K / V ``kv`` of 3 slots,
    without a captured graph (none is replayed here)."""
    return compiled.Graph(graph=None, params=None, store=None,
                          tokens=torch.zeros(3, dtype=torch.long),
                          pos=torch.zeros(3, dtype=torch.long),
                          cache={"self": kv}, logits=torch.zeros(3, 5),
                          launches={}, capture_ms=0.0)


def _row(value):
    return {"self": {name: torch.full((2, 1, 4, 1, 2), value,
                                      dtype=torch.float64)
                     for name in ("k", "v")}}


def test_write_slot_lands_in_a_graph_cache_in_place():
    """A slot write into the cache a graph handed out writes the graph's
    own K / V, returns the same handle, and the graph takes the handle
    without a copy (``Graph.serial`` unchanged)."""
    g = _graph({name: torch.zeros((2, 3, 4, 1, 2)) for name in ("k", "v")})
    handle = g.handle()
    assert mixer.write_slot(handle, _row(7.0), 1) is handle
    for name in ("k", "v"):
        t = g.cache["self"][name]
        assert t.dtype == torch.float32
        assert (t[:, 1] == 7.0).all() and (t[:, [0, 2]] == 0.0).all()
    assert g.adopt(handle) is handle and g.serial == 0


def test_write_slot_through_a_stale_handle_raises():
    """Two streams at one key, interleaved: once the graph has copied the
    second stream's cache in, a slot write through the first stream's
    handle raises and leaves the second stream's K / V as they were; the
    second stream's own handle still writes."""
    g = _graph({name: torch.zeros((2, 3, 4, 1, 2)) for name in ("k", "v")})
    first = g.handle()
    second = g.adopt({"self": {name: torch.full((2, 3, 4, 1, 2), 3.0)
                               for name in ("k", "v")}})
    assert g.serial == 1 and second is not first
    with pytest.raises(RuntimeError, match="taken another cache"):
        mixer.write_slot(first, _row(7.0), 1)
    for name in ("k", "v"):
        assert (g.cache["self"][name] == 3.0).all()
    with pytest.raises(RuntimeError, match="taken another cache"):
        g.adopt(first)
    assert mixer.write_slot(second, _row(7.0), 2) is second
    assert (g.cache["self"]["k"][:, 2] == 7.0).all()
    assert g.adopt(second) is second and g.serial == 1


def test_record_logits_keeps_each_requests_rows(dense):
    """``record_logits`` keeps, per request, its admission's last prefill
    logits and its row of each decode step: one row per token, whose
    argmax is the greedy token, and the first row equals the request's
    own prefill.  The wrappers hold the mixer weakly: it goes when its
    last reference does, without the garbage collector."""
    cfg, model, params = dense
    reqs = _stream(cfg, [3, 5, 7, 4], [4, 6, 3, 5], seed=3)
    mx = mixer.Mixer(model, params, slots=2, max_len=16)
    logits = record.record_logits(mx)
    results = mx.run(reqs)
    assert list(logits) == [r.uid for r in reqs]
    for req, res in zip(reqs, results):
        rows = logits[req.uid]
        assert len(rows) == req.max_new
        assert [int(r.argmax()) for r in rows] == res.tokens.tolist()
        alone, _ = model.prefill(params, torch.as_tensor(req.prompt)[None],
                                 16)
        assert torch.equal(rows[0], alone[0, -1])
    gone = weakref.ref(mx)
    del mx
    assert gone() is None


# ---------------------------------------------------------------------------
# ragged left-padded serving
# ---------------------------------------------------------------------------

def _left_padded(rows, pad):
    plen = max(len(r) for r in rows)
    return np.stack([np.concatenate([np.full(plen - len(r), pad, np.int32),
                                     r]) for r in rows])


def test_ragged_serving_equals_rows_alone_and_the_reference(dense):
    """Left-padded rows: each equals the row served alone, and the batch,
    its stable trace and its token counter equal the reference's."""
    cfg, model, params = dense
    rows = [np.random.default_rng(5).integers(1, cfg.vocab, (p,))
            .astype(np.int32) for p in (3, 7, 5)]
    batch = _left_padded(rows, 0)
    plen = batch.shape[1]
    with otrace.tracing() as tracer, ometrics.collecting() as reg:
        out, _, _ = serve.generate(model, params, torch.from_numpy(batch),
                                   5, plen + 5, prompt_pad_id=0,
                                   device="cpu")
    rparams = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), params))
    with rtrace.tracing() as rtracer, rmetrics.collecting() as rreg:
        rout, _, _ = rserve.generate(
            RModel(rget_config("chatglm3-6b").reduced()), rparams,
            jnp.asarray(batch), 5, plen + 5, prompt_pad_id=0)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    assert tracer.stable_trace() == rtracer.stable_trace()
    assert reg.snapshot() == rreg.snapshot()
    for r, row in enumerate(rows):
        alone, _, _ = serve.generate(model, params,
                                     torch.from_numpy(row)[None], 5,
                                     plen + 5, device="cpu")
        assert torch.equal(out[r], alone[0]), r


def test_ragged_serving_with_eos_pads_each_row(dense):
    cfg, model, params = dense
    rows = [np.random.default_rng(8).integers(1, cfg.vocab, (p,))
            .astype(np.int32) for p in (2, 6)]
    batch = torch.from_numpy(_left_padded(rows, 0))
    free, _, _ = serve.generate(model, params, batch, 5, 11,
                                prompt_pad_id=0, device="cpu")
    eos = int(free[0, 1])
    got, _, _ = serve.generate(model, params, batch, 5, 11, eos_id=eos,
                               pad_id=-7, prompt_pad_id=0, device="cpu")
    want = free.clone()
    for r in range(2):
        hits = (free[r] == eos).nonzero()
        if hits.numel():
            want[r, int(hits[0]) + 1:] = -7
    assert torch.equal(got, want)


@pytest.mark.parametrize("prompts,match", [
    ([[5, 6, 7, 0, 0], [1, 2, 3, 4, 5]], "LEFT-padded"),
    ([[0, 5, 0, 7, 8]], "LEFT-padded"),
    ([[0, 0, 0]], "all padding"),
])
def test_serving_rejects_right_or_interior_padding(dense, prompts, match):
    """The reference's messages, for each malformed batch."""
    cfg, model, params = dense
    with pytest.raises(ValueError, match=match) as got:
        serve.generate(model, params, torch.tensor(prompts), 2, 10,
                       prompt_pad_id=0, device="cpu")
    with pytest.raises(ValueError) as want:
        rserve._prompt_offsets(jnp.asarray(prompts, jnp.int32), 0)
    assert str(got.value) == str(want.value)


def test_serve_cli_mixer_on_cpu(capsys):
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--compressed",
                "--mixer", "--slots", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve/mixer] chatglm3-6b") \
        and "compressed: ratio=0.500" in out[0] \
        and "slots=2 requests=4 on cpu" in out[0]
    rows = [line for line in out if line.startswith("  req")]
    assert len(rows) == 4 and all("tok=16/16" in r for r in rows)
    assert "prompt=32 " in rows[0] and "prompt=14 " in rows[3]
    assert any("admit_step=0" in r for r in rows) and any(
        "admit_step=15" in r for r in rows)
    (total,) = [line for line in out if line.startswith("  decode")]
    assert "64 tok" in total and "over 30 steps" in total \
        and "slot_reuse_admits=2" in total
