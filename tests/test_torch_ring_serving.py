"""Serving the four dense-only families (and a uniform stack with a window)
through the mixer, the guard and the compiled step, against the reference
at fp32 on ``reduced()`` configs with the reference's ``Model.init``
weights.

* The mixer on gemma3-27b, recurrentgemma-2b and mamba2-780m: a stream
  whose longest prompt wraps the rings of 64, admitted by token ingest into
  3 slots; greedy tokens, ``events``, the stable trace and each request's
  ``HealthReport.stable_dict()`` equal the reference's.  Both refuse
  whisper-tiny.
* ``guarded_generate`` on recurrentgemma-2b and on gemma3-27b past its
  wrap: healthy; a transient NaN at one decode position (the failed step
  has also written NaN into everything it writes: the ring slot, the
  recurrent states), retried; and one that persists, switched to another
  dense model.  Tokens and ``stable_dict()`` equal the reference's, and
  the tokens the healthy run's.  The port's guard enqueues the next step
  before it checks a step, so a failure there also undoes the step ahead.
* A uniform chatglm3-6b stack with a window: dense and compressed (bitmap
  and 2:4, from the reference's plan JSON), greedy tokens equal to the
  reference's; its cache is ``max_len`` long, so its decode attends over
  the whole prefix while ``hidden_states`` masks to the window (the
  reference's behaviour, pinned in both packages).
* The compiled step's needs on every new cache tree: a decode step reads
  nothing back to the host (scalar and per-row ``pos``), a graph adopts
  and hands out every leaf (the 0-d ``cross_ready`` too), and the graph
  key follows the leaves' shapes.
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
from repro.launch import mixer as rmixer
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro.models.transformer import Model as RModel
from repro.obs import trace as rtrace
from repro.runtime import guard as rguard
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.launch import compiled, mixer, serve
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model, step_writes
from repro_torch.obs import trace as otrace
from repro_torch.runtime import guard
from test_torch_compiled import PLAIN_VERSIONS, _HostReads, _unwatched

FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": BlockBernoulli(0.5, 32 * 32), "nm": NM(2, 4)}
ARCHS = ["gemma3-27b", "recurrentgemma-2b", "mamba2-780m", "whisper-tiny"]
PLENS, MAX_NEW, SLOTS, MIX_LEN = [3, 66, 5, 9, 4], [6, 7, 5, 6, 8], 3, 80
PROMPT, GEN = 60, 10

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (RL, rattn, rrg, rssm):
            mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


_BUILT: dict = {}


def _family(arch: str) -> dict:
    """Both packages' configs and the reference's weights (once a
    module)."""
    if arch not in _BUILT:
        rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
        rparams = RModel(rcfg).init(jax.random.key(0))
        _BUILT[arch] = dict(
            rcfg=rcfg, cfg=cfg, rparams=rparams,
            params=params_from_numpy(jax.tree.map(np.asarray, rparams),
                                     "cpu"))
    return _BUILT[arch]


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _stream(mixer_mod, model, params, prompts, tracing):
    reqs = [mixer_mod.Request(uid=f"r{i}", prompt=p, max_new=MAX_NEW[i])
            for i, p in enumerate(prompts)]
    with tracing() as tracer:
        mx = mixer_mod.Mixer(model, params, slots=SLOTS, max_len=MIX_LEN)
        results = mx.run(reqs)
    return dict(tokens=[np.asarray(r.tokens) for r in results],
                events=mx.events, trace=tracer.stable_trace(),
                reports=[r.report.stable_dict() for r in results],
                slots=[r.slot for r in results])


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_mixer_stream_equals_the_references(arch):
    f = _family(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, f["cfg"].vocab, (p,)).astype(np.int32)
               for p in PLENS]
    want = _stream(rmixer, RModel(f["rcfg"]), f["rparams"],
                   [jnp.asarray(p) for p in prompts], rtrace.tracing)
    got = _stream(mixer, Model(f["cfg"]), f["params"], prompts,
                  otrace.tracing)
    for g, w in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(g, w)
    for key in ("events", "trace", "reports", "slots"):
        assert got[key] == want[key], key


def test_the_mixer_refuses_the_encoder_decoder():
    f = _family("whisper-tiny")
    for mod, model, params in ((rmixer, RModel(f["rcfg"]), f["rparams"]),
                               (mixer, Model(f["cfg"]), f["params"])):
        with pytest.raises(NotImplementedError, match="encoder frames"):
            mod.Mixer(model, params, slots=2, max_len=16)


# ---------------------------------------------------------------------------
# the guard: a retry, the step ahead's undo and a dense switch
# ---------------------------------------------------------------------------

class _RefNanAt:
    """The reference model with a jitted step whose logits turn NaN the
    first ``times`` calls at position ``at`` (its new cache is discarded
    by the reference's guard, as a failed step's)."""

    def __init__(self, model, at: int, times: int):
        self.cfg, self.model, self.at, self.left = model.cfg, model, at, times
        self._step = jax.jit(model.decode_step)

    def prefill(self, *args, **kwargs):
        return self.model.prefill(*args, **kwargs)

    def init_cache(self, *args, **kwargs):
        return self.model.init_cache(*args, **kwargs)

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = self._step(params, cache, tokens, pos)
        if int(pos) == self.at and self.left:
            self.left -= 1
            logits = jnp.full_like(logits, jnp.nan)
        return logits, cache


class _PortNanAt(_RefNanAt):
    """The port's model with the same fault.  Its step writes the cache
    in place, so the failed step also leaves NaN in everything it wrote:
    the guard must restart from the cache as it was before the step."""

    def __init__(self, model, at: int, times: int):
        self.cfg, self.model, self.at, self.left = model.cfg, model, at, times

    def decode_step(self, params, cache, tokens, pos):
        logits, cache = self.model.decode_step(params, cache, tokens, pos)
        if int(pos) == self.at and self.left:
            self.left -= 1
            for t in step_writes(cache, self.at):
                t.fill_(float("nan"))
            logits = torch.full_like(logits, float("nan"))
        return logits, cache


class _JitIdentity:
    """``jax`` for the reference's guard, with ``jit`` the identity: it
    jits the model's ``decode_step``, and the fault above is Python that
    acts per call (the step inside stays jitted)."""

    def __getattr__(self, name):
        return (lambda fn, **kw: fn) if name == "jit" else getattr(jax, name)


@pytest.mark.parametrize("fault", ["healthy", "transient", "dense_switch"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma3-27b"])
def test_guarded_generate_equals_the_references(arch, fault, monkeypatch):
    """Position 66 is past the rings' wrap at 64 (prompt 60, 10 tokens)."""
    f = _family(arch)
    at, times = {"healthy": (-1, 0), "transient": (66, 1),
                 "dense_switch": (66, 2)}[fault]
    prompts = np.random.default_rng(4).integers(1, f["cfg"].vocab,
                                                (2, PROMPT))
    rdense = RModel(f["rcfg"])
    with monkeypatch.context() as mp:
        mp.setattr(rguard, "jax", _JitIdentity())
        want, rrep = rguard.guarded_generate(
            _RefNanAt(rdense, at, times), f["rparams"],
            jnp.asarray(prompts, jnp.int32), GEN,
            dense_model=_RefNanAt(RModel(f["rcfg"]), -1, 0))
    got, rep = guard.guarded_generate(
        _PortNanAt(Model(f["cfg"]), at, times), f["params"],
        torch.from_numpy(prompts), GEN, dense_model=Model(f["cfg"]),
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rep.stable_dict() == rrep.stable_dict()
    healthy, _, _ = serve.generate(Model(f["cfg"]), f["params"],
                                   torch.from_numpy(prompts), GEN,
                                   PROMPT + GEN, device="cpu")
    assert torch.equal(got, healthy)
    assert rep.retries == {"healthy": 0, "transient": 1,
                           "dense_switch": 1}[fault]
    assert rep.switched_to_dense_at == \
        (66 if fault == "dense_switch" else None)


# ---------------------------------------------------------------------------
# a uniform stack with a window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def windowed(fp32):
    rcfg = dataclasses.replace(rget_config("chatglm3-6b").reduced(),
                               window=8)
    cfg = dataclasses.replace(get_config("chatglm3-6b").reduced(), window=8)
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, (2, 12))
    return dict(rcfg=rcfg, cfg=cfg, rparams=rparams, params=params,
                prompts=prompts)


@pytest.mark.parametrize("kind", ["dense", "bitmap", "nm"])
def test_a_windowed_stack_serves_the_references_tokens(windowed, kind):
    rcfg, cfg = windowed["rcfg"], windowed["cfg"]
    rmodel, rparams = RModel(rcfg), windowed["rparams"]
    model, params = Model(cfg), windowed["params"]
    if kind != "dense":
        plan = rexec.build_exec_plan(rcfg, SPARSITY[kind], tokens=64,
                                     search_cfg=FAST, value_bits=32)
        rparams = rexec.prune_params(rparams, plan, rcfg)
        rmodel = rexec.CompressedModel(
            rmodel, rexec.compress_params(rparams, plan, rcfg))
        model, params = serve.compressed_model(
            cfg, params, texec.ExecPlan.from_json(plan.to_json()),
            device="cpu")
        assert {op.choice.kind for op in plan.ops} == {kind}
    prompts = windowed["prompts"]
    want = rserve.generate(rmodel, rparams, jnp.asarray(prompts, jnp.int32),
                           6, 18)[0]
    got, _, _ = serve.generate(model, params, torch.from_numpy(prompts), 6,
                               18, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_a_windowed_stacks_decode_attends_over_the_whole_prefix(windowed):
    """The reference's behaviour, kept: the cache is ``max_len`` long, so
    past the window the decode's logits part from the windowed forward's,
    in both packages alike."""
    rcfg, cfg = windowed["rcfg"], windowed["cfg"]
    rmodel, model = RModel(rcfg), Model(cfg)
    toks = windowed["prompts"]
    rcache = rmodel.init_cache(2, 16)
    cache = model.init_cache(2, 16, device="cpu")
    assert rcache["self"]["k"].shape[2] == cache["self"]["k"].shape[2] == 16
    rfwd = np.asarray(jnp.einsum(
        "btd,vd->btv", rmodel.hidden_states(windowed["rparams"],
                                            jnp.asarray(toks), remat=False),
        windowed["rparams"]["embed"]))
    fwd = model.logits(windowed["params"], torch.from_numpy(toks)).numpy()
    step = jax.jit(rmodel.decode_step)
    for t in range(toks.shape[1]):
        want, rcache = step(windowed["rparams"], rcache,
                            jnp.asarray(toks[:, t]), jnp.asarray(t, jnp.int32))
        got, cache = model.decode_step(windowed["params"], cache,
                                       torch.from_numpy(toks[:, t]), t)
        want, got = np.asarray(want), got.numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        parted = np.abs(got - fwd[:, t]).max() > 1e-3 * np.abs(want).max()
        assert parted == (t >= cfg.window)
        assert parted == (np.abs(want - rfwd[:, t]).max()
                          > 1e-3 * np.abs(want).max())


# ---------------------------------------------------------------------------
# what the compiled step needs of each new cache tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scalar", "per-row"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_back_to_the_host(arch, kind,
                                                    monkeypatch):
    f = _family(arch)
    model = Model(f["cfg"])
    cache = model.init_cache(2, 80, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, f["cfg"].vocab, (2,)))

    def pos(t):
        return torch.tensor([t, t - 3] if kind == "per-row" else t)

    # the first step fills host-side caches (the score scale)
    model.decode_step(f["params"], cache, toks, pos(70))
    at = pos(71)
    mode = _HostReads()
    for name in PLAIN_VERSIONS:
        monkeypatch.setattr(ref, name, _unwatched(mode, getattr(ref, name)))
    with mode:
        logits, _ = model.decode_step(f["params"], cache, toks, at)
    assert mode.found == []
    assert logits.shape == (2, f["cfg"].vocab)


def _cpu_graph(cache) -> compiled.Graph:
    """A graph's bookkeeping without a capture, over ``cache``."""
    return compiled.Graph(graph=None, params=None, store=None,
                          tokens=torch.zeros(2, dtype=torch.long),
                          pos=torch.zeros((), dtype=torch.long),
                          cache=cache, logits=torch.zeros(2, 3),
                          launches={}, capture_ms=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_graph_adopts_and_hands_out_every_leaf(arch):
    f = _family(arch)
    model = Model(f["cfg"])
    g = _cpu_graph(model.init_cache(2, 80, device="cpu"))
    first = g.handle()
    assert g.adopt(first) is first
    assert all(a is b for a, b in zip(compiled.leaves(first),
                                      compiled.leaves(g.cache)))
    filled = model.init_cache(2, 80, device="cpu")
    for i, t in enumerate(compiled.leaves(filled)):
        t.fill_(i + 1)
    second = g.adopt(filled)
    assert second is not first and g.serial == 1
    for got, want, static in zip(compiled.leaves(second),
                                 compiled.leaves(filled),
                                 compiled.leaves(g.cache)):
        assert got is static and torch.equal(got, want)
    with pytest.raises(RuntimeError, match="another cache"):
        g.adopt(first)
    with pytest.raises(RuntimeError, match="another cache"):
        mixer.write_slot(first, model.init_cache(1, 80, device="cpu"), 0)


def test_the_key_follows_every_leaf_shape():
    """gemma3's ring is ``min(window, max_len)`` long: two contexts past
    the window have rings alike and global caches apart, and the key
    tells them apart.  recurrentgemma's ring and states and mamba2's
    states do not grow with the context past the window, so one graph
    serves both contexts; their batch parts the keys."""
    keys = set()
    for arch in ARCHS[:3]:
        f = _family(arch)
        model = Model(f["cfg"])
        for batch, max_len in ((2, 70), (2, 80), (3, 80)):
            cache = model.init_cache(batch, max_len, device="cpu")
            keys.add(compiled.key(model, f["params"], cache,
                                  torch.zeros(batch, dtype=torch.long), 3))
    assert len(keys) == 3 + 2 + 2
    g = _family("gemma3-27b")
    ring = [Model(g["cfg"]).init_cache(2, n, device="cpu")["local"]["k"]
            .shape[2] for n in (70, 80)]
    assert ring == [64, 64]
