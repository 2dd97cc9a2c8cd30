"""The port's serving telemetry against the reference's, on reduced
chatglm3-6b: the dispatcher's traffic counters and their metrics, the
kernel cache, plan fallbacks, ``kernel_timer`` and the serve CLI's
``--trace PATH`` / ``--metrics PATH`` exports.

Both packages get the same plan (the port's shipped reduced bitmap plan,
through its JSON; 2:4 by the same plan with every role N:M) and, for the
counters, the same weights (the reference's ``Model.init`` through numpy).
Counters are exact: the same fields, the same sums.  The CLI's exports are
held to what the reference's CLI exports for the same serving calls
(``src/repro/launch/serve.py:264-331``, driven here through the same
contexts): the same metric names and label sets, and for a static
``generate`` the same stable trace.  Values that depend on how often a
dispatch is recorded differ on purpose (the port counts every executed
dispatch, the reference one per jit trace;
``tests/test_torch_divergences.py``), and the reference's memo registry
has no source in the port yet, so its ``memo_*`` series are left out.
"""

import dataclasses
import importlib.util
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.exec import dispatch as rdispatch
from repro.launch import serve as rserve
from repro.launch.mixer import Mixer as RMixer
from repro.launch.mixer import Request as RRequest
from repro.models.transformer import Model as RModel
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro.obs.profile import kernel_timer as rkernel_timer
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.exec.plans import ExecPlan, shipped_plan
from repro_torch.kernels import build, ops
from repro_torch.launch import serve
from repro_torch.obs import metrics as ometrics
from repro_torch.obs import trace as otrace
from repro_torch.obs.profile import kernel_timer

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the CLI's defaults, as both packages' ``main`` sets them
BATCH, PLEN, GEN = 4, 32, 16


def _chip_smoke():
    """``chip_smoke.py`` as a module: its phase 9 holds the card's CLI
    exports to :func:`telemetry_series`, which this file holds to the
    reference's."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_nm(plan):
    return dataclasses.replace(
        plan, w_sparsity={"kind": "nm", "n": 2, "m": 4},
        ops=tuple(dataclasses.replace(op, choice=dataclasses.replace(
            op.choice, kind="nm", block_n=0, block_k=0,
            format_str="CP(2:4)")) for op in plan.ops))


@pytest.fixture(scope="module", params=["bitmap", "nm"])
def served(request):
    """(reference compressed model, its pruned params, the port's, the
    port's, cfg) from one plan JSON and the reference's weights."""
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    plan = shipped_plan(cfg, "bitmap")
    if request.param == "nm":
        plan = _as_nm(plan)
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    rparams = RModel(rcfg).init(jax.random.key(0))
    rpruned = rexec.prune_params(rparams, rplan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, rplan, rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(cfg, params, plan, device="cpu")
    return rcm, rpruned, cm, pruned, cfg


def _tokens(vocab):
    return np.arange(2 * 8).reshape(2, 8) % vocab


def test_ingest_instrument_equals_opcounters(served):
    _, _, cm, pruned, cfg = served
    with texec.instrument() as counters:
        cm.hidden_states(pruned, torch.from_numpy(_tokens(cfg.vocab)))
    assert counters
    reg = ometrics.MetricsRegistry()
    ometrics.ingest_instrument(reg, counters)
    for role, c in counters.items():
        for field, name in (("calls", "exec_dispatch_calls_total"),
                            ("w_fetch_bits", "exec_w_fetch_bits_total"),
                            ("w_distinct_bits", "exec_w_distinct_bits_total"),
                            ("w_stream_bits", "exec_w_stream_bits_total"),
                            ("x_bits", "exec_x_bits_total"),
                            ("y_bits", "exec_y_bits_total"),
                            ("macs", "exec_macs_total"),
                            ("decode_ops", "exec_decode_ops_total")):
            assert reg.value(name, role=role) == getattr(c, field)
        assert reg.value("exec_refetch_factor", role=role) == \
            c.refetch_factor


def test_one_forward_counters_equal_the_reference(served):
    """One forward of 2 x 8 tokens (M = 16): every field equal, the
    refetch fields too (one pass over the payload in both: the reference's
    16-row TPU tile, the port's decode entries stage all 16 rows)."""
    rcm, rpruned, cm, pruned, cfg = served
    toks = _tokens(cfg.vocab)
    with rexec.instrument() as want:
        rcm.hidden_states(rpruned, jnp.asarray(toks, jnp.int32))
    with texec.instrument() as got:
        cm.hidden_states(pruned, torch.from_numpy(toks))
    assert sorted(got) == sorted(want)
    for role in want:
        for f in ("calls", "w_fetch_bits", "w_distinct_bits",
                  "w_stream_bits", "x_bits", "y_bits", "macs", "decode_ops",
                  "w_fetch_bits_per_call", "w_stream_bits_per_call",
                  "refetch_factor"):
            assert getattr(got[role], f) == getattr(want[role], f), (role, f)


def test_kernel_cache_stats_and_collect_caches_equal_their_source(
        monkeypatch):
    """The counters count :func:`build.library`'s lookups of a loaded
    library (hits) and its loads (misses); a load that fails counts
    nothing.  ``collect_caches`` folds them in as the reference's names."""
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_STATS", {"hits": 0, "misses": 0})
    if build.shutil.which("nvcc") is None and not \
            pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.library("nm_spmm")
    assert ops.kernel_cache_stats() == {"hits": 0, "misses": 0, "entries": 0}
    build._LIBS["nm_spmm"] = object()
    build.library("nm_spmm")
    build.library("nm_spmm")
    stats = ops.kernel_cache_stats()
    assert stats == build.cache_stats() == {"hits": 2, "misses": 0,
                                            "entries": 1}
    reg = ometrics.MetricsRegistry()
    ometrics.collect_caches(reg)
    assert reg.value("kernel_cache_hits_total") == stats["hits"]
    assert reg.value("kernel_cache_misses_total") == stats["misses"]
    assert reg.value("kernel_cache_entries") == stats["entries"]
    ops.clear_kernel_cache()
    assert ops.kernel_cache_stats() == {"hits": 0, "misses": 0, "entries": 0}


def test_fallbacks_equal_the_reference():
    """The same plan JSON, three roles given fallback reasons (one code
    twice): the same roles, reasons and counts."""
    d = json.loads(shipped_plan(get_config("chatglm3-6b").reduced(),
                                "bitmap").to_json())
    for op, code in zip(d["ops"][:3], ("no_kernel", "no_kernel", "tile")):
        op["choice"]["fallback"] = {"code": code, "detail": op["role"]}
    text = json.dumps(d)
    got, want = ExecPlan.from_json(text), rexec.ExecPlan.from_json(text)
    assert {r: (f.code, f.detail) for r, f in got.fallbacks().items()} == \
        {r: (f.code, f.detail) for r, f in want.fallbacks().items()}
    assert got.fallback_counts() == want.fallback_counts() == {
        "no_kernel": 2, "tile": 1}
    clean = shipped_plan(get_config("chatglm3-6b").reduced(), "bitmap")
    assert clean.fallbacks() == {} and clean.fallback_counts() == {}


def test_kernel_timer_records_dispatches(served):
    """``tests/test_obs.py:443`` on the port: on the CPU every dispatch is
    recorded with its host seconds (the reference records at jit trace)."""
    _, _, cm, pruned, cfg = served
    reg, tracer = ometrics.MetricsRegistry(), otrace.Tracer()
    with kernel_timer(registry=reg, tracer=tracer):
        cm.hidden_states(pruned, torch.from_numpy(_tokens(cfg.vocab)))
    kind = cm.store.plan.ops[0].choice.kind
    assert reg.total("kernel_dispatch_total") == 7 * cfg.n_layers
    assert reg.value("kernel_dispatch_total", kind=kind) == 7 * cfg.n_layers
    hist = reg.snapshot()["histograms"][
        f"kernel_dispatch_seconds{{kind={kind}}}"]
    assert hist["count"] == 7 * cfg.n_layers
    xs = [e for e in tracer.events if e["ph"] == "X"]
    assert len(xs) == 7 * cfg.n_layers
    assert all(e["name"] == f"kernel:{kind}" and e["dur"] > 0 for e in xs)
    assert not tracer.stable_trace()          # all timing-derived


def _reference_cli(mixer: bool):
    """The reference CLI's serving run on the port's reduced bitmap plan
    (``src/repro/launch/serve.py:264-331`` with ``--reduced --compressed
    --trace --metrics`` and its defaults), through the same contexts:
    (tracer, registry)."""
    rcfg = rget_config("chatglm3-6b").reduced()
    plan = rexec.ExecPlan.from_json(
        shipped_plan(get_config("chatglm3-6b").reduced(), "bitmap")
        .to_json())
    rparams = RModel(rcfg).init(jax.random.key(0))
    rpruned = rexec.prune_params(rparams, plan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, plan, rcfg))
    tracer, reg = rtrace.Tracer(), rmetrics.MetricsRegistry()
    rng = np.random.default_rng(0)
    mx = None
    with rtrace.tracing(tracer), rmetrics.collecting(reg), \
            rkernel_timer(registry=reg, tracer=tracer), \
            rdispatch.instrument() as counters:
        if mixer:
            reqs = [RRequest(uid=f"req{i}", prompt=jnp.asarray(
                rng.integers(0, rcfg.vocab,
                             (max(1, PLEN - (i % 4) * (PLEN // 5)),)),
                jnp.int32), max_new=GEN, seed=i) for i in range(BATCH)]
            mx = RMixer(rcm, rpruned, slots=BATCH, max_len=PLEN + GEN)
            mx.run(reqs)
        else:
            prompts = jnp.asarray(rng.integers(0, rcfg.vocab, (BATCH, PLEN)),
                                  jnp.int32)
            rserve.generate(rcm, rpruned, prompts, GEN, PLEN + GEN)
    rmetrics.ingest_instrument(reg, counters)
    rmetrics.collect_caches(reg)
    if mx is not None:
        rmetrics.ingest_straggler(reg, mx.straggler)
    reg.gauge_set("serve_achieved_compression_ratio",
                  rcm.store.achieved_ratio())
    return tracer, reg


def _series(snap: dict) -> set[str]:
    return {k for part in ("counters", "gauges", "histograms")
            for k in snap[part]
            if not k.startswith("memo_")
            and k.split("{")[0] != "mixer_straggler_spikes_total"}


_PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]\w*="[^"]*"'
                          r'(,[a-zA-Z_]\w*="[^"]*")*\})? \S+$')


@pytest.mark.parametrize("mixer", [False, True])
def test_the_cli_exports_equal_the_references(mixer, tmp_path, capsys):
    """``python -m repro_torch.launch.serve --arch chatglm3-6b --reduced
    --compressed --trace T --metrics M --device cpu`` (and ``--mixer``)
    writes four parseable files; the metrics hold the reference CLI's
    series (names and label sets) for the same serving calls, which are
    ``chip_smoke.telemetry_series``; a static run's stable trace is the
    reference's."""
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--compressed",
                "--trace", t, "--metrics", m, "--device", "cpu"]
               + (["--mixer"] if mixer else []))
    out = capsys.readouterr().out
    assert "fallbacks=none" in out and f"metrics: {m}" in out
    with open(t) as f:
        chrome = json.load(f)
    with open(t + ".stable.json") as f:
        stable = json.load(f)
    with open(m) as f:
        snap = json.load(f)
    with open(m + ".prom") as f:
        prom = f.read()
    assert chrome["traceEvents"] and stable
    samples = [ln for ln in prom.splitlines() if ln and ln[0] != "#"]
    assert samples and all(_PROM_SAMPLE.match(ln) for ln in samples)
    tracer, reg = _reference_cli(mixer)
    want = _series(reg.snapshot())
    cfg = get_config("chatglm3-6b").reduced()
    assert _series(snap) == want == _chip_smoke().telemetry_series(
        [r.role for r in cfg.matmul_roles()], "bitmap", mixer)
    if not mixer:
        assert stable == json.loads(json.dumps(tracer.stable_trace()))
    kernels = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert len(kernels) == \
        snap["counters"]["kernel_dispatch_total{kind=bitmap}"]
