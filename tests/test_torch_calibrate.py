"""The port's calibration loop (``repro_torch.exec.calibrate``) against the
reference's (``tests/test_exec.py``'s calibration cases), on reduced
chatglm3-6b in fp32.

Each package searches its own plan (the two JSONs must be equal), prunes
and compresses the same weights (the reference's ``Model.init`` through
numpy) and runs one forward of 2 x 8 tokens (M = 16) under its own
``instrument()``.  At that M the CUDA tiling and the reference's TPU grid
both stream each payload once, so the counters, every fit, the re-search
and the calibrated plan's JSON are the reference's exactly.  At prefill
the stream side parts (``tests/test_torch_divergences.py``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.core import arch as rarch
from repro.core.cosearch import CoSearchConfig as RCoSearchConfig
from repro.core.engine import EngineConfig as REngineConfig
from repro.core.sparsity import NM as RNM
from repro.core.sparsity import Bernoulli as RBernoulli
from repro.core.sparsity import BlockBernoulli as RBlockBernoulli
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro.obs import trace as rtrace
from repro_torch import exec as texec
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import arch as tarch
from repro_torch.core.cosearch import CoSearchConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.core.sparsity import NM, Bernoulli, BlockBernoulli
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.obs import trace as otrace

# the modules: the packages export the function ``calibrate`` under the
# module's name
rcal = importlib.import_module("repro.exec.calibrate")
tcal = importlib.import_module("repro_torch.exec.calibrate")
FAST = CoSearchConfig(objective="edp",
                      engine=EngineConfig(max_levels=2,
                                          max_allocs_per_pattern=16),
                      spatial_top=2, max_pairs=6)
RFAST = RCoSearchConfig(objective="edp",
                        engine=REngineConfig(max_levels=2,
                                             max_allocs_per_pattern=16),
                        spatial_top=2, max_pairs=6)
SPARSITY = {"bitmap": (BlockBernoulli(0.5, 32 * 32),
                       RBlockBernoulli(0.5, 32 * 32)),
            "nm": (NM(2, 4), RNM(2, 4)),
            "iid": (Bernoulli(0.5), RBernoulli(0.5))}


@pytest.fixture(scope="module", autouse=True)
def fp32():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(L, "COMPUTE_DTYPE", torch.float32)
        yield


def _counters(kind, b=2, s=8):
    """(port cfg, reference cfg, the port's plan, the reference's, the
    port's counters, the reference's) for one forward of b x s tokens."""
    sp, rsp = SPARSITY[kind]
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    rplan = rexec.build_exec_plan(rcfg, rsp, tokens=64, search_cfg=RFAST,
                                  value_bits=32)
    plan = texec.build_exec_plan(cfg, sp, tokens=64, search_cfg=FAST,
                                 value_bits=32)
    assert plan.to_json() == rplan.to_json()
    rparams = RModel(rcfg).init(jax.random.key(0))
    rpruned = rexec.prune_params(rparams, rplan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, rplan, rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(cfg, params, plan, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (b, s))
    with rexec.instrument() as rcounters:
        rcm.hidden_states(rpruned, jnp.asarray(toks, jnp.int32))
    with texec.instrument() as counters:
        cm.hidden_states(pruned, torch.from_numpy(toks))
    return cfg, rcfg, plan, rplan, counters, rcounters


@pytest.fixture(scope="module", params=["bitmap", "nm", "iid"])
def measured(request, fp32):
    return (request.param,) + _counters(request.param)


def _report(rep):
    """A ``CalibrationReport`` as comparable values: its fields, with the
    calibrated plan as its JSON (the live search result it carries holds
    wall-clock seconds)."""
    fields = dataclasses.asdict(dataclasses.replace(rep,
                                                    calibrated_plan=None))
    return (fields, rep.calibrated_plan.to_json(), rep.energy_drift)


def test_counters_equal_the_references_at_decode_sizes(measured):
    """One stream pass at M = 16 on both sides: every per-call mean the
    calibration reads is the reference's."""
    _, _, _, plan, _, counters, rcounters = measured
    assert set(counters) == set(rcounters) == {op.role for op in plan.ops
                                               if op.choice.kind != "dense"}
    for role, want in rcounters.items():
        got = counters[role]
        assert got.w_fetch_bits_per_call == want.w_fetch_bits_per_call
        assert got.w_stream_bits_per_call == want.w_stream_bits_per_call


def test_calibration_report_equals_the_references(measured):
    """``calibrate`` on each package's own counters: rows, both fits,
    errors and residuals, energies, changed kinds and the calibrated
    plan's JSON, exactly."""
    kind, cfg, rcfg, plan, rplan, counters, rcounters = measured
    want = rexec.calibrate(rcfg, rplan, rcounters, search_cfg=RFAST)
    got = texec.calibrate(cfg, plan, counters, search_cfg=FAST)
    assert _report(got) == _report(want)
    assert got.rows and got.calibrated_plan.ops
    if kind == "bitmap":
        # the reference's acceptance bounds (tests/test_exec.py): the
        # BlockBernoulli spec models block pruning, so the fit is ~1
        assert 0.9 < got.scale < 1.1
        assert got.max_residual < 0.05
        assert abs(got.energy_drift) < 0.1
    if kind == "iid":
        # i.i.d. Bernoulli predicts fine-grained wins the executable blocks
        # cannot realize: measured traffic well above prediction
        assert got.scale > 1.3
        assert got.max_rel_err > 0.5
        assert got.max_residual < got.max_rel_err
        assert got.energy_drift > 0.2


def test_two_rounds_compose_as_the_references(measured):
    """A calibrated plan keeps the base arch's name and its scales, so its
    hardware resolves after a JSON round trip; a second round on the same
    counters composes multiplicatively, as the reference's does."""
    _, cfg, rcfg, plan, rplan, counters, rcounters = measured
    first = texec.calibrate(cfg, plan, counters, search_cfg=FAST)
    cal = first.calibrated_plan
    assert cal.arch == plan.arch
    assert cal.energy_scale == first.scale
    loaded = texec.ExecPlan.from_json(cal.to_json())
    assert loaded == cal
    assert loaded.hardware() == cal.hardware()
    assert loaded.hardware().dram.pj_per_bit == pytest.approx(
        plan.hardware().dram.pj_per_bit * first.scale)
    second = texec.calibrate(cfg, loaded, counters, search_cfg=FAST)
    assert second.calibrated_plan.energy_scale == \
        first.scale * second.scale
    assert second.calibrated_plan.glb_energy_scale == \
        first.glb_scale * second.glb_scale
    rfirst = rexec.calibrate(rcfg, rplan, rcounters, search_cfg=RFAST)
    rsecond = rexec.calibrate(
        rcfg, rexec.ExecPlan.from_json(rfirst.calibrated_plan.to_json()),
        rcounters, search_cfg=RFAST)
    assert _report(second) == _report(rsecond)


@pytest.mark.parametrize("scale,glb", [(0.5, 1.0), (1.7, 0.25)])
def test_calibrated_hardware_scales_dram_only(scale, glb):
    """The DRAM coefficient takes ``scale``; the GLB one ``glb_scale``
    only when it is not 1; every other level and the name's base stay.
    Equal, field for field, to the reference's."""
    arch = tarch.TPUV5E
    cal = tcal.calibrated_hardware(arch, scale, glb_scale=glb)
    want = rcal.calibrated_hardware(rarch.TPUV5E, scale, glb_scale=glb)
    assert dataclasses.asdict(cal) == dataclasses.asdict(want)
    assert cal.dram.pj_per_bit == pytest.approx(arch.dram.pj_per_bit * scale)
    assert cal.glb.pj_per_bit == pytest.approx(arch.glb.pj_per_bit * glb)
    assert cal.levels[2:] == arch.levels[2:]
    assert cal.name.startswith(arch.name)


def test_fits_equal_the_references_on_synthetic_rows():
    """``fit_scale`` / ``fit_glb_scale`` and every row property, on rows
    with and without refetch, and the identity on no refetch."""
    vals = [("a", 3.0, 2.0, 9.0, 4.0), ("b", 5.5, 7.25, 5.5, 7.25),
            ("c", 1e9, 1.1e9, 4e9, 2.2e9)]
    rows = [tcal.CalibRow(r, "bitmap", m, p, ms, ps)
            for r, m, p, ms, ps in vals]
    rrows = [rcal.CalibRow(r, "bitmap", m, p, ms, ps)
             for r, m, p, ms, ps in vals]
    assert tcal.fit_scale(rows) == rcal.fit_scale(rrows)
    assert tcal.fit_glb_scale(rows) == rcal.fit_glb_scale(rrows)
    props = ("rel_err", "measured_refetch_bits", "predicted_refetch_bits",
             "stream_rel_err")
    for a, b in zip(rows, rrows):
        assert [getattr(a, p) for p in props] == \
            [getattr(b, p) for p in props]
        assert a.residual(1.3) == b.residual(1.3)
        assert a.refetch_residual(0.7) == b.refetch_residual(0.7)
    assert tcal.fit_glb_scale(rows[1:2]) == 1.0
    with pytest.raises(ValueError, match="no measured counters"):
        texec.calibrate(get_config("chatglm3-6b").reduced(),
                        texec.build_exec_plan(
                            get_config("chatglm3-6b").reduced(),
                            NM(2, 4), tokens=64, search_cfg=FAST,
                            value_bits=32), {}, search_cfg=FAST)


def test_calibrate_traces_the_references_spans(measured):
    """The spans ``calibrate``, ``calibrate.compare`` / ``.fit`` /
    ``.research`` and the event ``calibrate.fitted``: the stable trace
    equals the reference's."""
    _, cfg, rcfg, plan, rplan, counters, rcounters = measured
    tracer, rtracer = otrace.Tracer(), rtrace.Tracer()
    with otrace.tracing(tracer):
        texec.calibrate(cfg, plan, counters, search_cfg=FAST)
    with rtrace.tracing(rtracer):
        rexec.calibrate(rcfg, rplan, rcounters, search_cfg=RFAST)
    got = tracer.stable_trace()
    assert got == rtracer.stable_trace()
    assert {e["name"] for e in got} >= {
        "calibrate", "calibrate.compare", "calibrate.fit",
        "calibrate.research", "calibrate.fitted"}
