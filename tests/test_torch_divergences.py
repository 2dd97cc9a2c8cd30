"""Deliberate divergences from the reference, pinned (ROADMAP.md, Queue
3): inputs the port's CUDA entries refuse and the reference computes; the
telemetry's counts and seconds; the optimization flags the port refuses.

N:M groups wider than 32 (``kernels/nm_spmm.py::MAX_M_GROUP``: the CUDA
kernels stage 32-column runs) are refused by both N:M entries with a
``ValueError`` before any launch, so the card never serves something else
in silence; the reference's kernels take any group.  On the CPU the port's
plain version serves them, equal to the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import nm_spmm as nm
from repro_torch.kernels import ops

N_SEL, M_GROUP = 4, 64                 # a 4:64 plan, past MAX_M_GROUP


def _operands(m, n, k):
    rng = np.random.default_rng(m + n + k)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return w, x, ops.compress_nm(torch.from_numpy(w), N_SEL, M_GROUP)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m", [4, 64])
def test_nm_entries_refuse_groups_above_32(pipeline, m):
    assert M_GROUP > nm.MAX_M_GROUP
    w, x, c = _operands(m, 256, 64)
    with pytest.raises(ValueError, match=f"{N_SEL}:{M_GROUP}"):
        nm.select_entry(torch.from_numpy(x), c.values, c.indices, N_SEL,
                        M_GROUP, pipeline)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("m", [4, 64])
def test_cpu_plain_path_serves_groups_above_32_as_the_reference(pipeline, m):
    """The same payload as the reference's host compressor, and the product
    equal to the reference's Pallas kernel (interpret mode) to its own
    1e-5 (tests/test_kernels.py)."""
    n, k = 256, 64
    w, x, c = _operands(m, n, k)
    rc = rops.compress_nm(w, N_SEL, M_GROUP)
    assert np.array_equal(c.values.numpy(), np.asarray(rc.values))
    assert np.array_equal(c.indices.numpy(), np.asarray(rc.indices))
    y = ops.nm_spmm(torch.from_numpy(x), c, pipeline=pipeline)
    want = np.asarray(rops.nm_spmm(jnp.asarray(x), rc, bm=m, bn=128, bk=k,
                                   pipeline=pipeline))
    assert y.shape == (m, k)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Telemetry and flags: what the port counts, times or refuses otherwise
# ---------------------------------------------------------------------------

def _reduced_pair(kind="bitmap"):
    """(reference cfg, port cfg, reference compressed model, its pruned
    params, the port's, the port's) from the port's reduced bitmap plan
    JSON and the reference's weights."""
    import dataclasses
    import jax
    from repro import exec as rexec
    from repro.configs import get_config as rget_config
    from repro.models.transformer import Model as RModel
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.launch import serve
    rcfg = rget_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    plan = shipped_plan(cfg, "bitmap")
    if kind == "nm":
        plan = dataclasses.replace(
            plan, w_sparsity={"kind": "nm", "n": 2, "m": 4},
            ops=tuple(dataclasses.replace(op, choice=dataclasses.replace(
                op.choice, kind="nm", block_n=0, block_k=0,
                format_str="CP(2:4)")) for op in plan.ops))
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    rparams = RModel(rcfg).init(jax.random.key(0))
    rpruned = rexec.prune_params(rparams, rplan, rcfg)
    rcm = rexec.CompressedModel(RModel(rcfg),
                                rexec.compress_params(rpruned, rplan, rcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    cm, pruned = serve.compressed_model(cfg, params, plan, device="cpu")
    return rcfg, cfg, rcm, rpruned, cm, pruned


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_stream_passes_follow_the_cuda_tiling(kind):
    """``OpCounters.w_stream_bits`` counts the passes the CUDA kernels the
    wrapper picks make over the payload (one per row of tiles of their
    grid; ``stream_passes`` of the kernel modules), where the reference
    counts its TPU grid's, M / 128 at M = 512.  The distinct bits, and
    every other field, are the reference's."""
    from repro import exec as rexec
    from repro_torch import exec as texec
    from repro_torch.kernels import bitmap_spmm as bm
    rcfg, cfg, rcm, rpruned, cm, pruned = _reduced_pair(kind)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))
    with rexec.instrument() as want:
        rcm.hidden_states(rpruned, jnp.asarray(toks, jnp.int32))
    with texec.instrument() as got:
        cm.hidden_states(pruned, torch.from_numpy(toks))
    m = toks.size
    for role, w in want.items():
        g = got[role]
        assert g.w_distinct_bits == w.w_distinct_bits
        assert w.w_stream_bits == w.w_distinct_bits * (m // 128)
        d = cm.store.get(0, role).data
        passes = nm.stream_passes(m, d.k, True) if kind == "nm" else \
            bm.stream_passes(m, d.bk, d.k, d.blocks.data_ptr() % 16 == 0)
        assert g.w_stream_bits == g.w_distinct_bits * passes
        assert g.refetch_factor == passes
    # the two tilings part here: the bitmap prefill grid's 32-row tiles, the
    # N:M prefill kernel's 8-row ones on grids under 132 big tiles
    assert any(got[r].w_stream_bits != want[r].w_stream_bits for r in want)


def test_telemetry_counts_every_executed_dispatch():
    """Under ``instrument()`` and ``kernel_timer`` the port's decode runs
    eagerly and each executed dispatch records (2 layers x (1 prefill +
    16 decode steps) calls a role, as ``generate`` runs them, and one
    kernel dispatch each); the reference records at jit trace time, once
    for the prefill and once for the decode step (2 x 2 calls a role, and
    one dispatch a role a trace: its scanned layers share it)."""
    from repro import exec as rexec
    from repro.launch import serve as rserve
    from repro.obs import metrics as rmetrics
    from repro.obs.profile import kernel_timer as rkernel_timer
    from repro_torch import exec as texec
    from repro_torch.obs import metrics as ometrics
    from repro_torch.obs.profile import kernel_timer
    rcfg, cfg, rcm, rpruned, cm, pruned = _reduced_pair()
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    rreg, reg = rmetrics.MetricsRegistry(), ometrics.MetricsRegistry()
    with rkernel_timer(registry=rreg), rexec.instrument() as want:
        rserve.generate(rcm, rpruned, jnp.asarray(prompts, jnp.int32), 16,
                        48)
    with kernel_timer(registry=reg), texec.instrument() as got:
        cm.generate(pruned, torch.from_numpy(prompts), 16, device="cpu")
    layers = cfg.n_layers
    assert {c.calls for c in want.values()} == {layers * 2}
    assert {c.calls for c in got.values()} == {layers * 17}
    assert rreg.value("kernel_dispatch_total", kind="bitmap") == 7 * 2
    assert reg.value("kernel_dispatch_total", kind="bitmap") == \
        7 * layers * 17


def test_kernel_timer_reads_device_events_at_exit(monkeypatch):
    """On a CUDA tensor the port's ``kernel_timer`` records a CUDA event
    pair around the dispatch and reads it once the context exits (device
    seconds, one read for the run); the reference records host seconds at
    each dispatch.  Stand-ins for the tensor and the events show the
    order: nothing read inside the context, each pair read at its exit."""
    from repro_torch.obs import metrics as ometrics
    from repro_torch.obs import trace as otrace
    from repro_torch.obs.profile import kernel_timer
    reads = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            pass

        def synchronize(self):
            reads.append("sync")

        def elapsed_time(self, end):
            reads.append("read")
            return 2.5                         # ms

    class OnCard:
        is_cuda = True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    reg, tracer = ometrics.MetricsRegistry(), otrace.Tracer()
    with kernel_timer(registry=reg, tracer=tracer):
        for _ in range(3):
            ops._dispatch("nm", lambda x: x, OnCard())
        assert reads == [] and reg.value("kernel_dispatch_total",
                                         kind="nm") == 3
        assert [e["dur"] for e in tracer.events] == [0.0] * 3
    assert reads == ["sync", "read"] * 3
    assert [e["dur"] for e in tracer.events] == [0.0025] * 3
    hist = reg.snapshot()["histograms"]["kernel_dispatch_seconds{kind=nm}"]
    assert hist["count"] == 3 and hist["sum"] == pytest.approx(0.0075)


@pytest.mark.parametrize("flag", ["sparseffn", "bf16params", "padheads"])
def test_flags_the_port_does_not_compute_raise(flag):
    """Where the reference computes under these flags on reduced
    chatglm3-6b (the bitmap-stored FFN params; bf16 params, which only its
    dry run reads; heads padded from 4 to 16), the port's model entry
    points raise ``NotImplementedError``: it never serves something else
    under a flag's name."""
    import jax
    from repro.configs import get_config as rget_config
    from repro.models import optflags as roptflags
    from repro.models.transformer import Model as RModel
    from repro_torch.configs import get_config
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    rcfg = rget_config("chatglm3-6b").reduced()
    with roptflags.optimizations((flag,)):
        model = RModel(rcfg)
        params = model.init(jax.random.key(0))
        logits, _ = model.decode_step(params, model.init_cache(2, 8),
                                      jnp.array([1, 2], jnp.int32),
                                      jnp.asarray(0, jnp.int32))
        assert bool(jnp.all(jnp.isfinite(logits)))
    with optflags.optimizations((flag,)):
        with pytest.raises(NotImplementedError, match=flag):
            Model(get_config("chatglm3-6b").reduced()).init(seed=0,
                                                            device="cpu")
