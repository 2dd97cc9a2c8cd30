"""Deliberate divergences from the reference, pinned (ROADMAP.md, Queue
3): inputs the port's CUDA entries refuse and the reference computes; the
telemetry's counts and seconds; a mesh of more than one device, which the
port refuses; the errors ``padheads`` raises where the padded heads do
not group over the KV heads and where a plan's blocks do not tile the
padded weights.

N:M groups wider than 32 (``kernels/nm_spmm.py::MAX_M_GROUP``: the CUDA
kernels stage 32-column runs) are refused by both N:M entries with a
``ValueError`` before any launch, so the card never serves something else
in silence; the reference's kernels take any group.  On the CPU the port's
plain version serves them, equal to the reference.
"""

import dataclasses
import os
import pathlib

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


def _fast(pkg):
    """The serve CLI's search budget in one package (``repro`` or
    ``repro_torch``)."""
    import importlib
    cs = importlib.import_module(f"{pkg}.core.cosearch")
    eng = importlib.import_module(f"{pkg}.core.engine")
    return cs.CoSearchConfig(
        objective="edp",
        engine=eng.EngineConfig(max_levels=2, max_allocs_per_pattern=16),
        spatial_top=2, max_pairs=6)


@pytest.mark.parametrize("kind", ["bitmap", "nm"])
def test_glb_scale_follows_the_cuda_tiling_at_prefill(kind):
    """``calibrate`` at M = 512.  The distinct-fetch fit (``scale``, its
    errors and residuals) is the reference's: it reads sizes of the store.
    The stream side counts the CUDA kernels' passes (above), so the stream
    rows and ``max_stream_rel_err`` differ.  The searched plans predict no
    refetch (their loop orders keep W stationary), so ``glb_scale`` is the
    identity on both sides; on the same plan with four predicted passes
    a role (the reference's M / 128) the refetch fit is each package's fit
    of its own rows: about 1 for the reference, the CUDA passes' share
    above it for the port."""
    import importlib
    from repro import exec as rexec
    from repro_torch import exec as texec
    rcal = importlib.import_module("repro.exec.calibrate")
    tcal = importlib.import_module("repro_torch.exec.calibrate")
    rcfg, cfg, rcm, rpruned, cm, pruned = _reduced_pair(kind)
    plan = dataclasses.replace(cm.store.plan, checksums={})
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 128))
    with rexec.instrument() as want:
        rcm.hidden_states(rpruned, jnp.asarray(toks, jnp.int32))
    with texec.instrument() as got:
        cm.hidden_states(pruned, torch.from_numpy(toks))
    four = dataclasses.replace(plan, ops=tuple(
        dataclasses.replace(op, predicted_w_stream_bits=4 *
                            op.predicted_w_fetch_bits) for op in plan.ops))
    for p, refetch in ((plan, False), (four, True)):
        rp = rexec.ExecPlan.from_json(p.to_json())
        rrep = rexec.calibrate(rcfg, rp, want, search_cfg=_fast("repro"))
        rep = texec.calibrate(cfg, p, got, search_cfg=_fast("repro_torch"))
        assert (rep.scale, rep.max_rel_err, rep.max_residual) == \
            (rrep.scale, rrep.max_rel_err, rrep.max_residual)
        assert [(r.measured_bits, r.predicted_bits) for r in rep.rows] == \
            [(r.measured_bits, r.predicted_bits) for r in rrep.rows]
        assert [r.measured_stream_bits for r in rep.rows] != \
            [r.measured_stream_bits for r in rrep.rows]
        assert rep.max_stream_rel_err != rrep.max_stream_rel_err
        assert rep.glb_scale == tcal.fit_glb_scale(tcal.compare(p, got))
        assert rrep.glb_scale == rcal.fit_glb_scale(rcal.compare(rp, want))
        assert rep.calibrated_plan.glb_energy_scale == rep.glb_scale
        if refetch:
            assert abs(rrep.glb_scale - 1.0) < 0.1
            assert rep.glb_scale > 1.5 * rrep.glb_scale
        else:
            assert rep.glb_scale == rrep.glb_scale == 1.0
            assert rep.calibrated_plan.to_json() == \
                rrep.calibrated_plan.to_json()


def test_memo_fingerprint_is_the_ports_own(tmp_path):
    """``memo.code_fingerprint`` hashes the port's own sources, so a
    durable snapshot the reference wrote is stale to the port (``load``
    gives False and imports nothing) and the other way round; each
    package loads its own."""
    import hashlib
    from repro.core import memo as rmemo
    from repro.core import sparsity as rsp
    from repro.core.formats import standard_formats as rstd
    from repro_torch.core import memo as tmemo
    from repro_torch.core import sparsity as tsp
    from repro_torch.core.formats import standard_formats as tstd
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tmemo.__file__)))
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(pkg)):
        for f in sorted(x for x in files if x.endswith(".py")):
            path = os.path.join(root, f)
            h.update(os.path.relpath(path, pkg).encode())
            h.update(pathlib.Path(path).read_bytes())
    assert os.path.basename(pkg) == "repro_torch"
    assert tmemo.code_fingerprint() == h.hexdigest()
    assert tmemo.code_fingerprint() != rmemo.code_fingerprint()
    dims = {"N": 64, "K": 32}
    for memo, sp, std in ((rmemo, rsp, rstd), (tmemo, tsp, tstd)):
        memo.clear()
        spec = sp.TensorSpec(dims, sp.Bernoulli(0.3))
        for fmt in std(dims).values():
            sp.analyze(fmt, spec)
    rpath, tpath = str(tmp_path / "ref.pkl"), str(tmp_path / "port.pkl")
    assert rmemo.save(rpath) > 0 and tmemo.save(tpath) > 0
    rmemo.clear()
    tmemo.clear()
    assert not tmemo.load(rpath) and not rmemo.load(tpath)
    assert not any(tmemo.export_state().values())
    assert tmemo.load(tpath) and rmemo.load(rpath)
    assert any(tmemo.export_state().values())


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


@pytest.mark.parametrize("entry", ["generate", "guarded_generate",
                                   "serve --mesh", "train", "shard"])
def test_a_mesh_of_more_than_one_device_raises(entry, monkeypatch):
    """The reference shards over a (data, model) mesh with ``model`` > 1
    (tensor parallelism).  The port serves a ``model`` axis for the
    uniform attention stacks with no optflag on
    (``tests/test_torch_tensor_parallel.py``), the MoE models
    (``tests/test_torch_tensor_parallel_moe.py``) and gemma3 and the
    windowed stacks (``tests/test_torch_tensor_parallel_ring.py``), and
    raises ``NotImplementedError`` for everything else before it serves
    anything, never running unsharded in its place: here a reduced
    recurrentgemma-2b (RG-LRU under a ``model`` axis is not ported)
    through ``generate``, ``guarded_generate`` and ``serve --mesh``.
    Training takes a mesh's data axes only, and a bare ``shard(...,
    "model")`` outside the tensor-parallel driver raises.  A (2, 2) mesh
    over the CPU repeated; the two CLI entries get it through the mesh
    function each calls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Model
    cpu = torch.device("cpu")
    tp = mesh.Mesh(("data", "model"), (2, 2), mesh.grid([cpu] * 4, (2, 2)))
    monkeypatch.setattr(mesh, "make_serve_mesh", lambda *a, **k: tp)
    monkeypatch.setattr(mesh, "make_small_mesh", lambda *a, **k: tp)
    monkeypatch.setattr(serve, "make_serve_mesh", lambda *a, **k: tp)
    monkeypatch.setattr(mesh, "devices", lambda device="cuda": [cpu] * 4)
    cfg = get_config("recurrentgemma-2b").reduced()
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    prompts = torch.zeros((4, 4), dtype=torch.long)
    calls = {
        "generate": lambda: serve.generate(model, params, prompts, 2, 8,
                                           mesh=tp, device="cpu"),
        "guarded_generate": lambda: serve.generate(
            model, params, prompts, 2, 8, mesh=tp, guarded=True,
            device="cpu"),
        "serve --mesh": lambda: serve.main([
            "--arch", "recurrentgemma-2b", "--reduced", "--batch", "4",
            "--prompt-len", "4", "--gen", "2", "--mesh", "--device", "cpu"]),
        "train": lambda: train.main([
            "--arch", "chatglm3-6b", "--reduced", "--steps", "1",
            "--batch", "2", "--seq", "8", "--device", "cpu"]),
    }
    if entry == "shard":
        with tp, sharding.logical_axis_rules(mesh.axis_map_for(tp)):
            assert sharding.shard(torch.ones(4, 2), "batch", None) is not \
                None
            with pytest.raises(NotImplementedError, match="'model' of 2"):
                sharding.shard(torch.ones(4, 2), "batch", "model")
        return
    with pytest.raises(NotImplementedError, match="'model': 2"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["loss", "decode_step"])
def test_padded_heads_the_kv_heads_do_not_group_raise_value_error(entry):
    """whisper-tiny under ``padheads``: 6 query heads padded to 16 over 6
    KV heads.  Both packages fail: the reference with a ``TypeError``
    (a reshape) in its full-sequence attention and a ``ValueError`` (an
    einsum) at decode; the port with a ``ValueError`` in both, naming the
    head counts (at decode, first the cross-attention's query width).
    Shapes only: meta tensors on the port's side."""
    import jax
    from repro.configs import get_config as rget_config
    from repro.models import optflags as roptflags
    from repro.models.transformer import Model as RModel
    from repro_torch.configs import get_config
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    rcfg, cfg = rget_config("whisper-tiny"), get_config("whisper-tiny")
    flags = ("padheads",)
    with roptflags.optimizations(flags):
        rmodel = RModel(rcfg)
        rparams = jax.eval_shape(lambda: rmodel.init(jax.random.key(0)))
        if entry == "loss":
            batch = {"tokens": jax.ShapeDtypeStruct((1, 8), jnp.int32),
                     "labels": jax.ShapeDtypeStruct((1, 8), jnp.int32),
                     "enc_frames": jax.ShapeDtypeStruct(
                         (1, rcfg.enc_seq, rcfg.d_model), jnp.float32)}
            with pytest.raises(TypeError, match="reshape"):
                jax.eval_shape(rmodel.loss, rparams, batch)
        else:
            cache = jax.eval_shape(lambda: rmodel.init_cache(2, 8))
            with pytest.raises(ValueError):
                jax.eval_shape(rmodel.decode_step, rparams, cache,
                               jax.ShapeDtypeStruct((2,), jnp.int32),
                               jax.ShapeDtypeStruct((), jnp.int32))
    meta = torch.device("meta")
    with optflags.optimizations(flags):
        model = Model(cfg)
        params = model.init(device="meta")
        match = "16 query heads do not group over 6 KV heads" \
            if entry == "loss" else "cross-attention decode takes 6 heads"
        with pytest.raises(ValueError, match=match):
            if entry == "loss":
                tokens = torch.zeros((1, 8), dtype=torch.long, device=meta)
                model.loss(params, {
                    "tokens": tokens, "labels": tokens,
                    "enc_frames": torch.zeros((1, cfg.enc_seq, cfg.d_model),
                                              device=meta)})
            else:
                model.decode_step(params,
                                  model.init_cache(2, 8, device="meta"),
                                  torch.zeros(2, dtype=torch.long,
                                              device=meta), 0)


def test_padded_weights_the_plans_blocks_do_not_tile_raise_value_error():
    """deepseek-coder-33b under ``padheads``: the bitmap plan (searched on
    the unpadded roles) stores wq in 1024 x 7168 blocks, which do not tile
    the padded 7168 x 8192 wq.  Both packages refuse the plan before any
    kernel runs: the reference's ``block_prune`` with an
    ``AssertionError``, the port's with a ``ValueError`` naming the block
    and the weight.  Shapes only (one layer): meta tensors on the port's
    side."""
    import jax
    from repro import exec as rexec
    from repro.configs import get_config as rget_config
    from repro.models import optflags as roptflags
    from repro.models.transformer import Model as RModel
    from repro_torch import exec as texec
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    rcfg = dataclasses.replace(rget_config("deepseek-coder-33b"), n_layers=1)
    cfg = dataclasses.replace(get_config("deepseek-coder-33b"), n_layers=1)
    plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY["bitmap"])
    wq = next(op.choice for op in plan.ops if op.role == "attn.wq")
    assert (wq.block_n, wq.block_k) == (1024, 7168)
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    with roptflags.optimizations(("padheads",)):
        rparams = jax.eval_shape(lambda: RModel(rcfg).init(
            jax.random.key(0)))
        with pytest.raises(AssertionError):
            jax.eval_shape(lambda p: rexec.prune_params(p, rplan, rcfg),
                           rparams)
    with optflags.optimizations(("padheads",)):
        params = Model(cfg).init(device="meta")
        with pytest.raises(ValueError, match=r"block \(1024, 7168\) does "
                                             r"not tile \(7168, 8192\)"):
            texec.prune_params(params, plan, cfg)


def test_the_dry_run_gives_no_per_device_terms_on_a_production_mesh():
    """The reference's dry run reads per-device FLOPs, bytes and
    collectives from post-partitioning HLO; the port has no partitioner.
    On a production mesh its record says ``"partitioned": false``, leaves
    those fields and the peak ``null`` and gives the whole step's counts
    under ``step_flops`` / ``step_bytes``; the per-device argument and
    output bytes come from the specs.  On a mesh of one device the
    per-device fields are the step's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    cfg = get_config("chatglm3-6b").reduced()
    multi = dryrun.run_cell("chatglm3-6b", "decode_32k", False, cfg=cfg)
    assert multi["ok"] and multi["devices"] == 256
    assert multi["partitioned"] is False
    assert multi["flops"] is multi["hlo_bytes"] is None
    assert multi["collectives"] is multi["coll_bytes"] is None
    assert multi["memory_analysis"]["peak_memory_in_bytes"] is None
    assert multi["step_flops"] > 0 and multi["step_bytes"] > 0
    one = dryrun.run_cell("chatglm3-6b", "decode_32k", False, cfg=cfg,
                          mesh=Mesh(("data", "model"), (1, 1)))
    assert one["ok"] and one["devices"] == 1 and one["partitioned"] is True
    assert (one["flops"], one["hlo_bytes"]) == \
        (one["step_flops"], one["step_bytes"]) == \
        (multi["step_flops"], multi["step_bytes"])
    assert one["coll_bytes"] == one["collectives"]["count"] == 0
    mem = one["memory_analysis"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > \
        multi["memory_analysis"]["argument_size_in_bytes"]
