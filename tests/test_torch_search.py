"""The port's search plane (``repro_torch.core``, ``exec.plans``) against
the reference's ``repro.core`` / ``repro.exec.plans``, on the same inputs.

Every module is a numpy-only copy, so the contract is equality, not a
tolerance: the same formats, allocation plans, size reports, mappings,
candidates, cost arrays (``np.array_equal``), design points and plan JSON
(byte for byte).  Each case builds its inputs through one package's
modules (a namespace of them, ``REF`` or ``PORT``) and compares the two
results as plain values (:func:`plain`: dataclasses as their fields,
enums by name, arrays by dtype, shape and items, floats by ``repr``).
Both memo registries are cleared before a comparison, and the plan cases
run once cold and once warm.
"""

import dataclasses
import enum
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.configs import get_config as rget_config
from repro.core import arch as r_arch
from repro.core import baselines as r_baselines
from repro.core import codesign as r_codesign
from repro.core import cosearch as r_cosearch
from repro.core import costmodel as r_costmodel
from repro.core import dataflow as r_dataflow
from repro.core import engine as r_engine
from repro.core import formats as r_formats
from repro.core import memo as r_memo
from repro.core import primitives as r_primitives
from repro.core import sparsity as r_sparsity
from repro.core import workload as r_workload
from repro.exec import plans as r_plans
from repro_torch.configs import get_config
from repro_torch.core import arch as t_arch
from repro_torch.core import baselines as t_baselines
from repro_torch.core import codesign as t_codesign
from repro_torch.core import cosearch as t_cosearch
from repro_torch.core import costmodel as t_costmodel
from repro_torch.core import dataflow as t_dataflow
from repro_torch.core import engine as t_engine
from repro_torch.core import formats as t_formats
from repro_torch.core import memo as t_memo
from repro_torch.core import primitives as t_primitives
from repro_torch.core import sparsity as t_sparsity
from repro_torch.core import workload as t_workload
from repro_torch.exec import plans as t_plans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = types.SimpleNamespace(
    arch=r_arch, baselines=r_baselines, codesign=r_codesign,
    cosearch=r_cosearch, costmodel=r_costmodel, dataflow=r_dataflow,
    engine=r_engine, formats=r_formats, memo=r_memo, prims=r_primitives,
    sparsity=r_sparsity, workload=r_workload, plans=r_plans,
    get_config=rget_config)
PORT = types.SimpleNamespace(
    arch=t_arch, baselines=t_baselines, codesign=t_codesign,
    cosearch=t_cosearch, costmodel=t_costmodel, dataflow=t_dataflow,
    engine=t_engine, formats=t_formats, memo=t_memo, prims=t_primitives,
    sparsity=t_sparsity, workload=t_workload, plans=t_plans,
    get_config=get_config)


def plain(x):
    """``x`` as nested tuples of builtins, equal across the two packages
    exactly when the values are: dataclasses by class name and fields,
    enums by class and member name, arrays by dtype, shape and items,
    floats by ``repr`` (exact, and NaN equals NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, plain(x.tolist()))
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float):
        return ("float", repr(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((repr(plain(k)), plain(v))
                                        for k, v in x.items()))
    return x


def both(fn):
    """``fn(REF)`` and ``fn(PORT)``, each on a cleared memo registry."""
    out = []
    for ns in (REF, PORT):
        ns.memo.clear()
        out.append(fn(ns))
    return out


def assert_same(fn):
    ref, port = both(fn)
    assert plain(ref) == plain(port)
    return ref, port


def fast(ns, **kw):
    """The serve CLI's small search budget (``tests/test_exec.py``'s
    ``FAST``)."""
    return ns.cosearch.CoSearchConfig(
        objective="edp",
        engine=ns.engine.EngineConfig(max_levels=2,
                                      max_allocs_per_pattern=16),
        spatial_top=2, max_pairs=6, **kw)


def opt125m(ns):
    """``examples/quickstart.py``'s OPT-125M workload."""
    return ns.workload.build_llm(ns.workload.OPT_125M, seq=256,
                                 decode_tokens=32, act_density=0.35,
                                 w_density=0.15, fc2_act_density=0.05)


SPARSITIES = {
    "bernoulli": lambda sp: sp.Bernoulli(0.3),
    "block": lambda sp: sp.BlockBernoulli(0.5, 32 * 32),
    "nm": lambda sp: sp.NM(2, 4),
}
DIMS = ({"M": 64, "N": 96}, {"N": 256, "K": 128}, {"M": 1, "K": 4096})


def _spec(ns, dims, kind, bits=16):
    return ns.sparsity.TensorSpec(dict(dims), SPARSITIES[kind](ns.sparsity),
                                  bits)


# ---------------------------------------------------------------------------
# primitives, formats, sparsity
# ---------------------------------------------------------------------------

def test_primitives_equal_the_reference():
    def run(ns):
        p = ns.prims
        stats = [p.LevelStats(s, f, n, c) for s, f, n, c in
                 ((1.0, 16, 9.5, 3.25), (12.0, 4, 30.0, 1.0),
                  (3.5, 1024, 700.25, 0.5))]
        return ([p.clog2(x) for x in (0.5, 1, 2, 3, 1000, 2 ** 40 + 1)],
                {k.name: v for k, v in p.DECODE_COST.items()},
                [[p.metadata_bits(prim, s) for s in stats]
                 for prim in p.Prim
                 if prim not in (p.Prim.CUSTOM,)],
                [p.keeps_only_nonempty(prim) for prim in p.Prim])
    assert_same(run)


@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_formats_and_allocation_plans_equal_the_reference(dims):
    def run(ns):
        f = ns.formats
        std = {k: str(v) for k, v in f.standard_formats(dims).items()}
        pats = list(f.enumerate_patterns(list(dims), max_levels=2))
        plans = [list(f.allocation_plans(pat, dims, max_allocs=16))
                 for pat in pats[:12]]
        fmts = [[str(x) for x in f.allocate(pat, dims, max_allocs=4)]
                for pat in pats[:12]]
        return std, pats, plans, fmts, list(f.factorizations(4096, 3))
    assert_same(run)


@pytest.mark.parametrize("kind", sorted(SPARSITIES))
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_size_reports_equal_the_reference(dims, kind):
    """``analyze`` per format, ``analyze_batch`` and ``analyze_plans`` at
    Bernoulli, BlockBernoulli and N:M specs."""
    def run(ns):
        f, sp = ns.formats, ns.sparsity
        spec = _spec(ns, dims, kind)
        fmts = list(f.standard_formats(dims).values())
        for pat in list(f.enumerate_patterns(list(dims), max_levels=2))[:6]:
            fmts += list(f.allocate(pat, dims, max_allocs=3))
        one = [sp.analyze(x, spec) for x in fmts]
        batch = sp.analyze_batch(fmts, spec)
        pat = next(iter(f.enumerate_patterns(list(dims), max_levels=2,
                                             min_levels=2)))
        rows = sp.analyze_plans(list(f.allocation_plans(pat, dims,
                                                        max_allocs=16)),
                                spec)
        return one, batch, rows
    assert_same(run)


def test_arch_and_workloads_equal_the_reference():
    def run(ns):
        a, w = ns.arch, ns.workload
        return (a.ALL_ARCHS, a.TPUV5E, a.arch_by_name("TPUv5e"),
                a.arch_by_name("arch3"),
                a.with_streaming_reuse(a.ARCH3, 0.25),
                opt125m(ns), w.alexnet(), w.resnet18(),
                w.build_llm(w.LLAMA2_7B, seq=128, decode_tokens=8))
    assert_same(run)


# ---------------------------------------------------------------------------
# dataflow, engine, cost model
# ---------------------------------------------------------------------------

def _op(ns, m=64, n=96, k=128):
    sp = ns.sparsity
    return ns.workload.MatMul("op", m, n, k, sp.Bernoulli(0.4),
                              sp.Bernoulli(0.3), sp.Bernoulli(0.5))


@pytest.mark.parametrize("arch", ["ARCH2", "ARCH3", "TPUV5E"])
def test_mappings_equal_the_reference(arch):
    def run(ns):
        op, hw = _op(ns), getattr(ns.arch, arch)
        maps = list(ns.dataflow.enumerate_mappings(op, hw, 0.6, 0.4,
                                                   spatial_top=3))
        memo_maps = ns.dataflow.mappings_for(op, hw, 0.6, 0.4, 3)
        refetch = [ns.dataflow.irrelevant_refetch(o, side,
                                                  {"M": 3, "N": 5, "K": 7})
                   for o in ns.dataflow.ORDERS for side in "IWO"]
        return maps, memo_maps, refetch
    ref, port = assert_same(run)
    assert ref[0]


@pytest.mark.parametrize("kind", sorted(SPARSITIES))
def test_engine_candidates_equal_the_reference(kind):
    """``generate_candidates`` (batched and the scalar loop) and
    ``allocate_for_mappings`` on a W-side spec."""
    def run(ns):
        e = ns.engine
        spec = _spec(ns, {"N": 256, "K": 512}, kind)
        cfg = e.EngineConfig(max_levels=2, max_allocs_per_pattern=16)
        stats = e.SearchStats()
        cands = e.generate_candidates(spec, cfg, stats=stats)
        loop = e.generate_candidates(spec, cfg, use_batch=False)
        op = ns.workload.MatMul("w", 64, 256, 512, ns.sparsity.DENSE,
                                spec.sparsity)
        maps = list(ns.dataflow.enumerate_mappings(op, ns.arch.ARCH3,
                                                   spatial_top=2))[:40]
        allocs = [e.allocate_for_mappings(c.fmt.levels, spec.dims,
                                          {"M": 64, "N": 256, "K": 512},
                                          maps)
                  for c in cands[:3]]
        return cands, loop, stats, [[str(f) for f in a] for a in allocs]
    assert_same(run)


def _pool(ns, spec):
    f, cm = ns.formats, ns.costmodel
    pool = [cm.compile_format(None, spec)]
    pool += [cm.compile_format(x, spec)
             for x in f.standard_formats(spec.dims).values()]
    for pat in list(f.enumerate_patterns(list(spec.dims), max_levels=2))[:8]:
        pool += [cm.compile_format(x, spec)
                 for x in f.allocate(pat, spec.dims, max_allocs=2)]
    return pool


@pytest.mark.parametrize("arch", ["ARCH2", "ARCH3"])
def test_cost_arrays_equal_the_reference(arch):
    """``evaluate`` reports and ``evaluate_batch`` /
    ``evaluate_batch_gather`` arrays (serial and chunked tails), element for
    element."""
    fields = ("energy", "cycles", "edp", "utilization", "dram_bits",
              "e_dram", "e_glb", "e_decode", "dram_cycles", "compute_cycles")

    def run(ns):
        cm, sp = ns.costmodel, ns.sparsity
        op, hw = _op(ns), getattr(ns.arch, arch)
        maps = list(ns.dataflow.enumerate_mappings(op, hw,
                                                   spatial_top=2))[:48]
        spec_i = sp.TensorSpec(op.i_dims(), op.sp_i, op.value_bits)
        spec_w = sp.TensorSpec(op.w_dims(), op.sp_w, op.value_bits)
        spec_o = sp.TensorSpec(op.o_dims(), op.sp_o, op.value_bits)
        pool_i, pool_w = _pool(ns, spec_i), _pool(ns, spec_w)
        cf_o = cm.compile_format(
            ns.formats.standard_formats(spec_o.dims)["Bitmap"], spec_o)
        rng = np.random.default_rng(7)
        rows = 40 * len(maps)
        map_idx = rng.integers(0, len(maps), rows)
        i_idx = rng.integers(0, len(pool_i), rows)
        w_idx = rng.integers(0, len(pool_w), rows)
        reports = [cm.evaluate(op, hw, maps[j], pool_i[i_idx[j]],
                               pool_w[w_idx[j]], cf_o) for j in range(24)]
        batch = cm.evaluate_batch(op, hw, [maps[x] for x in map_idx[:200]],
                                  [(pool_i[a], pool_w[b]) for a, b in
                                   zip(i_idx[:200], w_idx[:200])], cf_o)
        table = cm.pack_mappings(maps)
        ft_i = cm.format_fetch_table(pool_i, table)
        ft_w = cm.format_fetch_table(pool_w, table)
        gathers = [cm.evaluate_batch_gather(op, hw, table, ft_i, i_idx, ft_w,
                                            w_idx, map_idx, cf_o,
                                            eval_threads=t)
                   for t in (1, 3)]
        arrays = [[getattr(b, f) for f in fields] + [b.e_rf, b.e_mac]
                  for b in [batch] + gathers]
        return (reports, [cm.memory_energy(r) for r in reports], pool_w,
                arrays)
    (rep, _, _, ref_arrays), (got, _, _, port_arrays) = both(run)
    assert plain(rep) == plain(got)
    for want, have in zip(ref_arrays, port_arrays):
        for a, b in zip(want, have):
            assert np.array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype


# ---------------------------------------------------------------------------
# co-search, multi-model search, baselines
# ---------------------------------------------------------------------------

def _result(res):
    """A ``SearchResult`` less its wall-clock seconds."""
    return res.design, res.evaluations, res.stats


@pytest.mark.parametrize("op_workers", [1, 2])
def test_cosearch_on_opt125m_equals_the_reference(op_workers):
    """``examples/quickstart.py``'s workload on ARCH3 under the small
    budget: the same design point (formats, mappings, every cost), the
    same evaluation count and search statistics; then warm."""
    def run(ns):
        wl, cfg = opt125m(ns), fast(ns, op_workers=op_workers)
        cold = _result(ns.cosearch.cosearch(wl, ns.arch.ARCH3, cfg))
        warm = _result(ns.cosearch.cosearch(wl, ns.arch.ARCH3, cfg))
        fixed = _result(ns.cosearch.cosearch(
            wl, ns.arch.ARCH3, cfg, fixed_formats=("CSR", "Bitmap")))
        return cold, warm[:2], fixed
    (ref, _, _), (port, warm, _) = assert_same(run)
    assert plain(port[:2]) == plain(warm)
    assert ref[0].ops


def _two_workloads(ns):
    w = ns.workload
    return [w.build_llm(w.LLMSpec("A", 2, 256, 1024, 4), seq=64,
                        act_density=0.2, w_density=0.2),
            w.build_llm(w.LLMSpec("B", 2, 256, 1024, 4), seq=64,
                        act_density=0.8, w_density=0.8)]


def _multi(res):
    designs, key, val = res
    return ({k: (v.design, v.evaluations) for k, v in designs.items()},
            key, val)


def test_cosearch_multi_with_threads_equals_the_reference():
    def run(ns):
        return _multi(ns.cosearch.cosearch_multi(
            _two_workloads(ns), ns.arch.ARCH3, {"A": 99.0, "B": 1.0},
            fast(ns), workers=2, executor="thread"))
    assert_same(run)


_PROCESS_CHILD = r"""
import json, sys
import torch
torch.ones(4).sum()                 # the parent holds torch and its pool
sys.path.insert(0, {tests!r})
from test_torch_search import PORT, _multi, _two_workloads, fast, plain
res = PORT.cosearch.cosearch_multi(
    _two_workloads(PORT), PORT.arch.ARCH3, {{"A": 99.0, "B": 1.0}},
    fast(PORT), workers=2, executor="process")
print(json.dumps(repr(plain(_multi(res)))))
"""


def test_cosearch_multi_with_processes_equals_the_reference():
    """Two process workers started from a parent that holds torch and its
    thread pool: the merged result is the reference's serial one.  The
    parent runs in a child interpreter, so a hung pool ends at the time
    limit instead of holding the test run."""
    REF.memo.clear()
    want = plain(_multi(REF.cosearch.cosearch_multi(
        _two_workloads(REF), REF.arch.ARCH3, {"A": 99.0, "B": 1.0},
        fast(REF))))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c",
         _PROCESS_CHILD.format(tests=os.path.join(ROOT, "tests"))],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == repr(want)


@pytest.mark.parametrize("mode", ["fixed", "search", "dimo"])
def test_baselines_equal_the_reference(mode):
    """The paper's comparators in their deterministic modes: stepwise
    fixed-format and count-budgeted format search (with its pair visit
    log), and the seeded DiMO-like walk."""
    def run(ns):
        b = ns.baselines
        wl, cfg, hw = opt125m(ns), fast(ns), ns.arch.ARCH3
        if mode == "fixed":
            return _result(b.stepwise_search(
                wl, hw, cfg, fixed_formats=("Bitmap", "Bitmap")))
        if mode == "search":
            log = []
            wl = ns.workload.Workload("two", wl.ops[:2])
            res = b.stepwise_search(wl, ns.arch.ARCH2, cfg,
                                    search_formats=True,
                                    budget_pairs_per_op=40, pair_log=log)
            return _result(res), log
        return _result(b.dimo_like_search(wl, hw, cfg, restarts=4, iters=40,
                                          seed=3))
    assert_same(run)


# ---------------------------------------------------------------------------
# memo registry
# ---------------------------------------------------------------------------

def test_memo_registry_equals_the_reference():
    """The same caches by name; after the same search, the same hit and
    miss counts and entries; export / import round-trips the port's state.
    (The reference's registry may also hold caches other tests registered,
    ``tests/test_memo.py``: only the port's names are compared.)"""
    names = set(t_memo.stats())

    def run(ns):
        ns.memo.reset_stats()
        ns.cosearch.cosearch(opt125m(ns), ns.arch.ARCH3, fast(ns))
        stats = {k: (v.hits, v.misses) for k, v in ns.memo.stats().items()
                 if k in names}
        sizes = {k: len(v) for k, v in ns.memo.export_state().items()
                 if k in names}
        return stats, sizes
    ref, port = assert_same(run)
    assert set(port[0]) == names and any(h for h, _ in port[0].values())
    state = t_memo.export_state()
    t_memo.clear()
    t_memo.import_state(state)
    assert {k: len(v) for k, v in t_memo.export_state().items()} == \
        {k: len(v) for k, v in state.items()}


def test_memo_snapshot_round_trips(tmp_path):
    path = str(tmp_path / "memo.pkl")
    t_memo.clear()
    PORT.cosearch.cosearch(opt125m(PORT), PORT.arch.ARCH3, fast(PORT))
    n = t_memo.save(path)
    cold = {k: len(v) for k, v in t_memo.export_state().items()}
    t_memo.clear()
    assert n > 0 and t_memo.load(path)
    assert {k: len(v) for k, v in t_memo.export_state().items()} == cold


# ---------------------------------------------------------------------------
# whole-model plans
# ---------------------------------------------------------------------------

def _cfgs(ns, reduced):
    cfg = ns.get_config("chatglm3-6b")
    return cfg.reduced() if reduced else cfg


def _plan_json(ns, reduced, make_sp, warm):
    cfg = _cfgs(ns, reduced)
    sp = make_sp(ns.sparsity)
    plan = ns.plans.build_exec_plan(cfg, sp, tokens=64,
                                    search_cfg=fast(ns), value_bits=32)
    if warm:
        again = ns.plans.build_exec_plan(cfg, sp, tokens=64,
                                         search_cfg=fast(ns), value_bits=32)
        assert again.to_json() == plan.to_json()
    return plan


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("kind", ["block", "nm"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_build_exec_plan_json_is_the_references(reduced, kind, warm):
    """``build_exec_plan(...).to_json()`` byte for byte, with a cleared
    registry and with a warm one; the live ``search`` result equal too,
    and out of the JSON and of equality."""
    ref, port = both(lambda ns: _plan_json(ns, reduced, SPARSITIES[kind],
                                           warm))
    assert port.to_json() == ref.to_json()
    assert plain(_result(port.search)) == plain(_result(ref.search))
    assert port == t_plans.ExecPlan.from_json(port.to_json())
    assert port.hardware() is t_arch.TPUV5E
    assert plain(port.sparsity) == plain(ref.sparsity)


@settings(max_examples=6, deadline=None)
@given(kind=st.sampled_from(["bernoulli", "block", "nm"]),
       density=st.floats(0.05, 0.95), block=st.sampled_from([16, 64, 1024]),
       n=st.integers(1, 7), reduced=st.booleans())
def test_build_exec_plan_json_over_sparsity_models(kind, density, block, n,
                                                   reduced):
    """Any sparsity model (density, block size, n:m) and either config:
    the port's plan JSON is the reference's, byte for byte."""
    m = 8 if n > 3 else 4

    def make(sp):
        if kind == "bernoulli":
            return sp.Bernoulli(density)
        if kind == "block":
            return sp.BlockBernoulli(density, block)
        return sp.NM(n, m)
    ref, port = both(lambda ns: _plan_json(ns, reduced, make, False))
    assert port.to_json() == ref.to_json()


def test_legacy_plan_surface_equals_the_reference():
    """``core.codesign``'s shim: ``plan_for_model`` on the FFN pair,
    ``translate`` and ``model_workload``."""
    def run(ns):
        cfg = _cfgs(ns, True)
        sp = ns.sparsity.BlockBernoulli(0.5, 1024)
        legacy = ns.codesign.plan_for_model(cfg, sp, tokens=64,
                                            search_cfg=fast(ns))
        return (legacy.choices, _result(legacy.search),
                ns.plans.model_workload(cfg, 64, sp, 0.5, 32),
                ns.codesign.ffn_workload(cfg, 64, sp), ns.codesign.MXU_ALIGN)
    assert_same(run)


def test_search_modules_import_no_torch():
    """A ``cosearch_multi`` process worker runs these modules only: they
    must not import torch (nor JAX)."""
    code = ("import sys, pkgutil, importlib, repro_torch.core as c\n"
            "for m in pkgutil.iter_modules(c.__path__):\n"
            "    if m.name != 'codesign':\n"
            "        importlib.import_module('repro_torch.core.' + m.name)\n"
            "bad = [m for m in ('torch', 'jax', 'repro') if m in sys.modules]\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
