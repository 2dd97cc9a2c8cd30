"""Progressive co-search workflow (paper §III-D, Fig. 7 right).

Interleaves dataflow and compression-format exploration in a single forward
pass, with no post-hoc correction loops:

  1. the Sparsity Analyzer models the computation-reduction strategy UPFRONT
     (effective MAC/cycle fractions shrink temporal bounds before any
     dataflow is generated);
  2. compression patterns are generated (adaptive engine, penalty-pruned);
  3. per pattern, loop ordering/tiling candidates are enumerated with
     COMPRESSION-AWARE legality (compressed tile sizes → more tilings legal,
     none invalidated later);
  4. the dimension allocation is derived from each candidate mapping
     (efficiency-oriented allocating), and the evaluator scores the joint
     (format, mapping) point.

One compression pattern is selected per operand role for the whole workload
(hardware ships a single format decoder); dimension allocations follow each
operator's own tiling.

Hot-loop structure: per (op, pattern pair), the mapping space comes from the
memoized :func:`repro_torch.core.dataflow.mappings_for`, mapping-derived
allocations are deduplicated per (tile, spatial) factor tuple (loop order
does not enter the allocation) and derived for all tuples in one
:func:`repro_torch.core.engine.allocate_for_mappings` call, and the whole
candidate set scores through the gather evaluator
(:func:`repro_torch.core.costmodel.evaluate_batch_gather`): the op's mapping set
packs once, each side's UNIQUE derived/reference formats build one
:func:`repro_torch.core.costmodel.format_fetch_table`, candidate rows are
(mapping, format row) index triples, and the mapping-only formula half
(:func:`repro_torch.core.costmodel.mapping_ctx`) is memoized by (op shape, arch,
exact ratio tuple, cf_o) so pattern pairs with coinciding reference ratios
share one context.  ``use_gather=False`` keeps the earlier per-row
:func:`repro_torch.core.costmodel.evaluate_batch` repack as a benchmark
reference, ``use_batch=False`` the seed scalar loop — all three
bit-identical.  Whole `_search_op` results are memoized by (op
shape+sparsity+count, arch, candidate pair, config) so identical layers
are searched once across pairs and models; see :mod:`repro_torch.core.memo` for
the cache registry and key conventions.  :func:`cosearch_multi` flattens
(pair, model) items into a work-list that can shard across threads or
processes (``workers=``, ``executor=``) with a deterministic merge;
process workers ship their `_search_op`/compile/`mapping_ctx` cache deltas
back for the parent to :func:`repro_torch.core.memo.import_state`, so later
searches over shared op shapes replay instead of recomputing.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import memo
from repro_torch.core.arch import HardwareConfig
from repro_torch.core.costmodel import (CompiledFormat, CostReport, cf_key,
                                        compile_format, dense_format, evaluate,
                                        evaluate_batch, evaluate_batch_gather,
                                        format_fetch_table, format_key,
                                        mapping_ctx, memory_energy,
                                        pack_mappings)
from repro_torch.core.dataflow import Mapping, mappings_for
from repro_torch.core.engine import (Candidate, EngineConfig, SearchStats,
                                     allocate_for_mapping,
                                     allocate_for_mappings,
                                     generate_candidates, reference_allocation)
from repro_torch.core.formats import Format, Level, standard_formats
from repro_torch.core.primitives import Prim
from repro_torch.core.sparsity import TensorSpec
from repro_torch.core.workload import MatMul, Workload


class SearchError(RuntimeError):
    """The search space contains no legal design.

    Raised instead of silently asserting: carries the operator name and the
    (pattern_i, pattern_w) pair that last failed to produce a legal
    (mapping, allocation), so callers can tell WHICH op/format combination
    exhausted the space (typically: no mapping fits the GLB under the
    compression ratios, or the pattern cannot be allocated on the op's
    dims)."""

    def __init__(self, message: str, op: Optional[str] = None,
                 pair: Optional[tuple] = None):
        super().__init__(message)
        self.op = op
        self.pair = pair


@dataclasses.dataclass(frozen=True)
class CoSearchConfig:
    objective: str = "edp"             # "energy" | "latency" | "edp"
    engine: EngineConfig = EngineConfig()
    spatial_top: int = 3
    max_pairs: int = 12                # (fmt_i, fmt_w) combos evaluated
    compress_threshold: float = 0.999  # only compress operands sparser than this
    use_batch: bool = True             # vectorized evaluator (False = the
    #                                    legacy scalar loop, for benchmarks)
    use_gather: bool = True            # score through evaluate_batch_gather
    #                                    over per-op fetch tables (False =
    #                                    the earlier per-row evaluate_batch
    #                                    repack, kept as a benchmark
    #                                    reference; bit-identical)
    eval_threads: Optional[int] = None  # _evaluate_terms tail chunking:
    #                                     None = auto, 1 = serial; any
    #                                     value is bit-identical (the tail
    #                                     is elementwise per row)
    op_workers: Optional[int] = None    # thread the per-op _search_op loop
    #                                     inside each pattern pair (ops are
    #                                     independent given the registry);
    #                                     None/1 = serial.  Results AND
    #                                     SearchStats are identical for any
    #                                     setting (deterministic replay
    #                                     merge in op order)


@dataclasses.dataclass
class OpDesign:
    op: MatMul
    mapping: Mapping
    fmt_i: Optional[Format]
    fmt_w: Optional[Format]
    cost: CostReport


@dataclasses.dataclass
class DesignPoint:
    ops: list[OpDesign]
    pattern_i: Optional[tuple]
    pattern_w: Optional[tuple]

    @property
    def energy(self) -> float:
        return sum(o.cost.energy for o in self.ops)

    @property
    def cycles(self) -> float:
        return sum(o.cost.cycles for o in self.ops)

    @property
    def edp(self) -> float:
        return self.energy * self.cycles

    @property
    def memory_energy(self) -> float:
        return sum(memory_energy(o.cost) for o in self.ops)

    def metric(self, objective: str) -> float:
        return {"energy": self.energy, "latency": self.cycles,
                "edp": self.edp}[objective]


@dataclasses.dataclass
class SearchResult:
    design: DesignPoint
    evaluations: int
    runtime_s: float
    stats: SearchStats


# ---------------------------------------------------------------------------

def _representative_spec(workload: Workload, role: str) -> TensorSpec:
    """The largest sparse tensor of the role drives pattern generation."""
    best, best_sz = None, -1.0
    for op in workload.ops:
        dims = op.i_dims() if role == "I" else op.w_dims()
        sp = op.sp_i if role == "I" else op.sp_w
        sz = float(op.M) * op.N if role == "I" else float(op.N) * op.K
        if sp.density < 1.0 and sz > best_sz:
            best, best_sz = TensorSpec(dims, sp, op.value_bits), sz
    if best is None:
        # dense role — no compression candidates
        op = workload.ops[0]
        dims = op.i_dims() if role == "I" else op.w_dims()
        sp = op.sp_i if role == "I" else op.sp_w
        best = TensorSpec(dims, sp, op.value_bits)
    return best


def _role_candidates(workload: Workload, role: str, cfg: CoSearchConfig,
                     stats: SearchStats) -> list[Optional[Candidate]]:
    spec = _representative_spec(workload, role)
    if spec.sparsity.density > cfg.compress_threshold:
        return [None]                   # dense operand: store uncompressed
    cands = generate_candidates(spec, cfg.engine, stats=stats,
                                use_batch=cfg.use_batch)
    side = max(2, int(math.isqrt(cfg.max_pairs)) + 1)
    return list(cands[:side]) + [None]


def _bare_and_leaf(cand: Candidate
                   ) -> tuple[tuple[Level, ...], dict[str, int]]:
    """Strip sizes & dense head from a candidate's reference format; keep
    dense-leaf block factors (relative block shape travels with the
    pattern)."""
    bare = tuple(Level(l.prim, l.dim, None) for l in cand.fmt.levels
                 if l.prim is not Prim.NONE)
    pattern_dims_set = {l.dim for l in bare}
    leaf = {l.dim: int(l.size) for l in cand.fmt.levels
            if l.prim is Prim.NONE and l.dim in pattern_dims_set
            and l.size is not None}
    return bare, leaf


def _op_format(cand: Optional[Candidate], pattern_dims: dict[str, int],
               mapping: Mapping, spec: TensorSpec) -> Optional[CompiledFormat]:
    """Instantiate the candidate pattern on one op via mapping-derived
    allocation (efficiency-oriented allocating); standard named formats are
    instantiated directly (their layout IS their identity)."""
    if cand is None:
        return None
    if cand.fmt.name in ("Bitmap", "RLE", "CSR", "CSC", "COO"):
        return compile_format(standard_formats(spec.dims)[cand.fmt.name], spec)
    bare, leaf = _bare_and_leaf(cand)
    fmt = allocate_for_mapping(bare, spec.dims, spec.dims, mapping, leaf=leaf)
    if fmt is None:
        return None
    return compile_format(fmt, spec)


def _reference_cf(cand: Optional[Candidate], spec: TensorSpec
                  ) -> Optional[CompiledFormat]:
    """Best SIZE-optimal allocation of the candidate's pattern on this op's
    dims (the engine's reference view, independent of the mapping).

    The allocation scan lives in :func:`repro_torch.core.engine.
    reference_allocation`, whose cache :func:`~repro_torch.core.engine.
    generate_candidates` seeds as a by-product of candidate generation — on
    the representative spec the reference is a dict hit, not a second scan;
    only ops whose dims/sparsity differ fall through to one vectorized
    pass.  The compile itself is memoized by (format, spec)."""
    if cand is None:
        return None
    if cand.fmt.name in ("Bitmap", "RLE", "CSR", "CSC", "COO"):
        return compile_format(standard_formats(spec.dims)[cand.fmt.name], spec)
    bare, _ = _bare_and_leaf(cand)
    fmt = reference_allocation(bare, spec)
    return compile_format(fmt, spec) if fmt is not None else None


def output_cf(cand_i: Optional[Candidate], op: MatMul
              ) -> Optional[CompiledFormat]:
    """Output-activation writeback format: the I-side (activation) decoder
    re-used on O's dims (positional rename N→K) — O is the next operator's
    sparse input and leaves the chip compressed (SCNN-style)."""
    if cand_i is None or op.sp_o.density >= 0.999:
        return None
    spec_o = TensorSpec(op.o_dims(), op.sp_o, op.value_bits)
    if cand_i.fmt.name in ("Bitmap", "RLE", "CSR", "CSC", "COO"):
        return compile_format(standard_formats(spec_o.dims)[cand_i.fmt.name],
                              spec_o)
    rename = {"N": "K"}
    bare = tuple(Level(l.prim, rename.get(l.dim, l.dim), None)
                 for l in cand_i.fmt.levels if l.prim is not Prim.NONE)
    renamed = Candidate(Format(bare), cand_i.report, cand_i.eq_data)
    return _reference_cf(renamed, spec_o)


_SEARCH_OP_CACHE: dict = memo.register({}, "search_op")


def _search_op_key(op: MatMul, arch: HardwareConfig,
                   cand_i: Optional[Candidate], cand_w: Optional[Candidate],
                   cfg: CoSearchConfig) -> Optional[tuple]:
    """Cache key for a whole per-op search: the op's SHAPE + sparsity +
    repeat count (its name does not enter any formula), the architecture,
    the exact candidate pair, and the search config.  ``eval_threads`` and
    ``op_workers`` are normalized out of the key — they are perf-only knobs
    whose every setting is bit-identical by contract, so thread settings
    share one cache."""
    key = ((op.M, op.N, op.K, op.sp_i, op.sp_w, op.sp_o, op.count,
            op.value_bits), arch, cand_i, cand_w,
           dataclasses.replace(cfg, eval_threads=None, op_workers=None))
    try:
        hash(key)
    except TypeError:           # unhashable sparsity model / custom config
        return None
    return key


def _search_op(op: MatMul, arch: HardwareConfig,
               cand_i: Optional[Candidate], cand_w: Optional[Candidate],
               cfg: CoSearchConfig) -> tuple[Optional[OpDesign], int, bool]:
    """Best (mapping, allocation) for one op under a fixed pattern pair.

    Two allocations compete per mapping: the mapping-DERIVED one
    (efficiency-oriented allocating — perfectly aligned, possibly larger)
    and the SIZE-optimal reference (smaller, alignment-penalized by the
    cost model).  The evaluator arbitrates, which is exactly the paper's
    co-design argument made operational.

    Returns ``(design, evaluations, cache_hit)`` — ``evaluations`` replays
    the recorded count on a hit (warm and cold runs stay bit-identical);
    the flag lets callers track how much work was FRESH
    (``SearchStats.fresh_evaluations``)."""
    key = _search_op_key(op, arch, cand_i, cand_w, cfg)
    if memo.enabled() and key is not None:
        hit = _SEARCH_OP_CACHE.get(key)
        memo.note(_SEARCH_OP_CACHE, hit is not None)
        if hit is not None:
            od, evals = hit
            # the cached design came from an identically-shaped op; rebind
            # the identity (name) of THIS op
            return (dataclasses.replace(od, op=op) if od is not None
                    else None, evals, True)
    od, evals = _search_op_impl(op, arch, cand_i, cand_w, cfg)
    if memo.enabled() and key is not None:
        _SEARCH_OP_CACHE[key] = (od, evals)
    return od, evals, False


def _search_ops(ops: Sequence[MatMul], arch: HardwareConfig,
                cand_i: Optional[Candidate], cand_w: Optional[Candidate],
                cfg: CoSearchConfig
                ) -> tuple[list[OpDesign], int, int, Optional[str]]:
    """Search every op of a workload under one fixed pattern pair.

    Returns ``(designs, evaluations, fresh evaluations, failed op name or
    None)`` — the shared inner loop of :func:`cosearch` and
    :func:`_multi_work_item`.

    With ``cfg.op_workers`` > 1 the per-op searches run on a thread pool.
    Ops are independent given the candidate pair, so only the MERGE order
    matters: one pool task is submitted per unique :func:`_search_op_key`
    (duplicate-shape ops would otherwise race to compute the same entry;
    unkeyable ops each get their own task), then results are replayed IN OP
    ORDER — the first op of each key takes its task's (design, evals, hit)
    verbatim, later same-key ops re-probe :func:`_search_op` (a guaranteed
    cache hit that also rebinds the design to that op's name), and counting
    stops at the first failed op exactly where the serial loop breaks.
    Designs, evaluation counts, AND memo hit/miss counters are therefore
    bit-identical to the serial path for any worker count."""
    workers = cfg.op_workers
    if not workers or workers <= 1 or len(ops) < 2:
        designs: list[OpDesign] = []
        evals = fresh = 0
        for op in ops:
            od, e, hit = _search_op(op, arch, cand_i, cand_w, cfg)
            evals += e
            if not hit:
                fresh += e
            if od is None:
                return designs, evals, fresh, op.name
            designs.append(od)
        return designs, evals, fresh, None

    from concurrent.futures import ThreadPoolExecutor
    tasks: list[MatMul] = []            # one representative op per task
    task_of_op: list[tuple[int, bool]] = []     # (task index, first-of-key)
    if memo.enabled():
        owner: dict = {}                # cache key -> task index
        for op in ops:
            key = _search_op_key(op, arch, cand_i, cand_w, cfg)
            if key is not None and key in owner:
                task_of_op.append((owner[key], False))
                continue
            idx = len(tasks)
            tasks.append(op)
            if key is not None:
                owner[key] = idx
            task_of_op.append((idx, True))
    else:
        # no cache to dedup through: every op computes independently
        for i, op in enumerate(ops):
            tasks.append(op)
            task_of_op.append((i, True))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs = [ex.submit(_search_op, op, arch, cand_i, cand_w, cfg)
                for op in tasks]
        results = [f.result() for f in futs]
    designs = []
    evals = fresh = 0
    for op, (idx, first) in zip(ops, task_of_op):
        if first:
            od, e, hit = results[idx]
        else:
            od, e, hit = _search_op(op, arch, cand_i, cand_w, cfg)
        evals += e
        if not hit:
            fresh += e
        if od is None:
            return designs, evals, fresh, op.name
        designs.append(od)
    return designs, evals, fresh, None


def _derived_side(cand: Optional[Candidate], spec: TensorSpec,
                  rep_mappings: Sequence[Mapping], fixed: bool,
                  ref: CompiledFormat) -> list[CompiledFormat]:
    """Mapping-derived allocations for one operand side, one compile per
    representative mapping (falling back to the reference allocation where
    the derivation fails) — the batched equivalent of per-mapping
    :func:`_op_format` calls."""
    if fixed or cand is None:
        return [ref] * len(rep_mappings)
    bare, leaf = _bare_and_leaf(cand)
    fmts = allocate_for_mappings(bare, spec.dims, spec.dims, rep_mappings,
                                 leaf=leaf)
    return [compile_format(f, spec) if f is not None else ref for f in fmts]


def _factor_key(mapping: Mapping) -> tuple:
    """Dedup key of the mapping-derived allocation: the (tile, spatial)
    factor tuples — the loop order never enters the derivation.  Shared by
    every plane of :func:`_search_op_impl`, whose bit-identity contract
    depends on all of them deduplicating identically."""
    return (tuple(mapping.tile.items()), tuple(mapping.spatial.items()))


_MAPCTX_CACHE: dict = memo.register({}, "mapping_ctx")


def _mapping_ctx_for(op: MatMul, arch: HardwareConfig, ratio_i: float,
                     ratio_w: float, spatial_top: int,
                     cf_o: Optional[CompiledFormat],
                     mappings: Sequence[Mapping]):
    """Packed mapping table + mapping-only evaluator context for one op's
    mapping set, memoized by (op shape, arch, exact ratio tuple,
    spatial_top, cf_o value key).

    :func:`repro_torch.core.dataflow.mappings_for` is deterministic in exactly
    those inputs (names, repeat counts and sparsity models beyond the
    densities/probabilities the context reads do not enter), so pattern
    pairs whose reference ratios coincide — e.g. every metadata-heavy side
    whose ratio clips to 1.0, and identically-shaped layers across models —
    share one context instead of re-deriving it per pair.  The packed
    table is cf_o-independent, so it caches under its own (tagged) key:
    pairs differing only in output format share the table and only
    re-derive the context half."""
    base = ((op.M, op.N, op.K, op.value_bits, op.sp_i, op.sp_w), arch,
            (ratio_i, ratio_w), spatial_top)
    try:
        hash((base, cf_key(cf_o)))
        t_key = ("table", base)
        c_key = ("ctx", base, cf_key(cf_o))
    except TypeError:           # unhashable sparsity model
        base = None
        t_key = c_key = None
    table = memo.get_or(_MAPCTX_CACHE, t_key,
                        lambda: pack_mappings(mappings))
    ctx = memo.get_or(_MAPCTX_CACHE, c_key,
                      lambda: mapping_ctx(op, arch, table, cf_o))
    return table, ctx, base


_FETCH_TABLE_CACHE: dict = memo.register({}, "fetch_table")


def _fetch_table_for(base: Optional[tuple], side: str,
                     cfs: Sequence[CompiledFormat], table) -> "FormatTable":
    """Per-(mapping table, format population) fetch table, memoized.

    Keyed like ``mapping_ctx`` (``base`` identifies the op's packed table
    exactly) plus the population's compiled-format value keys — pattern
    pairs of the same op whose derived/reference populations coincide on
    one side (very common: the W-side population repeats across every
    I-side pattern it is paired with) share one table instead of
    re-running the alignment broadcast per pair."""
    key = None
    if base is not None:
        try:
            key = ("ft", side, base, tuple(cf_key(cf) for cf in cfs))
            hash(key)
        except TypeError:
            key = None
    return memo.get_or(_FETCH_TABLE_CACHE, key,
                       lambda: format_fetch_table(cfs, table))


def _side_rows(ders: Sequence[CompiledFormat], ref: CompiledFormat
               ) -> tuple[list[CompiledFormat], np.ndarray, int]:
    """Deduplicate one side's derived formats into fetch-table rows.

    Returns (unique formats, per-rep row index, reference row index) —
    dedup keys on :func:`format_key`, which is exact on one spec: equal
    keys compile to value-identical :class:`CompiledFormat`\\ s."""
    uniq: list[CompiledFormat] = []
    pos: dict[tuple, int] = {}
    idx = np.empty(len(ders), np.int64)
    for r, cf in enumerate(ders):
        k = format_key(cf.fmt)
        p = pos.get(k)
        if p is None:
            p = pos[k] = len(uniq)
            uniq.append(cf)
        idx[r] = p
    rk = format_key(ref.fmt)
    rp = pos.get(rk)
    if rp is None:
        rp = len(uniq)
        uniq.append(ref)
    return uniq, idx, rp


def _search_op_gather(op: MatMul, arch: HardwareConfig,
                      cand_i: Optional[Candidate],
                      cand_w: Optional[Candidate], cfg: CoSearchConfig,
                      spec_i: TensorSpec, spec_w: TensorSpec,
                      ref_i: CompiledFormat, ref_w: CompiledFormat,
                      cf_o: Optional[CompiledFormat], ratio_i: float,
                      ratio_w: float, fixed_i: bool, fixed_w: bool,
                      mappings: Sequence[Mapping]
                      ) -> tuple[Optional[OpDesign], int]:
    """The gather evaluator plane of :func:`_search_op_impl`: candidate
    rows are (mapping, I-format row, W-format row) index triples over the
    op's packed mapping table and per-side fetch tables built from the
    UNIQUE derived/reference formats — no per-row format repacking.  Row
    order replays the repack path exactly (per mapping: derived pair, then
    the reference pair when it differs), so designs, tie-breaks and
    ``evaluations`` are bit-identical to ``use_gather=False``."""
    n_map = len(mappings)
    if n_map == 0:
        return None, 0
    # dedupe (tile, spatial) factor tuples; rep_of maps mapping -> rep row
    reps: dict[tuple, int] = {}
    rep_of = np.empty(n_map, np.int64)
    rep_mappings: list[Mapping] = []
    for j, mapping in enumerate(mappings):
        fkey = _factor_key(mapping)
        r = reps.get(fkey)
        if r is None:
            r = reps[fkey] = len(rep_mappings)
            rep_mappings.append(mapping)
        rep_of[j] = r
    der_i = _derived_side(cand_i, spec_i, rep_mappings, fixed_i, ref_i)
    der_w = _derived_side(cand_w, spec_w, rep_mappings, fixed_w, ref_w)
    uniq_i, i_rep, ref_i_pos = _side_rows(der_i, ref_i)
    uniq_w, w_rep, ref_w_pos = _side_rows(der_w, ref_w)

    # candidate rows: per mapping the derived pair, then the reference
    # pair when it differs by format value (the repack path's dup rule)
    i_map, w_map = i_rep[rep_of], w_rep[rep_of]
    dup = (i_map != ref_i_pos) | (w_map != ref_w_pos)
    counts = 1 + dup.astype(np.int64)
    map_idx = np.repeat(np.arange(n_map), counts)
    is_ref = np.zeros(len(map_idx), bool)
    is_ref[np.cumsum(counts)[dup] - 1] = True
    i_idx = i_map[map_idx]
    w_idx = w_map[map_idx]
    i_idx[is_ref] = ref_i_pos
    w_idx[is_ref] = ref_w_pos
    evals = len(map_idx)

    table, ctx, base = _mapping_ctx_for(op, arch, ratio_i, ratio_w,
                                        cfg.spatial_top, cf_o, mappings)
    ft_i = _fetch_table_for(base, "I", uniq_i, table)
    ft_w = _fetch_table_for(base, "W", uniq_w, table)
    bc = evaluate_batch_gather(op, arch, table, ft_i, i_idx, ft_w, w_idx,
                               map_idx, cf_o, ctx=ctx,
                               eval_threads=cfg.eval_threads)
    j = int(np.argmin(bc.metric(cfg.objective)))
    cf_i = ref_i if is_ref[j] else uniq_i[int(i_idx[j])]
    cf_w = ref_w if is_ref[j] else uniq_w[int(w_idx[j])]
    best = OpDesign(op, mappings[int(map_idx[j])], cf_i.fmt, cf_w.fmt,
                    bc.report(j))
    return best, evals


def _search_op_impl(op: MatMul, arch: HardwareConfig,
                    cand_i: Optional[Candidate], cand_w: Optional[Candidate],
                    cfg: CoSearchConfig) -> tuple[Optional[OpDesign], int]:
    spec_i = TensorSpec(op.i_dims(), op.sp_i, op.value_bits)
    spec_w = TensorSpec(op.w_dims(), op.sp_w, op.value_bits)

    dense_i = dense_format(spec_i)
    dense_w = dense_format(spec_w)
    ref_i = _reference_cf(cand_i, spec_i) or dense_i
    ref_w = _reference_cf(cand_w, spec_w) or dense_w
    cf_o = output_cf(cand_i, op)
    # compression-aware legality from THIS op's reference formats
    ratio_i = min(ref_i.ratio, 1.0)
    ratio_w = min(ref_w.ratio, 1.0)
    # standard named formats have a fixed layout — the reference IS the
    # only allocation, so mapping-derived variants would be duplicates
    named = ("Bitmap", "RLE", "CSR", "CSC", "COO")
    fixed_i = cand_i is not None and cand_i.fmt.name in named
    fixed_w = cand_w is not None and cand_w.fmt.name in named

    # The mapping-derived allocation depends only on the tile/spatial
    # factors, never the loop order — derive once per factor tuple (6
    # orders share each).
    mappings = mappings_for(op, arch, ratio_i, ratio_w,
                            spatial_top=cfg.spatial_top)
    if cfg.use_batch and cfg.use_gather:
        return _search_op_gather(op, arch, cand_i, cand_w, cfg, spec_i,
                                 spec_w, ref_i, ref_w, cf_o, ratio_i,
                                 ratio_w, fixed_i, fixed_w, mappings)
    derived: dict[tuple, tuple[CompiledFormat, CompiledFormat]] = {}
    if cfg.use_batch:
        # batched: all deduped factor tuples of the op derived at once
        reps: dict[tuple, Mapping] = {}
        for mapping in mappings:
            reps.setdefault(_factor_key(mapping), mapping)
        rep_mappings = list(reps.values())
        der_i = _derived_side(cand_i, spec_i, rep_mappings, fixed_i, ref_i)
        der_w = _derived_side(cand_w, spec_w, rep_mappings, fixed_w, ref_w)
        derived = {fkey: (mi, mw)
                   for fkey, mi, mw in zip(reps, der_i, der_w)}

    cand_mappings: list[Mapping] = []
    cand_pairs: list[tuple[CompiledFormat, CompiledFormat]] = []
    for mapping in mappings:
        fkey = _factor_key(mapping)
        pair = derived.get(fkey)
        if pair is None:            # legacy scalar path (use_batch=False)
            map_i = ref_i if fixed_i else \
                (_op_format(cand_i, op.i_dims(), mapping, spec_i) or ref_i)
            map_w = ref_w if fixed_w else \
                (_op_format(cand_w, op.w_dims(), mapping, spec_w) or ref_w)
            pair = derived[fkey] = (map_i, map_w)
        map_i, map_w = pair
        cand_mappings.append(mapping)
        cand_pairs.append((map_i, map_w))
        # the reference pair competes unless the derived allocation IS the
        # reference (compare by value — caching may or may not share objects)
        if (format_key(map_i.fmt), format_key(map_w.fmt)) != \
                (format_key(ref_i.fmt), format_key(ref_w.fmt)):
            cand_mappings.append(mapping)
            cand_pairs.append((ref_i, ref_w))

    evals = len(cand_mappings)
    if not cand_mappings:
        return None, 0

    if cfg.use_batch:
        bc = evaluate_batch(op, arch, cand_mappings, cand_pairs, cf_o)
        j = int(np.argmin(bc.metric(cfg.objective)))
        cf_i, cf_w = cand_pairs[j]
        best = OpDesign(op, cand_mappings[j], cf_i.fmt, cf_w.fmt,
                        bc.report(j))
        return best, evals

    # legacy scalar loop (benchmark reference for the batch path)
    best: Optional[OpDesign] = None
    for mapping, (cf_i, cf_w) in zip(cand_mappings, cand_pairs):
        cost = evaluate(op, arch, mapping, cf_i, cf_w, cf_o)
        if best is None or cost.metric(cfg.objective) < best.cost.metric(cfg.objective):
            best = OpDesign(op, mapping, cf_i.fmt, cf_w.fmt, cost)
    return best, evals


def _dense_sentinel(cands: Sequence[Optional[Candidate]]) -> float:
    """Finite EqData stand-in for the dense (no-format) option when ranking
    pattern pairs.  ``math.inf / 4`` is still ``inf``, so dense-containing
    pair sums all collapsed to ``inf`` and their relative order was
    arbitrary; a finite sentinel above every observed EqData keeps dense
    sides ranked last PER SIDE while part-dense pairs still order by their
    compressed side's EqData."""
    observed = [c.eq_data for c in cands if c is not None]
    return 4.0 * max(observed) if observed else 1.0


def _pair_rank(pair: tuple[Optional[Candidate], Optional[Candidate]],
               sentinel: float) -> float:
    ci, cw = pair
    return ((ci.eq_data if ci is not None else sentinel) +
            (cw.eq_data if cw is not None else sentinel))


def _fixed_candidate(fmt_name: str, spec: TensorSpec) -> Optional[Candidate]:
    if fmt_name in (None, "dense", "Dense"):
        return None
    fmt = standard_formats(spec.dims)[fmt_name]
    from repro_torch.core.sparsity import analyze
    rep = analyze(fmt, spec)
    return Candidate(fmt, rep, rep.total_bits)


def cosearch(workload: Workload, arch: HardwareConfig,
             cfg: CoSearchConfig = CoSearchConfig(),
             fixed_formats: Optional[tuple[Optional[str], Optional[str]]] = None,
             ) -> SearchResult:
    """Joint dataflow + compression-format search for one workload.

    ``fixed_formats=(name_i, name_w)`` runs the Table-I "Fixed" mode: the
    format is preset (one of Bitmap/RLE/CSR/COO or None=dense) and only the
    dataflow is searched — still with the progressive workflow's upfront
    reduction + compression-aware allocation.
    """
    t0 = time.perf_counter()
    stats = SearchStats()

    if fixed_formats is not None:
        spec_i = _representative_spec(workload, "I")
        spec_w = _representative_spec(workload, "W")
        pairs: list[tuple[Optional[Candidate], Optional[Candidate]]] = [(
            _fixed_candidate(fixed_formats[0], spec_i),
            _fixed_candidate(fixed_formats[1], spec_w),
        )]
    else:
        cands_i = _role_candidates(workload, "I", cfg, stats)
        cands_w = _role_candidates(workload, "W", cfg, stats)
        pairs = [(ci, cw) for ci in cands_i for cw in cands_w]
        # rank pairs by combined reference EqData (finite dense sentinel) and cap
        sentinel = _dense_sentinel(cands_i + cands_w)
        pairs.sort(key=lambda p: _pair_rank(p, sentinel))
        # always keep the fully-dense pair as a fallback
        dense_pair = (None, None)
        pairs = pairs[: cfg.max_pairs]
        if dense_pair not in pairs:
            pairs.append(dense_pair)

    evals = 0
    best_design: Optional[DesignPoint] = None
    last_fail: tuple[Optional[str], Optional[tuple]] = (None, None)
    for ci, cw in pairs:
        pair_key = (ci.pattern if ci else None, cw.pattern if cw else None)
        ops, e, f, fail = _search_ops(workload.ops, arch, ci, cw, cfg)
        evals += e
        stats.evaluations += e
        stats.fresh_evaluations += f
        if fail is not None:
            last_fail = (fail, pair_key)
            continue
        dp = DesignPoint(ops, *pair_key)
        if best_design is None or dp.metric(cfg.objective) < best_design.metric(cfg.objective):
            best_design = dp
    if best_design is None:
        raise SearchError(
            f"co-search produced no legal design for {workload.name!r} "
            f"(last failure: op={last_fail[0]!r} pair={last_fail[1]!r})",
            op=last_fail[0], pair=last_fail[1])
    return SearchResult(best_design, evals, time.perf_counter() - t0, stats)


# ---------------------------------------------------------------------------
# Multi-model co-search with importance scoring (§III-C3)
# ---------------------------------------------------------------------------

# Caches whose per-item deltas process workers ship back to the parent:
# the whole-op search results plus the compile/context state they rest on.
_RETURN_CACHES = ("search_op", "compile_format", "mapping_ctx")

_WORKER_BASELINE: Optional[dict] = None


def _multi_init_worker(state: dict) -> None:
    """Process-pool initializer: warm the child's memo caches from the
    parent's :func:`repro_torch.core.memo.export_state` snapshot, so each worker
    starts with the candidate/compile/mapping state phase 1 already paid
    for instead of recomputing it per process.  A key snapshot of the
    return caches is taken here so each work item can ship back exactly
    the entries THIS worker computed (:func:`repro_torch.core.memo.
    export_delta`)."""
    memo.import_state(state)
    global _WORKER_BASELINE
    _WORKER_BASELINE = memo.key_snapshot(_RETURN_CACHES)


def _multi_work_item(item: tuple
                     ) -> tuple[list[OpDesign], int, int, float,
                                Optional[str]]:
    """One (pattern pair, model) unit of the co-search work-list.

    Top-level and fed a picklable tuple — (pair key, candidate pair,
    workload, arch, config) are all frozen value types — so the same
    function runs on the serial path, thread pool, and process pool.
    Returns (designs, evaluations, fresh evaluations, seconds, failed op
    name)."""
    key, pair, wl, arch, cfg = item
    ci, cw = pair
    t0 = time.perf_counter()
    ops, evals, fresh, fail = _search_ops(wl.ops, arch, ci, cw, cfg)
    return ops, evals, fresh, time.perf_counter() - t0, fail


def _multi_work_item_return_state(item: tuple) -> tuple:
    """:func:`_multi_work_item` plus the worker's new return-cache entries
    since its baseline snapshot — the process path's result payload.  The
    baseline advances past each shipped delta, so every entry crosses the
    process boundary once per worker; the parent merges the deltas via
    :func:`repro_torch.core.memo.import_state` (idempotent ``setdefault``, safe
    under overlap between workers)."""
    out = _multi_work_item(item)
    delta: dict = {}
    if _WORKER_BASELINE is not None:
        delta = memo.export_delta(_WORKER_BASELINE, _RETURN_CACHES)
        for name, entries in delta.items():
            _WORKER_BASELINE[name].update(entries)
    return out + (delta,)


def cosearch_multi(workloads: Sequence[Workload], arch: HardwareConfig,
                   importance: dict[str, float],
                   cfg: CoSearchConfig = CoSearchConfig(),
                   workers: Optional[int] = None,
                   executor: str = "thread",
                   memo_autosave: Optional[str] = None,
                   autosave_every: int = 16,
                   ) -> tuple[dict[str, SearchResult], tuple, float]:
    """Pick ONE shared format pair across models minimizing the importance-
    weighted objective.  Returns (per-model results under the winning pair,
    winning pattern pair, weighted metric).

    Runs as three phases: (1) per-model candidate generation (serial —
    memoized and cheap — with per-model ``SearchStats`` snapshots, so each
    model's result reports ITS OWN pattern/allocation counters rather than
    aliasing one shared object); (2) a flat (pair, model) work-list whose
    items are independent — ``workers`` opts into a ``concurrent.futures``
    pool; (3) a deterministic merge in work-list order, so results are
    identical for any worker count and either executor.

    ``executor`` picks the phase-2 pool: ``"thread"`` shares the
    ``_search_op`` cache in-process (the items spend much of their time in
    vectorized NumPy, which releases the GIL, but the remaining Python
    share serializes); ``"process"`` shards past the GIL — its workers are
    spawned interpreters that import this package's numpy-only search
    modules (nothing of a serving caller's torch or threads), work items
    are picklable value tuples, and each worker warms its own memo registry
    from a :func:`repro_torch.core.memo.export_state` snapshot of phase 1's
    caches, so per-process state pays off immediately.  Process workers
    also ship their new ``_search_op``/``compile_format``/``mapping_ctx``
    entries back with each item result (:func:`repro_torch.core.memo.
    export_delta`), which the parent imports — the parent registry ends
    the run as warm as a serial run's, so later models/searches sharing
    op shapes replay instead of recomputing (pinned by the
    ``fresh_evaluations`` regression test).  Item results (designs + eval
    counts) are pure functions of the item, so the merged output is
    identical across executors and worker counts — with one diagnostic
    exception: ``SearchStats.fresh_evaluations`` reflects which items
    found a warm cache, which under a pool depends on scheduling; it is
    deterministic only on the serial path.

    ``memo_autosave`` checkpoints the long phase-2 loop: the memo registry
    snapshots to that path (:func:`repro_torch.core.memo.save`) after every
    ``autosave_every`` completed work items and again at the end.  After a
    crash/kill, a fresh process that :func:`repro_torch.core.memo.load`\\ s the
    snapshot and re-runs the same call replays the completed items from
    cache and recomputes only the rest — results are bit-identical to an
    uninterrupted run (the memo replays recorded designs AND eval
    counters)."""
    # -- phase 1: candidate generation, union of pattern pairs over models --
    per_model_stats: dict[str, SearchStats] = {}
    pair_keys: dict[tuple, tuple[Optional[Candidate], Optional[Candidate]]] = {}
    for wl in workloads:
        st = SearchStats()
        cands_i = _role_candidates(wl, "I", cfg, st)
        cands_w = _role_candidates(wl, "W", cfg, st)
        per_model_stats[wl.name] = st
        for ci in cands_i:
            for cw in cands_w:
                key = (ci.pattern if ci else None, cw.pattern if cw else None)
                pair_keys.setdefault(key, (ci, cw))

    sentinel = _dense_sentinel([c for pair in pair_keys.values()
                                for c in pair])
    items = sorted(pair_keys.items(),
                   key=lambda kv: _pair_rank(kv[1], sentinel))[: cfg.max_pairs]

    # -- phase 2: flat (pair, model) work-list ------------------------------
    if executor not in ("thread", "process"):
        raise ValueError(f"executor must be 'thread' or 'process', "
                         f"got {executor!r}")
    work = [(key, pair, wl) for key, pair in items for wl in workloads]
    payload = [(key, pair, wl, arch, cfg) for key, pair, wl in work]

    def autosave(done: int) -> None:
        if memo_autosave and autosave_every > 0 \
                and done % autosave_every == 0:
            memo.save(memo_autosave)

    if workers is not None and workers > 1 and executor == "process":
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        state = memo.export_state()
        results = []
        # spawned workers, not forked: a serving caller holds torch's and
        # the evaluator's threads, whose locks a fork would copy mid-use
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context(
                                     "spawn"),
                                 initializer=_multi_init_worker,
                                 initargs=(state,)) as ex:
            for out in ex.map(_multi_work_item_return_state, payload):
                # absorb the worker's _search_op/compile/mapping_ctx work
                # into the parent registry: later models/searches sharing
                # op shapes replay it instead of recomputing
                memo.import_state(out[-1])
                results.append(out[:-1])
                autosave(len(results))
    elif workers is not None and workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        results = []
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for out in ex.map(_multi_work_item, payload):
                results.append(out)
                autosave(len(results))
    else:
        results = []
        for item in payload:
            results.append(_multi_work_item(item))
            autosave(len(results))
    if memo_autosave:
        memo.save(memo_autosave)

    # -- phase 3: deterministic merge in work-list order --------------------
    table: dict[str, dict[tuple, float]] = {wl.name: {} for wl in workloads}
    designs: dict[tuple, dict[str, SearchResult]] = {}
    last_fail: tuple[Optional[str], Optional[tuple]] = (None, None)
    for (key, (ci, cw), wl), (ops, evals, fresh, dt, fail) in zip(work,
                                                                  results):
        designs.setdefault(key, {})
        if fail is not None:
            last_fail = (fail, key)
            continue
        dp = DesignPoint(ops, *key)
        designs[key][wl.name] = SearchResult(
            dp, evals, dt,
            dataclasses.replace(per_model_stats[wl.name],
                                evaluations=evals,
                                fresh_evaluations=fresh))
        table[wl.name][key] = dp.metric(cfg.objective)

    complete = [k for k in designs if len(designs[k]) == len(workloads)]
    best_key, best_val = None, math.inf
    for k in complete:
        val = sum(importance.get(wl.name, 1.0) * table[wl.name][k]
                  for wl in workloads)
        if val < best_val:
            best_key, best_val = k, val
    if best_key is None:
        raise SearchError(
            "multi-model co-search found no pattern pair legal for every "
            f"model (last failure: op={last_fail[0]!r} pair={last_fail[1]!r})",
            op=last_fail[0], pair=last_fail[1])
    return designs[best_key], best_key, best_val
