"""Adaptive Compression Engine (paper §III-C).

Generates candidate compression formats for tensors with varying sparsity via
three techniques:

  1. *Complexity-based penalizing* — ``EqData = γ^level × ActualData`` with
     γ = 1.05 by default; during pattern search, a pattern is pruned when its
     (lower-bounded or realized) EqData cannot beat the best strictly-simpler
     pattern.  This collapses the >4×10⁵-point space of Fig. 6 to a handful
     of 2–3-level candidates within a fraction of a percent of the optimum.

  2. *Efficiency-oriented allocating* — subdimension sizes are copied from
     the dataflow's loop-tiling hierarchy so compression groups coincide with
     tiles (zero alignment overhead in the cost model).

  3. *Importance-based scoring* — multi-LLM deployments select one shared
     format by ``argmin_fmt Σ ImpScore_i × OptMetric_i``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core import formats as F
from repro_torch.core import memo
from repro_torch.core.dataflow import Mapping
from repro_torch.core.formats import Format, Level
from repro_torch.core.primitives import Prim
from repro_torch.core.sparsity import (SizeReport, Sparsity, TensorSpec,
                                       analyze, analyze_plans, spec_key)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    gamma: float = 1.05            # complexity penalty base (configurable)
    max_levels: int = 3            # pattern depth cap (paper finds 2–3 wins)
    top_k: int = 8                 # candidates handed to the co-search
    max_allocs_per_pattern: int = 64
    prims: tuple[Prim, ...] = (Prim.B, Prim.CP, Prim.RLE, Prim.UOP)


@dataclasses.dataclass(frozen=True)
class Candidate:
    fmt: Format                    # pattern with a reference allocation
    report: SizeReport
    eq_data: float                 # γ^levels × total bits

    @property
    def pattern(self) -> tuple:
        return self.fmt.pattern_key()


@dataclasses.dataclass
class SearchStats:
    patterns_seen: int = 0
    allocations_seen: int = 0
    pruned_patterns: int = 0
    # Evaluator-plane counters, filled by the co-search drivers:
    # ``evaluations`` counts every candidate the search SCORED (cache hits
    # replay the recorded count, keeping warm and cold runs bit-identical);
    # ``fresh_evaluations`` counts only candidates actually computed this
    # run — the share a warm ``_search_op`` cache (including entries
    # shipped back from process workers) did NOT have to redo.  It is a
    # DIAGNOSTIC: under thread/process executors, which work item finds a
    # warm cache depends on scheduling, so it is deterministic only on the
    # serial path (designs and ``evaluations`` are deterministic always).
    evaluations: int = 0
    fresh_evaluations: int = 0


def eq_data(total_bits: float, levels: int, gamma: float) -> float:
    """Equivalent data size (§III-C1): penalize deep patterns."""
    return (gamma ** levels) * total_bits


# Early-exit pruning knobs of the in-pattern allocation scan (§III-C1 applied
# per allocation): give the scan a warm-up before the simpler-format bar can
# cut it, and stop once the landscape has flattened.
_ALLOC_MIN_SCAN = 15
_ALLOC_PATIENCE = 24


def _alloc_scan_len(e: np.ndarray, bar: float) -> tuple[int, bool]:
    """Replay of the scalar allocation scan's early exits on an EqData
    vector: (how many allocations the per-candidate loop examines, whether
    it breaks inside this prefix).  The stop condition at index i depends
    only on e[:i+1], so the replay is exact on any prefix.  Keeps
    ``SearchStats.allocations_seen`` and the returned best allocation
    identical between the batched and scalar paths."""
    n = len(e)
    if not math.isfinite(bar):
        return n, False
    runmin = np.minimum.accumulate(e)
    improve = np.empty(n, bool)
    improve[0] = True
    improve[1:] = e[1:] < runmin[:-1]
    idx = np.arange(n)
    since = idx - np.maximum.accumulate(np.where(improve, idx, -1))
    stop = ((idx >= _ALLOC_MIN_SCAN) & (runmin >= bar)) | \
        (since >= _ALLOC_PATIENCE)
    if not stop.any():
        return n, False
    return int(np.argmax(stop)) + 1, True


_CANDIDATES_CACHE: dict = memo.register({}, "generate_candidates")

# Depth of the SIZE-optimal reference-allocation scan (the engine's
# "reference view" of a pattern on a tensor, mapping-independent): the first
# _REF_ALLOC_CAP dimension allocations, best total bits.
_REF_ALLOC_CAP = 24
_REF_ALLOC_CACHE: dict = memo.register({}, "reference_alloc")


def reference_allocation(pattern: Sequence[Level], spec: TensorSpec
                         ) -> Optional[Format]:
    """Best size-optimal allocation of a bare ``pattern`` on ``spec``'s dims
    (argmin total bits over the first ``_REF_ALLOC_CAP`` allocations).

    This is the reference format the co-search pits against mapping-derived
    allocations (:func:`repro_torch.core.cosearch._reference_cf`).  Memoized by
    (pattern, spec); :func:`generate_candidates` seeds the cache for every
    candidate it returns as a by-product of its batched allocation scan, so
    on the engine's own generation spec the reference never costs a second
    scan — only ops whose dims/sparsity differ from the representative
    tensor fall through to the one-pass recompute here."""
    pattern = tuple(pattern)
    sk = spec_key(spec)
    return memo.get_or(_REF_ALLOC_CACHE,
                       None if sk is None else (pattern, sk),
                       lambda: _reference_allocation_impl(pattern, spec))


def _reference_allocation_impl(pattern: tuple[Level, ...], spec: TensorSpec
                               ) -> Optional[Format]:
    plans = list(F.allocation_plans(pattern, spec.dims,
                                    max_allocs=_REF_ALLOC_CAP))
    if not plans:
        return None
    # one vectorized pass; argmin's first-occurrence ties match the scalar
    # strict-less scan this replaced
    j = int(np.argmin(analyze_plans(plans, spec).total_bits))
    return plans[j].build()


def generate_candidates(spec: TensorSpec, cfg: EngineConfig = EngineConfig(),
                        penalize: bool = True,
                        stats: Optional[SearchStats] = None,
                        use_batch: bool = True,
                        ) -> list[Candidate]:
    """Enumerate patterns by iterative deepening with complexity pruning.

    Level-(n+1) patterns are built by extending level-n patterns; with
    ``penalize=True`` only patterns whose EqData beats the best strictly
    simpler pattern survive — excluded patterns are neither kept nor
    extended, which is what collapses the Fig. 6 search space.  With
    ``penalize=False`` every prefix is extended (the "w/o penalizing"
    series).  Returns the top-k candidates by EqData, each carrying its best
    reference allocation.

    Memoized by (spec dims+sparsity+value_bits, cfg, penalize): the search
    is deterministic, so repeat calls (per role × per pattern pair × per
    model in :func:`repro_torch.core.cosearch.cosearch_multi`) replay the cached
    candidate list plus the counter deltas into ``stats``.

    ``use_batch=True`` scores every allocation of a pattern in one
    :func:`repro_torch.core.sparsity.analyze_batch` pass and replays the scalar
    loop's early-exit pruning on the EqData vector post hoc — results and
    ``SearchStats`` counters are bit-identical to the legacy per-allocation
    loop (``use_batch=False``, kept as the benchmark reference), so the two
    paths share one cache.
    """
    outer_stats = stats
    try:
        key = ((tuple(spec.dims.items()), spec.sparsity, spec.value_bits),
               cfg, penalize)
        hash(key)
    except TypeError:
        key = None
    if key is not None and memo.enabled():
        hit = _CANDIDATES_CACHE.get(key)
        memo.note(_CANDIDATES_CACHE, hit is not None)
        if hit is not None:
            cands, delta = hit
            if outer_stats is not None:
                outer_stats.patterns_seen += delta.patterns_seen
                outer_stats.allocations_seen += delta.allocations_seen
                outer_stats.pruned_patterns += delta.pruned_patterns
            return list(cands)
    stats = SearchStats()
    dims = list(spec.dims)
    sk = spec_key(spec)
    # collect the size-optimal reference allocation per pattern while the
    # batched scan has the scored rows in hand (seeded into
    # _REF_ALLOC_CACHE for the winners below)
    collect_ref = use_batch and memo.enabled() and sk is not None
    ref_plans: dict[tuple[Level, ...], F.AllocPlan] = {}

    def score_scalar(pattern: tuple[Level, ...], bar: float
                     ) -> Optional[Candidate]:
        """Legacy per-allocation loop (the seed path, benchmark reference).
        When penalizing, stop early once the pattern evidently cannot beat
        the simpler-format bar (the same exclusion rule, applied
        in-pattern)."""
        best_alloc: Optional[Candidate] = None
        since_improve = 0
        for i, fmt in enumerate(F.allocate(pattern, spec.dims,
                                           max_allocs=cfg.max_allocs_per_pattern)):
            stats.allocations_seen += 1
            rep = analyze(fmt, spec)
            e = eq_data(rep.total_bits, len(pattern), cfg.gamma)
            if best_alloc is None or e < best_alloc.eq_data:
                best_alloc = Candidate(fmt, rep, e)
                since_improve = 0
            else:
                since_improve += 1
            if math.isfinite(bar):
                if i >= _ALLOC_MIN_SCAN and best_alloc.eq_data >= bar:
                    break              # evidently dominated by simpler formats
                if since_improve >= _ALLOC_PATIENCE:
                    break              # allocation landscape has flattened
        return best_alloc

    def score_batched(pattern: tuple[Level, ...], bar: float
                      ) -> Optional[Candidate]:
        """Allocations scored in vectorized chunks over raw size rows
        (:func:`repro_torch.core.formats.allocation_plans` +
        :func:`repro_torch.core.sparsity.analyze_plans` — no Format objects for
        losing allocations); the early-exit semantics of the scalar loop
        are applied as a post-hoc cut of the EqData vector, so chunks stop
        being consumed as soon as the replayed scan breaks (overshoot
        < one chunk).  With ``collect_ref``, the same pass also records the
        pattern's size-optimal reference allocation (first _REF_ALLOC_CAP
        rows, best total bits) — the scan window of the per-candidate
        replay stays the scalar loop's own cap, so the extra rows never
        enter the counters or the returned candidate."""
        cap = cfg.max_allocs_per_pattern
        gen = F.allocation_plans(pattern, spec.dims,
                                 max_allocs=max(cap, _REF_ALLOC_CAP)
                                 if collect_ref else cap)
        g = cfg.gamma ** len(pattern)
        # first chunk reaches exactly the earliest possible bar-stop
        # (index _ALLOC_MIN_SCAN); later chunks cover one patience window
        chunk = cap if not math.isfinite(bar) else _ALLOC_MIN_SCAN + 1
        if collect_ref:
            chunk = max(chunk, _REF_ALLOC_CAP)
        plans: list[F.AllocPlan] = []
        brs: list[tuple[int, object]] = []      # (row offset, BatchSizeReport)
        e = np.zeros(0)
        tb = np.zeros(0)
        k = 0
        while True:
            part = list(itertools.islice(gen, chunk))
            if not part:
                break
            br = analyze_plans(part, spec)
            brs.append((len(plans), br))
            plans.extend(part)
            e = np.concatenate((e, g * br.total_bits))
            tb = np.concatenate((tb, br.total_bits))
            k, stopped = _alloc_scan_len(e[:cap], bar)
            if stopped:
                break
            chunk = _ALLOC_PATIENCE
        if not plans:
            return None
        if collect_ref:
            # first chunk already covers >= _REF_ALLOC_CAP rows, so the
            # reference argmin sees the same prefix reference_allocation()
            # would enumerate
            ref_plans[pattern] = plans[int(np.argmin(tb[:_REF_ALLOC_CAP]))]
        stats.allocations_seen += k
        j = int(np.argmin(e[:k]))
        off, br = next(t for t in reversed(brs) if t[0] <= j)
        return Candidate(plans[j].build(), br.report(j - off), float(e[j]))

    score = score_batched if use_batch else score_scalar

    out: list[Candidate] = []
    frontier: list[tuple[Level, ...]] = [()]
    best_simpler = math.inf            # best EqData among shallower levels
    for n in range(1, cfg.max_levels + 1):
        level_best = math.inf
        next_frontier: list[tuple[Level, ...]] = []
        for base in frontier:
            for d in dims:
                for prim in cfg.prims:
                    pattern = base + (Level(prim, d),)
                    stats.patterns_seen += 1
                    if prim is Prim.UOP:
                        # UOP at the leaf is unscoreable (nothing to offset
                        # into) but extending it can win (CSR/CSC prefixes):
                        # inherit survival from the base pattern.
                        next_frontier.append(pattern)
                        continue
                    cand = score(pattern, best_simpler if penalize else math.inf)
                    if cand is None:
                        stats.pruned_patterns += 1
                        continue
                    if penalize and cand.eq_data >= best_simpler:
                        stats.pruned_patterns += 1
                        continue
                    level_best = min(level_best, cand.eq_data)
                    out.append(cand)
                    next_frontier.append(pattern)
        frontier = next_frontier
        best_simpler = min(best_simpler, level_best)

    out.sort(key=lambda c: c.eq_data)
    out = out[: cfg.top_k]
    if collect_ref:
        # seed the reference-allocation cache for the winners: the
        # co-search's per-op _reference_cf on the generation spec becomes a
        # cache hit instead of a second allocation scan
        for c in out:
            bare = tuple(Level(l.prim, l.dim, None) for l in c.fmt.levels
                         if l.prim is not Prim.NONE)
            plan = ref_plans.get(bare)
            if plan is not None:
                _REF_ALLOC_CACHE.setdefault((bare, sk), plan.build())
    if key is not None and memo.enabled():
        _CANDIDATES_CACHE[key] = (tuple(out), stats)
    if outer_stats is not None:
        outer_stats.patterns_seen += stats.patterns_seen
        outer_stats.allocations_seen += stats.allocations_seen
        outer_stats.pruned_patterns += stats.pruned_patterns
    return list(out)


# ---------------------------------------------------------------------------
# Efficiency-oriented allocating (§III-C2)
# ---------------------------------------------------------------------------

def _split_chain(extent: int, mapping_chain: Sequence[int], parts: int
                 ) -> Optional[tuple[int, ...]]:
    """Split ``extent`` into ``parts`` factors following the dataflow's
    tiling hierarchy ``mapping_chain`` (outer→inner extents, product ==
    extent).  If the chain has more stages than parts, inner stages merge;
    if fewer, fall back to balanced factor splits."""
    chain = [c for c in mapping_chain if c > 1]
    if len(chain) >= parts:
        merged = list(chain[: parts - 1])
        tail = 1
        for c in chain[parts - 1:]:
            tail *= c
        merged.append(tail)
        if math.prod(merged) == extent and all(c > 1 for c in merged):
            return tuple(merged)
    # fallback: balanced split (prefer near-equal factors > 1)
    best: Optional[tuple[int, ...]] = None
    for fac in F.factorizations_cached(extent, parts):
        if any(f <= 1 for f in fac):
            continue
        spread = max(fac) / min(fac)
        if best is None or spread < max(best) / min(best):
            best = fac
    return best


def _divide_out(chain: Sequence[int], leaf: int) -> Optional[list[int]]:
    """Remove a factor ``leaf`` from the inner end of a tiling chain."""
    out = list(chain)
    rem = leaf
    for i in range(len(out) - 1, -1, -1):
        g = math.gcd(out[i], rem)
        out[i] //= g
        rem //= g
        if rem == 1:
            break
    if rem != 1:
        return None
    return [c for c in out if c > 1]


_NO_FMT = object()              # fmt-cache sentinel (None is a legal value)


def allocate_for_mappings(pattern: Sequence[Level], dims: dict[str, int],
                          op_extents: dict[str, int],
                          mappings: Sequence[Mapping],
                          leaf: Optional[dict[str, int]] = None,
                          ) -> list[Optional[Format]]:
    """Derive the dimension allocation from the dataflow (§III-C2), for many
    mappings of one op at once.

    For each dim the loop hierarchy is (#DRAM tiles, tile/spatial, spatial);
    format levels take sizes outer→inner from that chain — e.g. with M=8
    outer and M=32 inner loops, ``B(M1)-B(M2)`` becomes ``B(M1,8)-B(M2,32)``.
    ``leaf`` optionally reserves an innermost dense-block factor per dim
    (block-sparse formats); it is divided out of the chain's inner stages.

    The allocation depends only on the pattern dims' (tile, spatial) extents
    — never the loop order — so the chain split runs once per unique per-dim
    extent pair and the format assembly once per unique factor tuple; the
    dim-only feasibility gates (leaf divisibility, enough >1 factors) are
    checked once for the whole batch.  Per-mapping results are identical to
    the original scalar derivation (:func:`allocate_for_mapping` is now a
    batch of one)."""
    leaf = leaf or {}
    per_dim_slots: dict[str, int] = {}
    for l in pattern:
        per_dim_slots[l.dim] = per_dim_slots.get(l.dim, 0) + 1

    # mapping-independent feasibility + targets, once per dim
    base: dict[str, tuple[int, int, int]] = {}   # d -> (extent, lf, target)
    for d, parts in per_dim_slots.items():
        extent = dims[d]
        lf = leaf.get(d, 1)
        if lf > 1 and extent % lf:
            return [None] * len(mappings)
        target = extent // lf
        if target == 1 or (parts > 1 and target < 2 ** parts):
            return [None] * len(mappings)
        base[d] = (extent, lf, target)

    head = tuple(Level(Prim.NONE, d, dims[d]) for d in dims
                 if d not in per_dim_slots)
    leaves = tuple(Level(Prim.NONE, d, lf) for d, lf in leaf.items()
                   if lf > 1 and d in per_dim_slots)

    split_cache: dict[tuple, Optional[tuple[int, ...]]] = {}
    fmt_cache: dict[tuple, Optional[Format]] = {}

    def dim_split(d: str, t: int, u: int) -> Optional[tuple[int, ...]]:
        skey = (d, t, u)
        if skey in split_cache:
            return split_cache[skey]
        extent, lf, target = base[d]
        chain: list[int] = []
        if t and extent % t == 0:
            chain = [extent // t, max(t // u, 1), u]
            if lf > 1:
                chain = _divide_out(chain, lf) or []
        split = _split_chain(target, chain, per_dim_slots[d])
        split_cache[skey] = split
        return split

    out: list[Optional[Format]] = []
    for mapping in mappings:
        fkey = tuple((d, mapping.tile.get(d, base[d][0]),
                      mapping.spatial.get(d, 1)) for d in per_dim_slots)
        fmt = fmt_cache.get(fkey, _NO_FMT)
        if fmt is not _NO_FMT:
            out.append(fmt)             # type: ignore[arg-type]
            continue
        chains: dict[str, tuple[int, ...]] = {}
        for d, t, u in fkey:
            split = dim_split(d, t, u)
            if split is None:
                break
            chains[d] = split
        if len(chains) != len(per_dim_slots):
            fmt_cache[fkey] = None
            out.append(None)
            continue
        used = dict.fromkeys(per_dim_slots, 0)
        levels: list[Level] = []
        for l in pattern:
            idx = used[l.dim]
            levels.append(l.with_size(chains[l.dim][idx]))
            used[l.dim] += 1
        fmt = Format(head + tuple(levels) + leaves)
        try:
            fmt.validate(dims)
        except ValueError:
            fmt = None
        fmt_cache[fkey] = fmt
        out.append(fmt)
    return out


def allocate_for_mapping(pattern: Sequence[Level], dims: dict[str, int],
                         op_extents: dict[str, int], mapping: Mapping,
                         leaf: Optional[dict[str, int]] = None,
                         ) -> Optional[Format]:
    """Scalar :func:`allocate_for_mappings` — a batch of one (single source
    of truth for the derivation rules)."""
    return allocate_for_mappings(pattern, dims, op_extents, (mapping,),
                                 leaf=leaf)[0]


# ---------------------------------------------------------------------------
# Importance-based scoring (§III-C3)
# ---------------------------------------------------------------------------

def select_shared(metric_by_model_by_format: dict[str, dict[str, float]],
                  importance: dict[str, float]) -> tuple[str, float]:
    """argmin_fmt Σ_i ImpScore(LLM_i) × OptMetric(LLM_i, fmt).

    ``metric_by_model_by_format[model][format_key]`` must be complete over a
    shared format-key set.  Returns (format_key, weighted metric)."""
    fmt_keys = None
    for model, table in metric_by_model_by_format.items():
        keys = set(table)
        fmt_keys = keys if fmt_keys is None else (fmt_keys & keys)
    if not fmt_keys:
        raise ValueError("no common format across models")
    best_key, best_val = None, math.inf
    for k in sorted(fmt_keys):
        val = sum(importance.get(m, 1.0) * table[k]
                  for m, table in metric_by_model_by_format.items())
        if val < best_val:
            best_key, best_val = k, val
    assert best_key is not None
    return best_key, best_val
