"""Cost Model (paper §III-A Evaluator, right half).

Evaluates a design candidate = (MatMul op, hardware, Mapping, compression
formats for I and W) into energy / latency / EDP, "modeling MAC operations
and memory transfers".  The Sparsity Analyzer supplies compressed sizes and
computation-reduction fractions; this module turns them into per-level
access counts and cycles.

Alignment between format and dataflow (§III-C2, efficiency-oriented
allocating) is modeled physically:
  * a level whose block extent ``b`` exceeds the tile extent ``t`` along its
    dim forces over-fetch (whole compression groups move, factor b/t);
  * a tile that straddles group boundaries re-decodes the boundary groups
    (factor ceil(t/b)/(t/b));
  * RLE has no random access — a tile fetch decodes the whole run-chain
    spanned by the sequential region (granule rule).
When the dimension allocation copies the dataflow's tiling factors, every
factor collapses to 1.0 — exactly the paper's "aligns the compression format
with the dataflow, reducing runtime overhead".

Batch evaluator architecture
----------------------------
The search hot loop scores thousands of (mapping, format-pair) candidates
per op.  :func:`evaluate_batch` materializes the whole candidate set into
structure-of-arrays form — tile/spatial extents and DRAM bounds as (n, 3)
arrays over (M, N, K), refetch multipliers gathered from a per-loop-order
lookup table, and each :class:`CompiledFormat` packed into a padded
per-level row (:func:`_format_row`, value-cached) — then computes
energy/cycles/EDP for every candidate in one vectorized NumPy pass.
Scalar :func:`evaluate` is a thin wrapper over a batch of one, so there is
a single source of truth for the cost formulas.  :func:`compile_format`
results are memoized by (format levels+name, dims, sparsity, value_bits)
via :mod:`repro_torch.core.memo`.

:func:`evaluate_batch_gather` is the sweep entry point every search plane
now routes through: candidates are (mapping row, I-format row, W-format
row) index triples over a :func:`pack_mappings` table and per-population
:func:`format_fetch_table`\\ s, the mapping-only formula half is hoisted
into a reusable :func:`mapping_ctx`, and only the elementwise
:func:`_evaluate_terms` tail runs per candidate — optionally chunked
across a thread pool (``eval_threads``; the tail is elementwise per row,
so any chunking is bit-identical to the serial pass).
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import memo
from repro_torch.core.arch import HardwareConfig
from repro_torch.core.dataflow import DIMS, ORDERS, Mapping, irrelevant_refetch
from repro_torch.core.formats import Format
from repro_torch.core.primitives import DECODE_COST, Prim
from repro_torch.core.sparsity import (SizeReport, TensorSpec, analyze,
                                       gather_scalar, spec_key)
from repro_torch.core.workload import MatMul


@dataclasses.dataclass(frozen=True)
class _LevelInfo:
    dim: str
    block_below: int          # elements along `dim` under one position
    meta_bits: float
    decode_ops: float


@dataclasses.dataclass(frozen=True)
class CompiledFormat:
    """(format × tensor) analysis, pre-chewed for the mapping hot loop."""

    fmt: Optional[Format]               # None = stored dense
    dense_bits: float
    payload_bits: float
    levels: tuple[_LevelInfo, ...]
    payload_granule: dict[str, int]     # smallest fetchable payload block per
    #                                     dim (innermost compressed level's
    #                                     block, or RLE sequential span)

    @property
    def total_bits(self) -> float:
        return self.payload_bits + sum(l.meta_bits for l in self.levels)

    @property
    def ratio(self) -> float:
        return self.total_bits / self.dense_bits

    def _align(self, b: int, t: int) -> float:
        if b > t:
            return b / t
        whole = t / b
        return math.ceil(whole) / whole

    def fetched_bits(self, tile: dict[str, int]) -> float:
        """Bits moved per full pass over the tensor, tile-at-a-time."""
        if self.fmt is None:
            return self.dense_bits
        pay = self.payload_bits
        for d, g in self.payload_granule.items():
            if g > 1 and d in tile:
                pay *= self._align(g, tile[d])
        meta = sum(l.meta_bits * self._align(l.block_below, tile.get(l.dim, l.block_below))
                   for l in self.levels)
        return pay + meta

    def decode_ops(self, tile: dict[str, int]) -> float:
        if self.fmt is None:
            return 0.0
        return sum(l.decode_ops * self._align(l.block_below, tile.get(l.dim, l.block_below))
                   for l in self.levels)


def format_key(fmt: Optional[Format]) -> tuple:
    """Value-based hashable identity of a (possibly sized) format."""
    if fmt is None:
        return (None,)
    return (fmt.name, fmt.levels)


def cf_key(cf: Optional["CompiledFormat"]) -> tuple:
    """Value-based hashable identity of a compiled (format × tensor)
    analysis — everything the evaluator reads from it.  Two compiles with
    equal keys are interchangeable in any cost formula, which is what lets
    mapping contexts memoize by (op, arch, ratios, cf_o key)."""
    if cf is None:
        return (None,)
    return (format_key(cf.fmt), cf.dense_bits, cf.payload_bits, cf.levels,
            tuple(sorted(cf.payload_granule.items())))


_COMPILE_CACHE: dict = memo.register({}, "compile_format")


def compile_format(fmt: Optional[Format], spec: TensorSpec) -> CompiledFormat:
    sk = spec_key(spec)
    key = None if sk is None else (format_key(fmt), sk)
    return memo.get_or(_COMPILE_CACHE, key,
                       lambda: _compile_format_impl(fmt, spec))


def compile_format_from_report(fmt: Format, spec: TensorSpec,
                               report: SizeReport) -> CompiledFormat:
    """:func:`compile_format` fed a precomputed :class:`SizeReport` — the
    entry point for batch analyzers (``analyze_batch`` /
    ``analyze_plans``), which score whole format families in one pass and
    then compile each member without re-running the scalar ``analyze``.
    Shares the compile cache with :func:`compile_format`, so either entry
    point can satisfy the other's lookups."""
    sk = spec_key(spec)
    key = None if sk is None else (format_key(fmt), sk)
    return memo.get_or(_COMPILE_CACHE, key,
                       lambda: _compiled_with_report(fmt, spec, report))


def _compile_format_impl(fmt: Optional[Format], spec: TensorSpec
                         ) -> CompiledFormat:
    if fmt is None:
        return CompiledFormat(None, spec.dense_bits, spec.dense_bits, (), {})
    return _compiled_with_report(fmt, spec, analyze(fmt, spec))


def _compiled_with_report(fmt: Format, spec: TensorSpec, report: SizeReport
                          ) -> CompiledFormat:
    infos: list[_LevelInfo] = []
    below: dict[str, int] = dict.fromkeys(spec.dims, 1)
    # block_below per level = product of sizes of INNER levels on the same dim
    sizes_per_dim: dict[str, list[int]] = {}
    for l in fmt.levels:
        sizes_per_dim.setdefault(l.dim, []).append(int(l.size))  # type: ignore[arg-type]
    seen: dict[str, int] = dict.fromkeys(spec.dims, 0)
    for i, l in enumerate(fmt.levels):
        seq = sizes_per_dim[l.dim]
        idx = seen[l.dim]
        blk = 1
        for s in seq[idx + 1:]:
            blk *= s
        seen[l.dim] += 1
        infos.append(_LevelInfo(l.dim, blk, report.per_level[i],
                                DECODE_COST[l.prim] * report.per_level[i]))
    # Payload granule per dim: payload is stored per position of the
    # innermost COMPRESSED level, so fetches move whole such blocks.  RLE has
    # no random access — its sequential span is the level extent times
    # everything below it.
    gran: dict[str, int] = {}
    rle_span: dict[str, int] = {}
    for i, l in enumerate(fmt.levels):
        if l.prim is Prim.NONE:
            continue
        # innermost compressed level wins: walking outer→inner, overwrite
        gran[l.dim] = infos[i].block_below
        if l.prim is Prim.RLE:
            span = int(l.size) * infos[i].block_below  # type: ignore[arg-type]
            rle_span[l.dim] = max(rle_span.get(l.dim, 1), span)
    for d, span in rle_span.items():
        gran[d] = max(gran.get(d, 1), span)
    return CompiledFormat(fmt, spec.dense_bits, report.payload_bits,
                          tuple(infos), gran)


def dense_format(spec: TensorSpec) -> CompiledFormat:
    return compile_format(None, spec)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostReport:
    energy: float               # normalized pJ
    cycles: float
    edp: float
    breakdown: dict[str, float]
    utilization: float
    dram_bits: float

    def metric(self, objective: str) -> float:
        return {"energy": self.energy, "latency": self.cycles,
                "edp": self.edp}[objective]


# --- structure-of-arrays packing for the batch path ------------------------

_DIM_COL = {d: i for i, d in enumerate(DIMS)}            # M→0, N→1, K→2
_ORDER_IDX = {o: i for i, o in enumerate(ORDERS)}
# Per loop order: does the operand's (single) irrelevant dim sit outer to
# its innermost relevant loop?  Probed through irrelevant_refetch itself so
# the table can never drift from the scalar rule.
_PROBE = {d: 2 for d in DIMS}
_REFETCH_OUTER = {
    X: np.array([irrelevant_refetch(o, X, _PROBE) > 1.0 for o in ORDERS])
    for X in ("I", "W", "O")}
_IRR_COL = {"I": _DIM_COL["K"], "W": _DIM_COL["M"], "O": _DIM_COL["N"]}


@dataclasses.dataclass(frozen=True)
class _FormatRow:
    """One CompiledFormat flattened for vectorized fetch/decode math."""

    dense: bool
    dense_bits: float
    payload_bits: float
    ratio: float
    lvl_col: np.ndarray          # (L,) int — tile column per level
    lvl_block: np.ndarray        # (L,) float — block_below per level
    lvl_meta: np.ndarray         # (L,) float
    lvl_decode: np.ndarray       # (L,) float
    gran: np.ndarray             # (3,) float — payload granule per dim, 1=none


_ROW_CACHE: dict = memo.register({}, "format_row")


def _format_row(cf: CompiledFormat) -> _FormatRow:
    key = (cf.fmt is None, cf.dense_bits, cf.payload_bits, cf.levels,
           tuple(sorted(cf.payload_granule.items())))
    return memo.get_or(_ROW_CACHE, key, lambda: _build_row(cf))


def _build_row(cf: CompiledFormat) -> _FormatRow:
    gran = np.ones(len(DIMS))
    for d, g in cf.payload_granule.items():
        if g > 1:
            gran[_DIM_COL[d]] = float(g)
    # Zero-contribution levels (dense ``None`` heads/leaves: no metadata, no
    # decode work) drop out of the packed row — their align factors only
    # ever multiply 0.0, so the fetch/decode sums are exact without them
    # and every align matrix shrinks to the compressed levels only.
    lvls = [l for l in cf.levels if l.meta_bits != 0.0 or l.decode_ops != 0.0]
    return _FormatRow(
        dense=cf.fmt is None,
        dense_bits=cf.dense_bits,
        payload_bits=cf.payload_bits,
        ratio=cf.ratio,
        lvl_col=np.array([_DIM_COL[l.dim] for l in lvls], np.int64),
        lvl_block=np.array([float(l.block_below) for l in lvls]),
        lvl_meta=np.array([l.meta_bits for l in lvls]),
        lvl_decode=np.array([l.decode_ops for l in lvls]),
        gran=gran,
    )


@dataclasses.dataclass(frozen=True)
class _FormatSoA:
    """A stack of _FormatRows, level-padded (block=1, meta=decode=0)."""

    dense: np.ndarray            # (m,) bool
    dense_bits: np.ndarray       # (m,)
    payload_bits: np.ndarray     # (m,)
    ratio: np.ndarray            # (m,)
    lvl_col: np.ndarray          # (m, L) int
    lvl_block: np.ndarray        # (m, L)
    lvl_meta: np.ndarray         # (m, L)
    lvl_decode: np.ndarray       # (m, L)
    gran: np.ndarray             # (m, 3)


def _pack(cfs: Sequence[CompiledFormat]) -> _FormatSoA:
    rows = [_format_row(cf) for cf in cfs]
    m = len(rows)
    L = max((len(r.lvl_col) for r in rows), default=0) or 1
    col = np.zeros((m, L), np.int64)
    blk = np.ones((m, L))
    met = np.zeros((m, L))
    dec = np.zeros((m, L))
    for i, r in enumerate(rows):
        k = len(r.lvl_col)
        col[i, :k] = r.lvl_col
        blk[i, :k] = r.lvl_block
        met[i, :k] = r.lvl_meta
        dec[i, :k] = r.lvl_decode
    return _FormatSoA(
        dense=np.array([r.dense for r in rows], bool),
        dense_bits=np.array([r.dense_bits for r in rows]),
        payload_bits=np.array([r.payload_bits for r in rows]),
        ratio=np.array([r.ratio for r in rows]),
        lvl_col=col, lvl_block=blk, lvl_meta=met, lvl_decode=dec,
        gran=np.stack([r.gran for r in rows]),
    )


@dataclasses.dataclass(frozen=True)
class MappingSoA:
    """A mapping set packed once into structure-of-arrays form, so sweeps
    that score many (mapping subset, format pair) combinations of the same
    set (the stepwise baseline) pay the per-mapping Python exactly once."""

    tiles: np.ndarray            # (n, 3) int64 over DIMS
    sps: np.ndarray              # (n, 3) int64
    ords: np.ndarray             # (n,) int64 — index into ORDERS

    def __len__(self) -> int:
        return len(self.ords)


def pack_mappings(mappings: Sequence[Mapping]) -> MappingSoA:
    n = len(mappings)
    tiles = np.array([[m.tile[d] for d in DIMS] for m in mappings],
                     np.int64).reshape(n, len(DIMS))
    sps = np.array([[m.spatial[d] for d in DIMS] for m in mappings],
                   np.int64).reshape(n, len(DIMS))
    ords = np.array([_ORDER_IDX[m.order] for m in mappings], np.int64)
    return MappingSoA(tiles, sps, ords)


def _align_vec(b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Vectorized CompiledFormat._align: b/t when b>t, else ceil(t/b)/(t/b)."""
    whole = t / b
    return np.where(b > t, b / t, np.ceil(whole) / whole)


def _tiles_at_levels(soa: _FormatSoA, tiles: np.ndarray) -> np.ndarray:
    """Gather per-level tile extents: (n, L).  A one-row SoA broadcasts
    against an n-candidate tile array."""
    if soa.lvl_col.shape[0] == 1:
        return tiles[:, soa.lvl_col[0]]
    return np.take_along_axis(tiles, soa.lvl_col, axis=1)


def _fetched_bits_vec(soa: _FormatSoA, tiles: np.ndarray) -> np.ndarray:
    a = _align_vec(soa.lvl_block, _tiles_at_levels(soa, tiles))
    meta = (soa.lvl_meta * a).sum(axis=1)
    pay = soa.payload_bits * _align_vec(soa.gran, tiles).prod(axis=1)
    return np.where(soa.dense, soa.dense_bits, pay + meta)


def _prob_nonempty_vec(sp, vals: np.ndarray) -> np.ndarray:
    # Distribution models are arbitrary Python; tile extents come from a
    # small divisor set, so evaluate once per unique value and gather
    # (shared with sparsity.analyze_batch).
    return gather_scalar(sp.prob_nonempty, vals)


@dataclasses.dataclass
class BatchCost:
    """Vectorized cost of n (mapping, format-pair) candidates of one op.

    All arrays are length n and already scaled by ``op.count``;
    :meth:`report` reconstitutes the full scalar :class:`CostReport` for one
    candidate (identical to what :func:`evaluate` returns for it)."""

    energy: np.ndarray
    cycles: np.ndarray
    edp: np.ndarray
    utilization: np.ndarray
    dram_bits: np.ndarray
    e_dram: np.ndarray
    e_glb: np.ndarray
    e_decode: np.ndarray
    dram_cycles: np.ndarray
    compute_cycles: np.ndarray
    e_rf: float                     # format-independent, scalar
    e_mac: float

    def __len__(self) -> int:
        return len(self.energy)

    def metric(self, objective: str) -> np.ndarray:
        return {"energy": self.energy, "latency": self.cycles,
                "edp": self.edp}[objective]

    def report(self, i: int) -> CostReport:
        return CostReport(
            energy=float(self.energy[i]),
            cycles=float(self.cycles[i]),
            edp=float(self.edp[i]),
            breakdown={
                "dram": float(self.e_dram[i]), "glb": float(self.e_glb[i]),
                "rf": self.e_rf, "mac": self.e_mac,
                "decode": float(self.e_decode[i]),
                "dram_cycles": float(self.dram_cycles[i]),
                "compute_cycles": float(self.compute_cycles[i]),
            },
            utilization=float(self.utilization[i]),
            dram_bits=float(self.dram_bits[i]),
        )


def _empty_batch() -> BatchCost:
    z = np.zeros(0)
    return BatchCost(energy=z, cycles=z, edp=z, utilization=z,
                     dram_bits=z, e_dram=z, e_glb=z, e_decode=z,
                     dram_cycles=z, compute_cycles=z, e_rf=0.0, e_mac=0.0)


def evaluate_batch(op: MatMul, arch: HardwareConfig,
                   mappings: Sequence[Mapping],
                   cf_pairs: Sequence[tuple[CompiledFormat, CompiledFormat]],
                   cf_o: Optional[CompiledFormat] = None) -> BatchCost:
    """Vectorized :func:`evaluate` over aligned ``mappings``/``cf_pairs``.

    ``cf_pairs[j]`` is the (cf_i, cf_w) pair scored with ``mappings[j]``; a
    single pair broadcasts across all mappings.  ``cf_o`` (output writeback
    format) is shared by the whole batch, mirroring the search structure —
    it depends on the candidate pattern, not the mapping.
    """
    n = len(mappings)
    if len(cf_pairs) not in (1, n):
        raise ValueError(f"cf_pairs length {len(cf_pairs)} != 1 or {n}")
    if n == 0:
        return _empty_batch()
    soa_i = _pack([p[0] for p in cf_pairs])
    soa_w = _pack([p[1] for p in cf_pairs])
    ctx = mapping_ctx(op, arch, pack_mappings(mappings), cf_o)
    return _evaluate_core(op, arch, ctx, slice(None), soa_i, soa_w)


@dataclasses.dataclass(frozen=True)
class FormatTable:
    """Per-(format, tile) fetch terms of a format population over a packed
    mapping set, precomputed as (F, S) matrices.

    A sweep scoring many (format pair, mapping) combinations of the same
    populations (the stepwise baseline: up to 600×600 pairs over one
    shortlist) gathers rows from these tables instead of re-running the
    alignment math per candidate row — the only per-candidate work left is
    the elementwise tail of the cost formulas."""

    fet: np.ndarray              # (F, S) fetched bits per DRAM pass
    dec: np.ndarray              # (F, S) metadata decode ops
    ratio: np.ndarray            # (F,) compressed/dense ratio


def format_fetch_table(cfs: Sequence[CompiledFormat],
                       table: MappingSoA) -> FormatTable:
    """Build the (format population × mapping table) fetch matrices in one
    broadcast pass — element (f, s) carries exactly what the row-wise
    evaluator computes for (``cfs[f]``, ``table`` row ``s``): the same
    align/meta/payload expressions, summed over levels in the same order."""
    soa = _pack(cfs)
    tiles_f = table.tiles.astype(float)             # (S, 3)
    tl = tiles_f[:, soa.lvl_col]                    # (S, F, L)
    a = _align_vec(soa.lvl_block, tl)               # (S, F, L)
    meta = (soa.lvl_meta * a).sum(axis=2)           # (S, F)
    pay = soa.payload_bits * \
        _align_vec(soa.gran, tiles_f[:, None, :]).prod(axis=2)
    fet = np.where(soa.dense, soa.dense_bits, pay + meta)
    dec = np.where(soa.dense, 0.0, (soa.lvl_decode * a).sum(axis=2))
    return FormatTable(fet=np.ascontiguousarray(fet.T),
                       dec=np.ascontiguousarray(dec.T),
                       ratio=soa.ratio)


def evaluate_batch_gather(op: MatMul, arch: HardwareConfig,
                          table: MappingSoA, ft_i: FormatTable,
                          i_idx: np.ndarray, ft_w: FormatTable,
                          w_idx: np.ndarray, map_idx: np.ndarray,
                          cf_o: Optional[CompiledFormat] = None,
                          ctx: Optional["_MapCtx"] = None,
                          eval_threads: Optional[int] = None) -> BatchCost:
    """:func:`evaluate_batch` over gathered rows: candidate ``r`` pairs
    ``table`` row ``map_idx[r]`` with I-side format ``i_idx[r]`` and W-side
    format ``w_idx[r]`` of the precomputed :func:`format_fetch_table`\\ s.

    The mapping-only half of the formulas computes once per TABLE row
    (:func:`mapping_ctx` — pass ``ctx`` to reuse one across calls sharing
    (op, arch, table, cf_o), e.g. every chunk of a sweep), the
    per-(format, tile) fetch terms come from the tables, and only the
    elementwise tail runs per candidate — no per-row Python, no per-row
    alignment math.  Results are bit-identical to :func:`evaluate_batch`
    on the materialized rows (same expressions, same operation order).

    ``eval_threads`` splits the :func:`_evaluate_terms` tail into
    contiguous row chunks across a shared thread pool (NumPy releases the
    GIL inside the array kernels).  Every tail expression is elementwise
    over candidate rows, so the chunked result is bit-identical to the
    serial one for ANY thread count; ``None`` (the default) picks a count
    automatically — 1 below :data:`_EVAL_CHUNK_ROWS` rows, so small
    batches never pay pool overhead."""
    if len(map_idx) == 0:
        return _empty_batch()
    if ctx is None:
        ctx = mapping_ctx(op, arch, table, cf_o)
    args = (ft_i.fet[i_idx, map_idx], ft_i.dec[i_idx, map_idx],
            ft_i.ratio[i_idx],
            ft_w.fet[w_idx, map_idx], ft_w.dec[w_idx, map_idx],
            ft_w.ratio[w_idx])
    threads = resolve_eval_threads(eval_threads, len(map_idx))
    if threads <= 1:
        return _evaluate_terms(op, arch, ctx, map_idx, *args)
    bounds = np.linspace(0, len(map_idx), threads + 1).astype(np.int64)
    futures = [
        _eval_pool().submit(_evaluate_terms, op, arch, ctx,
                            map_idx[lo:hi], *(a[lo:hi] for a in args))
        for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    return _concat_batch([f.result() for f in futures])


# --- threaded tail: pool + sizing ------------------------------------------

_EVAL_CHUNK_ROWS = 32768        # min rows per thread chunk (auto mode)
_EVAL_POOL = None
_EVAL_POOL_LOCK = threading.Lock()


def _eval_pool():
    """Shared thread pool for the evaluator tail, created on first use
    (sized to the machine; per-call chunk counts are what bound fan-out)."""
    global _EVAL_POOL
    if _EVAL_POOL is None:
        with _EVAL_POOL_LOCK:
            if _EVAL_POOL is None:
                from concurrent.futures import ThreadPoolExecutor
                _EVAL_POOL = ThreadPoolExecutor(
                    max_workers=max(1, os.cpu_count() or 1),
                    thread_name_prefix="eval-tail")
    return _EVAL_POOL


def _reset_eval_pool() -> None:
    # A forked child (cosearch_multi's process executor on Linux) inherits
    # the pool OBJECT but not its worker threads — submitting to it would
    # block forever.  Drop the reference so the child lazily builds its
    # own pool on first threaded tail.
    global _EVAL_POOL
    _EVAL_POOL = None


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_eval_pool)


def resolve_eval_threads(eval_threads: Optional[int], n_rows: int) -> int:
    """The thread count a gather evaluation of ``n_rows`` rows will use:
    an explicit ``eval_threads`` wins (floored at 1); ``None`` = auto —
    one thread per :data:`_EVAL_CHUNK_ROWS` rows, capped at the CPU count,
    so the pool only engages when the tail is large enough to amortize
    thread handoff."""
    if eval_threads is not None:
        return max(1, int(eval_threads))
    return max(1, min(os.cpu_count() or 1, n_rows // _EVAL_CHUNK_ROWS))


def _concat_batch(parts: Sequence[BatchCost]) -> BatchCost:
    """Concatenate per-chunk tail results back into one :class:`BatchCost`.
    Every array is elementwise per candidate row, so concatenation of
    contiguous chunks reproduces the serial arrays exactly."""
    if len(parts) == 1:
        return parts[0]
    cat = {f.name: np.concatenate([getattr(p, f.name) for p in parts])
           for f in dataclasses.fields(BatchCost)
           if f.name not in ("e_rf", "e_mac")}
    return BatchCost(e_rf=parts[0].e_rf, e_mac=parts[0].e_mac, **cat)


@dataclasses.dataclass(frozen=True)
class _MapCtx:
    """The mapping-only half of the cost formulas, one row per mapping of a
    packed set: refetch multipliers, output traffic, conditional-fetch
    probabilities, GLB stream bases, compute cycles, utilization.  Rows are
    format-independent, so a sweep re-scoring the same mappings under many
    format pairs gathers instead of recomputing."""

    tiles_f: np.ndarray          # (S, 3)
    f_i: np.ndarray              # (S,) refetch multipliers
    f_w: np.ndarray
    i_fetch: np.ndarray          # (S,) conditional-fetch probabilities
    w_fetch: np.ndarray
    o_bits: np.ndarray           # (S,) output DRAM traffic (cf_o applied)
    glb_i_base: np.ndarray       # (S,) GLB stream bases (pre-ratio)
    glb_w_base: np.ndarray
    glb_o: np.ndarray            # (S,) partial-sum GLB traffic
    compute_cycles: np.ndarray   # (S,)
    util: np.ndarray             # (S,) pre-clip utilization


def mapping_ctx(op: MatMul, arch: HardwareConfig, msoa: MappingSoA,
                cf_o: Optional[CompiledFormat] = None) -> _MapCtx:
    """Precompute the mapping-only formula half for a packed mapping set;
    the result is reusable across every evaluation sharing
    (op, arch, mapping set, cf_o)."""
    n = len(msoa)
    vb = op.value_bits
    rho_i = op.sp_i.density
    rho_w = op.sp_w.density
    mac_frac = arch.reduc.mac_fraction(rho_i, rho_w)
    cyc_frac = arch.reduc.cycle_fraction(rho_i, rho_w)
    macs_dense = float(op.M) * op.N * op.K

    tiles, sps, ords = msoa.tiles, msoa.sps, msoa.ords
    tiles_f = tiles.astype(float)
    sps_f = sps.astype(float)
    ext = np.array([op.M, op.N, op.K], float)
    bounds = np.ceil(ext / tiles_f)

    # --- DRAM refetch (tile-reuse rule) + output traffic -------------------
    f_i = np.where(_REFETCH_OUTER["I"][ords], bounds[:, _IRR_COL["I"]], 1.0)
    f_w = np.where(_REFETCH_OUTER["W"][ords], bounds[:, _IRR_COL["W"]], 1.0)
    f_o = np.where(_REFETCH_OUTER["O"][ords], bounds[:, _IRR_COL["O"]], 1.0)
    o_elems = float(op.M) * op.K
    if cf_o is not None:
        # cf_o's dims are (M, K); the N column of ``tiles`` is never indexed
        o_final = _fetched_bits_vec(_pack([cf_o]), tiles_f)
    else:
        o_final = np.full(n, o_elems * vb)        # compressed writeback
    # intermediate partial sums (when the reduction is split across tiles)
    # move in wide precision: (f_o − 1) write+read round trips
    o_bits = 2.0 * (f_o - 1.0) * o_elems * 2 * vb + o_final
    # Conditional fetch under skipping: a W stripe is fetched only if SOME
    # input element pairing it inside the tile is non-zero (decisive during
    # decode, M=1: zero activations skip whole weight rows — Deja-Vu-style);
    # symmetrically for I under weight checking.
    w_fetch = np.ones(n)
    i_fetch = np.ones(n)
    if arch.reduc.kind == "skipping":
        if arch.reduc.check_i:
            w_fetch = _prob_nonempty_vec(op.sp_i, tiles[:, _DIM_COL["M"]])
        if arch.reduc.check_w:
            i_fetch = _prob_nonempty_vec(op.sp_w, tiles[:, _DIM_COL["K"]])

    # --- GLB stream bases: per-MAC operand streams with spatial + RF reuse
    # (the operand ratio multiplies in per candidate).  I is shared across
    # the K-unrolled PEs, W across M-unrolled, O partial sums reduce across
    # N-unrolled; each fetched word is further reused ~rf_reuse times from
    # the register file.
    rr = arch.rf_reuse
    n_stat = np.maximum(tiles[:, 1] // sps[:, 1], 1)
    glb_i_base = macs_dense * vb / (sps_f[:, 2] * rr)
    glb_w_base = macs_dense * vb / (sps_f[:, 0] * rr)
    glb_o = macs_dense * 2 * vb * mac_frac / (sps_f[:, 1] * rr * n_stat)

    # --- compute latency + utilization -------------------------------------
    n_tiles = bounds.prod(axis=1)
    per_tile_cycles = np.ceil(tiles_f / sps_f).prod(axis=1)
    compute_cycles = n_tiles * per_tile_cycles * cyc_frac
    util = macs_dense * cyc_frac / (np.maximum(compute_cycles, 1.0)
                                    * arch.macs)
    return _MapCtx(tiles_f=tiles_f, f_i=f_i, f_w=f_w,
                   i_fetch=i_fetch, w_fetch=w_fetch, o_bits=o_bits,
                   glb_i_base=glb_i_base, glb_w_base=glb_w_base, glb_o=glb_o,
                   compute_cycles=compute_cycles, util=util)


def _evaluate_core(op: MatMul, arch: HardwareConfig, ctx: _MapCtx, idx,
                   soa_i: _FormatSoA, soa_w: _FormatSoA) -> BatchCost:
    """Row-wise entry of the cost formulas: compute each candidate's fetch
    terms from its format SoA row (one align matrix per operand, shared
    between the fetch and decode terms), then run the shared elementwise
    tail.  ``idx`` selects the candidates' mapping rows from ``ctx``
    (``slice(None)`` = identity); ``soa_*`` broadcast one format row across
    the batch or carry one per candidate."""
    tiles_f = ctx.tiles_f[idx]
    a_i = _align_vec(soa_i.lvl_block, _tiles_at_levels(soa_i, tiles_f))
    a_w = _align_vec(soa_w.lvl_block, _tiles_at_levels(soa_w, tiles_f))
    fet_i = np.where(soa_i.dense, soa_i.dense_bits,
                     soa_i.payload_bits
                     * _align_vec(soa_i.gran, tiles_f).prod(axis=1)
                     + (soa_i.lvl_meta * a_i).sum(axis=1))
    fet_w = np.where(soa_w.dense, soa_w.dense_bits,
                     soa_w.payload_bits
                     * _align_vec(soa_w.gran, tiles_f).prod(axis=1)
                     + (soa_w.lvl_meta * a_w).sum(axis=1))
    dec_i = np.where(soa_i.dense, 0.0, (soa_i.lvl_decode * a_i).sum(axis=1))
    dec_w = np.where(soa_w.dense, 0.0, (soa_w.lvl_decode * a_w).sum(axis=1))
    return _evaluate_terms(op, arch, ctx, idx, fet_i, dec_i, soa_i.ratio,
                           fet_w, dec_w, soa_w.ratio)


def _evaluate_terms(op: MatMul, arch: HardwareConfig, ctx: _MapCtx, idx,
                    fet_i: np.ndarray, dec_i: np.ndarray, ratio_i: np.ndarray,
                    fet_w: np.ndarray, dec_w: np.ndarray, ratio_w: np.ndarray
                    ) -> BatchCost:
    """The elementwise tail of the cost formulas, shared by every entry
    point: combine per-candidate fetch terms with the gathered mapping-only
    ctx rows into energy / cycles / EDP."""
    rho_i = op.sp_i.density
    rho_w = op.sp_w.density
    mac_frac = arch.reduc.mac_fraction(rho_i, rho_w)
    macs_dense = float(op.M) * op.N * op.K
    vb = op.value_bits
    f_i, f_w = ctx.f_i[idx], ctx.f_w[idx]
    o_bits = ctx.o_bits[idx]

    # --- DRAM traffic (tile-reuse rule + format fetch model) ---------------
    dram_i = fet_i * f_i * ctx.i_fetch[idx]
    dram_w = fet_w * f_w * ctx.w_fetch[idx]

    # --- GLB traffic: compressed operands stream fewer bits (data stays
    # compressed in GLB — SCNN-style); skipping suppresses the PARTNER
    # operand's reads (a W word whose paired I is zero is never fetched,
    # and vice versa) -------------------------------------------------------
    skip = arch.reduc.kind == "skipping"
    i_partner = rho_w if (skip and arch.reduc.check_w) else 1.0
    w_partner = rho_i if (skip and arch.reduc.check_i) else 1.0
    glb_extra = 0.0

    # --- streaming-reuse term: a `glb_resident_frac` slice of the GLB may
    # pin compressed payload across outer-loop iterations, so that fraction
    # of each operand's RE-fetches (the `f − 1` refetch passes of the
    # tile-reuse rule) is served on-chip instead of from DRAM.  Distinct
    # fetches (the first pass) always come from DRAM; avoided refetches are
    # re-charged as GLB reads.  Decode stays charged per total stream — the
    # decoder sits at the compute side of the hierarchy either way.  The
    # term is formulated so that formats which STREAM well (small distinct
    # payload ⇒ high residency r) separate from formats that merely PACK
    # well.  Disabled (frac = 0, the default) this branch is skipped
    # entirely, keeping every seed cost bit-for-bit. -------------------------
    resident = arch.glb_resident_frac
    if resident:
        cap = resident * arch.glb.capacity_bits
        r_i = np.minimum(cap / np.maximum(fet_i, 1e-30), 1.0)
        r_w = np.minimum(cap / np.maximum(fet_w, 1e-30), 1.0)
        refet_i = fet_i * (f_i - 1.0) * ctx.i_fetch[idx]
        refet_w = fet_w * (f_w - 1.0) * ctx.w_fetch[idx]
        dram_i = dram_i - refet_i * r_i
        dram_w = dram_w - refet_w * r_w
        glb_extra = refet_i * r_i + refet_w * r_w

    dram_bits = dram_i + dram_w + o_bits
    glb_bits = (ctx.glb_i_base[idx] * np.minimum(ratio_i, 1.0) * i_partner
                + ctx.glb_w_base[idx]
                * np.minimum(ratio_w, 1.0) * w_partner
                + ctx.glb_o[idx]
                + o_bits
                + glb_extra)

    # --- RF + MAC ----------------------------------------------------------
    rf_bits = macs_dense * mac_frac * 3 * vb
    mac_energy = macs_dense * mac_frac * arch.mac_pj

    # --- metadata decode (charged per DRAM stream) --------------------------
    decode = dec_i * f_i + dec_w * f_w
    decode_energy = decode * arch.decode_pj_per_op

    e_dram = dram_bits * arch.dram.pj_per_bit
    e_glb = glb_bits * arch.glb.pj_per_bit
    e_rf = rf_bits * arch.rf.pj_per_bit
    energy = e_dram + e_glb + e_rf + mac_energy + decode_energy

    # --- latency ------------------------------------------------------------
    compute_cycles = ctx.compute_cycles[idx]
    dram_cycles = dram_bits / arch.dram.bw_bits_per_cycle
    glb_cycles = glb_bits / arch.glb.bw_bits_per_cycle
    cycles = np.maximum(np.maximum(compute_cycles, dram_cycles),
                        np.maximum(glb_cycles, 1.0))

    util = ctx.util[idx]
    cnt = op.count
    energy = energy * cnt
    cycles = cycles * cnt
    return BatchCost(
        energy=energy,
        cycles=cycles,
        edp=energy * cycles,
        utilization=np.minimum(util, 1.0),
        dram_bits=dram_bits * cnt,
        e_dram=e_dram * cnt,
        e_glb=e_glb * cnt,
        e_decode=decode_energy * cnt,
        dram_cycles=dram_cycles * cnt,
        compute_cycles=compute_cycles * cnt,
        e_rf=e_rf * cnt,
        e_mac=mac_energy * cnt,
    )


def evaluate(op: MatMul, arch: HardwareConfig, mapping: Mapping,
             cf_i: CompiledFormat, cf_w: CompiledFormat,
             cf_o: Optional[CompiledFormat] = None) -> CostReport:
    """Cost of running ``op`` with ``mapping`` and the given formats.

    ``cf_o``: format for the OUTPUT activation writeback (SCNN-style — the
    output is the next operator's sparse input and leaves the chip
    compressed).  Partial sums still move in wide precision.

    Thin wrapper over :func:`evaluate_batch` with a batch of one — the
    vectorized path is the single source of truth for the formulas."""
    return evaluate_batch(op, arch, (mapping,), ((cf_i, cf_w),),
                          cf_o).report(0)


def memory_energy(report: CostReport) -> float:
    """The paper's 'memory energy' metric: DRAM + on-chip buffer traffic —
    the data movement compression formats actually change.  RF accesses are
    part of the PE datapath (3/MAC regardless of format) and are accounted
    with compute, following Eyeriss/SCNN's energy taxonomy."""
    b = report.breakdown
    return b["dram"] + b["glb"]
