"""Sparsity Analyzer (paper §III-A Evaluator, left half).

Estimates compressed data sizes and computation reduction using statistical
expectations.  Two entry points:

  * :func:`analyze`        — expectation model over a sparsity distribution
                             (the fast path used inside the search loop);
  * :func:`analyze_exact`  — exact bit counts for a concrete binary mask
                             (oracle for tests and for the Fig. 5 example).

Both walk the format's fiber tree outer→inner, tracking how many units are
*stored* at each level (compressed primitives prune empty children; ``None``
levels keep everything) and summing per-primitive metadata bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import memo
from repro_torch.core.formats import AllocPlan, Format
from repro_torch.core.primitives import (DECODE_COST, LevelStats, Prim, clog2,
                                         keeps_only_nonempty, metadata_bits)


# ---------------------------------------------------------------------------
# Sparsity distributions
# ---------------------------------------------------------------------------

class Sparsity:
    """Base class: a statistical model of where zeros fall in a tensor."""

    density: float

    def prob_nonempty(self, block_elems: float) -> float:
        raise NotImplementedError

    def expected_nnz(self, block_elems: float) -> float:
        return self.density * block_elems


@dataclasses.dataclass(frozen=True)
class Bernoulli(Sparsity):
    """I.i.d. zeros with the given density of non-zeros (paper's default
    statistical-expectation model for unstructured sparsity)."""

    density: float

    def prob_nonempty(self, block_elems: float) -> float:
        if self.density <= 0.0:
            return 0.0
        if self.density >= 1.0:
            return 1.0
        return 1.0 - (1.0 - self.density) ** block_elems


@dataclasses.dataclass(frozen=True)
class NM(Sparsity):
    """N:M structured sparsity: exactly ``n`` non-zeros per ``m`` consecutive
    elements along the innermost dimension (e.g. 2:4)."""

    n: int
    m: int

    @property
    def density(self) -> float:  # type: ignore[override]
        return self.n / self.m

    def prob_nonempty(self, block_elems: float) -> float:
        c = block_elems
        if c >= self.m:
            return 1.0  # every m-group carries n>=1 non-zeros
        # Probability that a sub-group window of c elements is all-zero:
        # hypergeometric — choose positions of the (m-n) zeros.
        c = int(c)
        num = math.comb(self.m - self.n, c) if c <= self.m - self.n else 0
        return 1.0 - num / math.comb(self.m, c)


@dataclasses.dataclass(frozen=True)
class BlockBernoulli(Sparsity):
    """Zeros clustered into whole blocks of ``block_elems`` elements: a
    block is entirely non-zero with probability ``density``, entirely zero
    otherwise (what block pruning produces — element density equals block
    density, but the zeros are NOT i.i.d.).

    The distinction matters to the cost model: under i.i.d. ``Bernoulli``
    a bn×bk tile is almost surely non-empty at any useful density, so a
    block-bitmap format predicts near-dense payload traffic; under the
    clustered model ``prob_nonempty`` of a within-block window is just
    ``density``, matching what the execution plane measures on real
    block-pruned weights (see :mod:`repro_torch.exec.calibrate`)."""

    density: float
    block_elems: int            # elements per pruning block (bn · bk)

    def prob_nonempty(self, elems: float) -> float:
        if self.density <= 0.0:
            return 0.0
        if self.density >= 1.0:
            return 1.0
        # a window of `elems` elements touches ~max(1, elems/block) blocks;
        # it is empty only if every touched block is pruned
        touched = max(1.0, elems / self.block_elems)
        return 1.0 - (1.0 - self.density) ** touched


DENSE = Bernoulli(1.0)


# ---------------------------------------------------------------------------
# Tensor spec + size report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A named-dimension tensor with a sparsity model."""

    dims: dict[str, int]               # ordered, e.g. {"M": 4096, "N": 4096}
    sparsity: Sparsity = DENSE
    value_bits: int = 16               # bf16/int16 payload by default

    @property
    def elems(self) -> int:
        out = 1
        for v in self.dims.values():
            out *= v
        return out

    @property
    def dense_bits(self) -> float:
        return float(self.elems * self.value_bits)


def spec_key(spec: "TensorSpec") -> Optional[tuple]:
    """Hashable cache key for a TensorSpec (None if the sparsity model is
    unhashable — callers then skip their cache)."""
    try:
        hash(spec.sparsity)
    except TypeError:
        return None
    return (tuple(spec.dims.items()), spec.sparsity, spec.value_bits)


@dataclasses.dataclass(frozen=True)
class SizeReport:
    """Compressed-size analysis for (format, tensor)."""

    payload_bits: float
    metadata_bits: float
    decode_ops: float                  # metadata-processing work (cost model)
    per_level: tuple[float, ...]       # metadata bits per level

    @property
    def total_bits(self) -> float:
        return self.payload_bits + self.metadata_bits


# ---------------------------------------------------------------------------
# Expectation model
# ---------------------------------------------------------------------------

_ANALYZE_CACHE: dict = memo.register({}, "analyze")


def gather_scalar(fn, vals: np.ndarray, as_int: bool = True,
                  cache: Optional[dict] = None) -> np.ndarray:
    """Evaluate an arbitrary Python scalar function over an array by unique
    value: distribution models and bit-width rules are plain Python, but the
    values they see in the search plane (level sizes, tile extents, block
    products) come from small divisor sets, so ``fn`` runs once per distinct
    value and the results are gathered back.

    ``as_int`` converts each unique value to a Python ``int`` before the
    call, matching the scalar paths (which pass exact integer block counts);
    the values must then be integral.  ``cache`` optionally persists results
    across calls (caller-owned dict)."""
    if cache is None:
        cache = {}
    get = cache.get
    if vals.size > 64:
        # large batches dedupe in C first: fn still runs once per distinct
        # value, each element still receives exactly fn(int(v))
        uniq, inv = np.unique(vals.ravel(), return_inverse=True)
        out_u = np.empty(len(uniq))
        for i, v in enumerate(uniq.tolist()):
            k = int(v) if as_int else v
            hit = get(k, _GATHER_MISS)
            if hit is _GATHER_MISS:
                hit = cache[k] = fn(k)
            out_u[i] = hit
        return out_u[inv].reshape(vals.shape)
    flat = vals.ravel().tolist()
    out = np.empty(len(flat))
    for i, v in enumerate(flat):
        k = int(v) if as_int else v
        hit = get(k, _GATHER_MISS)
        if hit is _GATHER_MISS:
            hit = cache[k] = fn(k)
        out[i] = hit
    return out.reshape(vals.shape)


_GATHER_MISS = object()


def analyze(fmt: Format, spec: TensorSpec) -> SizeReport:
    """Expected compressed size of ``spec`` under ``fmt``.

    Memoized by (format, dims, sparsity, value_bits) — the engine's
    allocation scoring and the co-search's format compilation revisit the
    same (format, tensor) pairs constantly."""
    key = (fmt, tuple(spec.dims.items()), spec.sparsity, spec.value_bits)
    return memo.get_or(_ANALYZE_CACHE, key, lambda: _analyze_impl(fmt, spec))


def _analyze_impl(fmt: Format, spec: TensorSpec) -> SizeReport:
    """Walk levels outer→inner.  Invariants maintained:
      stored   — expected number of stored units entering level i
                 (the level's parents);
      covered  — elements covered by ONE unit at the parent level.
    """
    fmt.validate(spec.dims)
    sp = spec.sparsity

    # elements covered by one position at each level = product of inner sizes
    sizes = [int(l.size) for l in fmt.levels]  # type: ignore[arg-type]
    inner = [1] * (len(sizes) + 1)
    for i in range(len(sizes) - 1, -1, -1):
        inner[i] = inner[i + 1] * sizes[i]
    # inner[i] = elements covered by one unit at level i (levels 1-indexed via i-1)

    stored = 1.0
    dense_positions = 1.0
    meta: list[float] = []
    decode = 0.0
    for i, level in enumerate(fmt.levels):
        s = sizes[i]
        c_child = inner[i + 1]          # elements under one child position
        p_child = sp.prob_nonempty(c_child)
        dense_positions *= s
        # Expected non-empty positions at this level is the GLOBAL dense
        # count × p (linearity of expectation) — every non-empty position
        # necessarily lies under a non-empty (hence stored) parent, so this
        # is exactly the number of children materialized below compressed
        # parents, regardless of pruning decisions above.
        total_positions = stored * s
        nonempty = dense_positions * p_child
        st = LevelStats(
            stored_parents=stored,
            fanout=s,
            nonempty_positions=nonempty,
            child_nnz=sp.expected_nnz(inner[i]),
        )
        bits = metadata_bits(level.prim, st)
        meta.append(bits)
        decode += DECODE_COST[level.prim] * bits
        stored = nonempty if keeps_only_nonempty(level.prim) else total_positions

    payload = stored * spec.value_bits  # leaf units cover exactly 1 element
    return SizeReport(payload_bits=payload,
                      metadata_bits=float(sum(meta)),
                      decode_ops=decode,
                      per_level=tuple(meta))


# ---------------------------------------------------------------------------
# Batched expectation model (SoA over many allocations of one tensor)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSizeReport:
    """Vectorized :class:`SizeReport` over ``m`` formats of one tensor.

    Arrays are length ``m``; ``per_level`` is padded to the deepest format
    with zero-bit levels.  :meth:`report` reconstitutes the exact scalar
    :class:`SizeReport` for one row."""

    payload_bits: np.ndarray
    metadata_bits: np.ndarray
    decode_ops: np.ndarray
    per_level: np.ndarray               # (m, L) padded with 0.0
    n_levels: tuple[int, ...]           # true level count per format

    @property
    def total_bits(self) -> np.ndarray:
        return self.payload_bits + self.metadata_bits

    def __len__(self) -> int:
        return len(self.n_levels)

    def report(self, i: int) -> SizeReport:
        k = self.n_levels[i]
        return SizeReport(
            payload_bits=float(self.payload_bits[i]),
            metadata_bits=float(self.metadata_bits[i]),
            decode_ops=float(self.decode_ops[i]),
            per_level=tuple(float(b) for b in self.per_level[i, :k]))


_PRIM_CODE = {Prim.B: 0, Prim.CP: 1, Prim.RLE: 2, Prim.UOP: 3, Prim.NONE: 4}
_PRIM_BY_CODE = (Prim.B, Prim.CP, Prim.RLE, Prim.UOP, Prim.NONE)
_DECODE_BY_CODE = np.array([DECODE_COST[p] for p in _PRIM_BY_CODE])
_B_CODE, _CP_CODE, _RLE_CODE = _PRIM_CODE[Prim.B], _PRIM_CODE[Prim.CP], \
    _PRIM_CODE[Prim.RLE]
_UOP_CODE, _NONE_CODE = _PRIM_CODE[Prim.UOP], _PRIM_CODE[Prim.NONE]


def analyze_batch(fmts: Sequence[Format], spec: TensorSpec,
                  validate: bool = True) -> BatchSizeReport:
    """Expected compressed sizes of ``spec`` under many formats at once.

    Bit-identical to per-format :func:`analyze`: the level walk runs
    column-wise over a (format, level) matrix padded with size-1 ``None``
    levels (a no-op for every invariant), with the same operations in the
    same order, and the Python-level distribution/bit-width functions
    (``prob_nonempty`` / ``expected_nnz`` / :func:`clog2`) evaluated once
    per unique operand via :func:`gather_scalar`.  ``validate=False`` skips
    per-format validation for callers whose formats are correct by
    construction (:func:`repro_torch.core.formats.allocate`)."""
    m = len(fmts)
    if m == 0:
        z = np.zeros(0)
        return BatchSizeReport(z, z, z, np.zeros((0, 1)), ())
    if validate:
        for f in fmts:
            f.validate(spec.dims)
    n_levels = tuple(len(f.levels) for f in fmts)
    L = max(n_levels)
    sizes = np.ones((m, L))
    prims = np.full((m, L), _NONE_CODE, np.int64)
    for i, f in enumerate(fmts):
        for j, l in enumerate(f.levels):
            if l.prim is Prim.CUSTOM:
                raise ValueError("Custom primitive requires a custom bit "
                                 "model; analyze_batch does not support it")
            sizes[i, j] = int(l.size)   # type: ignore[arg-type]
            prims[i, j] = _PRIM_CODE[l.prim]
    return _analyze_rows(sizes, prims, n_levels, spec)


def analyze_batch_rows(sizes: np.ndarray, prims: Sequence[Prim],
                       n_levels: Sequence[int], spec: TensorSpec
                       ) -> BatchSizeReport:
    """Raw-array entry point of :func:`analyze_batch` for batches whose
    formats all share one primitive row (every allocation of one pattern:
    identical dense head, identical pattern levels, ``None`` leaves and
    padding).  ``sizes`` is the (m, L) level-size matrix padded with 1s;
    ``prims`` the shared per-level primitive row; ``n_levels`` the true
    level count per row.  Lets the hot path skip building ``Format``
    objects for allocations that lose the scan."""
    m, L = sizes.shape
    if len(prims) != L:
        raise ValueError(f"prim row length {len(prims)} != {L} levels")
    if any(p is Prim.CUSTOM for p in prims):
        raise ValueError("Custom primitive requires a custom bit model; "
                         "analyze_batch_rows does not support it")
    row = np.array([_PRIM_CODE[p] for p in prims], np.int64)
    return _analyze_rows(sizes, row.reshape(1, L), tuple(n_levels), spec)


def analyze_plans(plans: Sequence["AllocPlan"], spec: TensorSpec
                  ) -> BatchSizeReport:
    """Score a group of :class:`repro_torch.core.formats.AllocPlan` rows — every
    allocation of ONE pattern on one tensor — in a single
    :func:`analyze_batch_rows` pass, without constructing
    :class:`~repro_torch.core.formats.Format` objects.

    All plans must share the same ``dense_head`` and ``pattern`` (which is
    what :func:`repro_torch.core.formats.allocation_plans` yields); trailing
    dense leaves may vary per plan and pad as ``None`` levels.  Used by the
    engine's batched allocation scoring and the stepwise baseline's format
    sweep."""
    if not plans:
        z = np.zeros(0)
        return BatchSizeReport(z, z, z, np.zeros((0, 1)), ())
    rows = [p.row_sizes() for p in plans]
    width = max(len(r) for r in rows)
    sizes = np.array([r + [1] * (width - len(r)) for r in rows], float)
    return analyze_batch_rows(sizes, plans[0].prim_row(width),
                              [len(r) for r in rows], spec)


def _analyze_rows(sizes: np.ndarray, prims: np.ndarray,
                  n_levels: tuple[int, ...], spec: TensorSpec
                  ) -> BatchSizeReport:
    """Shared level walk; ``prims`` is (m, L), or (1, L) when every row has
    the same primitive at every level."""
    sp = spec.sparsity
    m, L = sizes.shape

    # inner[:, j] = elements covered by one unit at level j (suffix product)
    inner = np.ones((m, L + 1))
    for j in range(L - 1, -1, -1):
        inner[:, j] = inner[:, j + 1] * sizes[:, j]
    # dense positions through level j (prefix product, sequential like the
    # scalar ``dense_positions *= s``)
    dp = np.multiply.accumulate(sizes, axis=1)

    p_cache: dict = {}
    cl_cache: dict = {}
    nnz_cache: dict = {}
    stored = np.ones(m)
    meta_total = np.zeros(m)
    decode = np.zeros(m)
    per_level = np.zeros((m, L))
    zeros = np.zeros(m)
    uniform = prims.shape[0] == 1
    for j in range(L):
        s = sizes[:, j]
        code = prims[:, j]
        c0 = int(code[0])
        # Allocations of one pattern share the prim at every column (same
        # dense head, same pattern levels, NONE leaves/padding), so the
        # homogeneous fast paths below are the common case.
        homo = uniform or bool((code == c0).all())
        if homo and c0 == _NONE_CODE:
            # dense level: zero metadata bits, every child kept
            stored = stored * s
            continue
        nonempty = dp[:, j] * gather_scalar(sp.prob_nonempty,
                                            inner[:, j + 1], cache=p_cache)
        if homo:
            if c0 == _B_CODE:
                bits = stored * s
            elif c0 == _CP_CODE:
                bits = nonempty * gather_scalar(clog2, s, cache=cl_cache)
            elif c0 == _RLE_CODE:
                bits = nonempty * gather_scalar(clog2, s + 1.0,
                                                cache=cl_cache)
            else:                       # UOP
                child_nnz = gather_scalar(sp.expected_nnz, inner[:, j],
                                          cache=nnz_cache)
                field = gather_scalar(clog2, child_nnz + 1.0, as_int=False)
                bits = stored * (s + 1.0) * field
            stored_next = nonempty
            dc = DECODE_COST[_PRIM_BY_CODE[c0]]
        else:                           # mixed column: general path
            total_positions = stored * s
            if (code == _UOP_CODE).any():
                child_nnz = gather_scalar(sp.expected_nnz, inner[:, j],
                                          cache=nnz_cache)
                field = gather_scalar(clog2, child_nnz + 1.0, as_int=False)
                uop_bits = stored * (s + 1.0) * field
            else:
                uop_bits = zeros
            bits = np.choose(code, (
                total_positions,                                      # B
                nonempty * gather_scalar(clog2, s, cache=cl_cache),   # CP
                nonempty * gather_scalar(clog2, s + 1.0,
                                         cache=cl_cache),             # RLE
                uop_bits,                                             # UOP
                zeros,                                                # NONE
            ))
            stored_next = np.where(code != _NONE_CODE, nonempty,
                                   total_positions)
            dc = _DECODE_BY_CODE[code]
        per_level[:, j] = bits
        meta_total = meta_total + bits
        decode = decode + dc * bits
        stored = stored_next

    payload = stored * spec.value_bits
    return BatchSizeReport(payload_bits=payload, metadata_bits=meta_total,
                           decode_ops=decode, per_level=per_level,
                           n_levels=n_levels)


# ---------------------------------------------------------------------------
# Exact model (concrete mask)
# ---------------------------------------------------------------------------

def analyze_exact(fmt: Format, mask: np.ndarray, dims: dict[str, int],
                  value_bits: int = 16) -> SizeReport:
    """Exact bit counts of ``fmt`` applied to a concrete 0/1 ``mask``.

    ``mask`` axes must follow ``dims`` order.  The mask is reshaped so its
    axes match the level order (splitting repeated dims into subdims), then
    the fiber tree is walked with boolean occupancy arrays.
    """
    fmt.validate(dims)
    if tuple(mask.shape) != tuple(dims.values()):
        raise ValueError(f"mask shape {mask.shape} != dims {dims}")
    mask = mask.astype(bool)

    # Split each dim axis into its per-level sizes (outer→inner for that dim),
    # then transpose so axes follow the global level order.
    dim_names = list(dims)
    split_shapes: list[list[int]] = []
    level_axis: list[tuple[int, int]] = []   # per level: (dim_index, split_slot)
    slot_count = {d: 0 for d in dim_names}
    per_dim_sizes: dict[str, list[int]] = {d: [] for d in dim_names}
    for l in fmt.levels:
        per_dim_sizes[l.dim].append(int(l.size))  # type: ignore[arg-type]
        level_axis.append((dim_names.index(l.dim), slot_count[l.dim]))
        slot_count[l.dim] += 1
    for d in dim_names:
        split_shapes.append(per_dim_sizes[d] if per_dim_sizes[d] else [dims[d]])

    new_shape: list[int] = []
    axis_of: dict[tuple[int, int], int] = {}
    for di, shp in enumerate(split_shapes):
        for si, s in enumerate(shp):
            axis_of[(di, si)] = len(new_shape)
            new_shape.append(s)
    arr = mask.reshape(new_shape)
    perm = [axis_of[key] for key in level_axis]
    # any dims without levels were given a single implicit axis already in
    # split_shapes — formats from allocate() always carry a dense tail, so
    # every dim has at least one level after validate(); perm covers all axes.
    arr = np.transpose(arr, perm)

    n = len(fmt.levels)
    nonempty = [np.any(arr, axis=tuple(range(i + 1, n))) if i + 1 < n else arr
                for i in range(n)]
    # nonempty[i] has shape sizes[:i+1]; True where the unit holds any nnz.

    stored_parent = np.ones((), dtype=bool)   # level-0 root
    meta: list[float] = []
    decode = 0.0
    for i, level in enumerate(fmt.levels):
        s = int(level.size)  # type: ignore[arg-type]
        parents = float(np.sum(stored_parent))
        ne_mask = nonempty[i] & stored_parent[..., None]
        ne = float(np.sum(ne_mask))
        if level.prim is Prim.B:
            bits = parents * s
        elif level.prim is Prim.CP:
            bits = ne * clog2(s)
        elif level.prim is Prim.RLE:
            bits = ne * clog2(s + 1)
        elif level.prim is Prim.UOP:
            # field width: max non-zero count under any stored parent
            axes = tuple(range(i, arr.ndim))
            child_nnz = np.sum(arr, axis=axes) * stored_parent
            width = clog2(float(np.max(child_nnz)) + 1.0)
            bits = parents * (s + 1) * width
        else:  # NONE / CUSTOM-dense
            bits = 0.0
        meta.append(bits)
        decode += DECODE_COST[level.prim] * bits
        stored_parent = ne_mask if keeps_only_nonempty(level.prim) \
            else np.broadcast_to(stored_parent[..., None],
                                 stored_parent.shape + (s,)).copy()

    payload = float(np.sum(stored_parent)) * value_bits
    return SizeReport(payload_bits=payload,
                      metadata_bits=float(sum(meta)),
                      decode_ops=decode,
                      per_level=tuple(meta))


# ---------------------------------------------------------------------------
# Computation reduction (paper §II-B2): gating / skipping, uni/bidirectional
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ComputeReduction:
    """One of the five strategies: none, {gating,skipping} × {→, ←, ↔}.

    ``check_i``/``check_w`` state which operand's zeros are detected; the
    checked operands' densities multiply into the effective MAC fraction.
    ``skipping`` saves cycles as well as energy; gating saves energy only.
    """

    kind: str = "none"                 # "none" | "gating" | "skipping"
    check_i: bool = False
    check_w: bool = False

    def mac_fraction(self, rho_i: float, rho_w: float) -> float:
        if self.kind == "none":
            return 1.0
        f = 1.0
        if self.check_i:
            f *= rho_i
        if self.check_w:
            f *= rho_w
        return f

    def cycle_fraction(self, rho_i: float, rho_w: float) -> float:
        """Upfront estimate of temporal loop-bound shrinkage (§III-D1)."""
        if self.kind == "skipping":
            return self.mac_fraction(rho_i, rho_w)
        return 1.0

    def label(self) -> str:
        if self.kind == "none":
            return "none"
        arrow = {"10": "I→W", "01": "W→I", "11": "I↔W"}[
            f"{int(self.check_i)}{int(self.check_w)}"]
        return f"{self.kind} {arrow}"


NO_REDUCTION = ComputeReduction()


def reduction(kind: str, direction: str) -> ComputeReduction:
    """Factory: direction in {'I', 'W', 'IW'} = which operands are checked."""
    return ComputeReduction(kind=kind,
                            check_i="I" in direction,
                            check_w="W" in direction)
