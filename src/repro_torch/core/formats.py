"""Hierarchical compression format encoding (paper §III-B).

A *compression pattern* (Definition 1) is an ordered sequence of primitives,
outer level first, each bound to a dimension or subdimension:

    CompPat(n) = [prim_1(dim_1), ..., prim_n(dim_n)]

A *dimension allocation* (Definition 2) assigns a concrete size to every
(sub)dimension, drawn from the prime factorization of the original dimension:

    DimAlloc(CompPat) = {(dim_ij, size_ij)}

A fully-specified :class:`Format` is a pattern + allocation; e.g. CSC over an
M×N tensor is ``UOP(N)-CP(M)`` and, with sizes, ``UOP(N,6)-CP(M,3)``.

The format is interpreted as a fiber tree: level 1 partitions the tensor into
``size_1`` units along ``dim_1``; each unit is recursively partitioned by the
next level.  The product of sizes bound to each named dimension must equal
that dimension's extent, and every tensor dimension must appear (possibly as a
single ``None`` level for dense dims).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Iterator, Optional, Sequence

from repro_torch.core import memo
from repro_torch.core.primitives import Prim


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of a compression format: primitive + dimension (+ size)."""

    prim: Prim
    dim: str                 # dimension name, e.g. "M" or "N"
    size: Optional[int] = None   # None until dimension allocation

    def with_size(self, size: int) -> "Level":
        return Level(self.prim, self.dim, size)

    def __str__(self) -> str:
        if self.size is None:
            return f"{self.prim}({self.dim})"
        return f"{self.prim}({self.dim},{self.size})"


@dataclasses.dataclass(frozen=True)
class Format:
    """An ordered (outer→inner) sequence of levels over a named-dim tensor."""

    levels: tuple[Level, ...]
    name: Optional[str] = None   # human name for standard formats

    # -- constructors ------------------------------------------------------
    @staticmethod
    def of(*levels: Level, name: Optional[str] = None) -> "Format":
        return Format(tuple(levels), name=name)

    # -- basic properties --------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def compressed_levels(self) -> int:
        """Number of levels that actually compress (exclude ``None``)."""
        return sum(1 for l in self.levels if l.prim is not Prim.NONE)

    def is_allocated(self) -> bool:
        return all(l.size is not None for l in self.levels)

    def pattern_key(self) -> tuple[tuple[str, str], ...]:
        """Hashable identity of the compression pattern (sizes stripped)."""
        return tuple((l.prim.value, l.dim) for l in self.levels)

    def __str__(self) -> str:
        base = "-".join(str(l) for l in self.levels)
        return f"{self.name}[{base}]" if self.name else base

    # -- validation --------------------------------------------------------
    def validate(self, dims: dict[str, int]) -> None:
        """Check the allocation covers ``dims`` exactly (product per dim)."""
        if not self.is_allocated():
            raise ValueError(f"format {self} is not fully allocated")
        prod: dict[str, int] = {}
        for l in self.levels:
            prod[l.dim] = prod.get(l.dim, 1) * int(l.size)  # type: ignore[arg-type]
        for d, extent in dims.items():
            if prod.get(d, 1) != extent:
                raise ValueError(
                    f"format {self}: dim {d} covers {prod.get(d, 1)} != {extent}")
        for d in prod:
            if d not in dims:
                raise ValueError(f"format {self}: unknown dim {d}")


# ---------------------------------------------------------------------------
# Standard named formats (the four baselines of §IV-A plus CSC/CSB).
# ---------------------------------------------------------------------------

def bitmap(dims: dict[str, int]) -> Format:
    """Flat bitmap: one bit per element.  ``None`` outer dims + B innermost
    (equivalent to B over the flattened tensor)."""
    names = list(dims)
    levels = [Level(Prim.NONE, d, dims[d]) for d in names[:-1]]
    levels.append(Level(Prim.B, names[-1], dims[names[-1]]))
    return Format(tuple(levels), name="Bitmap")


def rle(dims: dict[str, int]) -> Format:
    """Flat run-length encoding along the innermost dimension."""
    names = list(dims)
    levels = [Level(Prim.NONE, d, dims[d]) for d in names[:-1]]
    levels.append(Level(Prim.RLE, names[-1], dims[names[-1]]))
    return Format(tuple(levels), name="RLE")


def csr(dims: dict[str, int]) -> Format:
    """CSR over (row, col): UOP(row)-CP(col)."""
    (r, rs), (c, cs) = list(dims.items())
    return Format((Level(Prim.UOP, r, rs), Level(Prim.CP, c, cs)), name="CSR")


def csc(dims: dict[str, int]) -> Format:
    """CSC over (row, col): UOP(col)-CP(row) — Fig. 4(b), Flexagon."""
    (r, rs), (c, cs) = list(dims.items())
    return Format((Level(Prim.UOP, c, cs), Level(Prim.CP, r, rs)), name="CSC")


def coo(dims: dict[str, int]) -> Format:
    """COO: nested coordinate payloads (row then col coordinates)."""
    (r, rs), (c, cs) = list(dims.items())
    return Format((Level(Prim.CP, r, rs), Level(Prim.CP, c, cs)), name="COO")


def csb(dims: dict[str, int], block: dict[str, int]) -> Format:
    """Compressed Sparse Block (Procrustes, Fig. 4(b)): bitmap over the block
    grid with dense blocks below."""
    levels = []
    for d, extent in dims.items():
        b = block[d]
        if extent % b:
            raise ValueError(f"block {b} does not divide {d}={extent}")
        levels.append(Level(Prim.B, d, extent // b))
    for d, b in block.items():
        levels.append(Level(Prim.NONE, d, b))
    return Format(tuple(levels), name="CSB")


STANDARD_BASELINES = ("Bitmap", "RLE", "CSR", "COO")


def standard_formats(dims: dict[str, int]) -> dict[str, Format]:
    """The four widely-used baseline formats of §IV-A2."""
    return {
        "Bitmap": bitmap(dims),
        "RLE": rle(dims),
        "CSR": csr(dims),
        "COO": coo(dims),
    }


# ---------------------------------------------------------------------------
# Pattern / allocation enumeration (the two subspaces of §III-B).
# ---------------------------------------------------------------------------

SEARCH_PRIMS = (Prim.B, Prim.CP, Prim.RLE, Prim.UOP)


def enumerate_patterns(dims: Sequence[str], max_levels: int,
                       prims: Sequence[Prim] = SEARCH_PRIMS,
                       min_levels: int = 1,
                       ) -> Iterator[tuple[Level, ...]]:
    """Enumerate compression patterns (sizes unassigned).

    A pattern of ``n`` levels chooses, per level, a primitive and a dimension;
    dimensions may repeat (subdimensions).  Trailing ``None`` (dense-block)
    variants are generated by the allocator, not here.  Constraints applied:
      * UOP only meaningful as a non-leaf (it indexes children payloads);
      * at least one level per tensor dimension overall is implied by the
        allocator (a dim absent from the pattern is stored dense/flattened).
    """
    for n in range(min_levels, max_levels + 1):
        for dim_choice in itertools.product(dims, repeat=n):
            for prim_choice in itertools.product(prims, repeat=n):
                if prim_choice and prim_choice[-1] is Prim.UOP:
                    continue  # UOP at the leaf has nothing to offset into
                yield tuple(Level(p, d) for p, d in zip(prim_choice, dim_choice))


def factorizations(extent: int, parts: int) -> Iterator[tuple[int, ...]]:
    """All ordered factorizations of ``extent`` into ``parts`` integer factors
    (>=1 each, product == extent).  Derived from the prime factorization as in
    Definition 2."""
    if parts == 1:
        yield (extent,)
        return
    for first in sorted(_divisors(extent)):
        for rest in factorizations(extent // first, parts - 1):
            yield (first,) + rest


def _divisors(x: int) -> list[int]:
    out = []
    i = 1
    while i * i <= x:
        if x % i == 0:
            out.append(i)
            if i != x // i:
                out.append(x // i)
        i += 1
    return out


_FACTORIZATIONS_CACHE: dict = memo.register({}, "factorizations")


def factorizations_cached(extent: int, parts: int) -> tuple[tuple[int, ...], ...]:
    """Materialized, memoized :func:`factorizations` (identical order).

    The allocation planes — :func:`allocate` and the mapping-derived chain
    splitting in :mod:`repro_torch.core.engine` — revisit the same (extent, parts)
    pairs constantly (tensor dims come from a handful of layer shapes), so
    the recursive enumeration runs once per pair."""
    return memo.get_or(
        _FACTORIZATIONS_CACHE, (extent, parts),
        lambda: tuple(factorizations(extent, parts)))


def _alloc_key(opt: tuple[tuple[int, ...], Optional[int]]) -> float:
    # Order allocations by innermost-level size proximity to ~8: the
    # innermost compressed level dominates metadata cost per non-zero
    # (CP/RLE field width, B group amortization), and sizes 4–16 are
    # the sweet spot across densities — so capped/early-bailed
    # enumeration visits the likely winners first.
    factors, leaf = opt
    inner = leaf if leaf is not None else factors[-1]
    return abs(math.log2(max(inner, 1)) - 3.0)


_ALLOC_OPTS_CACHE: dict = memo.register({}, "alloc_opts")


def _dim_alloc_options(extent: int, k: int, allow_dense_leaf: bool
                       ) -> tuple[tuple[tuple[int, ...], Optional[int]], ...]:
    """Per-dim allocation options: (factors_for_slots, leaf_size or None),
    sorted by :func:`_alloc_key`.  Depends only on (extent, slot count,
    leaf policy), which recur for every pattern touching the dim — memoized."""
    def build():
        opts = [(f, None) for f in factorizations_cached(extent, k)
                if all(x > 1 for x in f)]
        if allow_dense_leaf:
            opts += [(f[:-1], f[-1])
                     for f in factorizations_cached(extent, k + 1)
                     if all(x > 1 for x in f)]
        opts.sort(key=_alloc_key)
        return tuple(opts)
    return memo.get_or(_ALLOC_OPTS_CACHE, (extent, k, allow_dense_leaf), build)


@dataclasses.dataclass(frozen=True)
class AllocPlan:
    """One dimension allocation in raw form — the hot-path view of
    :func:`allocate` (same enumeration order).  Carries the level sizes as
    plain integers so batch analyzers can score thousands of allocations
    without constructing :class:`Format`/:class:`Level` objects; the full
    format is materialized lazily via :meth:`build` for winners only."""

    pattern: tuple[Level, ...]
    dense_head: tuple[Level, ...]
    slot_sizes: tuple[int, ...]             # per pattern slot, slot order
    leaves: tuple[tuple[str, int], ...]     # trailing dense-leaf (dim, size)

    def row_sizes(self) -> list[int]:
        """Level sizes outer→inner: dense head + pattern slots + leaves."""
        return ([int(l.size) for l in self.dense_head]   # type: ignore[arg-type]
                + list(self.slot_sizes) + [s for _, s in self.leaves])

    def prim_row(self, width: int) -> list[Prim]:
        """Per-level primitive row aligned with :meth:`row_sizes`, padded
        with ``NONE`` to ``width`` (leaves and padding are both dense) —
        what the batch analyzers feed ``analyze_batch_rows``.  Shared by
        every allocation of one pattern."""
        head = len(self.dense_head)
        return [Prim.NONE] * head + [l.prim for l in self.pattern] \
            + [Prim.NONE] * (width - head - len(self.pattern))

    def build(self) -> Format:
        levels = tuple(l.with_size(s)
                       for l, s in zip(self.pattern, self.slot_sizes))
        leaf_levels = tuple(Level(Prim.NONE, d, s) for d, s in self.leaves)
        return Format(self.dense_head + levels + leaf_levels)


def allocation_plans(pattern: Sequence[Level], dims: dict[str, int],
                     max_allocs: Optional[int] = None,
                     allow_dense_leaf: bool = True) -> Iterator[AllocPlan]:
    """Enumerate dimension allocations for a pattern (Definition 2), as
    lightweight :class:`AllocPlan` rows.

    Dims not referenced by the pattern are prepended as dense ``None``
    levels (outermost), matching the paper's treatment of uncompressed dims.
    With ``allow_dense_leaf``, each pattern dim may optionally keep an extra
    innermost dense factor (``None`` leaf) — this expresses block-sparse
    formats such as CSB/Procrustes (dense blocks indexed by compressed
    outer levels).  Factors of 1 are disallowed (a size-1 level encodes
    nothing).
    """
    pattern = tuple(pattern)
    per_dim_slots: dict[str, list[int]] = {}
    for i, l in enumerate(pattern):
        per_dim_slots.setdefault(l.dim, []).append(i)

    # per dim: list of (factors_for_slots, leaf_size or None)
    choices: list[tuple[tuple[tuple[int, ...], Optional[int]], ...]] = []
    dim_order: list[str] = []
    for d, slots in per_dim_slots.items():
        if d not in dims:
            raise ValueError(f"pattern references unknown dim {d}")
        opts = _dim_alloc_options(dims[d], len(slots), allow_dense_leaf)
        if not opts:
            return  # cannot split this dim into that many >1 factors
        choices.append(opts)
        dim_order.append(d)

    dense_head = tuple(Level(Prim.NONE, d, dims[d]) for d in dims
                       if d not in per_dim_slots)

    count = 0
    n = len(pattern)
    for combo in itertools.product(*choices):
        sizes: dict[int, int] = {}
        leaves: list[tuple[str, int]] = []
        for d, (alloc, leaf) in zip(dim_order, combo):
            for slot, size in zip(per_dim_slots[d], alloc):
                sizes[slot] = size
            if leaf is not None:
                leaves.append((d, leaf))
        yield AllocPlan(pattern, dense_head,
                        tuple(sizes[i] for i in range(n)), tuple(leaves))
        count += 1
        if max_allocs is not None and count >= max_allocs:
            return


def allocate(pattern: Sequence[Level], dims: dict[str, int],
             max_allocs: Optional[int] = None,
             allow_dense_leaf: bool = True) -> Iterator[Format]:
    """:func:`allocation_plans`, materialized to :class:`Format` objects."""
    for plan in allocation_plans(pattern, dims, max_allocs=max_allocs,
                                 allow_dense_leaf=allow_dense_leaf):
        yield plan.build()
