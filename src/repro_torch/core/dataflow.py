"""Dataflow space: spatial unrolling, loop tiling, loop ordering, allocation.

Paper §II-B1: "Dataflow involves for-loop permutation combined with spatial
and temporal mapping... loop unrolling for parallelism, loop order
optimization, and loop allocation to memory hierarchy".  SnipSnap reuses
established methodology here ([20] ZigZag, [25] Sparseloop) — this module is
a compact ZigZag-lite mapper for the paper's MatMul convention
O[M,K] = Σ_N I[M,N]·W[N,K].

A :class:`Mapping` is:
  spatial — per-dim unroll factors on the MAC array (Π ≤ #MACs);
  tile    — per-dim GLB-resident tile extents (loop allocation: loops inside
            the tile run at the GLB/RF levels, loops over tiles at DRAM);
  order   — the DRAM-level loop permutation, outer→inner.

Access counting (costmodel.py) uses the classic tile-reuse rule: an operand's
DRAM traffic multiplies by the bounds of every loop that is irrelevant to it
and positioned OUTER to its innermost relevant loop.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterator, Optional, Sequence

import numpy as np

from repro_torch.core import memo
from repro_torch.core.arch import HardwareConfig
from repro_torch.core.workload import MatMul

DIMS = ("M", "N", "K")
RELEVANT = {"I": ("M", "N"), "W": ("N", "K"), "O": ("M", "K")}
ORDERS: tuple[tuple[str, str, str], ...] = tuple(itertools.permutations(DIMS))  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class Mapping:
    spatial: dict[str, int]
    tile: dict[str, int]
    order: tuple[str, str, str]

    def bounds(self, op: MatMul) -> dict[str, int]:
        """DRAM-level loop bounds (tiles per dim, ceil)."""
        ext = {"M": op.M, "N": op.N, "K": op.K}
        return {d: math.ceil(ext[d] / self.tile[d]) for d in DIMS}

    def __str__(self) -> str:
        sp = "x".join(f"{d}{self.spatial[d]}" for d in DIMS)
        tl = "x".join(f"{d}{self.tile[d]}" for d in DIMS)
        return f"sp[{sp}] tile[{tl}] order[{''.join(self.order)}]"


# ---------------------------------------------------------------------------
# Candidate enumeration, bounded for search speed.
# ---------------------------------------------------------------------------

def _capped_divisors(x: int, cap: int = 12) -> list[int]:
    """A representative divisor subset: powers of two times the odd part's
    divisors, thinned to ``cap`` values spread across magnitudes."""
    divs = []
    i = 1
    while i * i <= x:
        if x % i == 0:
            divs.append(i)
            if i != x // i:
                divs.append(x // i)
        i += 1
    divs.sort()
    if len(divs) <= cap:
        return divs
    # keep extremes + geometrically spread interior
    idx = {0, len(divs) - 1}
    for k in range(1, cap - 1):
        idx.add(round(k * (len(divs) - 1) / (cap - 1)))
    return [divs[i] for i in sorted(idx)]


def spatial_candidates(op: MatMul, arch: HardwareConfig,
                       top: int = 6) -> list[dict[str, int]]:
    """Unroll-factor triples maximizing PE utilization.

    The array is modeled as a flat MAC budget (geometry waste shows up as
    ceil-division cycles in the cost model); dims may not unroll past their
    extent."""
    ext = {"M": op.M, "N": op.N, "K": op.K}
    cands: list[tuple[float, dict[str, int]]] = []
    dm = _capped_divisors(ext["M"], 8)
    dn = _capped_divisors(ext["N"], 8)
    dk = _capped_divisors(ext["K"], 8)
    for um in dm:
        if um > arch.macs:
            continue
        for un in dn:
            if um * un > arch.macs:
                continue
            for uk in dk:
                if um * un * uk > arch.macs:
                    continue
                util = um * un * uk / arch.macs
                cands.append((util, {"M": um, "N": un, "K": uk}))
    cands.sort(key=lambda t: -t[0])
    out, seen = [], set()
    for util, sp in cands:
        key = tuple(sp.values())
        if key in seen:
            continue
        seen.add(key)
        out.append(sp)
        if len(out) >= top:
            break
    return out


def tile_candidates(op: MatMul, spatial: dict[str, int],
                    per_dim_cap: int = 8) -> Iterator[dict[str, int]]:
    """GLB tile extents: multiples of the spatial factors, divisor-aligned,
    spread across magnitudes (the smallest legal tile — the spatial factor
    itself — is always included so capacity-constrained ops stay mappable)."""
    ext = {"M": op.M, "N": op.N, "K": op.K}
    opts: dict[str, list[int]] = {}
    for d in DIMS:
        cands = sorted({t for t in _capped_divisors(ext[d], per_dim_cap + 8)
                        if t % spatial[d] == 0}
                       | {spatial[d], ext[d]})
        if len(cands) > per_dim_cap:
            idx = {0, len(cands) - 1}
            for k in range(1, per_dim_cap - 1):
                idx.add(round(k * (len(cands) - 1) / (per_dim_cap - 1)))
            cands = [cands[i] for i in sorted(idx)]
        opts[d] = cands
    for tm in opts["M"]:
        for tn in opts["N"]:
            for tk in opts["K"]:
                yield {"M": tm, "N": tn, "K": tk}


def tile_fits(op: MatMul, tile: dict[str, int], arch: HardwareConfig,
              ratio_i: float = 1.0, ratio_w: float = 1.0,
              double_buffer: bool = True) -> bool:
    """Loop-allocation legality: the three live tiles must fit in GLB.

    ``ratio_*`` are compressed/dense size ratios — this is the paper's
    *compression-aware loop allocation* (§III-D2): compressed tiles are
    smaller, so more aggressive tilings become legal with no post-hoc
    correction pass."""
    vb = op.value_bits
    bits_i = tile["M"] * tile["N"] * vb * ratio_i
    bits_w = tile["N"] * tile["K"] * vb * ratio_w
    bits_o = tile["M"] * tile["K"] * 2 * vb     # fp32-ish accumulators
    need = bits_i + bits_w + bits_o
    if double_buffer:
        need += bits_i + bits_w                 # ping-pong input buffers
    cap = arch.glb.capacity_bits
    return cap is None or need <= cap


def tile_fits_batch(op: MatMul, tiles: np.ndarray, arch: HardwareConfig,
                    ratio_i: np.ndarray, ratio_w: np.ndarray,
                    double_buffer: bool = True) -> np.ndarray:
    """:func:`tile_fits` for many (format-pair, tile) points at once.

    ``tiles`` is an (n, 3) integer array over ``DIMS``; ``ratio_i`` /
    ``ratio_w`` are length-``p`` compressed/dense ratio vectors (one entry
    per format pair).  Returns a (p, n) boolean legality matrix.  The
    arithmetic replays :func:`tile_fits` element-wise in the same operation
    order (exact-int tile×tile×bits products, then one float multiply per
    ratio), so a row is bit-identical to ``[tile_fits(op, t, arch, ri, rw)
    for t in tiles]`` — the stepwise baseline's sweep relies on that to
    replay the scalar path's legality decisions."""
    vb = op.value_bits
    elems_i = (tiles[:, 0] * tiles[:, 1] * vb)[None, :]     # exact int64
    elems_w = (tiles[:, 1] * tiles[:, 2] * vb)[None, :]
    bits_o = tiles[:, 0] * tiles[:, 2] * (2 * vb)
    bits_i = elems_i * np.asarray(ratio_i, float)[:, None]
    bits_w = elems_w * np.asarray(ratio_w, float)[:, None]
    need = bits_i + bits_w + bits_o
    if double_buffer:
        need = need + (bits_i + bits_w)
    cap = arch.glb.capacity_bits
    if cap is None:
        return np.ones(need.shape, bool)
    return need <= cap


def irrelevant_refetch(order: Sequence[str], operand: str,
                       bounds: dict[str, int]) -> float:
    """Π of bounds of loops irrelevant to ``operand`` that sit outer to its
    innermost relevant loop — the refetch multiplier for DRAM traffic."""
    rel = RELEVANT[operand]
    innermost_rel = max(order.index(d) for d in rel)
    f = 1.0
    for pos, d in enumerate(order):
        if d not in rel and pos < innermost_rel:
            f *= bounds[d]
    return f


def enumerate_mappings(op: MatMul, arch: HardwareConfig,
                       ratio_i: float = 1.0, ratio_w: float = 1.0,
                       spatial_top: int = 4,
                       orders: Optional[Sequence[tuple[str, str, str]]] = None,
                       ) -> Iterator[Mapping]:
    """Full (bounded) mapping space for one MatMul on one architecture."""
    orders = tuple(orders) if orders is not None else ORDERS
    for sp in spatial_candidates(op, arch, top=spatial_top):
        for tile in tile_candidates(op, sp):
            if not tile_fits(op, tile, arch, ratio_i, ratio_w):
                continue
            for order in orders:
                yield Mapping(spatial=sp, tile=tile, order=order)


_MAPPINGS_CACHE: dict = memo.register({}, "mappings_for")


def mappings_for(op: MatMul, arch: HardwareConfig,
                 ratio_i: float = 1.0, ratio_w: float = 1.0,
                 spatial_top: int = 4,
                 orders: Optional[Sequence[tuple[str, str, str]]] = None,
                 ) -> tuple[Mapping, ...]:
    """Memoized :func:`enumerate_mappings` (same candidate set, same order).

    The space depends only on the op SHAPE (extents + value_bits — names,
    sparsity models and repeat counts do not enter legality), the
    architecture, the exact compression ratios, and the enumeration knobs —
    that tuple is the cache key, so identical layers across pattern pairs
    and models enumerate once.
    """
    orders = tuple(orders) if orders is not None else ORDERS
    key = ((op.M, op.N, op.K, op.value_bits), arch, ratio_i, ratio_w,
           spatial_top, orders)
    return memo.get_or(
        _MAPPINGS_CACHE, key,
        lambda: tuple(enumerate_mappings(op, arch, ratio_i, ratio_w,
                                         spatial_top=spatial_top,
                                         orders=orders)))
