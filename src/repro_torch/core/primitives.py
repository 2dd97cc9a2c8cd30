"""Compression primitives — the atoms of SnipSnap's hierarchical format encoding.

Paper §III-B, Fig. 4(a). A *primitive* is a basic compression operation applied
at one level of a fiber-tree view of a tensor:

  RLE  — run-length encoding: number of zeros between adjacent non-zeros.
  CP   — coordinate payload: coordinates of non-zero positions.
  B    — bitmap: one bit per position marking zero/non-zero.
  UOP  — uncompressed offset pairs: group-wise first-non-zero offsets ending
         with the total count (CSR-style row-pointer array).
  NONE — level kept uncompressed / flattened (dense positions).
  CUSTOM — user-supplied metadata-bit model.

Each primitive defines how many METADATA bits it stores at its level, given
(a) the number of *stored parents* (units whose children this level describes),
(b) the level's fan-out ``s`` (positions per parent), and
(c) occupancy statistics supplied by the Sparsity Analyzer.

Semantics shared by all compressed primitives: metadata is materialized only
under parents that are actually stored, and only non-empty children are
recursed into / stored below.  This is what makes hierarchical formats win
(Fig. 5): an all-zero group of 6 elements costs 1 top-level bit, not 6.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Optional


def clog2(x: float) -> int:
    """ceil(log2(x)) with a floor of 1 bit (a field narrower than 1 bit
    does not exist in hardware)."""
    return max(1, math.ceil(math.log2(max(2.0, float(x)))))


class Prim(enum.Enum):
    RLE = "RLE"
    CP = "CP"
    B = "B"
    UOP = "UOP"
    NONE = "None"
    CUSTOM = "Custom"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclasses.dataclass(frozen=True)
class LevelStats:
    """Occupancy statistics for one format level, from the Sparsity Analyzer.

    stored_parents : expected number of parent units whose children this level
                     describes (>= number of *non-empty* parents; equal to it
                     unless an outer ``None`` level forced dense storage).
    fanout         : s — positions per parent at this level.
    nonempty_positions : expected number of non-empty positions at this level
                     (across all parents).
    child_nnz      : expected number of non-zero *elements* under ONE parent
                     (used to size UOP offset fields).
    """

    stored_parents: float
    fanout: int
    nonempty_positions: float
    child_nnz: float


# ---------------------------------------------------------------------------
# Metadata-bit models, one per primitive.
# ---------------------------------------------------------------------------

def _bits_b(st: LevelStats) -> float:
    # One bit per position, for every stored parent.
    return st.stored_parents * st.fanout


def _bits_cp(st: LevelStats) -> float:
    # One coordinate per non-empty position; field addresses the fan-out.
    return st.nonempty_positions * clog2(st.fanout)


def _bits_rle(st: LevelStats) -> float:
    # One run-length per non-empty position.  Field must be able to express a
    # run spanning the whole fan-out (escape codes ignored — expectation
    # model; same simplification as Sparseloop's RLE model).
    return st.nonempty_positions * clog2(st.fanout + 1)


def _bits_uop(st: LevelStats) -> float:
    # Per stored parent: s offsets + a terminating total count, each wide
    # enough to index the parent's non-zero payload (CSR row pointers).
    field = clog2(st.child_nnz + 1.0)
    return st.stored_parents * (st.fanout + 1) * field


def _bits_none(st: LevelStats) -> float:
    return 0.0


_BIT_MODELS: dict[Prim, Callable[[LevelStats], float]] = {
    Prim.B: _bits_b,
    Prim.CP: _bits_cp,
    Prim.RLE: _bits_rle,
    Prim.UOP: _bits_uop,
    Prim.NONE: _bits_none,
}


def metadata_bits(prim: Prim, stats: LevelStats,
                  custom_model: Optional[Callable[[LevelStats], float]] = None
                  ) -> float:
    """Expected metadata bits stored by ``prim`` at a level with ``stats``."""
    if prim is Prim.CUSTOM:
        if custom_model is None:
            raise ValueError("Custom primitive requires a custom bit model")
        return custom_model(stats)
    return _BIT_MODELS[prim](stats)


def keeps_only_nonempty(prim: Prim) -> bool:
    """Whether the primitive prunes empty children from storage below it.

    All compressed primitives do; ``None`` keeps every child (dense level).
    """
    return prim is not Prim.NONE


# Decompression/complexity weight per primitive, used by the cost model to
# charge metadata-processing energy.  Relative magnitudes follow the paper's
# qualitative ranking (B cheapest to decode; UOP/CSR-style pointer chasing and
# RLE prefix-sums cost more).  Units: decode ops per metadata bit.
DECODE_COST: dict[Prim, float] = {
    Prim.B: 1.0,
    Prim.CP: 1.5,
    Prim.RLE: 2.0,
    Prim.UOP: 1.5,
    Prim.NONE: 0.0,
    Prim.CUSTOM: 2.0,
}
