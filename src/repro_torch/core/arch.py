"""Hardware configurations (paper §III-A input 2, Table II).

A :class:`HardwareConfig` is a MAC array + a memory hierarchy (outer→inner)
+ a computation-reduction strategy + the compression-format slot(s) the
hardware implements.  Energy constants are per-bit, in normalized units
following the Eyeriss/SCNN energy-per-access ratios (DRAM ≈ 200× RF per
16-bit word); all paper experiments report *normalized* energy, so the
ratios — not absolute joules — are what matters and what we validate.

Arch 1/2 model Eyeriss-style hierarchies, Arch 3/4 DSTC-style (Table II),
both scaled to 16× MACs and 4× on-chip memory per §IV-A1.  TPUV5E models the
execution-plane target for the codesign bridge (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.sparsity import ComputeReduction, reduction


@dataclasses.dataclass(frozen=True)
class MemLevel:
    """One memory level.  ``capacity_bits`` None = unbounded (off-chip)."""

    name: str
    capacity_bits: Optional[float]
    bw_bits_per_cycle: float
    pj_per_bit_read: float
    pj_per_bit_write: float

    @property
    def pj_per_bit(self) -> float:
        return (self.pj_per_bit_read + self.pj_per_bit_write) / 2.0


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    name: str
    macs: int
    levels: tuple[MemLevel, ...]        # outer→inner: [DRAM, GLB, RF]
    mac_pj: float                       # energy per MAC
    reduc: ComputeReduction
    clock_ghz: float = 1.0
    decode_pj_per_op: float = 0.05      # metadata decode energy (§IV-E:
    #                                     1.56–15.45% area overhead ⇒ small
    #                                     per-op cost relative to a MAC)
    rf_reuse: float = 16.0              # temporal reuse at the RF level —
    #                                     each GLB word feeds ~this many MACs
    #                                     (Eyeriss row-stationary ≈ 0.5KB RF)
    glb_resident_frac: float = 0.0      # fraction of GLB capacity the
    #                                     streaming pipeline may pin for
    #                                     compressed-payload residency; 0
    #                                     disables the reuse term (the seed
    #                                     cost model, bit-for-bit)

    @property
    def dram(self) -> MemLevel:
        return self.levels[0]

    @property
    def glb(self) -> MemLevel:
        return self.levels[1]

    @property
    def rf(self) -> MemLevel:
        return self.levels[-1]


# 16-bit-word energy ratios (Eyeriss ISCA'16): DRAM=200, GLB=6, RF=1, MAC=1.
_WORD = 16.0


def _eyeriss_like(name: str, reduc: ComputeReduction) -> HardwareConfig:
    # Eyeriss: 168 PEs × 16 = 2688 MACs; 108KB GLB × 4 = 432KB.
    return HardwareConfig(
        name=name,
        macs=2688,
        levels=(
            MemLevel("DRAM", None, 64.0, 200 / _WORD, 200 / _WORD),
            MemLevel("GLB", 432e3 * 8 * 1.0, 512.0, 6 / _WORD, 6 / _WORD),
            MemLevel("RF", 0.5e3 * 8 * 2688, 2 * 2688.0, 1 / _WORD, 1 / _WORD),
        ),
        mac_pj=1.0,
        reduc=reduc,
        clock_ghz=0.2,
    )


def _dstc_like(name: str, reduc: ComputeReduction) -> HardwareConfig:
    # DSTC-style tensor core: 2048 MACs, larger SRAM, wider DRAM bus.
    return HardwareConfig(
        name=name,
        macs=2048,
        levels=(
            MemLevel("DRAM", None, 256.0, 200 / _WORD, 200 / _WORD),
            MemLevel("GLB", 2e6 * 8 * 1.0, 2048.0, 5 / _WORD, 5 / _WORD),
            MemLevel("RF", 1e3 * 8 * 2048, 4 * 2048.0, 1 / _WORD, 1 / _WORD),
        ),
        mac_pj=1.0,
        reduc=reduc,
        clock_ghz=1.0,
    )


# Table II.  Default formats: Arch1/2 ship RLE, Arch3/4 ship Bitmap.
ARCH1 = _eyeriss_like("Arch 1", reduction("gating", "I"))
ARCH2 = _eyeriss_like("Arch 2", reduction("skipping", "I"))
ARCH3 = _dstc_like("Arch 3", reduction("skipping", "IW"))
ARCH4 = _dstc_like("Arch 4", reduction("gating", "IW"))

DEFAULT_FORMAT = {"Arch 1": "RLE", "Arch 2": "RLE",
                  "Arch 3": "Bitmap", "Arch 4": "Bitmap"}

ALL_ARCHS = (ARCH1, ARCH2, ARCH3, ARCH4)


# Execution-plane target: TPU v5e (197 TFLOP/s bf16, 819 GB/s HBM, ~128 MiB
# VMEM modeled).  Zero-skipping on the MXU only exists at tile granularity
# (DESIGN.md §4) — modeled as block-granular skipping I↔W.
TPUV5E = HardwareConfig(
    name="TPUv5e",
    macs=4 * 128 * 128,
    levels=(
        MemLevel("HBM", 16e9 * 8, 819e9 * 8 / 0.94e9, 200 / _WORD, 200 / _WORD),
        MemLevel("VMEM", 128e6 * 8, 5e12 * 8 / 0.94e9, 3 / _WORD, 3 / _WORD),
        MemLevel("VREG", 1e6 * 8, 4 * 65536.0, 1 / _WORD, 1 / _WORD),
    ),
    mac_pj=1.0,
    reduc=reduction("skipping", "IW"),
    clock_ghz=0.94,
)


def with_streaming_reuse(arch: HardwareConfig,
                         frac: float = 0.5) -> HardwareConfig:
    """``arch`` with a GLB residency budget for the streaming pipeline.

    ``frac`` of the GLB may hold compressed payload across outer-loop
    iterations, so re-fetches of the resident slice are served on-chip
    instead of from DRAM (the cost model's reuse term,
    ``costmodel._evaluate_terms``).  The name is tagged so memo keys and
    reports distinguish reuse-aware searches from the baseline."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"glb_resident_frac must be in [0,1], got {frac}")
    return dataclasses.replace(
        arch, name=f"{arch.name}+resident{frac:g}", glb_resident_frac=frac)


def arch_by_name(name: str) -> HardwareConfig:
    if "+resident" in name:               # with_streaming_reuse round trip
        base, _, frac = name.rpartition("+resident")
        return with_streaming_reuse(arch_by_name(base), float(frac))
    table = {a.name: a for a in ALL_ARCHS + (TPUV5E,)}
    # tolerate compact ids
    table.update({"arch1": ARCH1, "arch2": ARCH2, "arch3": ARCH3,
                  "arch4": ARCH4, "tpuv5e": TPUV5E})
    return table[name]
