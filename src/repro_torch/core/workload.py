"""Sparse workloads: operator-level MatMul specs + LLM graph builders.

Paper §III-A: SnipSnap's first input is "sparse workloads, possibly including
one or multiple LLMs, with operator-level computation and sparsity
specifications".  The core operation is MatMul in the paper's naming
convention:

    O[M][K] = sum_N  I[M][N] * W[N][K]        (N is the contracted dim)

so operand dimensions are  I:{M,N},  W:{N,K},  O:{M,K}.

LLM builders emit one MatMul per projection (Q,K,V,O,FC1,FC2) per phase
(prefill / per-token decode), annotated with activation/weight sparsity in
the ranges quoted by the paper from [4],[5] (e.g. FC2 activation sparsity up
to 97%, FC1 35–70%).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.sparsity import DENSE, Bernoulli, NM, Sparsity


@dataclasses.dataclass(frozen=True)
class MatMul:
    """One sparse matmul operator: O[M,K] = Σ_N I[M,N]·W[N,K]."""

    name: str
    M: int
    N: int
    K: int
    sp_i: Sparsity = DENSE          # input/activation sparsity
    sp_w: Sparsity = DENSE          # weight sparsity
    sp_o: Sparsity = DENSE          # OUTPUT activation sparsity (post-
    #                                 nonlinearity — compressed on writeback,
    #                                 SCNN-style, with the activation format)
    count: float = 1.0              # repetitions (layers × phases)
    value_bits: int = 16

    @property
    def macs(self) -> float:
        return float(self.M) * self.N * self.K * self.count

    def i_dims(self) -> dict[str, int]:
        return {"M": self.M, "N": self.N}

    def w_dims(self) -> dict[str, int]:
        return {"N": self.N, "K": self.K}

    def o_dims(self) -> dict[str, int]:
        return {"M": self.M, "K": self.K}


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named bag of MatMul operators (one LLM, or one LLM phase)."""

    name: str
    ops: tuple[MatMul, ...]

    @property
    def macs(self) -> float:
        return sum(op.macs for op in self.ops)


# ---------------------------------------------------------------------------
# LLM graph builders (§IV-A2 benchmarks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLMSpec:
    name: str
    layers: int
    d_model: int
    d_ff: int
    heads: int
    # activation density (non-zero fraction) per op family; weight density.
    act_density: float = 1.0
    w_density: float = 1.0
    fc2_act_density: Optional[float] = None   # FC2 input often much sparser
    nm_weights: Optional[tuple[int, int]] = None   # e.g. (2, 4)


# Public configs.  Densities follow Fig. 10's annotated activation/weight
# density pairs and the §II-A ranges (FC1 act 35–70% sparse, FC2 up to 97%).
LLAMA2_7B = LLMSpec("LLaMA2-7B", 32, 4096, 11008, 32)
LLAMA2_13B = LLMSpec("LLaMA2-13B", 40, 5120, 13824, 40)
OPT_125M = LLMSpec("OPT-125M", 12, 768, 3072, 12)
OPT_6_7B = LLMSpec("OPT-6.7B", 32, 4096, 16384, 32)
OPT_13B = LLMSpec("OPT-13B", 40, 5120, 20480, 40)
OPT_30B = LLMSpec("OPT-30B", 48, 7168, 28672, 56)
BERT_BASE = LLMSpec("BERT-Base", 12, 768, 3072, 12)


def _sp(density: float) -> Sparsity:
    return DENSE if density >= 1.0 else Bernoulli(density)


def build_llm(spec: LLMSpec, seq: int, decode_tokens: int = 0,
              act_density: Optional[float] = None,
              w_density: Optional[float] = None,
              fc2_act_density: Optional[float] = None,
              batch: int = 1) -> Workload:
    """Emit the projection MatMuls for prefill (M=seq) and decode (M=1 per
    token, ``count`` scaled by decode_tokens).  2048-token prefill +
    128-token decode is the paper's evaluation setting (§IV-C, via [21]).
    FC2's input (the FFN activation) is usually far sparser than the rest
    (up to 97% zero in ReLU-fied OPT — §II-A)."""
    ad = spec.act_density if act_density is None else act_density
    wd = spec.w_density if w_density is None else w_density
    fc2_ad = fc2_act_density if fc2_act_density is not None else (
        spec.fc2_act_density if spec.fc2_act_density is not None else ad)
    sp_w: Sparsity = NM(*spec.nm_weights) if spec.nm_weights else _sp(wd)

    d, f, L = spec.d_model, spec.d_ff, spec.layers
    ops: list[MatMul] = []

    def phase(tag: str, m: int, count: float) -> None:
        ops.extend([
            MatMul(f"{tag}.qkv", m, d, 3 * d, _sp(ad), sp_w, _sp(ad), count),
            MatMul(f"{tag}.o", m, d, d, _sp(ad), sp_w, _sp(ad), count),
            # FC1's output IS FC2's (very sparse) input activation
            MatMul(f"{tag}.fc1", m, d, f, _sp(ad), sp_w, _sp(fc2_ad), count),
            MatMul(f"{tag}.fc2", m, f, d, _sp(fc2_ad), sp_w, _sp(ad), count),
        ])

    phase("prefill", seq * batch, float(L))
    if decode_tokens:
        phase("decode", batch, float(L) * decode_tokens)
    return Workload(spec.name, tuple(ops))


# ---------------------------------------------------------------------------
# CNN workloads for the DiMO-Sparse comparison (§IV-D) — conv as im2col GEMM.
# ---------------------------------------------------------------------------

def _conv_gemm(name: str, out_hw: int, cin: int, k: int, cout: int,
               act_density: float, w_density: float) -> MatMul:
    return MatMul(name, out_hw * out_hw, cin * k * k, cout,
                  _sp(act_density), _sp(w_density))


def alexnet(act_density: float = 0.6, w_density: float = 0.35) -> Workload:
    layers = [
        _conv_gemm("conv1", 55, 3, 11, 96, 1.0, w_density),
        _conv_gemm("conv2", 27, 96, 5, 256, act_density, w_density),
        _conv_gemm("conv3", 13, 256, 3, 384, act_density, w_density),
        _conv_gemm("conv4", 13, 384, 3, 384, act_density, w_density),
        _conv_gemm("conv5", 13, 384, 3, 256, act_density, w_density),
    ]
    return Workload("AlexNet", tuple(layers))


def vgg16(act_density: float = 0.5, w_density: float = 0.3) -> Workload:
    cfg = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
           (56, 128, 256), (56, 256, 256), (56, 256, 256),
           (28, 256, 512), (28, 512, 512), (28, 512, 512),
           (14, 512, 512), (14, 512, 512), (14, 512, 512)]
    ops = [_conv_gemm(f"conv{i}", hw, cin, 3, cout,
                      1.0 if i == 0 else act_density, w_density)
           for i, (hw, cin, cout) in enumerate(cfg)]
    return Workload("VGG-16", tuple(ops))


def resnet18(act_density: float = 0.55, w_density: float = 0.4) -> Workload:
    cfg = [(56, 64, 64)] * 4 + [(28, 128, 128)] * 4 + \
          [(14, 256, 256)] * 4 + [(7, 512, 512)] * 4
    ops = [_conv_gemm(f"conv{i}", hw, cin, 3, cout, act_density, w_density)
           for i, (hw, cin, cout) in enumerate(cfg)]
    return Workload("ResNet-18", tuple(ops))
