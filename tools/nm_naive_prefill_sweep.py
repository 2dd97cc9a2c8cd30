#!/usr/bin/env python3
"""Sweep the naive N:M kernel's prefill design on one card.

    python3 tools/nm_naive_prefill_sweep.py [--out DIR]

Builds ``src/repro_torch/csrc/nm_spmm.cu`` once per variant, with the
source edited as ``VARIANTS`` says, into ``DIR`` (default
``build/sweep-prefill``): the design alternatives the committed prefill
kernel (``nm_spmm_naive_prefill_kernel``: 128 x 128 tiles of 8 x 8 outputs a
thread, x copied and staged as fp32, each run expanded once into a dense
shared-memory tile, 2:4 and 1:4 a group per item; 32 x 32 tiles of 2 x 4
where the big grid has fewer than 64 blocks) was chosen against: other
thread tiles (8 x 8 over 64 x 128, 4 x 4 over 64 x 64, 16 x 8 over 128 x
128), x staged in its own type and widened in the FMA loop, each thread
expanding its own dense values in registers for every dense row (no dense
tile), the dense-row expansion for 2:4 and 1:4 too, the big tile for the
K = 256 roles and a 4 x 4 small tile.  It prints each variant's ptxas
registers and spills for the naive prefill kernel.  Then at every
projection role of full-width chatglm3-6b, 2:4 (weights pruned from a
seeded generator), M = 512, x in bf16 and fp32, it launches each variant's
``nm_spmm_naive_*`` by a direct C call, holds the result to the committed
pipelined entry (``torch.equal``) and prints device ms (CUDA events, L2
flushed, mean of 5) per role and summed over the seven roles of a layer,
beside the pipelined entry (kernel 3), one fp32 ``torch.matmul`` over the
dense weight and the bound (the dense FMAs the naive design does, at 67
TFLOP/s fp32).
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

BIG = "using NaiveBig = NTile<16, 16, 8, 8, 2>;"
SMALL = "using NaiveSmall = NTile<16, 8, 2, 4, 4>;"
FMA_CALL = (
    "    fma_run<TT, T>(reinterpret_cast<const T*>(stage(run)) + RM * ty,\n"
    "                   dense + (run & 1) * XC * TK + 4 * tx, acc);")
MARK = "\n// Naive prefill kernel"
# bf16 x rows widened in the FMA loop: 16 bits into the high half of a word
LOAD_BF16 = r"""
template <int R>
__device__ __forceinline__ void load_x_rows(const __nv_bfloat16* xc,
                                            float (&a)[R]) {
  unsigned w[R / 2];
  if constexpr (R == 2) {
    w[0] = *reinterpret_cast<const unsigned*>(xc);
  } else if constexpr (R == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(xc);
    w[0] = t.x;
    w[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < R / 8; ++i) {
      const uint4 t = *reinterpret_cast<const uint4*>(xc + 8 * i);
      w[4 * i] = t.x;
      w[4 * i + 1] = t.y;
      w[4 * i + 2] = t.z;
      w[4 * i + 3] = t.w;
    }
  }
#pragma unroll
  for (int u = 0; u < R / 2; ++u) {
    a[2 * u] = __uint_as_float(w[u] << 16);
    a[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}
"""
# the dense values of a thread's columns expanded in registers for every
# dense row, from the staged kept rows (no dense tile, no expansion pass)
FMA_REGISTERS = r"""
template <class TT, typename T>
__device__ __forceinline__ void fma_run_registers(
    const T* __restrict__ xs, const float* __restrict__ vs,
    const unsigned* __restrict__ is4, int xw, int n_sel, int m_group,
    float (&acc)[TT::RM][TT::RK]) {
  constexpr int RM = TT::RM, RK = TT::RK, TK = TT::TK, Q = TK / 4;
  const int tx = threadIdx.x % TT::TX;
  for (int c = 0; c < XC; ++c) {
    const int g = c / m_group;
    const unsigned p = (unsigned)(c - g * m_group);
    float a[RM], b[RK];
    load_x_rows<RM>(xs + c * TT::TM, a);
#pragma unroll
    for (int j = 0; j < RK; ++j) b[j] = 0.f;
    for (int s = g * n_sel; s < (c < xw ? g + 1 : g) * n_sel; ++s) {
#pragma unroll
      for (int h = 0; h < RK / 4; ++h) {
        const int q = tx + TT::TX * h;
        const float4 v = *reinterpret_cast<const float4*>(vs + s * TK + 4 * q);
        const unsigned pk = is4[s * Q + q];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[4 * h + j] += (pk >> (8 * j) & 0xffu) == p ? w[j] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}
"""


def _edit(*pairs):
    """Replace each (old, new) once; an old text missing from the source
    fails the sweep."""
    def edit(src: str) -> str:
        for old, new in pairs:
            if old not in src:
                sys.exit(f"the edit no longer applies: {old[:60]!r}")
            src = src.replace(old, new, 1)
        return src
    return edit


def _registers(src: str) -> str:
    src = _edit((MARK, FMA_REGISTERS + MARK),
                ("    if (run + 1 < runs) expand(run + 1);\n", ""),
                ("  expand(0);\n", ""))(src)
    return _edit((FMA_CALL, """    {
      const float* vs = reinterpret_cast<const float*>(stage(run) + xbytes);
      fma_run_registers<TT, T>(
          reinterpret_cast<const T*>(stage(run)) + RM * ty, vs,
          reinterpret_cast<const unsigned*>(vs + rows_all * TK),
          gcur(run) * m_group, n_sel, m_group, acc);
    }"""))(src)


# name: edit of the source; the first is the committed variant
VARIANTS = {
    "committed": lambda src: src,
    "8x8 over 64x128": _edit(
        (BIG, "using NaiveBig = NTile<8, 16, 8, 8, 3>;")),
    "4x4 over 64x64": _edit(
        (BIG, "using NaiveBig = NTile<16, 16, 4, 4, 2>;")),
    "16x8 over 128x128": _edit(
        (BIG, "using NaiveBig = NTile<8, 16, 16, 8, 1>;")),
    "x in its own type": _edit(
        ("      using XS = float;", "      using XS = T;"),
        ("\n// The FMAs of one run", LOAD_BF16 + "\n// The FMAs of one run")),
    "dense in registers": _registers,
    "row expansion": _edit(
        ("if (n_sel == 2 && m_group == 4)\n      expand_groups",
         "if (n_sel < 0)\n      expand_groups"),
        ("else if (n_sel == 1 && m_group == 4)\n      expand_groups",
         "else if (n_sel < 0)\n      expand_groups")),
    "big tile at K=256": _edit(
        ("constexpr int NV_MIN_GRID = 64;", "constexpr int NV_MIN_GRID = 1;")),
    "small tile 4x4": _edit(
        (SMALL, "using NaiveSmall = NTile<8, 8, 4, 4, 4>;")),
}
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
M = 512


def _build(out_dir: str) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/nm_spmm.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        variant = edit(src)
        cu = os.path.join(out_dir, f"nm{i}.cu")
        so = os.path.join(out_dir, f"nm{i}.so")
        open(cu, "w").write(variant)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            hit = re.search(r"nm_spmm_naive_prefill_kernelI\w*?NTileILi(\d+)"
                            r"ELi(\d+)ELi(\d+)ELi(\d+)ELi\d+EEE"
                            r"(13__nv_bfloat16|f)Lb([01])", line)
            if "Function properties for" in line and hit:
                ty, tx, rm, rk = map(int, hit.groups()[:4])
                print(f"[sweep] {name}: naive prefill {ty * rm} x {tx * rk} "
                      f"({rm} x {rk} a thread) x "
                      f"{'bf16' if hit[5] != 'f' else 'fp32'} "
                      f"{'cp.async' if hit[6] == '1' else 'plain'}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "sweep-prefill"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("nm_naive_prefill_sweep: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import ops
    from repro_torch.sparse import masks

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = _build(args.out)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, device=dev)

    def time_ms(fn, reps=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    def naive(lib, name, x, c):
        """One call of the variant's naive entry, as the wrapper makes it:
        one slice and the workspace of ``workspace_numel``."""
        m, n = x.shape
        k = c.values.shape[1]
        y = torch.empty((m, k), device=dev)
        ws = torch.empty(nm.workspace_numel("nm_spmm_naive", m, n, k, 1),
                         device=dev)
        fn = getattr(lib, "nm_spmm_naive_bf16" if x.dtype == torch.bfloat16
                     else "nm_spmm_naive_f32")
        fn.argtypes, fn.restype = nm._ARGTYPES, ctypes.c_int
        err = fn(x.data_ptr(), c.values.data_ptr(), c.indices.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), m, n, k, c.n_sel, c.m_group,
                 1, nm.split_plan(m, n, k, c.n_sel, c.m_group)[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"{name}: launch failed: CUDA error {err}")
        return y

    cfg = get_config("chatglm3-6b")
    gen = torch.Generator(device=dev).manual_seed(7)
    failed = []
    for dtype in (torch.bfloat16, torch.float32):
        sums = dict.fromkeys([*libs, "pipelined", "matmul", "dense bound"],
                             0.0)
        for role in cfg.matmul_roles():
            w = torch.randn((role.n, role.k), generator=gen, device=dev) \
                / math.sqrt(role.n)
            wp = masks.nm_prune(w, 2, 4)
            c = ops.compress_nm(wp, 2, 4)
            x = torch.randn((M, role.n), generator=gen, device=dev).to(dtype)
            y = ops.nm_spmm(x, c)
            row = []
            for name, lib in libs.items():
                y_v = naive(lib, name, x, c)
                torch.cuda.synchronize()
                if not torch.equal(y_v, y):
                    failed.append(f"{name} {role.role} {dtype}")
                    row.append(f"{name} FAILED")
                    continue
                ms = time_ms(lambda: naive(lib, name, x, c))
                sums[name] += ms
                row.append(f"{name} {ms:.4f}")
            ms3 = time_ms(lambda: ops.nm_spmm(x, c))
            lib_ms = time_ms(lambda: torch.matmul(x.float(), wp))
            nbytes = c.values.numel() * 5 + x.numel() * x.element_size() \
                + M * role.k * 4
            bound = 1e3 * max(nbytes / HBM_BYTES_S,
                              2.0 * M * role.n * role.k / FP32_FLOP_S)
            sums["pipelined"] += ms3
            sums["matmul"] += lib_ms
            sums["dense bound"] += bound
            print(f"[sweep] {role.role} 2:4 M={M} x={str(dtype)[6:]} ms: "
                  f"{'; '.join(row)}; pipelined {ms3:.4f}; matmul "
                  f"{lib_ms:.4f}; dense bound {bound:.4f}", flush=True)
            del w, wp, c, x, y
        print(f"[sweep] layer (7 roles) 2:4 M={M} x={str(dtype)[6:]} ms: "
              + "; ".join(f"{k} {v:.4f}" for k, v in sums.items()),
              flush=True)
    if failed:
        sys.exit("nm_naive_prefill_sweep: FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
