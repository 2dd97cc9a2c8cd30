#!/usr/bin/env python3
"""Sweep the naive N:M kernel's decode design on one card.

    python3 tools/nm_naive_sweep.py [--out DIR]

Builds ``src/repro_torch/csrc/nm_spmm.cu`` once per variant, with the
source edited as ``VARIANTS`` says, into ``DIR`` (default ``build/sweep``):
the design alternatives the committed decode kernel was chosen against
(kept rows a load batch: 16 instead of 8 at MT <= 4, or 8 or 4 at every
MT instead of 8 at MT <= 4 and 4 above; the run-time loop for every group
shape instead of the compile-time 2:4 / 1:4 bodies; 128 output columns a
block instead of 256; the tiled 64 x 64 kernel with one slice, the design
before it).  It prints each variant's ptxas registers and spills for the
naive decode kernel.  Then at every projection role of full-width
chatglm3-6b, 2:4 and 1:4 (weights pruned from a seeded generator), M = 4
and 16, bf16 x, it launches each variant's ``nm_spmm_naive_bf16`` by a
direct C call, holds the result to the committed pipelined entry
(``torch.equal``; the tiled variant, whose order differs, to 1e-4 of the
plain version) and prints device ms (CUDA events, L2 flushed, mean of 10)
per role and summed over the seven roles of a layer, beside the pipelined
entry, one fp32 ``torch.matmul`` over the dense weight and the bound (the
payload, x and y bytes at 3.35 TB/s).
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

# name: edit of the source; the first is the committed variant
VARIANTS = {
    "committed": lambda src: src,
    "rows 16 to MT 4": lambda src: src.replace(
        "constexpr int NV_ROWS = MT <= 4 ? 8 : 4;",
        "constexpr int NV_ROWS = MT <= 4 ? 16 : 4;"),
    "rows 8": lambda src: src.replace(
        "constexpr int NV_ROWS = MT <= 4 ? 8 : 4;",
        "constexpr int NV_ROWS = 8;"),
    "rows 4": lambda src: src.replace(
        "constexpr int NV_ROWS = MT <= 4 ? 8 : 4;",
        "constexpr int NV_ROWS = 4;"),
    # every group shape through the run-time loop
    "run-time loop": lambda src: src.replace(
        "if (n_sel == 2 && m_group == 4)", "if (n_sel < 0)").replace(
        "else if (n_sel == 1 && m_group == 4)", "else if (n_sel < 0)"),
    # 32 threads of 4 columns a block (both decode kernels)
    "128 columns": lambda src: src.replace(
        "constexpr int SK_THREADS = 64;", "constexpr int SK_THREADS = 32;"),
    # the decode shapes through the 64 x 64 tiled kernel, one slice
    "tiled": lambda src: src.replace(
        "const bool decode = m <= SK_MAX_M && k % 4 == 0;",
        "const bool decode = entry != NAIVE && m <= SK_MAX_M && k % 4 == 0;"),
}
HBM_BYTES_S = 3.35e12


def _build(out_dir: str) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/nm_spmm.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        variant = edit(src)
        if name != "committed" and variant == src:
            sys.exit(f"{name}: the edit no longer applies to the source")
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
            hit = re.search(r"nm_spmm_naive_small_m_kernelI(13__nv_bfloat16|f)"
                            r"Li(\d+)ELb([01])E", line)
            if "Function properties for" in line and hit:
                print(f"[sweep] {name}: naive decode MT={hit[2]} x "
                      f"{'bf16' if hit[1] != 'f' else 'fp32'} "
                      f"{'16-byte' if hit[3] == '1' else 'plain'}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("nm_naive_sweep: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse import masks

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = _build(args.out)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, device=dev)

    def time_ms(fn, reps=10):
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
        """One call of the variant's naive entry, as the wrapper makes it
        (the tiled variant with one slice)."""
        m, n = x.shape
        k = c.values.shape[1]
        slices, length = nm.split_plan(m, n, k, c.n_sel, c.m_group)
        if name == "tiled":
            slices, length = 1, n // c.m_group
        y = torch.empty((m, k), device=dev)
        ws = torch.empty(max(1, slices * m * k), device=dev)
        fn = lib.nm_spmm_naive_bf16
        fn.argtypes, fn.restype = nm._ARGTYPES, ctypes.c_int
        err = fn(x.data_ptr(), c.values.data_ptr(), c.indices.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), m, n, k, c.n_sel, c.m_group,
                 slices, length, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"{name}: launch failed: CUDA error {err}")
        return y

    cfg = get_config("chatglm3-6b")
    gen = torch.Generator(device=dev).manual_seed(5)
    failed = []
    for n_sel in (2, 1):
        for m in (4, 16):
            sums = dict.fromkeys([*libs, "pipelined", "matmul", "bound"], 0.0)
            for role in cfg.matmul_roles():
                w = torch.randn((role.n, role.k), generator=gen, device=dev) \
                    / math.sqrt(role.n)
                wp = masks.nm_prune(w, n_sel, 4)
                c = ops.compress_nm(wp, n_sel, 4)
                x = torch.randn((m, role.n), generator=gen,
                                device=dev).bfloat16()
                y = ops.nm_spmm(x, c)
                y_plain = ref.nm_spmm_ref(x, c.values, c.indices, n_sel, 4)
                row = []
                for name, lib in libs.items():
                    y_v = naive(lib, name, x, c)
                    torch.cuda.synchronize()
                    if name == "tiled":
                        err = (y_v - y_plain).abs().max().item()
                        ok = err <= 1e-4 * y_plain.abs().max().item() + 1e-5
                    else:
                        ok = torch.equal(y_v, y)
                    if not ok:
                        failed.append(f"{name} {role.role} {n_sel}:4 M={m}")
                        row.append(f"{name} FAILED")
                        continue
                    ms = time_ms(lambda: naive(lib, name, x, c))
                    sums[name] += ms
                    row.append(f"{name} {ms:.4f}")
                ms3 = time_ms(lambda: ops.nm_spmm(x, c))
                lib_ms = time_ms(lambda: torch.matmul(x.float(), wp))
                nbytes = c.values.numel() * 5 + x.numel() * 2 + m * role.k * 4
                bound = 1e3 * nbytes / HBM_BYTES_S
                sums["pipelined"] += ms3
                sums["matmul"] += lib_ms
                sums["bound"] += bound
                print(f"[sweep] {role.role} {n_sel}:4 M={m} bf16 ms: "
                      f"{'; '.join(row)}; pipelined {ms3:.4f}; matmul "
                      f"{lib_ms:.4f}; bound {bound:.4f}", flush=True)
                del w, wp, c, x, y, y_plain
            print(f"[sweep] layer (7 roles) {n_sel}:4 M={m} bf16 ms: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in sums.items()),
                  flush=True)
    if failed:
        sys.exit("nm_naive_sweep: FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
