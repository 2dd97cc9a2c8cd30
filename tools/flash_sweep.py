#!/usr/bin/env python3
"""Sweep the flash kernel's tensor-core entry on one card.

    python3 tools/flash_sweep.py [--out DIR]

Builds ``src/repro_torch/csrc/flash_attention.cu`` once per variant, with
the source edited as ``VARIANTS`` says (the design alternatives the
committed kernel was chosen against: consumer warpgroups that do not take
turns to issue their wgmmas, a three-stage K / V ring), into ``DIR``
(default ``build/sweep``), and prints each variant's ptxas registers and spills for
the tensor-core entry, and any ptxas note that it serialised the wgmmas.
Then at phase 4's bf16 shapes of ``chip_smoke.py`` with D = 128 (BH =
128, S = 128 and 2048, causal and full; BH = 32, S = 8192 causal), inputs
from a seeded generator, it launches each variant's
``flash_attention_bf16_tc``, holds the result per element to
``ref.flash_attention_bf16_tol`` and prints device ms (CUDA events, L2
flushed, mean of 5) beside ``scaled_dot_product_attention`` and the bound
(4·BH·S²·D FLOPs, halved when causal, at 989 TFLOP/s).
"""

from __future__ import annotations

import argparse
import ctypes
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
    # the consumer warpgroups issue their wgmmas whenever they are ready
    "no turns": lambda src: re.sub(
        r"^ *(if \(wg == [01]\) )?named_(sync|arrive)\(.*\n", "", src,
        flags=re.M),
    "3 stages": lambda src: src.replace("constexpr int STAGES = 2;",
                                        "constexpr int STAGES = 3;"),
}
BF16_FLOP_S = 989e12


def _build(out_dir: str) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/flash_attention.cu")
               ).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        variant = edit(src)
        if name != "committed" and variant == src:
            sys.exit(f"{name}: the edit no longer applies to the source")
        cu = os.path.join(out_dir, f"flash{i}.cu")
        so = os.path.join(out_dir, f"flash{i}.so")
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
        for line in lines:
            if "Performance Loss" in line:
                print(f"[sweep] {name}: {line.strip()}")
        for i, line in enumerate(lines):
            if "Function properties for" in line \
                    and "flash_attention_tc_kernel" in line:
                entry = line.split()[-1]
                print(f"[sweep] {name}: {entry}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_sweep: needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

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

    def call(lib, q, k, v, o, causal):
        fn = lib.flash_attention_bf16_tc
        fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
        bh, sq, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                 sq, k.shape[1], d, int(causal),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")

    gen = torch.Generator(device=dev).manual_seed(3)
    failed = []
    d = 128
    cases = [(128, s, causal) for s in (128, 2048) for causal in (True, False)]
    cases.append((32, 8192, True))
    for bh, s, causal in cases:
        q, k, v = (torch.randn((bh, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        o = torch.empty_like(q)
        heads = bh if s <= 2048 else 4        # a dense S x S score per head
        row = []
        for name, lib in libs.items():
            call(lib, q, k, v, o, causal)
            torch.cuda.synchronize()
            worst = 0.0
            for i in range(0, bh, heads):
                sl = slice(i, i + heads)
                o_plain = ref.flash_attention_ref(q[sl], k[sl], v[sl], causal)
                tol = ref.flash_attention_bf16_tol(q[sl], k[sl], v[sl],
                                                   o_plain, causal)
                worst = max(worst, ((o[sl].float() - o_plain.float()).abs()
                                    / tol).max().item())
                del o_plain, tol
            if not worst <= 1.0:
                failed.append(f"{name} BH={bh} S={s}: {worst} of the bound")
                row.append(f"{name} FAILED ({worst:.3f} of the bound)")
                continue
            ms = time_ms(lambda: call(lib, q, k, v, o, causal))
            row.append(f"{name} {ms:.4f} ({worst:.3f} of the bound)")
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal))
        bound = 1e3 * 4.0 * bh * s * s * d * (0.5 if causal else 1.0) \
            / BF16_FLOP_S
        print(f"[sweep] BH={bh} S={s} D={d} "
              f"{'causal' if causal else 'full'}"
              f" bf16 ms: {'; '.join(row)}; sdpa {lib_ms:.4f}; bound "
              f"{bound:.4f}", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    if failed:
        sys.exit("flash_sweep: FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
