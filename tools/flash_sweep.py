#!/usr/bin/env python3
"""Sweep the flash kernel's two entries on one card.

    python3 tools/flash_sweep.py [--out DIR] [--entry tc|fma|both]
                                 [--parent SRC]

Builds ``src/repro_torch/csrc/flash_attention.cu`` once per variant, with
the source edited as ``VARIANTS`` says, into ``DIR`` (default
``build/sweep``), all ``nvcc`` processes started together, and prints each
variant's ptxas registers and spills for every instance of the entry it
varies, and any ptxas note that it serialised the wgmmas.

* Tensor-core variants (the design alternatives the committed entry was
  chosen against: consumer warpgroups that do not take turns to issue
  their wgmmas, a three-stage K / V ring) are timed through
  ``flash_attention_bf16_tc`` at phase 4's bf16 shapes of ``chip_smoke.py``
  with D = 128 (BH = 128, S = 128 and 2048, causal and full; BH = 32,
  S = 8192 causal).
* FMA variants (the tile of one class of D: BQ x BKV, the threads' grid
  and so the micro-tile, one or two stages, blocks a SM) are timed through
  ``flash_attention_f32`` at phase 4's fp32 shapes (BH = 128, D = 128,
  S = 128 and 2048, causal and full), through ``flash_attention_bf16`` on
  operands off a 16-byte boundary at BH = 128, S = 2048, D = 128, and at
  BH = 128, S = 2048 causal fp32 with D = 32, 64 and 256 for the other
  classes.  ``--parent SRC`` adds another version of the source (say, the
  parent commit's) as the variant "parent", timed at every FMA shape.

Inputs come from a seeded generator.  Every result but a "timing only"
variant's (one loop of the committed kernel skipped) is held to the plain
version first (fp32: max|o - o_plain| <= 1e-4 max|o_plain| + 1e-5; bf16
per element to ``ref.flash_attention_bf16_tol``).  Times are device ms
(CUDA events, L2 flushed, mean of 5) beside
``scaled_dot_product_attention`` on the same inputs and the bound
(4·BH·S²·D FLOPs, halved when causal, at 989 TFLOP/s for the tensor-core
entry, 67 TFLOP/s for the FMA entry).  At S >= 2048 the committed variant
also runs back to back for 2 s while ``nvidia-smi`` reads the SM clock and
the power draw.  The first variant, "committed", is the source as it
stands.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))


def _tile(name: str, args: str):
    """Edit of the source giving ``fma_entry::<name>`` the tile ``args``."""
    return lambda src: re.sub(rf"using {name} = FTile<[^>]*>;",
                              f"using {name} = FTile<{args}>;", src)


def _unroll(loop: str, n: int):
    """Edit unrolling the FMA entry's score (``c4``) or P V (``k4``) loop
    ``n`` times."""
    return lambda src: re.sub(rf"#pragma unroll 2(\n *for \(int {loop} = 0)",
                              rf"#pragma unroll {n}\1", src)


# the score product's step by component: all RM rows loaded first, then
# each of the 4 columns of the panel across the RM x RS scores
S_BY_COMPONENT = """      float4 b[RS], a[RM];
#pragma unroll
      for (int j = 0; j < RS; ++j) b[j] = kp[c4 * BKV + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = qp[c4 * BQ + TY * i];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RS; ++j)
            s[i][j] = fmaf(reinterpret_cast<const float*>(&a[i])[e],
                           reinterpret_cast<const float*>(&b[j])[e],
                           s[i][j]);
"""


def _skip(loop: str):
    """Edit making the score (``c4``) or P V (``k4``) loop run no step at
    run time (D is never negative): its result is wrong, its time is what
    the rest of the kernel takes."""
    bound = {"c4": "nc4", "k4": "PH / 4"}[loop]
    return lambda src: src.replace(
        f"for (int {loop} = 0; {loop} < {bound}; ++{loop}) {{",
        f"for (int {loop} = 0; {loop} < (d < 0 ? {bound} : 0); ++{loop}) {{")


def _s_by_component(src: str) -> str:
    a = src.index("      float4 b[RS];\n")
    b = src.index("\n      }\n    }\n",
                  src.index("s[i][j] = fmaf(a.w, b[j].w, s[i][j]);"))
    return src[:a] + S_BY_COMPONENT + src[b + len("\n      }\n"):]


# name: ((entry it varies, D and operand type it is timed at), edit of the
# source).  FTile<BQ, BKV, TY, TX, DP, STAGES, PH, MIN_BLOCKS>: a thread
# owns BQ/TY x BKV/TX scores and BQ/TY x DP/TX outputs; STAGES 2 is a K / V
# ring, 1 one K and one V buffer copied in turn; P V in passes of PH keys
VARIANTS = {
    "committed": (("both", None, None), lambda src: src),
    # the consumer warpgroups issue their wgmmas whenever they are ready
    "no turns": (("tc", None, None), lambda src: re.sub(
        r"^ *(if \(wg == [01]\) )?named_(sync|arrive)\(.*\n", "", src,
        flags=re.M)),
    "3 stages": (("tc", None, None), lambda src: src.replace(
        "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")),
    "f32 128x64 ring": (("fma", 128, "f32"), _tile(
        "F32Tile128", "128, 64, 16, 16, 128, 2, 64, 1")),
    "f32 128x64 1 stage": (("fma", 128, "f32"), _tile(
        "F32Tile128", "128, 64, 16, 16, 128, 1, 64, 1")),
    "f32 128x128 PH 32": (("fma", 128, "f32"), _tile(
        "F32Tile128", "128, 128, 16, 16, 128, 1, 32, 1")),
    "f32 64x64 128 threads 2 blocks": (("fma", 128, "f32"), _tile(
        "F32Tile128", "64, 64, 8, 16, 128, 1, 64, 2")),
    "f32 128x64 TX 8": (("fma", 128, "f32"), _tile(
        "F32Tile128", "128, 64, 32, 8, 128, 2, 64, 1")),
    "f32 128x64 512 threads": (("fma", 128, "f32"), _tile(
        "F32Tile128", "128, 64, 32, 16, 128, 2, 64, 1")),
    # timing only (no correctness check): the committed kernel without its
    # score loop, without its P V loop, without both
    "timing only: no S": (("fma", 128, "f32"), _skip("c4")),
    "timing only: no P V": (("fma", 128, "f32"), _skip("k4")),
    "timing only: neither": (("fma", 128, "f32"),
                             lambda src: _skip("c4")(_skip("k4")(src))),
    "f32 S unroll 4": (("fma", 128, "f32"), _unroll("c4", 4)),
    "f32 S by component": (("fma", 128, "f32"), _s_by_component),
    "bf16 128x128 1 stage": (("fma", 128, "bf16"), _tile(
        "Bf16Tile128", "128, 128, 16, 16, 128, 1, 64, 1")),
    "bf16 128x64 1 stage": (("fma", 128, "bf16"), _tile(
        "Bf16Tile128", "128, 64, 16, 16, 128, 1, 64, 1")),
    "bf16 128x64 512 threads": (("fma", 128, "bf16"), _tile(
        "Bf16Tile128", "128, 64, 32, 16, 128, 2, 64, 1")),
    "f32 D32 128x64 256 threads": (("fma", 32, "f32"), _tile(
        "F32Tile32", "128, 64, 32, 8, 32, 2, 64, 1")),
    "f32 D64 128x128 1 stage": (("fma", 64, "f32"), _tile(
        "F32Tile64", "128, 128, 16, 16, 64, 1, 64, 1")),
    "f32 D256 64x32 ring": (("fma", 256, "f32"), _tile(
        "F32Tile256", "64, 32, 16, 16, 256, 2, 32, 1")),
}
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
TOL_REL, TOL_ABS = 1e-4, 1e-5


def _build(out_dir: str, entries: set[str], parent: str | None
           ) -> dict[str, tuple[ctypes.CDLL, tuple]]:
    from repro_torch.kernels import build
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/flash_attention.cu")
               ).read()
    os.makedirs(out_dir, exist_ok=True)
    todo = {name: (what, edit(src)) for name, (what, edit)
            in VARIANTS.items() if what[0] in entries | {"both"}}
    for name, (_, variant) in todo.items():
        if name != "committed" and variant == src:
            sys.exit(f"{name}: the edit no longer applies to the source")
    if parent is not None:
        todo["parent"] = (("fma", None, None), open(parent).read())
    procs = {}
    for i, (name, (what, variant)) in enumerate(todo.items()):
        cu = os.path.join(out_dir, f"flash{i}.cu")
        so = os.path.join(out_dir, f"flash{i}.so")
        open(cu, "w").write(variant)
        procs[name] = (what, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (what, so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for line in lines:
            if "Performance Loss" in line:
                print(f"[sweep] {name}: {line.strip()}")
        for i, line in enumerate(lines):
            if "Function properties for" in line and re.search(
                    r"flash_attention_(tc|fma_)?kernel", line):
                print(f"[sweep] {name}: {line.split()[-1]}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        libs[name] = (ctypes.CDLL(so), what)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep"))
    ap.add_argument("--entry", choices=("tc", "fma", "both"), default="both")
    ap.add_argument("--parent", default=None,
                    help="another flash_attention.cu, timed as 'parent' at "
                         "the FMA shapes")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_sweep: needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    entries = {"tc", "fma"} if args.entry == "both" else {args.entry}
    libs = _build(args.out, entries, args.parent)
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

    def clocks(fn, seconds=2.0):
        """Median SM clock (MHz) and power (W) nvidia-smi reads every 100
        ms while ``fn`` runs back to back for ``seconds``."""
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        smi.terminate()
        rows = [line.split(",") for line in smi.communicate()[0].splitlines()]
        rows = [(float(r[0]), float(r[1])) for r in rows
                if len(r) == 2 and all(re.fullmatch(r"\s*[\d.]+\s*", x)
                                       for x in r)]
        if not rows:
            return float("nan"), float("nan"), 0
        mhz = sorted(r[0] for r in rows)
        watts = sorted(r[1] for r in rows)
        return mhz[len(mhz) // 2], watts[len(watts) // 2], len(rows)

    def call(lib, symbol, q, k, v, o, causal):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
        bh, sq, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                 sq, k.shape[1], d, int(causal),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"{symbol} launch failed: CUDA error {err}")

    # (entry, BH, S, D, causal, dtype, operands off a 16-byte boundary)
    cases = []
    if "tc" in entries:
        cases += [("tc", 128, s, 128, causal, torch.bfloat16, False)
                  for s in (128, 2048) for causal in (True, False)]
        cases.append(("tc", 32, 8192, 128, True, torch.bfloat16, False))
    if "fma" in entries:
        cases += [("fma", 128, s, 128, causal, torch.float32, False)
                  for s in (128, 2048) for causal in (True, False)]
        cases += [("fma", 128, 2048, 128, causal, torch.bfloat16, True)
                  for causal in (True, False)]
        cases += [("fma", 128, 2048, d, True, torch.float32, False)
                  for d in (32, 64, 256)]
    gen = torch.Generator(device=dev).manual_seed(3)
    failed = []
    for entry, bh, s, d, causal, dtype, off in cases:
        def operand():
            x = torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
            if not off:
                return x
            y = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:]
            return y.view(x.shape).copy_(x)
        q, k, v = operand(), operand(), operand()
        o = torch.empty_like(q)
        heads = bh if s <= 2048 else 4        # a dense S x S score per head
        if entry == "tc":
            symbol = "flash_attention_bf16_tc"
        else:
            symbol = "flash_attention_f32" if dtype == torch.float32 \
                else "flash_attention_bf16"
        plain = [ref.flash_attention_ref(q[i:i + heads], k[i:i + heads],
                                         v[i:i + heads], causal)
                 for i in range(0, bh, heads)]
        row = []
        kind = "f32" if dtype == torch.float32 else "bf16"
        for name, (lib, (what, at_d, at_kind)) in libs.items():
            if what not in (entry, "both") or at_d not in (None, d) \
                    or at_kind not in (None, kind):
                continue
            o.fill_(float("nan"))
            call(lib, symbol, q, k, v, o, causal)
            torch.cuda.synchronize()
            worst = 0.0
            for n, i in enumerate(range(0 if "timing only" not in name
                                        else bh, bh, heads)):
                sl = slice(i, i + heads)
                diff = (o[sl].float() - plain[n].float()).abs()
                if dtype == torch.float32:
                    tol = TOL_REL * plain[n].abs().max() + TOL_ABS
                else:
                    tol = ref.flash_attention_bf16_tol(q[sl], k[sl], v[sl],
                                                       plain[n], causal)
                worst = max(worst, (diff / tol).max().item())
                del diff, tol
            if not worst <= 1.0:
                failed.append(f"{name} {symbol} BH={bh} S={s} D={d}: "
                              f"{worst} of the bound")
                row.append(f"{name} FAILED ({worst:.3f} of the bound)")
                continue
            ms = time_ms(lambda: call(lib, symbol, q, k, v, o, causal))
            row.append(f"{name} {ms:.4f} ({worst:.3f} of the bound)")
            if name == "committed" and s >= 2048:
                mhz, watts, n = clocks(
                    lambda: call(lib, symbol, q, k, v, o, causal))
                row.append(f"committed back to back: SM {mhz:.0f} MHz, "
                           f"{watts:.1f} W (median of {n} reads)")
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal))
        peak = BF16_FLOP_S if entry == "tc" else FP32_FLOP_S
        bound = 1e3 * 4.0 * bh * s * s * d * (0.5 if causal else 1.0) / peak
        print(f"[sweep] {entry} BH={bh} S={s} D={d} "
              f"{'causal' if causal else 'full'} {str(dtype)[6:]}"
              f"{' off 16 B' if off else ''} ms: {'; '.join(row)}; sdpa "
              f"{lib_ms:.4f}; bound {bound:.4f}", flush=True)
        del q, k, v, o, plain
        torch.cuda.empty_cache()
    if failed:
        sys.exit("flash_sweep: FAILED: " + "; ".join(failed))


if __name__ == "__main__":
    main()
