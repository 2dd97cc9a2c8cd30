#!/usr/bin/env python3
"""Sweep the bitmap prefill entry's tiles on one card.

    python3 tools/bitmap_prefill_sweep.py [--m 512] [--out DIR]

Builds ``src/repro_torch/csrc/bitmap_spmm.cu`` once per variant, with the
``BigTile`` / ``SmallTile`` definitions replaced (``PTile<TY, TX, RM, RK,
MIN_BLOCKS, STAGES, BC>``: threads, outputs a thread, blocks an SM, ring
depth, kept rows a chunk), into ``DIR`` (default ``build/sweep``).  Then at
every projection role of full-width chatglm3-6b (the shipped bitmap plan's
blocks, block density 0.5, seeded random weights), x bf16 with M rows, it
launches each variant's prefill entry with its big tile (and, for K = 256,
its small tile) forced, checks the result equal bit for bit to the naive
entry's, and prints device ms (CUDA events, L2 flushed, mean of 5), with
each variant's ptxas registers and spills and the sums over the seven
roles.  The variants are the design alternatives the committed tiles were
chosen against.
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

# name: (BigTile, SmallTile); the first is the committed pair
VARIANTS = {
    "committed": ("PTile<8, 16, 8, 8, 4, 4, 16>",
                  "PTile<8, 8, 4, 4, 8, 3, 64>"),
    "warp 4x8": ("PTile<16, 8, 8, 8, 4, 3, 16>",
                 "PTile<8, 8, 4, 4, 8, 3, 16>"),
    "warp 1x32": ("PTile<4, 32, 8, 8, 4, 4, 16>",
                  "PTile<8, 8, 4, 4, 8, 3, 32>"),
    "128x128": ("PTile<16, 16, 8, 8, 2, 4, 16>",
                "PTile<4, 8, 4, 4, 16, 3, 64>"),
    "16x8 a thread": ("PTile<8, 16, 16, 8, 2, 3, 16>",
                      "PTile<8, 8, 4, 4, 8, 8, 16>"),
    "32-row chunks": ("PTile<8, 16, 8, 8, 4, 3, 32>",
                      "PTile<8, 8, 4, 4, 8, 2, 128>"),
}


def _build(out_dir: str) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    src = open(os.path.join(ROOT, "src/repro_torch/csrc/bitmap_spmm.cu")
               ).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (big, small)) in enumerate(VARIANTS.items()):
        v = re.sub(r"using BigTile = PTile<[^>]*>;", f"using BigTile = {big};",
                   src)
        v = re.sub(r"using SmallTile = PTile<[^>]*>;",
                   f"using SmallTile = {small};", v)
        cu = os.path.join(out_dir, f"v{i}.cu")
        open(cu, "w").write(v)
        procs[name] = (os.path.join(out_dir, f"v{i}.so"), subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"v{i}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" in line and "prefill" in line:
                tile = re.search(r"PTileI((?:Li\d+E)+)", line).group(1)
                params = ", ".join(re.findall(r"Li(\d+)E", tile))
                print(f"[sweep] {name}: PTile<{params}>: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "sweep"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("bitmap_prefill_sweep: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import bitmap_spmm as bm
    from repro_torch.kernels import ops
    from repro_torch.sparse import masks

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

    def call(lib, x, c, tile, y, ws):
        m, n = x.shape
        nnzb, bn, bk = c.blocks.shape
        fn = lib.bitmap_spmm_bf16
        fn.argtypes, fn.restype = bm._ARGTYPES, ctypes.c_int
        err = fn(x.data_ptr(), c.blocks.data_ptr(), c.counts.data_ptr(),
                 c.row_ids.data_ptr(), c.offsets.data_ptr(), y.data_ptr(),
                 ws.data_ptr(), m, n, c.k, bn, bk, bm.tile_k(bk), nnzb, 1, 1,
                 1, tile, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")

    cfg = get_config("chatglm3-6b")
    plan = shipped_plan(cfg, "bitmap")
    gen = torch.Generator(device=dev).manual_seed(1)
    sums: dict[tuple[str, str], float] = {}    # (variant, tile group): ms
    for role in cfg.matmul_roles():
        ch = plan.for_role(role.role).choice
        bn, bk = ch.block_n, ch.block_k
        w = torch.randn((role.n, role.k), generator=gen, device=dev) \
            / math.sqrt(role.n)
        c = ops.compress_bitmap(masks.block_prune(w, bn, bk, 0.5), bn, bk)
        x = torch.randn((args.m, role.n), generator=gen, device=dev) \
            .to(torch.bfloat16)
        y_naive = ops.bitmap_spmm(x, c, pipeline=False)
        y = torch.empty((args.m, role.k), device=dev)
        ws = torch.empty(bm.xt_numel(args.m, role.n), device=dev)
        row = []
        for name, lib in libs.items():
            for tile in ((0, 1) if role.k == 256 else (0,)):
                call(lib, x, c, tile, y, ws)
                torch.cuda.synchronize()
                if not torch.equal(y, y_naive):
                    sys.exit(f"{name} tile {tile} {role.role}: differs from "
                             f"the naive entry")
                ms = time_ms(lambda: call(lib, x, c, tile, y, ws))
                label = f"{'big' if tile == 0 else 'small'} tile"
                group = (name, label + (" on K = 256" if role.k == 256
                                        else " on the large roles"))
                sums[group] = sums.get(group, 0.0) + ms
                row.append(f"{name}/{label} {ms:.4f}")
        print(f"[sweep] {role.role} M={args.m} x bf16 ms: {'; '.join(row)}",
              flush=True)
        del w, c, x, y, ws, y_naive
    for (name, group), ms in sums.items():
        print(f"[sweep] sum, {name}, {group}: {ms:.4f} ms")


if __name__ == "__main__":
    main()
