#!/usr/bin/env python3
"""Time the pipelined N:M kernel (kernel 3) of an older source beside the
committed one, and beside edits of it, on one card.

    python3 tools/nm_parent_bench.py --parent OLD/nm_spmm.cu [--variants]
        [--out DIR]

Builds ``OLD/nm_spmm.cu`` and ``src/repro_torch/csrc/nm_spmm.cu`` (with
``--variants`` also the committed source edited as ``VARIANTS`` says) into
``DIR`` (default ``build/nm_parent``), each by its own ``nvcc`` with the
port's flags, and prints ptxas's registers and spills for every source's
pipelined kernels.  The variants take parts of the non-finite handling out
or move them, to split its cost: they are for timing only, and give the
committed result on finite x.  Then at every projection role of full-width
chatglm3-6b, 2:4 weights pruned from a seeded generator, M = 4, 16 and 512,
x bf16, it calls each source's pipelined C entry (``nm_spmm_small_m_bf16``
at M <= 16, ``nm_spmm_bf16`` above) directly, with the wrapper's entry,
order and workspace (the committed workspace, which the older source's
fits in), and holds the two results on finite x to each other: equal
(``torch.equal``) and the count of outputs whose bits differ printed.  It
times them (CUDA events around one call after an L2 flush, the mean of 10
calls at M <= 16 and of 5 at 512) in passes over every case, older,
committed, committed, older, and prints per pass the seven roles' sum at
each M and each role's time; with ``--variants`` the passes run parent,
committed, the variants, the variants again in reverse, committed, parent.
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
sys.path.insert(0, ROOT)

MS = (4, 16, 512)

# name: edit of the committed source (timing only)
VARIANTS = {
    # the decode kernel's vote never set: its second pass compiled out
    "no decode pass": lambda src: src.replace(
        "return __syncthreads_or(bad) != 0;",
        "__syncthreads();\n  return false;"),
    # the prefill kernel's second pass never taken
    "no prefill pass": lambda src: src.replace(
        "  if (__syncthreads_or(bad_x) && c < k)\n",
        "  if (__syncthreads_or(bad_x) && c < 0)\n"),
    # no flags: the transpose writes none, the prefill kernel reads none
    "no prefill flags": lambda src: src.replace(
        "nm_transpose_x_kernel<T, T, true>",
        "nm_transpose_x_kernel<T, T, false>").replace(
        "  int bad_x = 0;\n  {", "  int bad_x = 0;\n  if (false) {"),
}


def _build(parent: str, out_dir: str, variants: bool
           ) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import build
    committed = os.path.join(build.CSRC, "nm_spmm.cu")
    sources = {"parent": parent, "committed": committed}
    os.makedirs(out_dir, exist_ok=True)
    src = open(committed).read()
    for i, (name, edit) in enumerate(VARIANTS.items() if variants else ()):
        edited = edit(src)
        if edited == src:
            sys.exit(f"{name}: the edit no longer applies to the source")
        sources[name] = os.path.join(out_dir, f"variant{i}.cu")
        open(sources[name], "w").write(edited)
    procs = {}
    for i, (name, cu) in enumerate(sources.items()):
        so = os.path.join(out_dir, f"nm_{i}.so")
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
            hit = re.search(r"(nm_spmm_small_m_kernel|nm_spmm_prefill_kernel"
                            r"|nm_transpose_x_kernel)I\w*", line)
            if "Function properties for" in line and hit:
                print(f"[build] {name}: {hit[0][:90]}: "
                      f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the older nm_spmm.cu to time beside the committed")
    ap.add_argument("--variants", action="store_true",
                    help="also time the committed source's VARIANTS")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "nm_parent"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("nm_parent_bench: needs a CUDA device")
    from chip_smoke import _time_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import ops
    from repro_torch.sparse import masks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = _build(args.parent, args.out, args.variants)
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, device=dev)

    def call(lib, x, c):
        """One call of ``lib``'s pipelined entry, as the wrapper makes it."""
        entry, slices, length = nm.select_entry(x, c.values, c.indices,
                                                c.n_sel, c.m_group)
        m, n = x.shape
        k = c.values.shape[1]
        y = torch.empty((m, k), device=dev)
        ws = torch.empty(max(1, nm.workspace_numel(entry, m, n, k, slices)),
                         device=dev)
        fn = getattr(lib, f"{entry}_bf16")
        fn.argtypes, fn.restype = nm._ARGTYPES, ctypes.c_int
        err = fn(x.data_ptr(), c.values.data_ptr(), c.indices.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), m, n, k, c.n_sel, c.m_group,
                 slices, length, torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed: CUDA error {err}")
        return y

    cfg = get_config("chatglm3-6b")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for role in cfg.matmul_roles():
        w = torch.randn((role.n, role.k), generator=gen, device=dev) \
            / math.sqrt(role.n)
        c = ops.compress_nm(masks.nm_prune(w, 2, 4), 2, 4)
        del w
        for m in MS:
            x = torch.randn((m, role.n), generator=gen, device=dev).bfloat16()
            yc = call(libs["committed"], x, c)
            for name, lib in libs.items():
                if name == "committed":
                    continue
                y = call(lib, x, c)
                torch.cuda.synchronize()
                bits = int((y.view(torch.int32) != yc.view(torch.int32))
                           .sum())
                if not torch.equal(y, yc):
                    sys.exit(f"{name} {role.role} M={m}: the results differ "
                             f"by {(y - yc).abs().max().item()}")
                print(f"[check] {role.role} M={m} bf16: {name} == committed "
                      f"(torch.equal); {bits} outputs differ in their bits")
            cases.append((role.role, m, x, c))
    others = [n for n in libs if n not in ("parent", "committed")]
    order = ["parent", "committed", *others, *others[::-1], "committed",
             "parent"]
    for i, name in enumerate(order):
        sums = dict.fromkeys(MS, 0.0)
        rows = []
        for role, m, x, c in cases:
            ms = _time_ms(lambda: call(libs[name], x, c),
                          10 if m <= 16 else 5, flush)
            sums[m] += ms
            rows.append(f"{role} M={m} {ms:.4f}")
        print(f"[time] pass {i + 1} {name}: layer (7 roles) bf16 ms: "
              + "; ".join(f"M={m} {v:.4f}" for m, v in sums.items()),
              flush=True)
        print(f"[time] pass {i + 1} {name}: " + "; ".join(rows), flush=True)


if __name__ == "__main__":
    main()
