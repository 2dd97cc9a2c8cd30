#!/usr/bin/env python3
"""Count the kernel events a CUDA-only ``torch.profiler`` trace loses.

    python3 tools/trace_loss.py [--traces N] [--wait-ms W]

Takes N rounds (default 1000) in one process.  A round runs one fp32
``torch.matmul`` of 4096 x 4096 (a few ms of device work, as the timing
loops between ``chip_smoke.py``'s traces), then traces one short launch
three ways: alone, between two marker kernels (``torch.cuda._sleep``'s
spin kernel, about 0.5 ms each) as ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` take it, and between markers with a host
wait of W ms (default 2) after the profiler starts.  The launch is the
naive bitmap entry on the tiled kernel (M 4, N 96, K 60, 24 x 30 blocks:
one ``bitmap_spmm_kernel`` launch of a few microseconds, the case whose
trace came back empty in whole-file card test runs).  Prints, for each
form, how many traces lost the call's kernel, the leading marker or the
trailing one, how many were empty, and the longest run of consecutive
rounds with a loss.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

FORMS = ("alone", "between markers", "between markers after a wait")


def _trace(fn, form: str, wait_s: float, path: str) -> list[str]:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.trace import MARKER_CYCLES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if form == FORMS[2]:
            time.sleep(wait_s)
        if form != FORMS[0]:
            torch.cuda._sleep(MARKER_CYCLES)
        fn()
        if form != FORMS[0]:
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "kernel"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=1000)
    ap.add_argument("--wait-ms", type=float, default=2.0)
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        sys.exit("trace_loss: needs a CUDA device")
    rng = np.random.default_rng(0)
    n, k, bn, bk = 96, 60, 24, 30
    keep = np.repeat(np.repeat(rng.random((n // bn, k // bk)) < 0.5, bn, 0),
                     bk, 1)
    w = torch.from_numpy((rng.normal(size=(n, k)) * keep).astype(np.float32))
    c = ops.compress_bitmap(w.cuda(), bn, bk)
    x = torch.randn(4, n, device="cuda").to(torch.bfloat16)
    load = torch.randn(4096, 4096, device="cuda")

    def call():
        ops.bitmap_spmm(x, c, pipeline=False)

    call()
    print(f"[trace_loss] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, {args.traces} rounds, wait {args.wait_ms} "
          f"ms")
    stats = {f: dict(kernel=0, lead=0, trail=0, empty=0, run=0, longest=0)
             for f in FORMS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        for _ in range(args.traces):
            torch.matmul(load, load)
            for form in FORMS:
                names = _trace(call, form, args.wait_ms / 1e3, path)
                s = stats[form]
                lost = not any("bitmap_spmm_kernel" in nm for nm in names)
                s["kernel"] += lost
                s["empty"] += not names
                if form != FORMS[0]:
                    lead = not (names and "spin_kernel" in names[0])
                    trail = not (names and "spin_kernel" in names[-1])
                    s["lead"] += lead
                    s["trail"] += trail
                    lost = lost or lead or trail
                s["run"] = s["run"] + 1 if lost else 0
                s["longest"] = max(s["longest"], s["run"])
    for form, s in stats.items():
        print(f"[trace_loss] {form}: kernel lost {s['kernel']}, leading "
              f"marker lost {s['lead']}, trailing marker lost {s['trail']}, "
              f"empty {s['empty']} of {args.traces}; longest run of lossy "
              f"rounds {s['longest']}")


if __name__ == "__main__":
    main()
