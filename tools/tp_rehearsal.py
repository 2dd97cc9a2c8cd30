#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phase 17 (tensor-parallel serving) on the
CPU, at reduced chatglm3-6b and, for its MoE and gemma3 parts, reduced
granite-moe-3b-a800m and gemma3-27b (rings of 64).

    python3 tools/tp_rehearsal.py

Runs ``chip_smoke.phase_tensor_parallel`` with what a machine without a
card lacks put in: counting stand-ins for ``ops._bitmap`` / ``ops._nm``
(the plain versions, each call counted as a launch of the pipelined or
the naive kernel, as the wrappers count on the card), ``get_config``
giving the MoE and gemma3 parts' models reduced,
``torch.cuda.synchronize`` and the memory statistics stubbed,
``exec.plans.shipped_plan`` giving the reduced bitmap plan (and that plan
with every sparse role 2:4 for "nm"), and the batch, prompt, generated
tokens and timed runs cut (``BATCH, PROMPT, GEN = 4, 8, 4``, ``M_PREFILL =
32``, ``TP_RUNS = 1``, the gemma3 part's prompt 8).  It checks the phase's
control flow, launch counts and tolerances before a chip call; its times
are the CPU's and mean nothing.  About 30 s.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.exec import plans  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _as_nm(plan):
    """The same plan with every sparse role 2:4 (the reduced config ships
    a bitmap plan only)."""
    return dataclasses.replace(
        plan, w_sparsity={"kind": "nm", "n": 2, "m": 4},
        ops=tuple(dataclasses.replace(op, choice=dataclasses.replace(
            op.choice, kind="nm", block_n=0, block_k=0,
            format_str="CP(2:4)")) for op in plan.ops))


def _counting(kind: str, name: str):
    real = getattr(ops, f"_{kind}")

    def launch(x, w, *args):
        y = real(x, w, *args)
        ops._LAUNCHES[name if args[-1] else f"{name}_naive"] += 1
        return y
    return launch


def main() -> None:
    shipped = plans.shipped_plan
    plans.shipped_plan = lambda cfg, kind="bitmap": (
        shipped(cfg, "bitmap") if kind == "bitmap"
        else _as_nm(shipped(cfg, "bitmap")))
    repro_torch.configs.get_config = lambda name: (
        get_config(name).reduced()
        if name in (cs.TP_MOE_ARCH, cs.TP_RING_ARCH) else get_config(name))
    ops._bitmap = _counting("bitmap", "bitmap_spmm")
    ops._nm = _counting("nm", "nm_spmm")
    for stub in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, stub, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    cs.BATCH, cs.PROMPT, cs.GEN = 4, 8, 4
    cs.M_DECODE, cs.M_PREFILL = 4, 32
    cs.TP_RUNS = 1
    cs.TP_RING_PROMPT = 8
    torch.set_num_threads(min(4, torch.get_num_threads()))
    acc = {name: cs._Acc() for name in ("bitmap_spmm", "bitmap_spmm_naive",
                                         "nm_spmm", "nm_spmm_naive")}
    t0 = time.perf_counter()
    launches = cs.phase_tensor_parallel(
        get_config("chatglm3-6b").reduced(), "cpu", torch.device("cpu"), acc)
    print(f"rehearsal of phase 17: launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
