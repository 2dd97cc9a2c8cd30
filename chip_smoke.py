#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root.  Phases, each of which ends the run with a
non-zero exit code when it fails:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 switched off for fp32 matmuls;
2. build: every CUDA source under ``src/repro_torch/csrc`` (parallel nvcc),
   with ptxas's registers and spills for every entry and a summary line for
   each instance of the N:M kernels (prefill tiles, naive decode MT x x
   type x row loads, naive prefill tiles x staging), of the bitmap
   kernels, pipelined and naive (prefill tiles, decode MT x x type, tiled
   x x type; transpose, reduce) and of both flash entries (FMA per tile
   and operand type, tensor-core per D); an N:M, bitmap or flash entry
   that spills, or a ptxas note that it serialised wgmmas, fails the run;
3. sparse kernels vs plain versions: ``bitmap_spmm`` and ``nm_spmm``, each
   in its pipelined and its naive (``pipeline=False``) variant, at every
   projection role of full-width chatglm3-6b (blocks of the shipped bitmap
   plan, density 0.5 by block pruning, plus a density-0 weight; N:M 2:4
   and 1:4), M = 4 (decode, batch 4) and M = 512 (prefill, 4 x 128), x in
   fp32 and bf16 (with each role's split of the reduction at M = 4,
   bitmap and N:M: slices, grid, partials' bytes; the naive kernels, N:M
   and bitmap, that ran at M = 4 and at M = 512 and their grids, read from
   a profiler trace and held to the wrapper's ``naive_kernel``; each
   bitmap role's prefill tile and grid at M = 512): each held to
   max|y - y_plain| <= 1e-4 max|y_plain| + 1e-5, the naive result equal to
   the pipelined one bit for bit, timed (the naive variants at bf16 only)
   beside the plain version, the bound on an H100 SXM (with the share of
   it the kernel reaches) and one ``torch.matmul`` over the decompressed
   weight; then the naive bitmap kernel once more at M = 4 with t_max
   above the longest column, on a weight whose masked steps read 105 MB of
   distinct stored blocks (beside the same call at t_max = the longest
   column and the pipelined kernel; all three results equal); and both
   variants of each served kernel (the shipped bitmap plan's blocks,
   N:M 2:4) at every role and every M the mixer's streams of phase 6
   give it (4 and 16 slots at decode, each prompt length at admission),
   x in fp32 and bf16, held to the same tolerance and naive == pipelined,
   checked but not timed; and non-finite inputs, checked but not timed:
   at every role of both plans, M = 4, 16 and 512, x fp32 and bf16, NaN
   in one input column and +Inf in another (some rows each, one row
   both, one row neither), where some output column has those slots
   pruned: the pipelined N:M kernel must equal the naive one (NaN for
   NaN, finite outputs bit for bit) and both must give the plain
   version's NaN / +-Inf masks, as must both bitmap variants, whose
   finite outputs stay within the tolerance of the plain version's;
4. flash attention vs its plain version at chatglm3-6b's attention width
   (BH = 4 x 32 heads, D = 128; S = 128 and 2048, causal or not, fp32 and
   bf16; one S = 8192 causal bf16 case at BH = 32), timed beside the
   plain version, the bound and ``scaled_dot_product_attention``; every
   shape prints the entry that ran (the bf16 shapes must launch the
   tensor-core entry, the fp32 ones the FMA entry) and the share of its
   bound the kernel reaches;
5. serving: full-width chatglm3-6b (all 28 layers), random weights from a
   seeded generator, through ``repro_torch.launch.serve.generate`` on the
   shipped bitmap plan and on the shipped N:M plan (batch 4, prompt 128,
   16 generated tokens), with the pipelined and the naive kernels
   (``ops.pipeline_default(False)``), which must give the same tokens and
   the same bf16 prefill logits.  Decode replays a CUDA graph of the step
   (``repro_torch.launch.compiled``): the first run captures it (the
   capture's time printed on its own line), then 5 runs with the graph
   and 5 eager (``compiled.disable()``), in turns, give the median and
   min-max of prefill ms and decode ms/token; every run's kernel launch
   counts must be 7 x layers x (1 + 16) of the served kernel and none of
   any other, and its tokens those of the first run.  Graph and eager
   must give ``torch.equal`` tokens and logits at every decode step, for
   both variants in bf16 and fp32 and for the dense model.  Compressed
   prefill logits are held against the dense model on the same pruned
   weights at fp32.  CUDA-only ``torch.profiler`` traces of 4 decode
   steps, graphed and eager for every variant, give the device's busy
   time, its idle share of the untraced median decode step, the device
   ops a step and the kernels that take the most time; the graphed trace
   must run the served kernel 7 x layers times a step, as the count a
   replay adds says, and every sparse kernel as often as the eager trace.
   Device memory is printed before each plan and after its model is
   deleted, graphs included;
6. the mixer: full-width chatglm3-6b served as a request stream through
   ``repro_torch.launch.mixer.Mixer`` on both plans: 12 greedy requests
   drawn with ``np.random.default_rng(3)`` (prompts of 8-256 tokens, one
   of 16 or fewer and one above 200; 8-32 new tokens), 4 slots, max_len
   288, no EOS.  Each plan and variant serves the stream graphed (the
   stream that captures the mixer's graph), eagerly
   (``compiled.disable()``) and graphed again: every stream must admit and
   evict each request, reuse a freed slot, emit every token and launch
   the served kernel 7 x layers x (admissions + decode steps) times and
   no other; the mixer's key must hold one graph whose ``serial`` is 0
   after the capturing stream and 1 after the next (no copy-in but a new
   stream's first), replays = decode steps - 1; every request's tokens
   must be equal across the three streams and between the variants.
   Sampled requests (temperature 0.8, top-k 20, seed i) served twice must
   give equal tokens.  At fp32 (TF32 off, pipelined) each request's
   admission logits must be ``torch.equal`` to its prefill served alone
   and each decode step's logits within 1e-3 max|logits| of the request
   served alone at batch 1 through ``serve.generate`` and of the same
   stream served through the dense model on the same pruned weights
   (``torch.matmul`` at the same M; a near tie that parts the greedy
   tokens ends the comparison of that request).  A 16-slot stream,
   graphed and eager, is timed only.  Every stream prints its admission
   ms (in total and per prompt token), decode ms/step (median, min-max),
   tokens/s and launches.  CUDA-only traces of one admission prefill of
   the shortest and of the longest prompt and of one graphed mixer step
   at 4 and at 16 slots give each one's device busy time, its idle share
   of the same call untraced, the sparse kernels' and the copies' share
   and the kernels that take the most time;
7. guarded serving (``repro_torch.runtime``): full-width chatglm3-6b on
   both shipped plans, batch 4, prompt 128, 16 tokens, bf16.  The seconds
   of ``compress_params`` (one checksum pass included), of
   ``checksum_store`` (its roles in a thread pool) against each role's
   digest taken alone, in turn, and of ``verify``, which must say ``ok``
   for every role.  A healthy guarded run (``serve.generate(guarded=True)``, verify
   on) must report healthy, give tokens ``torch.equal`` to the unguarded
   run's and launch the served kernel 7 x layers x (1 + 16) times, every
   decode step a replay of the unguarded run's graph; once more with the
   naive kernels; then 5 guarded runs (verify off) and 5 unguarded, in
   turns, give the median and min-max of prefill ms and decode ms/token.
   Faults on the plan's first role (``attn.wq``), layer 0: a bit flip
   (``bitflip_payload``) must verify as ``checksum_mismatch``, demote that
   role, launch 6 x layers x 17 and give the tokens of
   ``cm.demoted([role])`` served unguarded; ``corrupt_structure``
   (``truncate_offsets`` on bitmap, ``nm_indices_oob`` on 2:4, checksums
   stripped) the reference's reason at layer 0; a NaN payload
   (``poison_payload_nan``) with verify on ``checksum_mismatch``, and with
   verify off the outcome the store decides: the NaN makes one head's
   attention output NaN, and where ``attn.wo`` stores no weight on that
   head's rows the kernels never read it, so the logits stay finite and
   the tokens are the healthy run's (the card's gap, printed); else
   ``nonfinite_logits`` and the dense model's tokens.  On ``ffn.w_down``,
   whose output joins the residual stream, a NaN payload (verify off) and
   poisoned activations (``poison_activations``) must give
   ``nonfinite_logits``, one retry, the switch to the dense model at the
   prefill (the kernels' plain versions over the store give NaN too) and
   its tokens; a served kernel whose output is overwritten with NaN on the
   verified store ``KernelNonFiniteError``, with no dense step;
   ``kernel_failure`` one ``kernel_failure`` row a role, no launch and the
   dense model's tokens; a deadline of the prefill and 4.5 decode steps
   ``deadline_hit`` with the healthy run's tokens up to it and the tail
   padded;
8. grouped-query decode (``repro_torch.models.optflags``, flag
   ``gqagroup``): full-width chatglm3-6b on both shipped plans.  Under the
   flag the graph and the eager step must give ``torch.equal`` tokens and
   logits at every decode step, both variants, bf16 and fp32; at fp32
   each row's decode logits must stay within 1e-3 max|logits| of the
   flag-off run while the two runs' tokens agree (greedy agreement
   printed).  Graphed decode (batch 4, prompt 128, 16 tokens), flag off
   and on, 5 runs each in turns after a capturing round, gives the median
   and min-max of prefill ms and decode ms/token, the launches of both
   variants under the flag must be 7 x layers x (1 + 16), and a CUDA-only
   trace of one graphed step each gives its busy time, idle share and
   copy kernels (ms, launches, the largest).  The mixer's graphed step
   with every slot occupied, at 4 and at 16 slots, flag off and on (two
   mixers, 5 rounds of 4 steps in turns), is timed and traced the same
   way.  On the same models, phase 9's overhead row: ``generate`` with
   the CLI's telemetry on (tracer, registry, ``kernel_timer``,
   ``instrument()``: decode runs eagerly) and off, 5 runs each in turns;
   tokens equal, launches as phase 5's, ``kernel_dispatch_total`` equal
   to them;
9. the serve CLI's telemetry: ``repro_torch.launch.serve.main`` with
   ``--compressed --plan KIND --trace T --metrics M`` at full width on the
   bitmap and the N:M plan, and with ``--mixer`` on the bitmap plan.  The
   Chrome trace, its stable projection, the JSON snapshot and the
   Prometheus text must parse; the snapshot's series must be
   ``telemetry_series`` (the set the CPU tests hold the reference's CLI
   exports to); ``kernel_dispatch_total{kind}`` and the trace's
   ``kernel:<kind>`` events must equal the run's launches of that kind's
   kernels, and no other kernel may launch.

The line before the last is one JSON object describing every kernel (its
launches in phases 5-9, each counted from zero before the phase's run);
the last is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
port's sources beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores — the sparse kernels' arithmetic type — and the
# dense bf16 tensor-core rate, which bounds attention on bf16 inputs
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TOL_REL, TOL_ABS = 1e-4, 1e-5
BATCH, PROMPT, GEN = 4, 128, 16
TRACE_STEPS = 4              # decode steps in the serving trace
RUNS = 5                     # serving runs per variant and mode
M_DECODE, M_PREFILL = BATCH, BATCH * PROMPT
# phase 6: the mixer's stream
MIX_REQUESTS, MIX_SLOTS, MIX_MAX_LEN, MIX_WIDE = 12, 4, 288, 16
# phase 8: decode steps a mixer takes in each timed round
GQA_MIX_STEPS = 4
# phase 9: the serve CLI's --metrics series beside the dispatcher's per-role
# exec_* ones (``%s`` the plan's kind), for a static run and a --mixer run;
# series that only timing can create are left out of the comparison
EXEC_FAMILIES = (
    "exec_decode_ops_total", "exec_dispatch_calls_total", "exec_macs_total",
    "exec_refetch_factor", "exec_w_distinct_bits_total",
    "exec_w_fetch_bits_total", "exec_w_stream_bits_total",
    "exec_x_bits_total", "exec_y_bits_total")
CLI_SERIES = ("kernel_cache_entries", "kernel_cache_hits_total",
              "kernel_cache_misses_total", "kernel_dispatch_seconds{kind=%s}",
              "kernel_dispatch_total{kind=%s}",
              "serve_achieved_compression_ratio")
CLI_STATIC = ("serve_static_tokens_total",)
CLI_MIXER = ("mixer_admissions_total", "mixer_decode_step_seconds",
             "mixer_decode_steps_total",
             "mixer_evictions_total{reason=budget}", "mixer_slot_occupancy",
             "mixer_tokens_admitted_total",
             "serve_dense_steps_total", "serve_requests_total",
             "serve_retries_total", "serve_tokens_generated_total",
             "straggler_ewma_seconds", "straggler_flagged_total")
TIMING_SERIES = ("mixer_straggler_spikes_total",)
# the bitmap kernels the naive entry launches as their NAIVE = true instances
NAIVE_SWITCH = ("bitmap_spmm_small_m_kernel", "bitmap_spmm_prefill_kernel",
                "bitmap_spmm_kernel")


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, reps: int, flush) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls timed with CUDA
    events, each after a write of ``flush`` (larger than the 50 MB L2), so
    every call finds its weights cold, as a serving layer does."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOP_S
              ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def phase_environment() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{', '.join(p.name for p in libs.values())}")
    lines: dict[str, list[str]] = {}       # entry -> its ptxas lines
    for name, log in build.BUILD_LOG.items():
        entry = ""
        for line in log.splitlines():
            if "Function properties for" in line:       # names the entry
                entry = line.split()[-1]
                print(f"[build] {name}: {entry}")
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
                lines.setdefault(entry, []).append(line.strip())

    def xt(t):
        return "bf16" if t != "f" else "fp32"

    def nv(naive):
        return "naive " if naive == "1" else ""

    # one summary line per instance of the redesigned entries: the N:M
    # prefill kernel (Tile<R, WM, WK, MIN_BLOCKS>, x type, 16-byte cp.async
    # or plain staging), the naive N:M kernels (decode MT, x type, 16-byte
    # or plain row loads; prefill NTile<TY, TX, RM, RK, MIN_BLOCKS>, staged
    # x type, staging), the bitmap kernels, pipelined and naive (prefill
    # PTile<TY, TX, RM, RK, MIN_BLOCKS, STAGES, BC>, decode MT x x type,
    # tiled x x type; transpose, reduce) and both flash
    # entries (FMA per FTile<BQ, BKV, TY, TX, DP, STAGES, PH, MIN_BLOCKS> x
    # operand type, tensor-core per D)
    summaries = (
        (r"TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEE(13__nv_bfloat16|f)"
         r"Lb([01])",
         lambda r, wm, wk, minb, t, vec: (
             f"nm_spmm prefill Tile<{r}, {wm}, {wk}, {minb}> x {xt(t)} "
             f"{'cp.async' if vec == '1' else 'plain'} staging")),
        (r"nm_spmm_naive_small_m_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E",
         lambda t, mt, vec: (
             f"nm_spmm naive decode MT={mt} x {xt(t)} "
             f"{'16-byte' if vec == '1' else 'plain'} row loads")),
        (r"nm_spmm_naive_prefill_kernelI\w*?NTileILi(\d+)ELi(\d+)ELi(\d+)"
         r"ELi(\d+)ELi(\d+)EEE(13__nv_bfloat16|f)Lb([01])",
         lambda ty, tx, rm, rk, minb, t, vec: (
             f"nm_spmm naive prefill NTile<{ty}, {tx}, {rm}, {rk}, {minb}> "
             f"({int(ty) * int(rm)} x {int(tx) * int(rk)} outputs), x "
             f"staged as {xt(t)}, "
             f"{'cp.async' if vec == '1' else 'plain'} staging")),
        (r"bitmap_spmm_prefill_kernelINS_5PTileILi(\d+)ELi(\d+)ELi(\d+)"
         r"ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEELb([01])E",
         lambda ty, tx, rm, rk, minb, stages, bc, naive: (
             f"bitmap_spmm {nv(naive)}prefill PTile<{ty}, {tx}, {rm}, {rk}, "
             f"{minb}, {stages}, {bc}> ({int(ty) * int(rm)} x "
             f"{int(tx) * int(rk)} outputs, {stages} stages of {bc} rows)")),
        (r"bitmap_transpose_x_kernelI(13__nv_bfloat16|f)E",
         lambda t: f"bitmap_spmm transpose x {xt(t)}"),
        (r"bitmap_spmm_small_m_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E",
         lambda t, mt, naive: (
             f"bitmap_spmm {nv(naive)}decode MT={mt} x {xt(t)}")),
        (r"bitmap_spmm_kernelI(13__nv_bfloat16|f)Lb([01])E",
         lambda t, naive: f"bitmap_spmm {nv(naive)}tiled x {xt(t)}"),
        (r"bitmap_reduce_kernel", lambda: "bitmap_spmm reduce"),
        (r"flash_attention_fma_kernelI\w*?FTileILi(\d+)ELi(\d+)ELi(\d+)"
         r"ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EEE"
         r"(13__nv_bfloat16|f)",
         lambda bq, bkv, ty, tx, dp, stages, ph, minb, t: (
             f"flash_attention fma entry FTile<{bq}, {bkv}, {ty}, {tx}, "
             f"{dp}, {stages}, {ph}, {minb}> x {xt(t)}: D <= {dp}, "
             f"{int(bq) // int(ty)} x {int(bkv) // int(tx)} scores and "
             f"{int(bq) // int(ty)} x {int(dp) // int(tx)} outputs a "
             f"thread, {stages} stage(s), P V in passes of {ph} keys")),
        (r"flash_attention_tc_kernelILi(\d+)E",
         lambda d: f"flash_attention tensor-core entry D={d}"))
    for entry, found in lines.items():
        for pattern, label in summaries:
            hit = re.search(pattern, entry)
            if hit:
                print(f"[build] {label(*hit.groups())}: {'; '.join(found)}")
        if re.search(r"bitmap|nm_(spmm|reduce|transpose)|"
                     r"flash_attention_(tc|fma)", entry) \
                and re.search(r"[1-9]\d* bytes spill", " ".join(found)):
            _fail(f"{entry} spills: {'; '.join(found)}")
    # ptxas serialises wgmmas it cannot prove safe, at a loss it only notes
    for line in build.BUILD_LOG.get("flash_attention", "").splitlines():
        if "Performance Loss" in line and "wgmma" in line:
            _fail(f"flash_attention: {line.strip()}")


class _Acc:
    """Per-kernel accumulation of the kernel-vs-plain phase."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.sums: dict[tuple, dict[str, float]] = {}
        self.masked: dict | None = None      # kernel 2's masked-step case

    def add(self, key, err, ms, plain_ms, lib_ms, nbytes, flops):
        """Record one case; ``key`` None keeps it out of the sums (a
        case the serving path does not run)."""
        self.max_abs_err = max(self.max_abs_err, err)
        if key is None:
            return
        s = self.sums.setdefault(key, dict(ms=0.0, plain_ms=0.0,
                                           library_ms=0.0, bytes=0.0,
                                           flops=0.0))
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["library_ms"] += lib_ms
        s["bytes"] += nbytes
        s["flops"] += flops


def _check(name, y, y_plain) -> float:
    import torch
    err = (y - y_plain).abs().max().item()
    scale = y_plain.abs().max().item()
    if not torch.isfinite(y).all() or err > TOL_REL * scale + TOL_ABS:
        _fail(f"{name}: max|y - y_plain| = {err} > {TOL_REL} * {scale} "
              f"+ {TOL_ABS}")
    return err


def _trace(fn, label: str, prelude=None):
    """The device events of ``fn()`` from a CUDA-only ``torch.profiler``
    trace between marker kernels, after ``prelude()``
    (``repro_torch.kernels.trace``; the trace is written into ``build/``
    and removed).  The profiler loses whole traces or their first events
    (about 1 in 100, now and then many in a row; ``tools/trace_loss.py``):
    a trace that lost a marker is taken again after a pause, ten times at
    most."""
    from repro_torch.kernels import build, trace

    def lost(attempt, evs):
        print(f"[trace] {label}: trace {attempt + 1} lost an event, taken "
              f"again; it holds {len(evs)} events, first and last "
              f"{[e.name[:40] for e in evs[:2] + evs[-2:]]}")
    try:
        return trace.traced(
            fn, build.BUILD_DIR / f"trace-{os.getpid()}.json", on_loss=lost,
            prelude=prelude)
    except RuntimeError as e:
        _fail(f"{label}: {e}")


def _short(kernel: str) -> str:
    """A traced kernel's name without its namespace and arguments."""
    return re.search(r"(nm|bitmap)_\w+[^(]*",
                     kernel.replace("(anonymous namespace)::", ""))[0]


def _held_to(label: str, want, fn, naive_switch: tuple[str, ...] = ()
             ) -> str:
    """Fail unless the kernels ``fn()`` launches (the first complete
    ``_trace``) are exactly ``want`` (a wrapper's ``naive_kernel``: names
    and grids, in order; a grid is padded with 1s to the trace's three),
    those named in ``naive_switch`` as their ``NAIVE = true`` instances;
    return them as one printable line."""
    def same(name, grid, r, g):
        return name in r and (not g or tuple(g) == tuple(grid) + (1,) * (
            len(g) - len(grid))) and (name not in naive_switch
                                      or re.search(r"\btrue>", r))
    ran = [(e.name, e.grid) for e in _trace(fn, label) if e.cat == "kernel"]
    if len(ran) != len(want) or not all(
            same(name, grid, r, g) for (name, grid), (r, g) in zip(want, ran)):
        _fail(f"{label}: launched {ran}, expected {want}")
    return ", then ".join(
        f"{_short(r)} on grid {' x '.join(map(str, grid))}"
        f"{'' if g else ' (the trace gives no grid)'}"
        for (_, grid), (r, g) in zip(want, ran))


def phase_kernels(cfg, card: str, dev) -> dict[str, _Acc]:
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import bitmap_spmm as bm_cuda
    from repro_torch.kernels import nm_spmm as nm_cuda
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse import masks

    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    plan = shipped_plan(cfg, "bitmap")
    acc = {name: _Acc() for name in ("bitmap_spmm", "bitmap_spmm_naive",
                                     "nm_spmm", "nm_spmm_naive")}
    # every M the mixer's streams (phase 6) give the kernels: decode at
    # 4 and 16 slots, admission prefill at batch 1 and M = prompt length
    mix_ms = sorted({MIX_SLOTS, MIX_WIDE,
                     *(len(r.prompt) for r in _mixer_requests(cfg))})
    # its own draws, so the timed cases keep the inputs of earlier runs
    mix_gen = torch.Generator(device=dev).manual_seed(6)
    print(f"[kernels] tolerance max|y - y_plain| <= {TOL_REL} max|y_plain| "
          f"+ {TOL_ABS}; naive == pipelined bit for bit; times are device "
          f"ms with a cold L2, on {card}")

    def held_at_mixer_shapes(kname, label, n, kernel, plain):
        """Both variants of ``kernel(x, pipeline)`` against ``plain(x)``
        at each of the mixer's M, x in fp32 and bf16 (checked, not
        timed): each within the tolerance, naive == pipelined."""
        worst = 0.0
        for m in mix_ms:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, n), generator=mix_gen,
                                device=dev).to(dtype)
                y, y_naive, y_plain = kernel(x, True), kernel(x, False), \
                    plain(x)
                case = f"{label} M={m} {dtype}"
                tol = TOL_REL * y_plain.abs().max().item() + TOL_ABS
                for name, out in ((kname, y), (f"{kname}_naive", y_naive)):
                    err = _check(f"{name} {case}", out, y_plain)
                    acc[name].max_abs_err = max(acc[name].max_abs_err, err)
                    worst = max(worst, err / tol)
                if not torch.equal(y_naive, y):
                    _fail(f"{kname} {case}: the naive result differs from "
                          f"the pipelined one by "
                          f"{(y_naive - y).abs().max().item()}")
        print(f"[kernels] {kname} and {kname}_naive {label} at the mixer's "
              f"M={mix_ms}, x fp32 and bf16: within the tolerance (largest "
              f"share of it {worst:.4f}), naive == pipelined")

    def run(kname, label, m, dtype, n, kernel, plain, w_dense, nbytes_w,
            flops_per_row, x_cols, main_path):
        """``kernel(x, pipeline)``: both variants on the same x.  The
        naive variant computes the same function as the pipelined one,
        so it shares its plain and library times."""
        x = torch.randn((m, n), generator=gen, device=dev).to(dtype)
        y = kernel(x, True)
        y_naive = kernel(x, False)
        y_plain = plain(x)
        torch.cuda.synchronize()
        case = f"{label} M={m} {dtype}"
        err = _check(f"{kname} {case}", y, y_plain)
        err_naive = _check(f"{kname}_naive {case}", y_naive, y_plain)
        if not torch.equal(y_naive, y):
            _fail(f"{kname} {case}: the naive result differs from the "
                  f"pipelined one by {(y_naive - y).abs().max().item()}")
        reps = 10 if m <= M_DECODE else 5
        ms = _time_ms(lambda: kernel(x, True), reps, flush)
        plain_ms = _time_ms(lambda: plain(x), reps, flush)
        lib_ms = _time_ms(lambda: torch.matmul(x.float(), w_dense), reps,
                          flush)
        k = y.shape[1]
        nbytes = nbytes_w + m * x_cols * x.element_size() + m * k * 4
        flops = flops_per_row * m
        bound, by = _bound_ms(nbytes, flops)
        key = (m, dtype) if main_path else None
        acc[kname].add(key, err, ms, plain_ms, lib_ms, nbytes, flops)
        print(f"[kernels] {kname} {label} M={m} x={str(dtype)[6:]}: "
              f"err {err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"library {lib_ms:.4f} ms bound {bound:.4f} ms ({by}; "
              f"{bound / ms:.1%} of it reached)")
        if dtype != torch.bfloat16:              # naive timed at bf16 only
            a = acc[f"{kname}_naive"]
            a.max_abs_err = max(a.max_abs_err, err_naive)
            return
        ms_naive = _time_ms(lambda: kernel(x, False), reps, flush)
        acc[f"{kname}_naive"].add(key, err_naive, ms_naive, plain_ms,
                                  lib_ms, nbytes, flops)
        print(f"[kernels] {kname}_naive {label} M={m} x=bfloat16: "
              f"err {err_naive:.3e} kernel {ms_naive:.4f} ms (equal to "
              f"the pipelined result)")

    for role in cfg.matmul_roles():
        op = plan.for_role(role.role)
        bn, bk = op.choice.block_n, op.choice.block_k
        w = torch.randn((role.n, role.k), generator=gen, device=dev) \
            / math.sqrt(role.n)
        cases = [("d0.5", masks.block_prune(w, bn, bk, 0.5))]
        if role.role == "attn.wk":
            cases.append(("d0", torch.zeros_like(w)))
        for tag, wp in cases:
            c = ops.compress_bitmap(wp, bn, bk)
            nnzb = int(c.counts.sum())
            rows_used = int(torch.unique(c.row_ids[:nnzb]).numel())
            nbytes_w = nnzb * bn * bk * 4 + (2 * c.counts.numel() + nnzb) * 4
            slices, pieces = bm_cuda.split_plan(M_DECODE, bn, bk, role.k,
                                                c.max_per_col)
            tiles = role.k // bk * -(-bk // bm_cuda.SMALL_M_TILE_K)
            part = slices * M_DECODE * role.k * 4 if slices > 1 else 0
            if nnzb:
                print(f"[kernels] bitmap_spmm {role.role} ({bn}x{bk} {tag}) "
                      f"M={M_DECODE}: {slices} slices of {pieces} pieces "
                      f"(up to {pieces * bm_cuda.PIECE_ROWS} kept rows), "
                      f"grid {tiles} x {slices} = {tiles * slices} blocks, "
                      f"partials {part} B (round trip "
                      f"{2 * part / (nnzb * bn * bk * 4):.2%} of the "
                      f"payload)")
                pp = bm_cuda.prefill_plan(M_PREFILL, bk, role.k)
                print(f"[kernels] bitmap_spmm {role.role} ({bn}x{bk} {tag}) "
                      f"M={M_PREFILL}: prefill tile {pp.tm} x {pp.tk} "
                      f"({'big' if pp.tile == 0 else 'small'}), grid "
                      f"{' x '.join(map(str, pp.grid))} = "
                      f"{math.prod(pp.grid)} blocks")
            # the naive kernels that run at decode and at the prefill, and
            # their grids: the pipelined entry's kernels, naive instances
            for m in (M_DECODE, M_PREFILL):
                want = bm_cuda.naive_kernel(m, role.n, role.k, bn, bk,
                                            c.max_per_col,
                                            c.blocks.data_ptr() % 16 == 0)
                x = torch.randn((m, role.n), generator=gen,
                                device=dev).bfloat16()
                runs = _held_to(f"bitmap_spmm_naive {role.role} ({bn}x{bk} "
                                f"{tag}) M={m}", want,
                                lambda: ops.bitmap_spmm(x, c, pipeline=False),
                                NAIVE_SWITCH)
                print(f"[kernels] bitmap_spmm_naive {role.role} ({bn}x{bk} "
                      f"{tag}) M={m} x=bfloat16: ran {runs}")
            del x
            for m in (M_DECODE, M_PREFILL):
                for dtype in (torch.float32, torch.bfloat16):
                    run("bitmap_spmm", f"{role.role} ({bn}x{bk} {tag})", m,
                        dtype, role.n,
                        lambda x, p, c=c: ops.bitmap_spmm(x, c, pipeline=p),
                        lambda x, c=c: ref.bitmap_spmm_ref(
                            x, c.blocks, c.counts, c.row_ids, c.n, c.k),
                        wp, nbytes_w, 2.0 * nnzb * bn * bk, rows_used * bn,
                        tag == "d0.5")
            if tag == "d0.5":
                held_at_mixer_shapes(
                    "bitmap_spmm", f"{role.role} ({bn}x{bk} {tag})", role.n,
                    lambda x, p, c=c: ops.bitmap_spmm(x, c, pipeline=p),
                    lambda x, c=c: ref.bitmap_spmm_ref(
                        x, c.blocks, c.counts, c.row_ids, c.n, c.k))
        for n_sel in (2, 1):
            wp = masks.nm_prune(w, n_sel, 4)
            c = ops.compress_nm(wp, n_sel, 4)
            nbytes_w = c.values.numel() * 4 + c.indices.numel()
            slices, length = nm_cuda.split_plan(M_DECODE, role.n, role.k,
                                                n_sel, 4)
            tiles = -(-role.k // nm_cuda.SMALL_M_TILE_K)
            part = slices * M_DECODE * role.k * 4 if slices > 1 else 0
            print(f"[kernels] nm_spmm {role.role} ({n_sel}:4) M={M_DECODE}: "
                  f"{slices} slices of {length} groups, grid {tiles} x "
                  f"{slices} = {tiles * slices} blocks, partials {part} B "
                  f"(round trip {2 * part / nbytes_w:.2%} of the payload)")
            # the naive kernels that run at decode and at the prefill, and
            # their grids
            for m in (M_DECODE, M_PREFILL):
                want = nm_cuda.naive_kernel(m, role.n, role.k, n_sel, 4)
                x = torch.randn((m, role.n), generator=gen,
                                device=dev).bfloat16()
                runs = _held_to(f"nm_spmm_naive {role.role} ({n_sel}:4) "
                                f"M={m}", want,
                                lambda: ops.nm_spmm(x, c, pipeline=False))
                tile = "" if nm_cuda.small_m(m, role.k) else (
                    " ({} x {} tiles)".format(*nm_cuda.NAIVE_PREFILL_TILES[
                        nm_cuda.naive_prefill_plan(m, role.k).tile]))
                print(f"[kernels] nm_spmm_naive {role.role} ({n_sel}:4) "
                      f"M={m} x=bfloat16: ran {runs}{tile}")
            del x
            for m in (M_DECODE, M_PREFILL):
                for dtype in (torch.float32, torch.bfloat16):
                    run("nm_spmm", f"{role.role} ({n_sel}:4)", m, dtype,
                        role.n,
                        lambda x, p, c=c: ops.nm_spmm(x, c, pipeline=p),
                        lambda x, c=c: ref.nm_spmm_ref(
                            x, c.values, c.indices, c.n_sel, c.m_group),
                        wp, nbytes_w, 2.0 * c.values.numel(), role.n,
                        n_sel == 2)
            if n_sel == 2:
                held_at_mixer_shapes(
                    "nm_spmm", f"{role.role} ({n_sel}:4)", role.n,
                    lambda x, p, c=c: ops.nm_spmm(x, c, pipeline=p),
                    lambda x, c=c: ref.nm_spmm_ref(
                        x, c.values, c.indices, c.n_sel, c.m_group))
        del w
    acc["bitmap_spmm_naive"].masked = _masked_steps(gen, flush, dev)
    _non_finite_inputs(cfg, dev)
    return acc


def _held_non_finite(name: str, y, want, exact: bool) -> tuple[int, int]:
    """Fail unless ``y`` is NaN, +Inf and -Inf exactly where ``want`` is,
    and its finite values equal ``want``'s (``exact``) or lie within the
    kernel tolerance of them; return ``want``'s NaN and Inf counts."""
    import torch
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(y), mask(want)):
            _fail(f"{name}: {mask.__name__} differs in "
                  f"{int((mask(y) != mask(want)).sum())} outputs")
    fin = torch.isfinite(want)
    if fin.any():
        a, b = y[fin], want[fin]
        if exact and not torch.equal(a, b):
            _fail(f"{name}: finite outputs differ by "
                  f"{(a - b).abs().max().item()}")
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        if err > TOL_REL * scale + TOL_ABS:
            _fail(f"{name}: finite outputs differ by {err} > {TOL_REL} * "
                  f"{scale} + {TOL_ABS}")
    return int(torch.isnan(want).sum()), int(torch.isinf(want).sum())


def _non_finite_inputs(cfg, dev) -> None:
    """Phase 3's non-finite inputs, checked and not timed.  For every role
    of both shipped plans (the bitmap plan's blocks at density 0.5 by
    block pruning, and 2:4), at M = 4, 16 and 512, x fp32 and bf16: NaN in
    one input column in rows 0 and 2 (mod 4), +Inf in another in rows 1
    and 2, row 3 finite.  Bitmap: the NaN column lies in a block-row that
    some block-column does not store, the +Inf one in a block-row it does;
    both variants must give the plain version's NaN / +-Inf masks and its
    finite values within the tolerance.  N:M: columns 1 and N/2 + 2, each
    pruned in some output column; the pipelined kernel must equal the
    naive one (NaN for NaN, the rest bit for bit) and give the plain
    version's masks and, where finite, its values within the
    tolerance."""
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops, ref
    from repro_torch.sparse import masks
    gen = torch.Generator(device=dev).manual_seed(9)
    plan = shipped_plan(cfg, "bitmap")

    def poisoned(m, n, a, b, dtype):
        x = torch.randn((m, n), generator=gen, device=dev)
        rows = torch.arange(m, device=dev) % 4
        x[:, a] = torch.where((rows == 0) | (rows == 2), float("nan"),
                              x[:, a])
        x[:, b] = torch.where((rows == 1) | (rows == 2), float("inf"),
                              x[:, b])
        return x.to(dtype)

    for role in cfg.matmul_roles():
        op = plan.for_role(role.role)
        bn, bk = op.choice.block_n, op.choice.block_k
        w = torch.randn((role.n, role.k), generator=gen, device=dev) \
            / math.sqrt(role.n)
        bc = ops.compress_bitmap(masks.block_prune(w, bn, bk, 0.5), bn, bk)
        nc = ops.compress_nm(masks.nm_prune(w, 2, 4), 2, 4)
        del w
        # each block-column's stored block-rows; the NaN goes into a
        # block-row the first column lacking one does not store, the +Inf
        # into one that some column stores
        gn, rows, first, stored = role.n // bn, bc.row_ids.tolist(), 0, []
        for count in bc.counts.tolist():
            stored.append(set(rows[first:first + count]))
            first += count
        col = next((j for j, st in enumerate(stored) if len(st) < gn), None)
        if col is None or not any(stored):
            _fail(f"bitmap_spmm {role.role}: every block-column stores "
                  f"every block-row, or none stores any")
        ba = bn * min(set(range(gn)) - stored[col])
        bb = bn * min(set().union(*stored)) + 1
        na, nb = 1, role.n // 2 + 2
        for c in (na, nb):
            group = nc.indices[c // 4 * 2:c // 4 * 2 + 2].long()
            if (group == c % 4).any(dim=0).all():
                _fail(f"nm_spmm {role.role}: input {c} is kept in every "
                      f"output column")
        counts = {}
        for m in (M_DECODE, MIX_WIDE, M_PREFILL):
            for dtype in (torch.float32, torch.bfloat16):
                case = f"{role.role} M={m} {str(dtype)[6:]}"
                x = poisoned(m, role.n, ba, bb, dtype)
                want = ref.bitmap_spmm_ref(x, bc.blocks, bc.counts,
                                           bc.row_ids, bc.n, bc.k)
                for p in (True, False):
                    name = "bitmap_spmm" if p else "bitmap_spmm_naive"
                    counts[f"bitmap M={m}"] = _held_non_finite(
                        f"{name} {case} non-finite x",
                        ops.bitmap_spmm(x, bc, pipeline=p), want, False)
                x = poisoned(m, role.n, na, nb, dtype)
                y3 = ops.nm_spmm(x, nc, pipeline=True)
                y4 = ops.nm_spmm(x, nc, pipeline=False)
                _held_non_finite(f"nm_spmm {case} non-finite x vs naive",
                                 y3, y4, True)
                counts[f"nm M={m}"] = _held_non_finite(
                    f"nm_spmm {case} non-finite x vs plain", y3,
                    ref.nm_spmm_ref(x, nc.values, nc.indices, 2, 4), False)
        print(f"[kernels] non-finite x, {role.role}: bitmap ({bn}x{bk}, "
              f"NaN at input {ba}, not stored in block-column {col}; +Inf "
              f"at {bb}, stored) both variants == plain in NaN / +-Inf "
              f"masks, finite "
              f"within the tolerance; N:M 2:4 (NaN at {na}, +Inf at {nb}) "
              f"pipelined == naive (equal_nan, finite bit for bit) == plain "
              f"in masks; x fp32 and bf16; (NaN, Inf) outputs at M="
              f"{M_PREFILL}, bf16: bitmap {counts[f'bitmap M={M_PREFILL}']}, "
              f"N:M {counts[f'nm M={M_PREFILL}']}")


def _masked_steps(gen, flush, dev) -> dict:
    """Kernel 2 at decode with the static bound above the longest column:
    a (13696, 4096) weight of 16 x 16 blocks of 856 x 256 keeping 8 of each
    block-column's 16 (112 MB stored), served with t_max 8 and 16.  At 16
    each column's masked steps read the next column's 8 stored blocks (the
    clamped index min(off + t, nnzb - 1)): 105 MB of distinct blocks more,
    past the 50 MB L2, so the time rises unless the reads were dropped.
    The result must equal kernel 1's at both bounds."""
    import torch
    from repro_torch.kernels import ops
    n, k, bn, bk, m = 13696, 4096, 856, 256, M_DECODE
    keep = torch.rand((n // bn, k // bk), generator=gen, device=dev) \
        .argsort(dim=0) < 8
    mask = keep.repeat_interleave(bn, 0).repeat_interleave(bk, 1)
    w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(n) * mask
    c = ops.compress_bitmap(w, bn, bk)
    del w, mask
    x = torch.randn((m, n), generator=gen, device=dev).bfloat16()
    y = ops.bitmap_spmm(x, c)
    out = {"at": f"M={m}, x bf16, N={n} K={k}, blocks {bn}x{bk}, 8 of 16 "
                 f"kept per block-column", "stored_bytes":
           c.blocks.numel() * 4, "kernel1_ms": _time_ms(
               lambda: ops.bitmap_spmm(x, c), 10, flush)}
    for t_max in (c.max_per_col, 2 * c.max_per_col):
        if not torch.equal(ops.bitmap_spmm(x, c, t_max=t_max,
                                           pipeline=False), y):
            _fail(f"bitmap_spmm_naive with t_max={t_max}: the result "
                  f"differs from the pipelined one")
        # bytes the masked steps read: (t_max - counts[kj]) blocks a column
        masked = int((t_max - c.counts).sum()) * bn * bk * 4
        out[f"t_max={t_max}"] = {"ms": _time_ms(lambda: ops.bitmap_spmm(
            x, c, t_max=t_max, pipeline=False), 10, flush),
            "masked_bytes": masked}
    lo, hi = (out[f"t_max={t}"] for t in (c.max_per_col,
                                           2 * c.max_per_col))
    print(f"[kernels] bitmap_spmm_naive masked steps ({out['at']}, "
          f"{out['stored_bytes'] / 1e6:.1f} MB stored): kernel 1 "
          f"{out['kernel1_ms']:.4f} ms; naive t_max={c.max_per_col} "
          f"{lo['ms']:.4f} ms ({lo['masked_bytes'] / 1e6:.1f} MB masked); "
          f"t_max={2 * c.max_per_col} {hi['ms']:.4f} ms "
          f"({hi['masked_bytes'] / 1e6:.1f} MB masked): "
          f"{hi['ms'] / lo['ms']:.2f}x; results equal to kernel 1's")
    return out


def phase_flash(cfg, card: str, dev) -> dict:
    """Flash attention at chatglm3-6b's attention width: BH = batch 4 x 32
    heads, D = 128.  No serving path of either package launches the
    kernel (their models use plain chunked attention), so its launches
    are this phase's own."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    d = cfg.head_dim
    bh = BATCH * cfg.n_heads
    cases = [(bh, s, causal, dtype) for s in (128, 2048)
             for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((cfg.n_heads, 8192, True, torch.bfloat16))
    print(f"[flash] tolerance fp32 max|o - o_plain| <= {TOL_REL} "
          f"max|o_plain| + {TOL_ABS}; bf16 per element |o - o_plain| <= "
          f"2^-7 |o_plain| + 2^-5 sqrt(sum_j w_j^2 v_j^2) + 1e-6 (both "
          f"round the output to bf16 once and every softmax weight once, "
          f"at different places: ref.flash_attention_bf16_tol); times are "
          f"device ms with a cold L2, on {card}")
    ops.reset_launch_counts()
    shapes, max_err = [], 0.0
    for n_bh, s, causal, dtype in cases:
        q, k, v = (torch.randn((n_bh, s, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        heads = n_bh if s <= 2048 else 4      # a dense S x S score per head

        def plain():
            return torch.cat([ref.flash_attention_ref(
                q[i:i + heads], k[i:i + heads], v[i:i + heads], causal)
                for i in range(0, n_bh, heads)])

        entry = fa.select_entry(dtype, d, True)
        fa.reset_entry_counts()
        o = ops.flash_attention(q, k, v, causal=causal)
        if fa.entry_counts()[entry] != 1:
            _fail(f"flash_attention BH={n_bh} S={s} {dtype}: entry counts "
                  f"{fa.entry_counts()}, expected one launch of {entry}")
        o_plain = plain()
        diff = (o.float() - o_plain.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            ratio = err / (TOL_REL * o_plain.float().abs().max().item()
                           + TOL_ABS)
        else:
            ratio = max((diff[i:i + heads] / ref.flash_attention_bf16_tol(
                q[i:i + heads], k[i:i + heads], v[i:i + heads],
                o_plain[i:i + heads], causal)).max().item()
                for i in range(0, n_bh, heads))
        label = (f"BH={n_bh} S={s} D={d} {'causal' if causal else 'full'} "
                 f"{str(dtype)[6:]}")
        if not bool(torch.isfinite(o).all()) or o.dtype != dtype \
                or not ratio <= 1.0:
            _fail(f"flash_attention {label}: |o - o_plain| reaches {ratio} "
                  f"of its bound (max {err})")
        del o, o_plain, diff
        max_err = max(max_err, err)
        reps = 5 if s <= 2048 else 3
        ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                      reps, flush)
        plain_ms = _time_ms(plain, reps, flush)
        # 4-D (1, BH, S, D) views: PyTorch picks its fused backends only
        # for 4-D inputs
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), reps, flush)
        nbytes = 4 * n_bh * s * d * q.element_size()
        flops = 4.0 * n_bh * s * s * d * (0.5 if causal else 1.0)
        bound, by = _bound_ms(nbytes, flops, BF16_FLOP_S
                              if dtype == torch.bfloat16 else FP32_FLOP_S)
        shapes.append({"at": label, "entry": entry, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": lib_ms,
                       "max_abs_err": err, "err_over_bound": ratio})
        if (n_bh, s, causal, dtype) == (bh, 2048, True, torch.bfloat16):
            head = shapes[-1]
        print(f"[flash] {label}: {entry} entry, err {err:.3e} ({ratio:.3f} "
              f"of its bound) kernel {ms:.4f} ms ({bound / ms:.1%} of the "
              f"bound) plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound "
              f"{bound:.4f} ms ({by})")
        del q, k, v
        torch.cuda.empty_cache()
    launches = ops.launch_counts()["flash_attention"]
    print(f"[flash] {launches} launches in this phase")
    return {"shapes": shapes, "head": head, "max_abs_err": max_err,
            "launches": launches}


def _device_time(evs, calls: int) -> tuple[float, list]:
    """Device busy ms a call, from ``calls`` calls' trace events, and the
    kernels by the time they take, the most first: (ms a call, launches
    a call, name)."""
    import collections
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in evs:
        by_name[e.name][0] += e.us
        by_name[e.name][1] += 1
    top = sorted(((us / 1e3 / calls, n // calls, name)
                  for name, (us, n) in by_name.items()), reverse=True)
    return sum(e.us for e in evs) / 1e3 / calls, top


def _trace_decode(cm, pruned, prompts, label: str, step_ms: float
                  ) -> dict[str, float]:
    """Device time of ``TRACE_STEPS`` decode steps, taken as ``generate``
    takes them (a graph's replays, or eagerly inside
    ``compiled.disable()``), from a CUDA-only ``torch.profiler`` trace
    between markers (``_trace``), and the kernels that take the most of
    it.  The idle share is taken against ``step_ms``, the untraced decode
    median ms/token of the same mode: the profiler slows the host, so the
    traced step's host time is printed only beside it.  Returns the
    sparse kernels' events a step, by kernel (``_short``)."""
    import collections
    import torch
    from repro_torch.launch import compiled
    logits, cache = cm.prefill(pruned, prompts, PROMPT + GEN)
    state = {"tok": logits[:, -1].argmax(dim=-1), "cache": cache}
    step = compiled.CompiledStep(cm)
    pos = torch.empty((), dtype=torch.long, device=prompts.device)
    walls = []

    def decode(first: int, n: int):
        for t in range(first, first + n):
            pos.fill_(t)
            logits, state["cache"] = step(pruned, state["cache"],
                                          state["tok"], pos)
            state["tok"] = logits.argmax(dim=-1)

    def timed():
        t0 = time.perf_counter()
        decode(PROMPT + 1, TRACE_STEPS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / TRACE_STEPS)

    # one step before the markers: the profiler has lost the first events
    # of every such trace late in this process
    evs = _trace(timed, f"{label} decode",
                 prelude=lambda: decode(PROMPT, 1))
    busy, kernels = _device_time(evs, TRACE_STEPS)
    print(f"[serve {label}] trace of {TRACE_STEPS} decode steps: device "
          f"busy {busy:.3f} ms/step, idle share {1 - busy / step_ms:.4f} "
          f"of the untraced median {step_ms:.3f} ms/token; "
          f"{len(evs) / TRACE_STEPS:.0f} device ops a step; host clock "
          f"under the profiler {1e3 * walls[-1]:.3f} ms/step")
    for ms, count, name in kernels[:6]:
        print(f"[serve {label}]   {ms:.4f} ms/step {count} calls/step  "
              f"{name[:90]}")
    sparse = collections.Counter(
        _short(e.name) for e in evs if e.cat == "kernel"
        and re.match(r"(void )?\(anonymous namespace\)::(nm|bitmap)_", e.name))
    return {name: n / TRACE_STEPS for name, n in sorted(sparse.items())}


def _check_traced_launches(label: str, served: str, per_step: dict,
                           per_replay: int, want: int) -> None:
    """Fail unless the graph's trace ran the served kernel ``want`` (7 x
    layers) times a step, as the count a replay adds (``per_replay``)
    says, with no other variant's or plan's kernel, and every sparse
    kernel (the reduces among them) as many times a step as the eager
    step's trace."""
    family, naive = served.split("_")[0], served.endswith("_naive")

    def variant(short):
        if not short.startswith(family + "_"):
            return False
        if "reduce" in short:
            return True
        return bool(re.search(r"\btrue>", short) if family == "bitmap"
                    else "naive" in short) == naive
    graph, eager = per_step["graph"], per_step["eager"]
    main = sum(n for k, n in graph.items() if "reduce" not in k)
    if main != want or per_replay != want or not all(map(variant, graph)):
        _fail(f"{label}: the graph's trace runs {graph} a step; expected "
              f"{want} launches of {served} (the replay counts "
              f"{per_replay})")
    if graph != eager:
        _fail(f"{label}: the graph's trace runs {graph} a step, the eager "
              f"step's {eager}")
    print(f"[serve {label}] traced sparse kernels a step, graph == eager: "
          f"{graph} ({want} launches of {served}, as a replay counts)")


def _graph_equals_eager(model, params, prompts, label: str) -> None:
    """Fail unless the graph's greedy tokens and each decode step's logits
    are ``torch.equal`` to the eager step's (``model.decode_step``)."""
    import torch
    from repro_torch.launch import compiled
    toks, steps = compiled.greedy(compiled.CompiledStep(model), model,
                                  params, prompts, GEN)
    toks_e, steps_e = compiled.greedy(model.decode_step, model, params,
                                      prompts, GEN)
    if not torch.equal(toks, toks_e):
        _fail(f"{label}: graph tokens {toks.tolist()} differ from the eager "
              f"step's {toks_e.tolist()}")
    for i, (lg, lg_e) in enumerate(zip(steps, steps_e)):
        if not torch.equal(lg, lg_e):
            _fail(f"{label}: decode step {i}'s logits differ between graph "
                  f"and eager by {(lg - lg_e).abs().max().item()}")
    print(f"[serve {label}] graph == eager: tokens and the logits of all "
          f"{len(steps)} decode steps torch.equal")


def _spread(xs: list[float]) -> str:
    s = sorted(xs)
    return f"median {s[len(s) // 2]:.3f} (min {s[0]:.3f}, max {s[-1]:.3f})"


def phase_serving(cfg, card: str, dev) -> dict[str, int]:
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    expected = 7 * cfg.n_layers * (1 + GEN)
    launches: dict[str, int] = {}
    print(f"[serve] chatglm3-6b d_model={cfg.d_model} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} n_layers={cfg.n_layers} batch={BATCH} "
          f"prompt={PROMPT} gen={GEN}; {RUNS} runs per variant and mode "
          f"(graph: CUDA graph replays; eager: compiled.disable()), in "
          f"turns; host clock, synchronised, on {card}")
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        full_plan = shipped_plan(cfg, kind)
        t0 = time.perf_counter()
        params = Model(cfg).init(seed=0, device=dev)
        cm, pruned = serve.compressed_model(cfg, params, full_plan,
                                            device=dev)
        del params
        torch.cuda.synchronize()
        print(f"[serve {kind}] init + prune + compress "
              f"{time.perf_counter() - t0:.2f} s; store ratio "
              f"{cm.store.achieved_ratio():.6f}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        pg = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                                device=dev)

        def run(name):
            """One counted ``generate``: its tokens, prefill ms and decode
            ms/token; the launches must be the served kernel's only."""
            ops.reset_launch_counts()
            toks, t_prefill, t_gen = cm.generate(pruned, prompts, GEN,
                                                 device=dev)
            counts = ops.launch_counts()
            if counts[name] != expected or sum(counts.values()) != expected:
                _fail(f"{name}: launch counts {counts}, expected {expected} "
                      f"launches of {name} only")
            return toks, 1e3 * t_prefill, 1e3 * t_gen / GEN, counts

        for pipeline in (True, False):
            name = kname if pipeline else f"{kname}_naive"
            label = kind if pipeline else f"{kind} naive"
            with ops.pipeline_default(pipeline):
                # the first run captures: prefill, the first decode step
                # eagerly, the capture, then replays
                toks, t_prefill, step_ms, counts = run(name)
                launches[name] = counts[name]
                (capture_ms, per_replay), = [
                    (g.capture_ms, sum(g.launches.values()))
                    for k, g in compiled.graphs(cm).items()
                    if k[4] == pipeline]
                print(f"[serve {label}] capture {capture_ms:.3f} ms (once "
                      f"per key; this run's decode, capture included, "
                      f"{step_ms:.3f} ms/token); {per_replay} kernel "
                      f"launches counted per replay")
                print(f"[serve {label}] launch counts of every run: "
                      f"{name} = 7 * {cfg.n_layers} * (1 + {GEN}) = "
                      f"{expected}, none of any other kernel")
                logits, _ = cm.prefill(pruned, prompts, PROMPT)
                if pipeline:
                    if toks.shape != (BATCH, GEN) or not bool(
                            ((toks >= 0) & (toks < cfg.vocab)).all()):
                        _fail(f"{kind}: tokens out of range: "
                              f"{toks.tolist()}")
                    if not bool(torch.isfinite(logits).all()):
                        _fail(f"{kind}: non-finite bf16 prefill logits")
                    toks_p, logits_p = toks, logits
                    print(f"[serve {kind}] sample tokens {toks[0].tolist()}")
                else:
                    # the naive kernels: same tokens, same logits
                    if not torch.equal(toks, toks_p):
                        _fail(f"{label}: tokens {toks.tolist()} differ from "
                              f"the pipelined run's {toks_p.tolist()}")
                    if not torch.equal(logits, logits_p):
                        _fail(f"{label}: bf16 prefill logits differ from the "
                              f"pipelined run's by "
                              f"{(logits - logits_p).abs().max().item()}")
                    print(f"[serve {label}] tokens and bf16 prefill logits "
                          f"equal to the pipelined run's")
                del logits
                times = {"graph": ([], []), "eager": ([], [])}
                for _ in range(RUNS):
                    for mode in ("graph", "eager"):
                        if mode == "eager":
                            with compiled.disable():
                                out = run(name)
                        else:
                            out = run(name)
                        if not torch.equal(out[0], toks):
                            _fail(f"{label} {mode}: tokens {out[0].tolist()} "
                                  f"differ from {toks.tolist()}")
                        times[mode][0].append(out[1])
                        times[mode][1].append(out[2])
                for mode, (pre, dec) in times.items():
                    print(f"[serve {label} {mode}] over {RUNS} runs: prefill "
                          f"ms {_spread(pre)}; decode ms/token "
                          f"{_spread(dec)} — bf16 compute, on {card}")
                _graph_equals_eager(cm, pruned, prompts, f"{label} bf16")
                per_step = {}
                for mode in ("graph", "eager"):
                    dec = sorted(times[mode][1])[RUNS // 2]
                    with compiled.disable() if mode == "eager" \
                            else contextlib.nullcontext():
                        per_step[mode] = _trace_decode(
                            cm, pruned, prompts, f"{label} {mode}", dec)
                _check_traced_launches(label, name, per_step, per_replay,
                                       7 * cfg.n_layers)
        del logits_p

        # fp32: compressed vs the dense model on the same pruned weights,
        # and graph vs eager on both
        L.COMPUTE_DTYPE = torch.float32
        try:
            dense = Model(cfg)
            lc, _ = cm.prefill(pruned, prompts, PROMPT)
            ld, _ = dense.prefill(pruned, prompts, PROMPT)
            err = (lc - ld).abs().max().item()
            scale = ld.abs().max().item()
            agree = (lc.argmax(-1) == ld.argmax(-1)).float().mean().item()
            del lc, ld
            tc, _, _ = cm.generate(pruned, prompts, GEN, device=dev)
            td, _, _ = serve.generate(dense, pruned, prompts, GEN,
                                      PROMPT + GEN, device=dev)
            tok_agree = (tc == td).float().mean().item()
            for pipeline in (True, False):
                with ops.pipeline_default(pipeline):
                    _graph_equals_eager(
                        cm, pruned, prompts,
                        f"{kind}{'' if pipeline else ' naive'} fp32")
            _graph_equals_eager(dense, pruned, prompts, f"{kind} dense fp32")
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        print(f"[serve {kind}] fp32 compressed vs dense prefill logits: "
              f"max abs err {err:.3e} (bound 1e-3 * {scale:.3e}); greedy "
              f"agreement: prefill argmax {agree:.4f}, generated tokens "
              f"{tok_agree:.4f}")
        if not err <= 1e-3 * scale:
            _fail(f"{kind}: fp32 compressed logits differ from dense by "
                  f"{err} > 1e-3 * {scale}")
        _graph_equals_eager(dense, pruned, prompts, f"{kind} dense bf16")
        print(f"[serve {kind}] graphs held: "
              f"{len(compiled.graphs(cm))} (compressed), "
              f"{len(compiled.graphs(dense))} (dense); "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        del cm, pruned, dense
        torch.cuda.empty_cache()
        print(f"[serve {kind}] after the model is deleted: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return launches


def _mixer_requests(cfg, greedy: bool = True):
    """Phase 6's stream, drawn with ``np.random.default_rng(3)``: prompt
    lengths 8-256 (one of 16 or fewer and one above 200 forced where the
    draw has none), ``max_new`` 8-32; sampled requests take temperature
    0.8, top-k 20 and seed i."""
    import numpy as np
    from repro_torch.launch.mixer import Request
    rng = np.random.default_rng(3)
    plens = rng.integers(8, 257, MIX_REQUESTS)
    if not (plens <= 16).any():
        plens[1] = rng.integers(8, 17)
    if not (plens > 200).any():
        plens[2] = rng.integers(201, 257)
    max_new = rng.integers(8, 33, MIX_REQUESTS)
    sampling = {} if greedy else dict(temperature=0.8, top_k=20)
    return [Request(uid=f"m{i}", prompt=rng.integers(0, cfg.vocab, int(p)),
                    max_new=int(n), seed=i, **sampling)
            for i, (p, n) in enumerate(zip(plens, max_new))]


def _serve_stream(cm, pruned, reqs, slots: int, name: str, label: str,
                  card: str, capturing: bool = False, record: bool = False):
    """One counted mixer stream: its tokens, stats, per-step wall times
    and (with ``record``) each request's logits.  Fails unless the stream
    admits and evicts every request, emits every token and launches the
    served kernel 7 x layers x (admissions + decode steps) times and no
    other kernel.  ``capturing``: the stream's first step captures a
    graph, left out of the step spread."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mixer import Mixer
    from repro_torch.launch.record import record_logits
    from repro_torch.runtime.fault import StragglerMonitor

    class Timed(StragglerMonitor):
        def observe(self, step, dt):
            walls.append(dt)
            return super().observe(step, dt)

    walls: list[float] = []
    mx = Mixer(cm, pruned, slots=slots, max_len=MIX_MAX_LEN,
               straggler=Timed())
    logits = record_logits(mx) if record else None
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = mx.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = mx.stats()
    want = 7 * cm.cfg.n_layers * (st["admits"] + st["steps"])
    if st["admits"] != len(reqs) or st["evictions"] != len(reqs) or \
            st["tokens"] != sum(r.max_new for r in reqs):
        _fail(f"{label}: stream accounting {st}")
    if counts[name] != want or sum(counts.values()) != want:
        _fail(f"{label}: launch counts {counts}, expected {want} launches "
              f"of {name} only (7 * {cm.cfg.n_layers} * ({st['admits']} "
              f"admissions + {st['steps']} steps))")
    steps = [1e3 * w for w in (walls[1:] if capturing else walls)]
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    print(f"[mixer {label}] {st['admits']} admissions "
          f"({st['slot_reuse_admits']} into a freed slot), {st['steps']} "
          f"decode steps, {st['tokens']} tokens; admission "
          f"{1e3 * st['t_admit_s']:.3f} ms in total, "
          f"{1e3 * st['t_admit_s'] / prompt_tokens:.4f} ms per prompt "
          f"token ({prompt_tokens}); decode ms/step {_spread(steps)}"
          f"{f' (the capturing step {1e3 * walls[0]:.3f} ms left out)' if capturing else ''}; "
          f"stream {st['tokens'] / wall:.1f} tok/s over {wall:.3f} s; "
          f"{want} launches of {name}, none of any other kernel — on "
          f"{card}")
    return dict(tokens=[r.tokens for r in results], stats=st,
                launches=counts[name], logits=logits)


def _mixer_graph(cm, slots: int, dtype, pipeline: bool):
    """The one graph held for the mixer's key (slots, max_len, a (slots,)
    position, dtype, variant)."""
    from repro_torch.launch import compiled
    found = [g for k, g in compiled.graphs(cm).items()
             if k[:5] == (slots, MIX_MAX_LEN, 1, dtype, pipeline)]
    if len(found) != 1:
        _fail(f"mixer: {len(found)} graphs for the key (slots={slots}, "
              f"max_len={MIX_MAX_LEN}, per-row pos, {dtype}, "
              f"pipeline={pipeline}); expected one")
    return found[0]


def _hold_stream(label: str, got: dict, want: dict, got_toks: dict,
                 want_toks: dict) -> tuple[float, list]:
    """Hold each request's logits ``got`` (by uid: the admission's row,
    then one row a decode step, as ``record_logits`` keeps them) to
    ``want``'s within 1e-3 max|want row| (phase 5's bound), row by row, up
    to and including the row where the greedy tokens part at a near tie
    (a top-2 gap of ``want``'s row within twice the bound), after which
    the two decode different sequences.  Fails on a larger error or on
    tokens that part at a wider gap.  Returns the largest share of the
    bound and the near ties (uid, row, gap)."""
    worst, parted = 0.0, []
    for uid, rows in want.items():
        if len(got[uid]) != len(rows):
            _fail(f"{label} {uid}: {len(got[uid])} rows against "
                  f"{len(rows)}")
        for j, (a, b) in enumerate(zip(got[uid], rows)):
            bound = 1e-3 * b.abs().max().item()
            err = (a - b).abs().max().item()
            worst = max(worst, err / bound)
            if not err <= bound:
                _fail(f"{label} {uid} row {j}: max|logits - reference| = "
                      f"{err} > {bound}")
            if got_toks[uid][j] != want_toks[uid][j]:
                top2 = b.topk(2).values
                gap = (top2[0] - top2[1]).item()
                if gap > 2 * bound:
                    _fail(f"{label} {uid} row {j}: tokens part at a top-2 "
                          f"gap {gap} > {2 * bound}")
                parted.append((uid, j, gap))
                break
    return worst, parted


def _mixer_fp32_vs_alone(cm, pruned, reqs, name: str, label: str,
                         card: str) -> None:
    """fp32, TF32 off, pipelined: each request of a graphed stream against
    the same request served alone at batch 1 through ``serve.generate``
    (whose compiled step is recorded), and against the same stream served
    through the dense model on the same pruned weights (``torch.matmul``
    in place of every sparse kernel, at the same M).  The admission logits
    must be ``torch.equal`` to the standalone prefill's last logits; every
    row within 1e-3 max|logits| of both references (``_hold_stream``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.launch.mixer import Mixer
    from repro_torch.launch.record import record_logits
    from repro_torch.models.transformer import Model

    dev = pruned["embed"].device
    out = _serve_stream(cm, pruned, reqs, MIX_SLOTS, name, f"{label} fp32",
                        card, capturing=True, record=True)
    toks = {r.uid: t for r, t in zip(reqs, out["tokens"])}
    log: list = []

    class Recorded(compiled.CompiledStep):
        def __call__(self, *args):
            logits, cache = super().__call__(*args)
            log.append(logits[0].clone())
            return logits, cache

    alone, alone_toks, agree = {}, {}, 0
    plain = serve.CompiledStep
    serve.CompiledStep = Recorded
    try:
        for req in reqs:
            prompt = torch.as_tensor(req.prompt, device=dev)[None]
            alone_prefill, _ = cm.prefill(pruned, prompt, MIX_MAX_LEN)
            log.clear()
            gen, _, _ = serve.generate(cm, pruned, prompt, req.max_new,
                                       MIX_MAX_LEN, device=dev)
            admitted = out["logits"][req.uid][0]
            if not torch.equal(admitted, alone_prefill[0, -1]):
                _fail(f"{label} fp32 {req.uid}: admission logits differ "
                      f"from the standalone prefill's by "
                      f"{(admitted - alone_prefill[0, -1]).abs().max().item()}")
            # generate takes one step past the last token, as the reference
            alone[req.uid] = [alone_prefill[0, -1]] + log[:req.max_new - 1]
            alone_toks[req.uid] = gen[0].cpu().numpy()
            agree += int((alone_toks[req.uid] == toks[req.uid]).sum())
    finally:
        serve.CompiledStep = plain
    worst, parted = _hold_stream(f"{label} fp32 vs alone", out["logits"],
                                 alone, toks, alone_toks)
    print(f"[mixer {label} fp32] vs each request served alone at batch 1 "
          f"(serve.generate): admission logits torch.equal for all "
          f"{len(reqs)}; logits within 1e-3 max|logits| (largest share of "
          f"the bound {worst:.4f}); greedy agreement {agree}/"
          f"{sum(r.max_new for r in reqs)} tokens; parted at a near tie: "
          f"{parted or 'none'} — on {card}")
    dense = Model(cm.cfg)
    dmx = Mixer(dense, pruned, slots=MIX_SLOTS, max_len=MIX_MAX_LEN)
    dense_logits = record_logits(dmx)
    ops.reset_launch_counts()
    dense_toks = {r.uid: res.tokens for r, res in zip(reqs, dmx.run(reqs))}
    if sum(ops.launch_counts().values()):
        _fail(f"{label}: the dense stream launched {ops.launch_counts()}")
    worst, parted = _hold_stream(f"{label} fp32 vs dense", out["logits"],
                                 dense_logits, toks, dense_toks)
    agree = sum(int((dense_toks[u] == toks[u]).sum()) for u in toks)
    print(f"[mixer {label} fp32] vs the same stream through the dense model "
          f"on the same pruned weights (torch.matmul at the same M: "
          f"admission at M = prompt length, decode at M = {MIX_SLOTS}): "
          f"logits within 1e-3 max|logits| (largest share of the bound "
          f"{worst:.4f}); greedy agreement {agree}/"
          f"{sum(r.max_new for r in reqs)} tokens; parted at a near tie: "
          f"{parted or 'none'} — on {card}")
    del dmx, dense                    # its graph and pool go with it


def _traced_call(label: str, fn, host_ms: list[float],
                 tag: str = "mixer") -> None:
    """Print ``fn()``'s device busy ms from one CUDA-only trace
    (``_trace``, after one untraced call as its prelude), its idle share
    of the median of ``host_ms`` (the same call untraced, host clock,
    synchronised), its device ops, the sparse kernels' and the copies'
    share of the busy time, the copy kernels (a name holding "copy":
    strided copies, casts through ``copy_``, the stacks' batched copies;
    their ms, launches and the three largest) and the kernels that take
    the most of it, on lines tagged ``[tag label]``."""
    evs = _trace(fn, label, prelude=fn)
    busy, top = _device_time(evs, 1)
    host = sorted(host_ms)[len(host_ms) // 2]
    sparse = sum(e.us for e in evs if e.cat == "kernel" and re.match(
        r"(void )?\(anonymous namespace\)::(nm|bitmap)_", e.name)) / 1e3
    copies = sum(e.us for e in evs if e.cat != "kernel") / 1e3
    copy_kernels = [e for e in evs if e.cat == "kernel"
                    and "copy" in e.name.lower()]
    copy_ms, largest = _device_time(copy_kernels, 1)
    print(f"[{tag} {label}] trace: device busy {busy:.3f} ms, idle share "
          f"{1 - busy / host:.4f} of the untraced {_spread(host_ms)} ms; "
          f"{len(evs)} device ops; sparse kernels {sparse:.3f} ms "
          f"({sparse / busy:.1%} of busy), copies and sets {copies:.3f} ms; "
          f"copy kernels {copy_ms:.4f} ms ({copy_ms / busy:.1%} of busy) "
          f"in {len(copy_kernels)} launches")
    for ms, count, name in largest[:3]:
        print(f"[{tag} {label}]   copy {ms:.4f} ms {count} calls  "
              f"{name[:200]}")
    for ms, count, name in top[:4]:
        print(f"[{tag} {label}]   {ms:.4f} ms {count} calls  {name[:240]}")


def _trace_mixer(cm, pruned, reqs, label: str) -> None:
    """Where an admission's and a mixer step's time goes, pipelined bf16:
    one admission prefill of the stream's shortest prompt and one of its
    longest (``model.prefill`` at batch 1, as ``admit`` runs it), and one
    graphed ``Mixer`` step, host work included, with every slot occupied
    at ``MIX_SLOTS`` and at ``MIX_WIDE`` slots (the graphs the timed
    streams captured; each mixer copies its cache in once)."""
    import torch
    from repro_torch.launch.mixer import Mixer, Request
    dev = pruned["embed"].device
    for req in (min(reqs, key=lambda r: len(r.prompt)),
                max(reqs, key=lambda r: len(r.prompt))):
        prompt = torch.as_tensor(req.prompt, device=dev)[None]

        def prefill():
            cm.prefill(pruned, prompt, MIX_MAX_LEN)
            torch.cuda.synchronize()
        host = []
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            prefill()
            host.append(1e3 * (time.perf_counter() - t0))
        _traced_call(f"{label} admission prefill M={prompt.shape[1]}",
                     prefill, host)
    for slots in (MIX_SLOTS, MIX_WIDE):
        mx = Mixer(cm, pruned, slots=slots, max_len=MIX_MAX_LEN)
        for i in range(slots):
            src = reqs[i % len(reqs)]
            mx.admit(Request(uid=f"t{i}", prompt=src.prompt,
                             max_new=MIX_MAX_LEN - len(src.prompt)))
        mx._step()                    # the graph takes this mixer's cache
        host = []
        for _ in range(TRACE_STEPS):
            t0 = time.perf_counter()
            mx._step()                # ends on the logits' readback
            host.append(1e3 * (time.perf_counter() - t0))
        _traced_call(f"{label} {slots} slots graphed step", mx._step, host)
        del mx


def phase_mixer(cfg, card: str, dev) -> dict[str, int]:
    """Phase 6: the continuous-batching mixer at full width on both
    shipped plans and both variants (see the module docstring)."""
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    reqs = _mixer_requests(cfg)
    sampled = _mixer_requests(cfg, greedy=False)
    print(f"[mixer] chatglm3-6b n_layers={cfg.n_layers}, {MIX_REQUESTS} "
          f"greedy requests (np.random.default_rng(3)): prompt lengths "
          f"{[len(r.prompt) for r in reqs]}, max_new "
          f"{[r.max_new for r in reqs]}; {MIX_SLOTS} slots, max_len "
          f"{MIX_MAX_LEN}, no EOS; bf16 unless named; host clock, "
          f"synchronised, on {card}")
    launches: dict[str, int] = {}
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        t0 = time.perf_counter()
        params = Model(cfg).init(seed=0, device=dev)
        cm, pruned = serve.compressed_model(cfg, params,
                                            shipped_plan(cfg, kind),
                                            device=dev)
        del params
        torch.cuda.synchronize()
        print(f"[mixer {kind}] init + prune + compress "
              f"{time.perf_counter() - t0:.2f} s")
        first = None
        for pipeline in (True, False):
            name = kname if pipeline else f"{kname}_naive"
            label = kind if pipeline else f"{kind} naive"
            with ops.pipeline_default(pipeline):
                graphed = _serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                        f"{label} graph", card,
                                        capturing=True)
                launches[name] = graphed["launches"]
                g = _mixer_graph(cm, MIX_SLOTS, torch.bfloat16, pipeline)
                steps = graphed["stats"]["steps"]
                if graphed["stats"]["slot_reuse_admits"] < 1:
                    _fail(f"{label}: no admission into a freed slot")
                if g.serial != 0 or g.replays != steps - 1:
                    _fail(f"{label}: the capturing stream left serial "
                          f"{g.serial}, replays {g.replays}; expected 0 and "
                          f"{steps - 1}")
                with compiled.disable():
                    eager = _serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                          f"{label} eager", card)
                again = _serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                      f"{label} graph, second stream", card)
                if _mixer_graph(cm, MIX_SLOTS, torch.bfloat16,
                                pipeline) is not g or g.serial != 1 or \
                        g.replays != 2 * steps - 1:
                    _fail(f"{label}: after a second stream the graph has "
                          f"serial {g.serial}, replays {g.replays}; expected "
                          f"1 and {2 * steps - 1}")
                print(f"[mixer {label}] one graph for the key: capture "
                      f"{g.capture_ms:.3f} ms, serial 0 after the capturing "
                      f"stream and 1 after the second, {g.replays} replays "
                      f"= 2 x {steps} steps - 1")
                for mode, run in (("eager", eager), ("second graph", again)):
                    for i, (a, b) in enumerate(zip(graphed["tokens"],
                                                   run["tokens"])):
                        if not (a == b).all():
                            _fail(f"{label} {mode}: request m{i} tokens "
                                  f"{b.tolist()} differ from the graph's "
                                  f"{a.tolist()}")
                if first is None:
                    first = graphed["tokens"]
                else:
                    for i, (a, b) in enumerate(zip(first,
                                                   graphed["tokens"])):
                        if not (a == b).all():
                            _fail(f"{label}: request m{i} tokens "
                                  f"{b.tolist()} differ from the pipelined "
                                  f"variant's {a.tolist()}")
                print(f"[mixer {label}] tokens of all {MIX_REQUESTS} "
                      f"requests equal: graph == eager == second graph"
                      f"{'' if pipeline else ' == the pipelined variant'}")
        # sampled determinism, pipelined, graphed
        runs = [_serve_stream(cm, pruned, sampled, MIX_SLOTS, kname,
                              f"{kind} sampled run {i + 1}", card)
                for i in range(2)]
        for i, (a, b) in enumerate(zip(*(r["tokens"] for r in runs))):
            if not (a == b).all():
                _fail(f"{kind} sampled: request m{i} tokens {a.tolist()} "
                      f"then {b.tolist()}")
        differ = sum(int((a != b).sum())
                     for a, b in zip(runs[0]["tokens"], first))
        print(f"[mixer {kind} sampled] two runs equal (temperature 0.8, "
              f"top-k 20, seed i); {differ} of {sum(r.max_new for r in sampled)} "
              f"tokens differ from the greedy stream's")
        # fp32 against each request served alone
        L.COMPUTE_DTYPE = torch.float32
        try:
            _mixer_fp32_vs_alone(cm, pruned, reqs, kname, kind, card)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        # timing only: 16 slots, pipelined
        _serve_stream(cm, pruned, reqs, MIX_WIDE, kname,
                      f"{kind} {MIX_WIDE} slots graph", card,
                      capturing=True)
        with compiled.disable():
            _serve_stream(cm, pruned, reqs, MIX_WIDE, kname,
                          f"{kind} {MIX_WIDE} slots eager", card)
        _trace_mixer(cm, pruned, reqs, kind)
        print(f"[mixer {kind}] graphs held: {len(compiled.graphs(cm))}; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        del cm, pruned, g             # a graph holds the params and store
        torch.cuda.empty_cache()
        print(f"[mixer {kind}] after the model is deleted: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return launches


def _hashed_gb(store) -> float:
    """GB that one checksum pass over ``store`` hashes: what
    ``runtime.integrity`` digests (bitmap metadata and N:M indices
    widened to int64)."""
    n = 0
    for e in store:
        d = e.data
        if e.kind == "bitmap":
            nnzb = int(d.counts.sum())
            n += nnzb * d.bn * d.bk * d.blocks.element_size() \
                + 8 * (2 * d.counts.numel() + nnzb)
        elif e.kind == "nm":
            n += d.values.numel() * d.values.element_size() \
                + 8 * d.indices.numel()
        else:
            n += d.numel() * d.element_size()
    return n / 1e9


def _digests_alone(store, sums: dict, kind: str) -> dict[str, float]:
    """Seconds of each role's sha256 taken alone, one role after another
    (``checksum_store`` runs the roles in a thread pool); each digest must
    equal the pool's."""
    import hashlib
    from repro_torch.runtime import integrity
    by_role: dict = {}
    for e in store:
        by_role.setdefault(e.role, []).append(e)
    out = {}
    for role in sorted(by_role):
        t0 = time.perf_counter()
        h = hashlib.sha256()
        for e in sorted(by_role[role], key=lambda e: (e.layer, e.expert)):
            integrity._digest_entry(h, e)
        out[role] = time.perf_counter() - t0
        if h.hexdigest() != sums[role]:
            _fail(f"{kind}: {role}'s digest alone differs from the pool's")
    return out


def _nan_reaches_wo(cfg, store, poisoned, role: str) -> tuple[int, bool]:
    """(head, reaches) for a NaN payload value in ``role`` (``attn.wq``)
    of layer 0: the output column the NaN lands in names the head whose
    attention output turns NaN; it reaches the logits through the kernels
    only if ``attn.wo`` of layer 0 stores a weight on that head's rows."""
    import torch
    entry = poisoned.entries[(0, role, -1)]
    d = entry.data
    payload = d.blocks if entry.kind == "bitmap" else d.values
    where = torch.isnan(payload).nonzero()[0].tolist()
    if entry.kind == "bitmap":
        b, _, c = where
        kj = int(torch.searchsorted(d.offsets.long(), torch.tensor(
            b, device=d.offsets.device), right=True)) - 1
        col = kj * d.bk + c
    else:
        col = where[1]
    head = col // cfg.head_dim
    rows = range(head * cfg.head_dim, (head + 1) * cfg.head_dim)
    wo = store.entries[(0, "attn.wo", -1)].data
    if entry.kind == "bitmap":
        nnzb = int(wo.counts.sum())
        block_rows = {r // wo.bn for r in rows}
        return head, any(int(r) in block_rows
                         for r in wo.row_ids[:nnzb].tolist())
    # N:M keeps n_sel rows of every group of m_group in every column, and
    # a head's rows are whole groups: the NaN reaches every output
    return head, True


def phase_guarded(cfg, card: str, dev) -> dict[str, int]:
    """Phase 7: the guarded serving runtime at full width on both shipped
    plans (see the module docstring)."""
    import gc
    import torch
    print(f"[guard] chatglm3-6b n_layers={cfg.n_layers} batch={BATCH} "
          f"prompt={PROMPT} gen={GEN}: repro_torch.runtime.guard through "
          f"serve.generate(guarded=True) against unguarded serve.generate, "
          f"{RUNS} runs each in turns (verify off in the timed runs: it "
          f"runs before the prefill and is timed apart); bf16; host clock, "
          f"synchronised, on {card}")
    launches: dict[str, int] = {}
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        # one function a plan: its model, store and graphs go with its frame
        launches.update(_guarded_plan(cfg, kind, kname, card, dev))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[guard {kind}] after the model is deleted: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return launches


def _guarded_plan(cfg, kind: str, kname: str, card: str, dev
                  ) -> dict[str, int]:
    """Phase 7 on one shipped plan; returns the launches of its healthy
    guarded runs (pipelined and naive)."""
    import dataclasses
    import torch
    from repro_torch.exec.compress import (CompressedStore, compress_params,
                                           prune_params)
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import guard, inject, integrity

    layer_calls = 7 * cfg.n_layers
    expected = layer_calls * (1 + GEN)
    launches: dict[str, int] = {}
    plan = shipped_plan(cfg, kind)
    params = Model(cfg).init(seed=0, device=dev)
    pruned = prune_params(params, plan, cfg)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = compress_params(pruned, plan, cfg)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    sums = integrity.checksum_store(store)
    t_sums = time.perf_counter() - t0
    alone = _digests_alone(store, sums, kind)
    cm = CompressedModel(Model(cfg), store)
    t0 = time.perf_counter()
    status = cm.verify()
    t_verify = time.perf_counter() - t0
    roles = [op.role for op in plan.ops]
    if status != {r: "ok" for r in roles} or sums != store.plan.checksums:
        _fail(f"{kind}: verify after compress gives {status}; checksums "
              f"{'equal' if sums == store.plan.checksums else 'differ'}")
    gb = _hashed_gb(store)
    print(f"[guard {kind}] compress_params {t_compress:.3f} s (one "
          f"checksum pass included); checksum_store {t_sums:.3f} s; "
          f"verify {t_verify:.3f} s, all {len(status)} roles ok; "
          f"{gb:.3f} GB hashed a pass ({gb / t_verify:.2f} GB/s in "
          f"verify), on {card}")
    print(f"[guard {kind}] each role's digest alone, in turn: "
          + ", ".join(f"{r} {t:.3f} s" for r, t in alone.items())
          + f"; sum {sum(alone.values()):.3f} s against checksum_store's "
          f"thread pool {t_sums:.3f} s ({sum(alone.values()) / t_sums:.2f}x;"
          f" the largest role alone {max(alone.values()):.3f} s)")
    pg = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                            device=dev)

    def run(model, guarded, **kw):
        """One counted run: tokens, prefill ms, decode ms/token,
        launch counts and (guarded) the report."""
        ops.reset_launch_counts()
        out = serve.generate(model, pruned, prompts, GEN, PROMPT + GEN,
                             guarded=guarded, device=dev, **kw)
        rep = out[3] if guarded else None
        steps = rep.steps if guarded else GEN
        return (out[0], 1e3 * out[1], 1e3 * out[2] / max(steps, 1),
                ops.launch_counts(), rep)

    def only(counts, name, n, label):
        if counts[name] != n or sum(counts.values()) != n:
            _fail(f"{kind} {label}: launch counts {counts}; expected "
                  f"{n} of {name} only")

    # healthy: the unguarded run captures the graph, the guarded one
    # (verify on) must replay it with the same launches and tokens
    toks, *_, counts, _ = run(cm, False)
    only(counts, kname, expected, "unguarded")
    (g,) = compiled.graphs(cm).values()
    replays = g.replays
    toks_g, *_, counts, rep = run(cm, True)
    only(counts, kname, expected, "guarded")
    launches[kname] = counts[kname]
    if not rep.healthy or not torch.equal(toks_g, toks) or \
            len(compiled.graphs(cm)) != 1 or \
            next(iter(compiled.graphs(cm).values())) is not g or \
            g.replays != replays + GEN:
        _fail(f"{kind} guarded: healthy={rep.healthy}, tokens "
              f"{'equal' if torch.equal(toks_g, toks) else 'differ'}, "
              f"replays {replays} -> {g.replays} (expected +{GEN}), "
              f"{len(compiled.graphs(cm))} graphs")
    print(f"[guard {kind}] healthy guarded run: report healthy, tokens "
          f"torch.equal to unguarded serve.generate, {expected} launches "
          f"of {kname} (7 * {cfg.n_layers} * (1 + {GEN})), every "
          f"decode step a replay of the unguarded run's graph")
    with ops.pipeline_default(False):
        toks_n, *_, counts, rep = run(cm, True, verify=False)
    only(counts, f"{kname}_naive", expected, "guarded naive")
    launches[f"{kname}_naive"] = counts[f"{kname}_naive"]
    if not rep.healthy or not torch.equal(toks_n, toks):
        _fail(f"{kind} guarded naive: healthy={rep.healthy}, tokens "
              f"{toks_n.tolist()} against {toks.tolist()}")
    print(f"[guard {kind} naive] healthy guarded run: tokens equal, "
          f"{expected} launches of {kname}_naive")
    times = {True: ([], []), False: ([], [])}
    for _ in range(RUNS):
        for guarded in (False, True):
            out = run(cm, guarded, **({"verify": False} if guarded
                                      else {}))
            only(out[3], kname, expected, f"timed guarded={guarded}")
            if not torch.equal(out[0], toks) or \
                    (guarded and not out[4].healthy):
                _fail(f"{kind} timed guarded={guarded}: tokens "
                      f"{out[0].tolist()}")
            times[guarded][0].append(out[1])
            times[guarded][1].append(out[2])
    med = {m: sorted(times[m][1])[RUNS // 2] for m in times}
    for guarded in (False, True):
        pre, dec = times[guarded]
        print(f"[guard {kind} {'guarded' if guarded else 'unguarded'}] "
              f"over {RUNS} runs: prefill ms {_spread(pre)}; decode "
              f"ms/token {_spread(dec)} — bf16, graphed, on {card}")
    print(f"[guard {kind}] guarded / unguarded median decode ms/token: "
          f"{med[True] / med[False]:.4f}")

    # the faults target the plan's first role, layer 0
    role = roles[0]
    if role != "attn.wq":
        _fail(f"{kind}: the plan's first role is {role}, not attn.wq")
    want_dense, *_ = run(cm.model, False)
    dense_graph = next(iter(compiled.graphs(cm.model).values()))
    # bit flip: caught by the checksum, the role demoted, 6 of 7 kernels
    bad = CompressedModel(cm.model, inject.bitflip_payload(store, role))
    toks_b, *_, counts, rep = run(bad, True)
    want_verify = dict(status, **{role: "checksum_mismatch"})
    only(counts, kname, 6 * cfg.n_layers * (1 + GEN), "bit flip")
    want_b, *_ = run(cm.demoted([role]), False)
    if rep.verify != want_verify or \
            rep.fallback_counts() != {"integrity_violation": 1} or \
            rep.fallbacks[0]["role"] != role or \
            rep.switched_to_dense_at is not None or \
            not torch.equal(toks_b, want_b):
        _fail(f"{kind} bit flip: {rep.stable_dict()}; tokens "
              f"{'equal' if torch.equal(toks_b, want_b) else 'differ'}")
    print(f"[guard {kind}] bit flip in {role} layer 0: verify says "
          f"checksum_mismatch for {role} only, the role demoted, "
          f"{6 * cfg.n_layers * (1 + GEN)} launches (6 * "
          f"{cfg.n_layers} * (1 + {GEN})), tokens torch.equal to "
          f"cm.demoted([{role!r}]) served unguarded")
    del bad
    # corrupted structure, caught by the invariants alone
    mode = "truncate_offsets" if kind == "bitmap" else "nm_indices_oob"
    stripped = CompressedStore(
        dataclasses.replace(store.plan, checksums={}), store.entries)
    broken = inject.corrupt_structure(stripped, role, mode)
    t0 = time.perf_counter()
    report = integrity.verify_report(broken)
    t_struct = time.perf_counter() - t0
    want_reason = inject.STRUCTURAL_MODES[mode]
    try:
        broken.verify()
        err = None
    except integrity.IntegrityError as e:
        err = e
    if report != dict(status, **{role: want_reason}) or err is None or \
            (err.role, err.reason, err.layer) != (role, want_reason, 0):
        _fail(f"{kind} {mode}: verify_report {report}, error {err!r}")
    print(f"[guard {kind}] {mode} in {role} layer 0, checksums "
          f"stripped: {want_reason} (layer 0), every other role ok; "
          f"structure-only verify {t_struct:.3f} s")
    del stripped, broken
    # a NaN payload in the first role: verify catches it; with verify off
    # it turns one head's attention output NaN, which the kernels read
    # only where attn.wo stores weights on that head's rows (the plain
    # versions' dense matmul multiplies it by zero, giving NaN)
    nan_q = inject.poison_payload_nan(store, role)
    head, reaches = _nan_reaches_wo(cfg, store, nan_q, role)
    nan = CompressedModel(cm.model, nan_q)
    toks_q, *_, counts, rep = run(nan, True, verify=False)
    if reaches:
        ok = rep.fallback_counts() == {"nonfinite_logits": 1} and \
            rep.switched_to_dense_at == -1 and \
            torch.equal(toks_q, want_dense)
        seen = ("nonfinite_logits, the dense model's tokens")
    else:
        ok = rep.healthy and torch.equal(toks_q, toks) and \
            counts[kname] == expected
        seen = ("finite logits, a healthy report and the healthy run's "
                "tokens: the card's gap, the NaN is never read")
    if not ok:
        _fail(f"{kind} poison_payload_nan ({role}, head {head}, "
              f"{'reaches' if reaches else 'misses'} attn.wo's stored "
              f"weights), verify off: {rep.stable_dict()}")
    print(f"[guard {kind}] poison_payload_nan ({role} layer 0, head "
          f"{head}, whose attn.wo rows "
          f"{'hold' if reaches else 'hold no'} stored weights), verify "
          f"off: {seen}")
    toks_q, *_, counts, rep = run(nan, True)
    if rep.verify != dict(status, **{role: "checksum_mismatch"}) or \
            rep.fallback_counts() != {"integrity_violation": 1} or \
            not torch.equal(toks_q, want_b):
        _fail(f"{kind} poison_payload_nan ({role}), verify on: "
              f"{rep.stable_dict()}")
    print(f"[guard {kind}] poison_payload_nan ({role}), verify on: "
          f"checksum_mismatch, the role demoted, tokens torch.equal to "
          f"cm.demoted([{role!r}])")
    del nan, nan_q
    # poisoned payload (verify off) and poisoned activations: NaN
    # logits from the prefill on, one retry, the plain versions over the
    # store give NaN too, the dense model serves.  The NaN goes into
    # ffn.w_down, whose output joins the residual stream, so it reaches
    # stored weights of every later projection
    poisoned = "ffn.w_down"
    nan = CompressedModel(cm.model, inject.poison_payload_nan(store,
                                                              poisoned))
    dense_replays = dense_graph.replays
    for label, model, ctx in (
            ("poison_payload_nan", nan, contextlib.nullcontext()),
            ("poison_activations", cm,
             inject.poison_activations(poisoned))):
        with ctx:
            toks_p, *_, counts, rep = run(model, True, verify=False)
        only(counts, kname, 2 * layer_calls, label)
        if rep.fallback_counts() != {"nonfinite_logits": 1} or \
                rep.switched_to_dense_at != -1 or \
                rep.dense_steps != GEN or rep.retries != 1 or \
                not torch.equal(toks_p, want_dense):
            _fail(f"{kind} {label}: {rep.stable_dict()}; tokens "
                  f"{toks_p.tolist()} against the dense model's "
                  f"{want_dense.tolist()}")
        print(f"[guard {kind}] {label} ({poisoned}): nonfinite_logits, one "
              f"retry, switched_to_dense_at -1, {GEN} dense steps, "
              f"tokens torch.equal to the dense model's on the same "
              f"pruned weights; {2 * layer_calls} launches (two prefill "
              f"attempts)")
    if dense_graph.replays != dense_replays + GEN:
        _fail(f"{kind}: the dense graph replayed "
              f"{dense_graph.replays - dense_replays} times over both "
              f"poisons; expected {GEN} (the payload's; the activations' "
              f"steps are eager)")
    del nan
    # a served kernel whose output turns NaN on the verified store: the
    # plain versions give finite logits, so the fault is the kernel's and
    # guarded_generate raises; the dense model serves nothing
    wrapper = "_bitmap" if kind == "bitmap" else "_nm"
    kernel = getattr(ops, wrapper)

    def nan_out(*args):
        return torch.full_like(kernel(*args), float("nan"))

    setattr(ops, wrapper, nan_out)
    dense_replays = dense_graph.replays
    try:
        run(cm, True, verify=False)
        raised = None
    except guard.KernelNonFiniteError as e:
        raised = e
    finally:
        setattr(ops, wrapper, kernel)
    if raised is None or dense_graph.replays != dense_replays:
        _fail(f"{kind}: a kernel's NaN output on a verified store gave "
              f"{raised!r}, the dense graph replayed "
              f"{dense_graph.replays - dense_replays} times")
    print(f"[guard {kind}] a kernel's output overwritten with NaN: "
          f"KernelNonFiniteError ({raised}), no dense step")
    # an injected kernel failure: every kernel role demoted, no launch
    with inject.kernel_failure():
        toks_k, *_, counts, rep = run(cm, True, verify=False)
    only(counts, kname, 0, "kernel failure")
    if sorted(f["role"] for f in rep.fallbacks) != sorted(roles) or \
            rep.fallback_counts() != {"kernel_failure": len(roles)} or \
            rep.switched_to_dense_at is not None or \
            not torch.equal(toks_k, want_dense):
        _fail(f"{kind} kernel failure: {rep.stable_dict()}")
    print(f"[guard {kind}] kernel_failure: one kernel_failure row for "
          f"each of the {len(roles)} roles, no launch, tokens torch.equal "
          f"to the dense model's")
    # a deadline of the prefill and four and a half decode steps
    budget = (sorted(times[True][0])[RUNS // 2]
              + 4.5 * med[True]) / 1e3
    toks_t, *_, counts, rep = run(cm, True, verify=False,
                                  deadline_s=budget, pad_id=-1)
    steps = rep.steps
    if not rep.deadline_hit or steps >= GEN or \
            rep.fallback_counts() != {"deadline_exceeded": 1} or \
            not bool((toks_t[:, steps:] == -1).all()) or \
            not torch.equal(toks_t[:, :steps], toks[:, :steps]):
        _fail(f"{kind} deadline {budget:.4f} s: {rep.stable_dict()}")
    print(f"[guard {kind}] deadline {1e3 * budget:.3f} ms: deadline_hit, "
          f"{steps} of {GEN} tokens (equal to the healthy run's), the "
          f"tail padded")
    print(f"[guard {kind}] graphs held: {len(compiled.graphs(cm))} "
          f"(compressed), {len(compiled.graphs(cm.model))} (dense); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return launches


def telemetry_series(roles, kind: str, mixer: bool) -> set[str]:
    """The series a serve CLI run with ``--compressed --metrics`` exports
    (``_series_str`` form), less :data:`TIMING_SERIES`: the per-role
    ``exec_*`` families of ``roles``, the kernel and cache series of the
    plan's ``kind`` and the static or mixer serving series."""
    return ({f"{f}{{role={r}}}" for f in EXEC_FAMILIES for r in roles}
            | {s.replace("%s", kind) for s in CLI_SERIES}
            | set(CLI_MIXER if mixer else CLI_STATIC))


def _snapshot_series(snap: dict) -> set[str]:
    return {k for part in ("counters", "gauges", "histograms")
            for k in snap[part]
            if k.split("{")[0] not in TIMING_SERIES}


def _gqagroup_decode(cfg, kind: str, kname: str, cm, pruned, prompts,
                     card: str) -> dict[str, int]:
    """Phase 8 on one plan's model: graph == eager under the flag (both
    variants, bf16 and fp32); fp32 logits with the flag against without
    it; graphed decode with and without it, timed in turns and traced.
    Returns the launches of the flagged graphed runs, by kernel."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    from repro_torch.models import optflags
    on = ("gqagroup",)
    for dtype in (torch.bfloat16, torch.float32):
        L.COMPUTE_DTYPE = dtype
        try:
            with optflags.optimizations(on):
                for pipeline in (True, False):
                    with ops.pipeline_default(pipeline):
                        _graph_equals_eager(
                            cm, pruned, prompts,
                            f"{kind}{'' if pipeline else ' naive'} "
                            f"gqagroup {str(dtype)[6:]}")
            if dtype == torch.float32:
                toks, steps = compiled.greedy(compiled.CompiledStep(cm), cm,
                                              pruned, prompts, GEN)
                with optflags.optimizations(on):
                    toks_g, steps_g = compiled.greedy(
                        compiled.CompiledStep(cm), cm, pruned, prompts, GEN)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        compiled.graphs(cm).clear()
    # fp32: each row's decode steps while its tokens agree (a near tie
    # that parts them ends the row's comparison)
    worst, compared = 0.0, 0
    for r in range(toks.shape[0]):
        for i, (a, b) in enumerate(zip(steps, steps_g)):
            if not torch.equal(toks[r, :i + 1], toks_g[r, :i + 1]):
                break
            err = (a[r] - b[r]).abs().max().item()
            scale = b[r].abs().max().item()
            if err > 1e-3 * scale:
                _fail(f"{kind} gqagroup fp32: row {r} step {i} logits "
                      f"differ from the flag-off run's by {err} > 1e-3 * "
                      f"{scale}")
            worst, compared = max(worst, err / scale), compared + 1
    agree = (toks == toks_g).float().mean().item()
    print(f"[gqagroup {kind}] fp32 logits with the flag against without: "
          f"{compared} row-steps compared, largest max|diff| / "
          f"max|logits| {worst:.3e} (bound 1e-3); greedy agreement "
          f"{agree:.4f}")
    # graphed decode, flag off and on, in turns
    expected = 7 * cfg.n_layers * (1 + GEN)
    times = {"off": ([], []), "on": ([], [])}
    out = {}
    for _ in range(RUNS + 1):               # the first round captures
        for mode in ("off", "on"):
            ops.reset_launch_counts()
            with optflags.optimizations(on if mode == "on" else ()):
                t, t_prefill, t_gen = cm.generate(pruned, prompts, GEN,
                                                  device=prompts.device)
            counts = ops.launch_counts()
            if counts[kname] != expected or sum(counts.values()) != expected:
                _fail(f"{kind} gqagroup {mode}: launch counts {counts}, "
                      f"expected {expected} of {kname} only")
            if mode == "on":
                out = counts
            times[mode][0].append(1e3 * t_prefill)
            times[mode][1].append(1e3 * t_gen / GEN)
    for mode, (pre, dec) in times.items():
        print(f"[gqagroup {kind} {mode}] graphed, over {RUNS} runs (the "
              f"capturing round left out): prefill ms {_spread(pre[1:])}; "
              f"decode ms/token {_spread(dec[1:])} — bf16, on {card}")
    med = {m: sorted(d[1:])[RUNS // 2] for m, (_, d) in times.items()}
    print(f"[gqagroup {kind}] decode on / off {med['on'] / med['off']:.4f}")
    for mode in ("off", "on"):
        with optflags.optimizations(on if mode == "on" else ()):
            # room for the steps of a trace taken again
            logits, cache = cm.prefill(pruned, prompts, PROMPT + 4 * GEN)
            state = {"tok": logits[:, -1].argmax(dim=-1), "cache": cache,
                     "t": PROMPT}
            step = compiled.CompiledStep(cm)
            pos = torch.empty((), dtype=torch.long, device=prompts.device)

            def one():
                pos.fill_(state["t"])
                lg, state["cache"] = step(pruned, state["cache"],
                                          state["tok"], pos)
                state["tok"] = lg.argmax(dim=-1)
                state["t"] += 1
                torch.cuda.synchronize()
            one()                           # the graph takes this cache
            _traced_call(f"{kind} graphed decode step, flag {mode}", one,
                         [med[mode]], tag="gqagroup")
    compiled.graphs(cm).clear()
    return out


def _gqagroup_mixer(cm, pruned, reqs, kind: str, card: str) -> None:
    """Phase 8's mixer step: two mixers (flag off, flag on) with every
    slot occupied at ``MIX_SLOTS`` and ``MIX_WIDE`` slots, graphed, timed
    in turns (``RUNS`` rounds of ``GQA_MIX_STEPS`` steps each, host clock;
    a step ends on the logits' readback) and traced once each."""
    import torch
    from repro_torch.launch import compiled
    from repro_torch.launch.mixer import Mixer, Request
    from repro_torch.models import optflags
    for slots in (MIX_SLOTS, MIX_WIDE):
        mixers = {}
        for mode in ("off", "on"):
            with optflags.optimizations(("gqagroup",) if mode == "on"
                                        else ()):
                mx = Mixer(cm, pruned, slots=slots, max_len=MIX_MAX_LEN)
                for i in range(slots):
                    src = reqs[i % len(reqs)]
                    mx.admit(Request(uid=f"g{i}", prompt=src.prompt,
                                     max_new=MIX_MAX_LEN - len(src.prompt)))
                mx._step()                  # the graph takes its cache
            mixers[mode] = mx
        times = {"off": [], "on": []}
        for _ in range(RUNS):
            for mode, mx in mixers.items():
                with optflags.optimizations(("gqagroup",) if mode == "on"
                                            else ()):
                    t0 = time.perf_counter()
                    for _ in range(GQA_MIX_STEPS):
                        mx._step()
                    times[mode].append(1e3 * (time.perf_counter() - t0)
                                       / GQA_MIX_STEPS)
        for mode in ("off", "on"):
            print(f"[gqagroup {kind} mixer {slots} slots {mode}] graphed "
                  f"step ms over {RUNS} rounds of {GQA_MIX_STEPS}: "
                  f"{_spread(times[mode])} — bf16, on {card}")
        for mode, mx in mixers.items():
            with optflags.optimizations(("gqagroup",) if mode == "on"
                                        else ()):
                _traced_call(f"{kind} mixer {slots} slots, flag {mode}",
                             mx._step, times[mode], tag="gqagroup")
        del mixers, mx
        compiled.graphs(cm).clear()


def _telemetry_overhead(cfg, kind: str, kname: str, cm, pruned, prompts,
                        card: str) -> None:
    """Phase 9's overhead row, the counterpart of the reference's
    ``bench_serve`` row ``serve_telemetry_overhead``: ``generate`` with
    the CLI's telemetry on (tracer, registry, ``kernel_timer`` and
    ``instrument()``, which keep decode eager) and off (graphed), ``RUNS``
    runs each in turns after one of each.  Tokens must be equal, the
    launches 7 x layers x (1 + 16) of the served kernel and, with
    telemetry on, ``kernel_dispatch_total`` equal to them."""
    import torch
    from repro_torch.exec.dispatch import instrument
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as omet
    from repro_torch.obs import trace as otr
    from repro_torch.obs.profile import kernel_timer
    expected = 7 * cfg.n_layers * (1 + GEN)
    times = {"off": ([], []), "on": ([], [])}
    first = None
    for _ in range(RUNS + 1):
        for mode in ("off", "on"):
            ops.reset_launch_counts()
            if mode == "on":
                tracer, reg = otr.Tracer(), omet.MetricsRegistry()
                with otr.tracing(tracer), omet.collecting(reg), \
                        kernel_timer(registry=reg, tracer=tracer), \
                        instrument():
                    toks, t_pre, t_gen = cm.generate(
                        pruned, prompts, GEN, device=prompts.device)
            else:
                toks, t_pre, t_gen = cm.generate(pruned, prompts, GEN,
                                                 device=prompts.device)
            counts = ops.launch_counts()
            if counts[kname] != expected or sum(counts.values()) != expected:
                _fail(f"{kind} telemetry {mode}: launch counts {counts}, "
                      f"expected {expected} of {kname} only")
            if mode == "on" and reg.value("kernel_dispatch_total",
                                          kind=kind) != expected:
                _fail(f"{kind} telemetry: kernel_dispatch_total "
                      f"{reg.value('kernel_dispatch_total', kind=kind)} != "
                      f"{expected} launches")
            if first is None:
                first = toks
            elif not torch.equal(toks, first):
                _fail(f"{kind} telemetry {mode}: tokens {toks.tolist()} "
                      f"differ from {first.tolist()}")
            times[mode][0].append(1e3 * t_pre)
            times[mode][1].append(1e3 * t_gen / GEN)
    for mode, (pre, dec) in times.items():
        print(f"[telemetry {kind} {mode}] over {RUNS} runs: prefill ms "
              f"{_spread(pre[1:])}; decode ms/token {_spread(dec[1:])} — "
              f"bf16, on {card}")
    med = {m: sorted(d[1:])[RUNS // 2] for m, (_, d) in times.items()}
    print(f"[telemetry {kind}] serve_telemetry_overhead: decode on / off "
          f"{med['on'] / med['off']:.4f} (on: eager, every dispatch "
          f"recorded; {len(tracer.events)} trace events, "
          f"{len(reg.snapshot()['counters'])} counter series; tokens equal)")


def phase_gqagroup(cfg, card: str, dev) -> dict[str, int]:
    """Phases 8 and 9's overhead rows, on one build of each shipped plan
    at full width: ``gqagroup`` (``_gqagroup_decode``,
    ``_gqagroup_mixer``) and the telemetry overhead
    (``_telemetry_overhead``).  Returns the flagged graphed runs'
    launches, by kernel."""
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    launches = {}
    reqs = _mixer_requests(cfg)
    print(f"[gqagroup] chatglm3-6b at full width ({cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads), batch {BATCH}, prompt {PROMPT}, "
          f"{GEN} tokens; {RUNS} runs a mode in turns; host clock, "
          f"synchronised, on {card}")
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        params = Model(cfg).init(seed=0, device=dev)
        cm, pruned = serve.compressed_model(cfg, params,
                                            shipped_plan(cfg, kind),
                                            device=dev)
        del params
        pg = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                                device=dev)
        counts = _gqagroup_decode(cfg, kind, kname, cm, pruned, prompts,
                                  card)
        with ops.pipeline_default(False), \
                optflags.optimizations(("gqagroup",)):
            ops.reset_launch_counts()
            cm.generate(pruned, prompts, GEN, device=dev)
            naive = ops.launch_counts()
        launches[kname] = counts[kname]
        launches[f"{kname}_naive"] = naive[f"{kname}_naive"]
        _gqagroup_mixer(cm, pruned, reqs, kind, card)
        _telemetry_overhead(cfg, kind, kname, cm, pruned, prompts, card)
        del cm, pruned
        torch.cuda.empty_cache()
    return launches


def phase_telemetry(cfg, card: str, dev) -> dict[str, int]:
    """Phase 9: the port's serve CLI with ``--compressed --trace T
    --metrics M`` at full width on each shipped plan's kind, and with
    ``--mixer`` on the bitmap plan.  The four files must parse; the
    metrics' series must be :func:`telemetry_series` (what the CPU test
    holds the reference's exports to); ``kernel_dispatch_total{kind}``
    must equal the run's launches of that kind's kernels, and the kernel
    events of the trace one per launch.  Returns the launches, by
    kernel."""
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    out = build.BUILD_DIR / "telemetry"
    out.mkdir(parents=True, exist_ok=True)
    roles = [r.role for r in cfg.matmul_roles()]
    launches: dict[str, int] = {}
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]\w*="[^"]*"'
                        r'(,[a-zA-Z_]\w*="[^"]*")*\})? \S+$')
    for kind, mixer in (("bitmap", False), ("nm", False), ("bitmap", True)):
        label = f"{kind}{' --mixer' if mixer else ''}"
        tpath = str(out / f"{kind}{'-mixer' if mixer else ''}.trace.json")
        mpath = tpath.replace(".trace.json", ".metrics.json")
        argv = ["--arch", cfg.name, "--compressed", "--plan", kind,
                "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                "--gen", str(GEN), "--trace", tpath, "--metrics", mpath]
        if mixer:
            argv.append("--mixer")
        print(f"[telemetry] python -m repro_torch.launch.serve "
              f"{' '.join(argv)}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        serve.main(argv)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        with open(tpath) as f:
            chrome = json.load(f)["traceEvents"]
        with open(tpath + ".stable.json") as f:
            stable = json.load(f)
        with open(mpath) as f:
            snap = json.load(f)
        with open(mpath + ".prom") as f:
            prom = [ln for ln in f.read().splitlines()
                    if ln and not ln.startswith("#")]
        bad = [ln for ln in prom if not sample.match(ln)]
        if bad or not stable or not chrome:
            _fail(f"telemetry {label}: unparseable exports ({bad[:3]}, "
                  f"{len(stable)} stable events, {len(chrome)} events)")
        got = _snapshot_series(snap)
        want = telemetry_series(roles, kind, mixer)
        if got != want:
            _fail(f"telemetry {label}: series {sorted(got ^ want)} differ "
                  f"from the expected set")
        name = "bitmap_spmm" if kind == "bitmap" else "nm_spmm"
        ran = counts[name] + counts[f"{name}_naive"]
        dispatched = snap["counters"][f"kernel_dispatch_total{{kind={kind}}}"]
        kernels = sum(1 for e in chrome if e["name"] == f"kernel:{kind}")
        if dispatched != ran or kernels != ran or sum(counts.values()) != ran:
            _fail(f"telemetry {label}: kernel_dispatch_total {dispatched}, "
                  f"{kernels} kernel events, launches {counts}")
        launches[name] = launches.get(name, 0) + counts[name]
        print(f"[telemetry {label}] {wall:.2f} s (build and compress "
              f"included); trace {len(chrome)} events ({len(stable)} "
              f"stable), metrics {len(got)} series, {len(prom)} Prometheus "
              f"samples, all parsed; kernel_dispatch_total{{kind={kind}}} "
              f"= {dispatched:.0f} = the {ran} launches of {name} = the "
              f"trace's kernel:{kind} events; series as expected")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        _fail(f"the port's sources are not at {SRC}")
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config

    card = phase_environment()
    phase_build()
    cfg = get_config("chatglm3-6b")
    dev = torch.device("cuda", 0)
    acc = phase_kernels(cfg, card, dev)
    flash = phase_flash(cfg, card, dev)
    launches = phase_serving(cfg, card, dev)
    mixer_launches = phase_mixer(cfg, card, dev)
    guarded_launches = phase_guarded(cfg, card, dev)
    gqa_launches = phase_gqagroup(cfg, card, dev)
    telemetry_launches = phase_telemetry(cfg, card, dev)

    sources = {
        "bitmap_spmm": ("src/repro_torch/csrc/bitmap_spmm.cu",
                        "src/repro/kernels/bitmap_spmm.py:125"),
        "bitmap_spmm_naive": ("src/repro_torch/csrc/bitmap_spmm.cu",
                              "src/repro/kernels/bitmap_spmm.py:189"),
        "nm_spmm": ("src/repro_torch/csrc/nm_spmm.cu",
                    "src/repro/kernels/nm_spmm.py:135"),
        "nm_spmm_naive": ("src/repro_torch/csrc/nm_spmm.cu",
                          "src/repro/kernels/nm_spmm.py:167"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:87")}
    kernels = []
    for name, a in acc.items():
        # the main path's shapes: one layer's seven projections with bf16
        # activations, at a decode step and at the prefill
        entry = {"name": name, "route": "cuda", "source": sources[name][0],
                 "replaces": sources[name][1], "launches": launches[name],
                 "mixer_launches": mixer_launches[name],
                 "guarded_launches": guarded_launches[name],
                 "gqagroup_launches": gqa_launches[name],
                 "telemetry_launches": telemetry_launches.get(name, 0),
                 "max_abs_err": a.max_abs_err}
        for key, m in (("decode", M_DECODE), ("prefill", M_PREFILL)):
            s = a.sums[(m, torch.bfloat16)]
            bound, by = _bound_ms(s["bytes"], s["flops"])
            shape = {"ms": s["ms"], "plain_ms": s["plain_ms"],
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": s["library_ms"]}
            if key == "decode":
                entry.update(shape)
                entry["at"] = (f"sum over the 7 roles of one layer, "
                               f"M={m}, x bf16")
            else:
                entry["prefill"] = dict(shape, at=f"same, M={m}")
        if a.masked:
            entry["masked_steps"] = a.masked
        kernels.append(entry)
    # flash: headline shape BH=128 S=2048 causal bf16; every shape listed
    head = flash["head"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": sources["flash_attention"][0],
        "replaces": sources["flash_attention"][1],
        "launches": flash["launches"], "max_abs_err": flash["max_abs_err"],
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "at")},
        "note": "no serving path of either package launches it; launches "
                "are the flash phase's own",
        "shapes": flash["shapes"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
