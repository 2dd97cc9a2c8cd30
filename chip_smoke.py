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
   finite outputs stay within the tolerance of the plain version's; and
   kernel 4's masked tail groups (``PARTIAL_BATCH_CASES``: K = 4096, M 1
   to 16, 2:4 and 1:4 at an N whose last slice ends in a partial row
   batch, +Inf in x's last column): the naive kernel equal to the
   pipelined one and the plain version's masks, its Inf outputs included;
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
6. the mixer: full-width chatglm3-6b cut to ``MIX_LAYERS`` (7) of 28
   layers served as a request stream through
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
7. guarded serving (``repro_torch.runtime``): full-width chatglm3-6b cut
   to ``GUARD_LAYERS`` (4) layers, on both shipped plans, batch 4, prompt
   128, 16 tokens, bf16.  The seconds
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
   ``gqagroup``): full-width chatglm3-6b cut to ``GQA_LAYERS`` (14) of
   28 layers on both shipped plans.  Under the
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
   kernels, and no other kernel may launch.  The CLI searches its plan
   (``serve._fast_plan``), so the snapshot also holds the memo registry's
   ``memo_*`` series, which must be there and are left out of the
   comparison (they count every search the process ran);
10. search and calibrate (``repro_torch.core``, ``repro_torch.exec``): the
   port's own search, on this machine without JAX, for full-width
   chatglm3-6b under both sparsity models with the CLI's settings (tokens
   64, value_bits 32, ``serve.FAST_SEARCH``), cold (memo cleared) and warm,
   its host seconds printed; each plan's JSON must equal
   ``plans/chatglm3-6b.{bitmap,nm}.json`` byte for byte.  On phase 8's
   model of each shipped plan (before it is deleted): one prefill of the
   batch (M = 512) and one eager decode step (M = 4) under
   ``instrument()``, pipelined (2 x 7 x layers launches of the plan's
   kernel), and the decode step naive (7 x layers launches, the same
   counters).  ``calibrate`` on each set of counters, both plans,
   re-searching under the CLI's budget, prints ``scale``, ``glb_scale``,
   ``max_rel_err``, ``max_residual``, ``energy_drift``,
   ``max_stream_rel_err`` and ``kinds_changed``; the bitmap plan's M = 4
   fit must lie in 0.9 < scale < 1.1 with max_residual < 0.05 (the
   reference's bounds), every fitted number must be finite and positive,
   and the calibrated plan must come back from its JSON equal, with its
   hardware resolved;
11. every other model the compressed plane serves (``repro_torch.configs``:
   granite-moe-3b-a800m cut to 8 of 32 layers on the bitmap and the 2:4
   plan; qwen3-moe-30b-a3b, deepseek-coder-33b, internlm2-20b and
   pixtral-12b cut to 4 layers, whose full depth does not fit the card
   with fp32 params beside a pruned copy and a store; full width,
   seeded random weights), each initialised on the card, its plan from
   the port's own search (the same choices as the full config's), then
   ``prune_params`` -> ``compress_params`` -> ``CompressedModel``, with
   init, search, prune and compress seconds, the store's entries (expert
   entries too) and ratio, and the peak device memory printed.  Both
   variants of both sparse kernels against their plain versions at every
   role a plan dispatches (7 a dense or vlm layer, the 4 attention roles
   of a MoE layer: the experts run dense), M = 4, 16 and 512, x fp32 and
   bf16, with the tolerance of phase 3 and naive == pipelined; each
   model's roles timed at M = 4 and 512 (bf16) beside the plain version,
   the bound and one fp32 ``torch.matmul`` (they run the kernel instances
   phase 2 built and checked for spills).  ``serve.generate`` (batch 4, prompt
   128, 16 tokens, bf16) captures its graph, then 3 runs graphed and 3
   eager in turns give prefill ms and decode ms/token; every run launches
   the plan's kernel (kernel roles) x layers x (1 + 16) times and no
   other; the naive kernels give the same tokens; graph and eager give
   ``torch.equal`` tokens and logits at every step; at fp32 the
   compressed prefill logits stay within 1e-3 max|logits| of the dense
   model's on the same pruned weights (a row whose MoE routing parts
   where the swapped experts' gates lie within ``NEAR_TIE`` of each
   other is left out and printed), greedy agreement printed.  granite on
   the bitmap plan also serves phase 6's stream (graphed, eager, graphed
   again, pipelined and naive: tokens equal) and
   a guarded run with one bit flipped in an expert entry of
   ``moe.w_up``: ``verify`` names the role, the guard demotes it and the
   tokens are the healthy run's;
12. the four families the reference serves dense only (its compressed
   plane refuses them): gemma3-27b cut to 8 layers (one 5 local + 1
   global period and the 2-layer tail; window 1024), recurrentgemma-2b
   cut to 8 of 26 layers (2 rec, rec, attn periods and the 2-layer
   tail), mamba2-780m cut to 12 of 48 and whisper-tiny (whole, ``enc_seq``
   1500); full width, seeded random weights.  Each serves
   ``serve.generate``'s batch (4 x 128, 16 tokens, bf16), the prompt
   ingested token by token through the same CUDA graph as decode: one
   capturing run, then 3 graphed and 3 eager in turns (ingest and decode
   ms/token, median and min-max; every run's tokens equal); graph == eager
   on the tokens and every ingest and decode step's logits; a healthy
   guarded run with the unguarded tokens; the peak memory.  At fp32 (TF32
   off) every step's logits against the teacher-forced ``hidden_states``
   within 1e-3 max|logits| (not whisper, whose decode cross-attends to an
   empty cache in the reference too).  gemma3 and recurrentgemma also run
   batch 1 at fp32 ``WRAP_PAST`` positions past their full window (1024,
   2048) through the graph: from ``WRAP_BEFORE`` positions before the wrap
   the eager step, from a copy of the graph's cache, gives ``torch.equal``
   logits, and each meets the teacher-forced forward's within 1e-3
   max|logits|.  gemma3 and mamba2 serve a 6-request stream through the
   mixer (4 slots), graphed == eager tokens.  None of the five kernels
   may launch in the phase;
13. training (``repro_torch.launch.train``): chatglm3-6b at full width cut
   to ``TRAIN_LAYERS`` (8) of 28 layers, seeded random weights, batch 4 x
   512 tokens of ``TokenPipeline``, bf16 compute, eager.  10 steps of
   ``build_train_step`` (``Model.loss`` with remat, AdamW): the mean loss
   of the last 5 below that of the first 5; ms a step (median and min-max
   of the steps after the first), tokens/s and the peak memory.  One fp32
   step's loss and gradients (TF32 off) with remat off, on and under
   ``saveremat``: the loss and every leaf within 1e-5 max|leaf| of remat
   off, and the peak memory of each, no remat above the other two.  Three
   steps under ``grad_compress``: finite losses and error-feedback
   residuals.  Under ``torch.use_deterministic_algorithms(True)``, on the
   same width cut to ``TRAIN_CKPT_LAYERS`` (1) layer: 8 steps with a
   checkpoint after step 5, restore, replay steps 5-7: their losses equal
   the first run's to rtol 1e-5 (save and restore seconds printed).  The
   CLI at ``--reduced`` with ``--ckpt-dir`` into a temporary directory,
   then again with ``--resume``, which must print ``[resume] step 4``.
   None of the five kernels may launch in the phase;
14. the last optimization flags and the mesh: (a) ``sparseffn`` on
   chatglm3-6b at full width, all 28 layers (block-stored gate / up:
   107 block-columns of T = 8 of 32 block-rows), batch 4, 16 positions
   ingested through ``decode_step`` then 16 tokens, graphed and eager
   (``torch.equal`` tokens and logits at every step; ms a step, 3 runs a
   mode in turns), and at fp32 every step's logits within 1e-3
   max|logits| of a dense model whose gate / up weights are the payloads
   scattered and summed at their block-rows; (b) ``padheads`` on
   deepseek-coder-33b cut to 4 layers (56 heads padded to 64): prefill
   and decode through ``serve.generate``, graphed and eager (3 runs a
   mode; graph == eager), fp32 decode against teacher forcing within
   1e-3 max|logits|; the bitmap plan, whose wq blocks do not tile the
   padded wq, must be refused as the reference refuses it, and the 2:4
   plan serves the padded weights: ``nm_spmm``, pipelined and naive, at
   the padded wq and wo against its plain version (phase 3's tolerance),
   7 x 4 x (1 + 16) launches of ``nm_spmm`` and no other, graph ==
   eager; (c) ``bf16params`` on chatglm3-6b, all 28 layers: decode over
   params cast once to bf16 (``convert.bf16_params``) and over fp32
   params, in turns (ms/token, greedy agreement, peak memory), graph ==
   eager on the cast params; (d) ``make_serve_mesh(4)`` is ``None`` on
   one card (on n, the reference's (gcd(4, n), 1)) and ``serve.main``
   gives the same tokens with ``--mesh`` as without;
15. the dry run (``repro_torch.launch.dryrun``, ``launch.op_cost``) on
   this machine without JAX: (a) its CLI on ``DRYRUN_CELLS`` (chatglm3-6b
   train_4k and decode_32k, mamba2-780m prefill_32k and long_500k) at
   full width on the single production mesh, each record ``ok`` with its
   trace seconds, the step's FLOPs and bytes and the per-device argument
   and output bytes printed; (b) phase 13's cell on a one-device mesh
   (chatglm3-6b cut to ``TRAIN_LAYERS``, batch ``TRAIN_BATCH`` x
   ``TRAIN_SEQ``, bf16, remat, AdamW): the FLOPs and bytes traced at that
   depth on the meta device must equal those extrapolated from 1 and 2
   layers, the FLOPs counted over one real step on the card must equal
   the meta count, and the predicted peak may fall short of phase 13's
   measured ``max_memory_allocated`` by at most ``PEAK_SHORTFALL``
   (10 %); the achieved TFLOP/s (the counted FLOPs over phase 13's median
   step) printed beside the card's name and power limit.  None of the
   five kernels may launch in the phase;
16. a data mesh (``repro_torch.launch.data_parallel``): chatglm3-6b at
   full width cut to ``MESH_LAYERS`` (6) layers on both shipped plans,
   batch 4 x 128, 16 tokens, bf16, through ``serve.generate`` on a (2, 1)
   mesh repeating ``cuda:0`` (and, on a host of two or more cards, over
   the first two): each replica's tokens, prefill logits and every decode
   step's logits ``torch.equal`` to its 2 rows served alone on one
   device, graph == eager, launches 2 x 7 x layers x (1 + 16) of the
   plan's kernel only (the naive kernels too, same tokens); 3 runs a mode
   in turns (mesh graphed, mesh eager, one device at batch 4) give
   prefill ms and decode ms/token; at fp32 the replicas' prefill logits
   within 1e-3 max|logits| of the dense model on the same pruned weights;
   ``guarded_generate`` healthy (tokens equal, launches) and with replica
   1's payload bit flipped (``checksum_mismatch``, the role demoted on
   both replicas, the demoted model's tokens).  Then ``train.train`` at
   ``MESH_TRAIN_LAYERS`` (2) layers, 4 x 512, fp32, 3 steps on the (2, 1)
   mesh: the replicas' params bit for bit equal after every step, every
   loss within 1e-5 of one device's over the whole batch, no kernel
   launch;
17. tensor parallelism over a mesh's ``model`` axis
   (``repro_torch.launch.tensor_parallel``): chatglm3-6b at full width
   cut to ``TP_LAYERS`` (4) layers on both shipped plans, batch 4 x 128,
   16 tokens, bf16, through ``serve.generate`` on a (1, 2) mesh repeating
   ``cuda:0`` (and, on a host of two or more cards, over the first two;
   else it prints that this is untried): every shard's role at M = 4 and
   512, x fp32 and bf16, held to its plain version within phase 3's
   tolerance, naive == pipelined; launches 2 x 7 x layers x (1 + 16) of
   the plan's kernel only, pipelined and naive (same tokens); greedy
   agreement with one device printed; at fp32 the prefill logits within
   1e-3 max|logits| of the dense model on the same pruned weights;
   ``guarded_generate`` healthy (tokens equal, launches) and with one
   shard's payload bit flipped (``checksum_mismatch``, the role demoted
   on both shards, the demoted model's tokens); 3 runs a mode in turns
   (the mesh, eager; one device graphed and eager) give prefill ms and
   decode ms/token, and the peak GiB of each shard device.  On 2:4, (2, 2)
   and (1, 4) meshes repeating ``cuda:0`` once each: tokens against one
   device and the fp32 share.  On the first mesh the fp32 greedy tokens of
   the tensor-parallel decode against one device's, and at the first
   step where they part, the top-2 logit gap beside the two runs' logit
   difference there.  Then expert parallelism: granite-moe-3b-a800m at
   full width cut to ``TP_MOE_LAYERS`` (4) layers on both
   searched plans, the same batch, meshes and checks (4 attention roles a
   layer on the kernels, the experts dense; each shard holds 20 of the 40
   experts, the whole embedding: the vocab 49,155 splits over no t > 1),
   the fp32 share on the rows whose routing does not part at a near tie
   (``NEAR_TIE``, as phase 11; every shard routes alike), the guarded
   run's flipped bit in the last layer's last expert's ``moe.w_up`` entry
   on the shard that holds it (the role demoted on every shard, the
   healthy run's tokens), 3 runs a mode in turns (the mesh, eager; one
   device graphed), and on 2:4 a (1, 4) mesh (10 experts a shard).  Then
   ring caches: gemma3-27b at full width cut to ``TP_RING_LAYERS`` (8)
   layers (one 5 local + 1 global period and the 2-layer tail), dense,
   batch 4, a 32-token prompt ingested token by token through the group's
   step, 16 tokens, bf16, on the (1, 2) meshes and a (1, 4) mesh
   repeating ``cuda:0``: greedy agreement with one device printed; at
   fp32 every ingest and decode step's logits along one device's tokens
   within 1e-3 max|logits| of one device's eager step; on the first mesh
   the wrap at the full window (1,024): batch 1, fp32, from one device's
   seeded cache and its KV-head slices, ``TP_WRAP_BEFORE`` (3) positions
   before the wrap to ``TP_WRAP_PAST`` (3) past it, each step within
   1e-3 max|logits| of one device's eager step; ``guarded_generate``
   healthy and with a NaN at a decode position once (retried, the
   healthy run's tokens); 3 runs a mode in turns (the mesh, eager; one
   device graphed) and each shard device's peak GiB.  None of the five
   kernels may launch in this part.

The line before the last is one JSON object describing every kernel (its
launches in phases 5-11, 14, 16 and 17, each counted from zero before the
phase's run; ``families`` holds phase 11's per-model sums);
the last is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
port's sources beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# phase 6: the mixer's stream, and chatglm3-6b's layers serving it: 14 of
# 28 since phase 16 came, when the script took 954 s on an H100 80GB HBM3
# at 700 W (phase 6 158 s of it at 28 layers); 7 since phase 17's MoE
# part came, when it took 808-907 s there (phase 6 70-86 s of it at 14)
MIX_REQUESTS, MIX_SLOTS, MIX_MAX_LEN, MIX_WIDE = 12, 4, 288, 16
MIX_LAYERS = 7
# phase 8: chatglm3-6b's layers (and so phase 10's forwards'): 14 of 28
# since phase 17's MoE part came (phase 8 111-128 s of the runs above at
# 28), and the decode steps a mixer takes in each timed round
GQA_LAYERS, GQA_MIX_STEPS = 14, 4
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
# phase 11: every model the compressed plane serves beside chatglm3-6b:
# (arch, layers on the card, 0 for all of them; the plans it serves).
# granite-moe-3b-a800m keeps 8 of its 32 layers: on an H100 80GB HBM3 at
# 700 W it took 81.2 s of the phase at 32 and 41.6 s at 16; phase 15 needed
# the room, and with phase 16 the script took 856 s there
FAMILIES = (
    ("granite-moe-3b-a800m", 8, ("bitmap", "nm")),
    ("qwen3-moe-30b-a3b", 4, ("bitmap",)),
    ("deepseek-coder-33b", 4, ("bitmap",)),
    ("internlm2-20b", 4, ("bitmap",)),
    ("pixtral-12b", 4, ("bitmap",)),
)
FAMILY_RUNS = 3              # serving runs a mode
# the model of phase 11 that also serves phase 6's stream and a guarded run
# with a flipped expert bit
FAMILY_STREAM = "granite-moe-3b-a800m"
FAMILY_MS = (M_DECODE, MIX_WIDE, M_PREFILL)
# the relative gap between two experts' fp32 gates below which the
# attention kernels' summation order may swap them in a MoE router (a few
# fp32 roundings; phase 11)
NEAR_TIE = 1e-5
# phase 7: chatglm3-6b's layers in the guarded runs (every fault class at
# full width; the depth cut to make room for phase 12)
GUARD_LAYERS = 4
# phase 12: the families the reference serves dense only: (arch, layers on
# the card, 0 for all of them).  gemma3-27b keeps one 5 local + 1 global
# period and the 2-layer tail: at 62 layers its fp32 params (about 108 GB)
# do not fit the card.  recurrentgemma-2b keeps 2 of its 8 periods and the
# tail, mamba2-780m 12 of 48 layers: at full depth they took 49 and 44 s
# on an H100 80GB HBM3 at 700 W; with phase 14 the script took 802 s
# there (then 4 periods and 24 layers), with phase 16 856 s
DENSE_FAMILIES = (("gemma3-27b", 8), ("recurrentgemma-2b", 8),
                  ("mamba2-780m", 12), ("whisper-tiny", 0))
DENSE_RUNS = 3               # serving runs a mode
DENSE_MIXED = ("gemma3-27b", "mamba2-780m")
# the mixer's stream there: requests, shortest and longest prompt, tokens a
# request, max_len
DENSE_MIX = (6, 8, 24, 6, 32)
# the batch-1 fp32 run past a ring's wrap: positions after the window, and
# positions before the wrap from which graph and eager are compared
WRAP_PAST, WRAP_BEFORE = 24, 8
# phase 13: training.  chatglm3-6b keeps 8 of its 28 layers: at 28 its fp32
# params, gradients and two AdamW moments take 16 B for each of about 6.2 G
# params (about 99 GB), more than the card's 80 GB; at 8, about 1.9 G
# params, 30 GB, plus the int8 compression's residual and the step's new
# params and moments.  The checkpoint's round trip writes and reads params
# and both moments: 23 GB at 8 layers, 5.6 GB at 1 (8.1 GB at 2 layers
# took 29 s through npz beside an H100, most of the phase's minute)
TRAIN_LAYERS, TRAIN_CKPT_LAYERS = 8, 1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 10
# phase 14: positions ingested (then as many tokens generated) under
# sparseffn, timed runs a mode, and deepseek-coder-33b's layers under
# padheads (phase 11's cut)
FLAG_INGEST, FLAG_RUNS, FLAG_PAD_LAYERS = 16, 3, 4
# AdamW's rate there (2 warmup steps of 40), the train CLI's default: the
# reference's test takes 1e-3 at d_model 128, which at 4096 moved the loss
# up over 10 steps (11.57 -> 11.81); 1e-4 lowered the mean of the last 5
# by 0.018, 3e-4 by 0.047
TRAIN_LR = 3e-4
# phase 15: the dry run's cells on the single production mesh, (arch,
# shape): a train, a prefill, a decode and a long_500k cell.  mamba2's
# prefill, since a full-attention prefill_32k cell traces 64 x 64 chunk
# pairs a layer (about a minute on a CPU)
DRYRUN_CELLS = (("chatglm3-6b", "train_4k"), ("mamba2-780m", "prefill_32k"),
                ("chatglm3-6b", "decode_32k"), ("mamba2-780m", "long_500k"))
# the share of phase 13's measured peak the dry run's prediction may fall
# short by
PEAK_SHORTFALL = 0.10
# phase 16: chatglm3-6b's layers served over a (2, 1) data mesh, serving
# runs a mode, and the data-parallel training cut (layers, steps; batch
# TRAIN_BATCH x TRAIN_SEQ): two replicas on one card hold two copies of
# the params and the store (about 12 GB a replica at 8 layers).  6 of 28
# layers since phase 17 came, when the script took 774 s on an H100 80GB
# HBM3 at 700 W (phase 16 52.7 s of it at 8 layers)
MESH_LAYERS, MESH_RUNS = 6, 3
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 3
# phase 17: chatglm3-6b's layers served tensor-parallel, and the timed runs
# a mode.  4 of 28 layers since the gemma3 part came: at 8 the script took
# 672 s on an H100 80GB HBM3 at 700 W (phase 17 86.2 s of it), over its
# 600 s aim
TP_LAYERS, TP_RUNS = 4, 3
# phase 17's MoE part: the model and its depth.  4 of 32 layers: at phase
# 11's 8 the part took 43.7 and 49.2 s on an H100 80GB HBM3 at 700 W, over
# its 45 s budget
TP_MOE_ARCH, TP_MOE_LAYERS = "granite-moe-3b-a800m", 4
# phase 17's gemma3 part: the model, its depth (phase 12's cut: one 5 local
# + 1 global period and the 2-layer tail; its 62 layers' fp32 params, about
# 108 GB, do not fit the card, and the shards hold a second copy), its
# prompt, and the batch-1 fp32 steps held to one device around the rings'
# wrap at the full window of 1,024: positions before it and past it
TP_RING_ARCH, TP_RING_LAYERS, TP_RING_PROMPT = "gemma3-27b", 8, 32
TP_WRAP_BEFORE, TP_WRAP_PAST = 3, 3
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
    """Per-kernel accumulation of the kernel-vs-plain cases (phases 3 and
    11); ``sums`` is keyed by (arch, M, x dtype)."""

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
                                           flops=0.0, roles=0))
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["library_ms"] += lib_ms
        s["bytes"] += nbytes
        s["flops"] += flops
        s["roles"] += 1


def _check(name, y, y_plain) -> float:
    import torch
    err = (y - y_plain).abs().max().item()
    scale = y_plain.abs().max().item()
    if not torch.isfinite(y).all() or err > TOL_REL * scale + TOL_ABS:
        _fail(f"{name}: max|y - y_plain| = {err} > {TOL_REL} * {scale} "
              f"+ {TOL_ABS}")
    return err


def _bitmap_case(c) -> tuple:
    """A bitmap-compressed weight's case: ``kernel(x, pipeline)``, its
    plain version ``plain(x)``, the bytes of the stored weight, the
    operations a row of x and the columns of x the kernel reads (the rows
    of its stored blocks)."""
    import torch
    from repro_torch.kernels import ops, ref
    rows_used = int(torch.unique(c.row_ids[:c.nnzb]).numel())
    return (lambda x, p: ops.bitmap_spmm(x, c, pipeline=p),
            lambda x: ref.bitmap_spmm_ref(x, c.blocks, c.counts, c.row_ids,
                                          c.n, c.k),
            c.nnzb * c.bn * c.bk * 4 + (2 * c.counts.numel() + c.nnzb) * 4,
            2.0 * c.nnzb * c.bn * c.bk, rows_used * c.bn)


def _nm_case(c) -> tuple:
    """An N:M-compressed weight's case, as :func:`_bitmap_case`."""
    from repro_torch.kernels import ops, ref
    return (lambda x, p: ops.nm_spmm(x, c, pipeline=p),
            lambda x: ref.nm_spmm_ref(x, c.values, c.indices, c.n_sel,
                                      c.m_group),
            c.values.numel() * 4 + c.indices.numel(),
            2.0 * c.values.numel(), c.n)


def _run_case(acc: dict, key, kname: str, label: str, x, case: tuple,
              w_dense, flush=None, log: bool = True) -> float:
    """Both variants of ``case``'s kernel (:func:`_bitmap_case`,
    :func:`_nm_case`) on the same ``x`` against its plain version: each
    within the tolerance, naive == pipelined; their errors go into
    ``acc``.  Returns the larger error's share of the tolerance.  With
    ``flush`` the case is timed too, beside the plain version and one
    fp32 ``torch.matmul`` with ``w_dense``, and added to ``acc``'s sums
    under ``key`` (None keeps it out of them: a case the serving path does
    not run).  The naive variant computes the same function as the
    pipelined one, so it shares their plain and library times; it is
    timed at bf16 only."""
    import torch
    kernel, plain, nbytes_w, flops_per_row, x_cols = case
    y, y_naive, y_plain = kernel(x, True), kernel(x, False), plain(x)
    torch.cuda.synchronize()
    m, dtype = x.shape[0], x.dtype
    label = f"{label} M={m} {dtype}"
    tol = TOL_REL * y_plain.abs().max().item() + TOL_ABS
    err = _check(f"{kname} {label}", y, y_plain)
    err_naive = _check(f"{kname}_naive {label}", y_naive, y_plain)
    if not torch.equal(y_naive, y):
        _fail(f"{kname} {label}: the naive result differs from the "
              f"pipelined one by {(y_naive - y).abs().max().item()}")
    share = max(err, err_naive) / tol
    if flush is None or dtype != torch.bfloat16:
        a = acc[f"{kname}_naive"]
        a.max_abs_err = max(a.max_abs_err, err_naive)
    if flush is None:
        acc[kname].max_abs_err = max(acc[kname].max_abs_err, err)
        return share
    reps = 10 if m <= M_DECODE else 5
    ms = _time_ms(lambda: kernel(x, True), reps, flush)
    plain_ms = _time_ms(lambda: plain(x), reps, flush)
    lib_ms = _time_ms(lambda: torch.matmul(x.float(), w_dense), reps, flush)
    nbytes = nbytes_w + m * x_cols * x.element_size() + m * y.shape[1] * 4
    flops = flops_per_row * m
    acc[kname].add(key, err, ms, plain_ms, lib_ms, nbytes, flops)
    if log:
        bound, by = _bound_ms(nbytes, flops)
        print(f"[kernels] {kname} {label}: err {err:.3e} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms library {lib_ms:.4f} ms bound "
              f"{bound:.4f} ms ({by}; {bound / ms:.1%} of it reached)")
    if dtype != torch.bfloat16:
        return share
    ms_naive = _time_ms(lambda: kernel(x, False), reps, flush)
    acc[f"{kname}_naive"].add(key, err_naive, ms_naive, plain_ms, lib_ms,
                              nbytes, flops)
    if log:
        print(f"[kernels] {kname}_naive {label}: err {err_naive:.3e} "
              f"kernel {ms_naive:.4f} ms (equal to the pipelined result)")
    return share


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
    from repro_torch.kernels import ops
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

    def held_at_mixer_shapes(kname, label, n, case):
        """Both variants of ``case``'s kernel against its plain version at
        each of the mixer's M, x in fp32 and bf16 (checked, not timed)."""
        worst = 0.0
        for m in mix_ms:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, n), generator=mix_gen,
                                device=dev).to(dtype)
                worst = max(worst, _run_case(acc, None, kname, label, x,
                                             case, None))
        print(f"[kernels] {kname} and {kname}_naive {label} at the mixer's "
              f"M={mix_ms}, x fp32 and bf16: within the tolerance (largest "
              f"share of it {worst:.4f}), naive == pipelined")

    def run(kname, label, n, case, w_dense, main_path):
        """Both variants timed on the same x at the decode and the prefill
        M, x in fp32 and bf16."""
        for m in (M_DECODE, M_PREFILL):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, n), generator=gen, device=dev).to(dtype)
                _run_case(acc, (cfg.name, m, dtype) if main_path else None,
                          kname, label, x, case, w_dense, flush)

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
            nnzb = c.nnzb
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
            label = f"{role.role} ({bn}x{bk} {tag})"
            run("bitmap_spmm", label, role.n, _bitmap_case(c), wp,
                tag == "d0.5")
            if tag == "d0.5":
                held_at_mixer_shapes("bitmap_spmm", label, role.n,
                                     _bitmap_case(c))
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
            label = f"{role.role} ({n_sel}:4)"
            run("nm_spmm", label, role.n, _nm_case(c), wp, n_sel == 2)
            if n_sel == 2:
                held_at_mixer_shapes("nm_spmm", label, role.n, _nm_case(c))
        del w
    acc["bitmap_spmm_naive"].masked = _masked_steps(gen, flush, dev)
    _non_finite_inputs(cfg, dev)
    _partial_row_batch(dev)
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


#: (M, N, n_sel) at K = 4096 whose last slice ends in a partial row batch of
#: the naive decode kernel (NV_ROWS kept rows: 8 at M <= 4, 4 above)
PARTIAL_BATCH_CASES = tuple((m, 4104, 2) for m in (1, 2, 3, 4)) + \
    tuple((m, 4100, 2) for m in (8, 16)) + \
    tuple((m, 4112, 1) for m in (1, 2, 4)) + \
    tuple((m, 4104, 1) for m in (8, 16))


def _partial_row_batch(dev) -> None:
    """Phase 3: kernel 4's masked tail groups.  At each of
    ``PARTIAL_BATCH_CASES``, x fp32 and bf16, +Inf in x's last column (the
    last group of the last slice, whose batch the kernel fills with masked
    groups) and, above M = 1, NaN in the last row: the naive kernel must
    equal the pipelined one (NaN for NaN, the rest bit for bit) and give
    the plain version's NaN / +-Inf masks, its Inf outputs included."""
    import torch
    from repro_torch.kernels import nm_spmm as nm_cuda
    from repro_torch.kernels import ops, ref
    k = 4096
    gen = torch.Generator(device=dev).manual_seed(12)
    infs = 0
    for m, n, n_sel in PARTIAL_BATCH_CASES:
        slices, length = nm_cuda.split_plan(m, n, k, n_sel, 4)
        last = n // 4 - (slices - 1) * length
        if not last % ((8 if m <= 4 else 4) // n_sel):
            _fail(f"nm_spmm M={m} N={n} {n_sel}:4: no partial row batch")
        c = ops.compress_nm(torch.randn((n, k), generator=gen, device=dev),
                            n_sel, 4)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, n), generator=gen, device=dev)
            x[:, n - 1] = float("inf")
            if m > 1:
                x[m - 1, 1] = float("nan")
            x = x.to(dtype)
            case = f"M={m} N={n} {n_sel}:4 {str(dtype)[6:]} partial batch"
            y4 = ops.nm_spmm(x, c, pipeline=False)
            _held_non_finite(f"nm_spmm_naive {case} vs pipelined", y4,
                             ops.nm_spmm(x, c, pipeline=True), True)
            want = ref.nm_spmm_ref(x, c.values, c.indices, n_sel, 4)
            _held_non_finite(f"nm_spmm_naive {case} vs plain", y4, want,
                             False)
            if not torch.isinf(want).any():
                _fail(f"nm_spmm {case}: the plain version gives no Inf")
            infs += int(torch.isinf(want).sum())
    print(f"[kernels] kernel 4's masked tail: at K={k}, "
          f"{len(PARTIAL_BATCH_CASES)} (M, N, n_sel) whose last slice ends "
          f"in a partial row batch, x fp32 and bf16, +Inf in the last "
          f"column: naive == pipelined (equal_nan, finite bit for bit) == "
          f"plain in NaN / +-Inf masks ({infs} Inf outputs)")

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
    served kernel (kernel roles a layer: 7, or 4 for MoE) x layers x
    (admissions + decode steps) times and no other kernel.  ``capturing``: the stream's first step captures a
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
    per_layer = len(_kernel_roles(cm.cfg))
    want = per_layer * cm.cfg.n_layers * (st["admits"] + st["steps"])
    if st["admits"] != len(reqs) or st["evictions"] != len(reqs) or \
            st["tokens"] != sum(r.max_new for r in reqs):
        _fail(f"{label}: stream accounting {st}")
    if counts[name] != want or sum(counts.values()) != want:
        _fail(f"{label}: launch counts {counts}, expected {want} launches "
              f"of {name} only ({per_layer} * {cm.cfg.n_layers} * "
              f"({st['admits']} admissions + {st['steps']} steps))")
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
             if k[0] == slots and k[2:5] == (1, dtype, pipeline)
             and all(shape[2] == MIX_MAX_LEN for shape, _ in k[1])]
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
    """The snapshot's series less :data:`TIMING_SERIES` and the memo
    registry's (``memo_*``: they count every search the process ran)."""
    return {k for part in ("counters", "gauges", "histograms")
            for k in snap[part]
            if k.split("{")[0] not in TIMING_SERIES
            and not k.startswith("memo_")}


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


def phase_gqagroup(cfg, card: str, dev, then=None) -> dict[str, int]:
    """Phases 8 and 9's overhead rows, on one build of each shipped plan
    at full width: ``gqagroup`` (``_gqagroup_decode``,
    ``_gqagroup_mixer``) and the telemetry overhead
    (``_telemetry_overhead``); ``then(kind, cm, pruned, prompts)`` runs on
    each plan's model before it is deleted (phase 10's instrumented
    forwards, so ``compress_params`` is not paid again).  Returns the
    flagged graphed runs' launches, by kernel."""
    import torch
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    launches = {}
    reqs = _mixer_requests(cfg)
    print(f"[gqagroup] chatglm3-6b at full width ({cfg.n_heads} heads, "
          f"{cfg.n_kv_heads} KV heads), {cfg.n_layers} layers, batch "
          f"{BATCH}, prompt {PROMPT}, "
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
        if then is not None:
            then(kind, cm, pruned, prompts)
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
        memo = [k for k in snap["counters"] if k.startswith("memo_")]
        if not memo:
            _fail(f"telemetry {label}: no memo_* series although the CLI "
                  f"searched its plan")
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
              f"stable), metrics {len(got)} series (+ {len(memo)} memo), "
              f"{len(prom)} Prometheus "
              f"samples, all parsed; kernel_dispatch_total{{kind={kind}}} "
              f"= {dispatched:.0f} = the {ran} launches of {name} = the "
              f"trace's kernel:{kind} events; series as expected")
    return launches


def _calibration_forwards(cfg, kind: str, kname: str, cm, pruned, prompts,
                          card: str, dev) -> dict:
    """Phase 10's forwards, on phase 8's compressed model of ``kind``'s
    shipped plan: one prefill of the batch (M = BATCH x PROMPT) and one eager
    decode step of it (M = BATCH), each under ``instrument()`` with the
    pipelined kernels; the decode step once more with the naive kernels,
    whose counters must equal the pipelined ones'.  Returns the counters
    by M and the launches, by kernel, counted from zero."""
    import torch
    from repro_torch.exec.dispatch import instrument
    from repro_torch.kernels import ops
    layer_calls = 7 * cfg.n_layers
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with instrument() as pre:
        logits, cache = cm.prefill(pruned, prompts, PROMPT + 1)
    tok = logits[:, -1].argmax(dim=-1)
    pos = torch.tensor(PROMPT, device=dev)
    with instrument() as dec:
        cm.decode_step(pruned, cache, tok, pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    with ops.pipeline_default(False), instrument() as naive:
        cm.decode_step(pruned, cache, tok, pos)
    torch.cuda.synchronize()
    naive_counts = ops.launch_counts()
    if counts[kname] != 2 * layer_calls or sum(counts.values()) != \
            2 * layer_calls or naive_counts[f"{kname}_naive"] != \
            layer_calls or sum(naive_counts.values()) != layer_calls:
        _fail(f"calibration forwards {kind}: launches {counts}, naive "
              f"{naive_counts}; expected {2 * layer_calls} of {kname} and "
              f"{layer_calls} of {kname}_naive")
    roles = {op.role for op in cm.store.plan.ops}
    for m, c in ((M_PREFILL, pre), (M_DECODE, dec)):
        if set(c) != roles or {x.calls for x in c.values()} != \
                {cfg.n_layers}:
            _fail(f"calibration forwards {kind} M={m}: counters for "
                  f"{sorted(c)} with calls {[x.calls for x in c.values()]}")
    bad = [r for r in dec
           if (dec[r].w_fetch_bits, dec[r].w_stream_bits)
           != (naive[r].w_fetch_bits, naive[r].w_stream_bits)]
    if bad:
        _fail(f"calibration forwards {kind}: naive counters differ at {bad}")
    print(f"[search {kind}] instrumented forwards on phase 8's model: "
          f"prefill M={M_PREFILL} + one eager decode step M={M_DECODE} in "
          f"{wall:.3f} s, {counts[kname]} launches of {kname}; the decode "
          f"step naive: {layer_calls} launches of {kname}_naive, counters "
          f"equal; refetch factor at M={M_PREFILL}: "
          + ", ".join(f"{r} {pre[r].refetch_factor:g}" for r in sorted(pre))
          + f"; on {card}")
    launches = dict(counts)
    launches[f"{kname}_naive"] = naive_counts[f"{kname}_naive"]
    return {"counters": {M_DECODE: dec, M_PREFILL: pre},
            "launches": launches}


def phase_search(cfg, card: str, forwards: dict) -> None:
    """Phase 10: the port's own search at full width under both sparsity
    models with the serve CLI's settings, cold (memo cleared) and warm;
    each plan's JSON must be the shipped one.  Then ``calibrate`` on each
    set of phase 8's counters (``forwards``: by kind, by M), re-searching
    under the CLI's budget: the fit, its errors and the drift printed; the
    M = 4 bitmap fit inside the reference's bounds; every fitted number
    finite and positive; the calibrated plan through JSON and back, its
    hardware resolved."""
    from repro_torch.core import memo
    from repro_torch.exec import ExecPlan, calibrate
    from repro_torch.exec.plans import PLANS_DIR
    from repro_torch.launch import serve
    plans = {}
    for kind in ("bitmap", "nm"):
        sp = serve.PLAN_SPARSITY[kind]
        memo.clear()
        t0 = time.perf_counter()
        plan = serve._fast_plan(cfg, 64, sp)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = serve._fast_plan(cfg, 64, sp)
        warm = time.perf_counter() - t0
        shipped = (PLANS_DIR / f"{cfg.name}.{kind}.json").read_text()
        if plan.to_json() != shipped.rstrip("\n") or \
                again.to_json() != plan.to_json():
            _fail(f"search {kind}: the port's plan is not "
                  f"plans/{cfg.name}.{kind}.json")
        plans[kind] = plan
        print(f"[search {kind}] {cfg.name} full width ({cfg.n_layers} "
              f"layers, d_model {cfg.d_model}) under {sp}, tokens 64, "
              f"value_bits 32: the port's search {cold:.4f} s cold (memo "
              f"cleared), {warm:.4f} s warm, host clock; "
              f"{plan.search.evaluations} evaluations; JSON equal to "
              f"plans/{cfg.name}.{kind}.json byte for byte; on {card}")
    for kind in ("bitmap", "nm"):
        for m, counters in sorted(forwards[kind]["counters"].items()):
            t0 = time.perf_counter()
            rep = calibrate(cfg, plans[kind], counters,
                            search_cfg=serve.FAST_SEARCH)
            secs = time.perf_counter() - t0
            fitted = {"scale": rep.scale, "glb_scale": rep.glb_scale,
                      "energy_scale": rep.calibrated_plan.energy_scale,
                      "glb_energy_scale":
                          rep.calibrated_plan.glb_energy_scale,
                      "baseline_energy": rep.baseline_energy,
                      "calibrated_energy": rep.calibrated_energy}
            bad = {k: v for k, v in fitted.items()
                   if not (math.isfinite(v) and v > 0)}
            errs = (rep.max_rel_err, rep.max_residual, rep.energy_drift,
                    rep.max_stream_rel_err, rep.max_refetch_residual)
            if bad or not all(math.isfinite(x) for x in errs):
                _fail(f"calibrate {kind} M={m}: not finite and positive: "
                      f"{bad}, errors {errs}")
            loaded = ExecPlan.from_json(rep.calibrated_plan.to_json())
            hw = loaded.hardware()
            if loaded != rep.calibrated_plan or \
                    hw != rep.calibrated_plan.hardware() or \
                    not hw.name.startswith(plans[kind].arch):
                _fail(f"calibrate {kind} M={m}: the calibrated plan does "
                      f"not round-trip ({hw.name})")
            if kind == "bitmap" and m == M_DECODE and not (
                    0.9 < rep.scale < 1.1 and rep.max_residual < 0.05):
                _fail(f"calibrate bitmap M={m}: scale {rep.scale!r}, "
                      f"max_residual {rep.max_residual!r} outside (0.9, "
                      f"1.1) and < 0.05")
            print(f"[search {kind}] calibrate M={m}: scale {rep.scale!r} "
                  f"glb_scale {rep.glb_scale!r} max_rel_err "
                  f"{rep.max_rel_err!r} max_residual {rep.max_residual!r} "
                  f"energy_drift {rep.energy_drift!r} max_stream_rel_err "
                  f"{rep.max_stream_rel_err!r} kinds_changed "
                  f"{rep.kinds_changed or 'none'}; {secs:.4f} s with the "
                  f"re-search, host clock; calibrated plan round-trips, "
                  f"hardware {hw.name}; counters from {card}")


# ---------------------------------------------------------------------------
# Phase 11: every model the compressed plane serves
# ---------------------------------------------------------------------------

def _kernel_roles(cfg) -> list:
    """The projection roles a plan dispatches to a kernel: every role but
    the MoE experts, which run dense inside the MoE block (seven a dense
    or vlm layer, four a MoE one)."""
    return [r for r in cfg.matmul_roles() if not r.role.startswith("moe.")]


@contextlib.contextmanager
def _routes(out: list):
    """Record every MoE block's routing while the context is open: per
    call, the experts the block routes each (group, token) to, in slot
    order, and the fp32 gates it chose them by (``models.moe._route``'s
    own results)."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod._route

    def recorded(xg, p, cfg):
        gates, topw, tope = route(xg, p, cfg)
        out.append((tope, gates))
        return gates, topw, tope

    moe_mod._route = recorded
    try:
        yield
    finally:
        moe_mod._route = route


def _held_rows(label: str, lc, ld, routes_c: list, routes_d: list):
    """fp32 prefill logits of the compressed model ``lc`` against the
    dense model's ``ld`` on the same pruned weights, row by row, within
    1e-3 max|ld|.  A MoE router whose fp32 gates tie to within a few
    roundings can pick another expert when the attention kernels'
    summation order moves its input by an ulp; the two runs then compute
    different functions of that row (its routing group) from there on.
    Such a row is left out of the comparison and printed if, at the first
    layer where its routing parts, every expert that changed slot lies
    within ``NEAR_TIE`` of the expert the dense run put there, in the
    dense run's gates, relative to the larger of the two; a wider gap
    fails, and at least one row must be held.  Returns (the largest share
    of the bound, held rows, parted rows: row -> (layer, token, gap))."""
    import torch
    b, s, _ = ld.shape
    if len(routes_c) != len(routes_d):
        _fail(f"{label}: {len(routes_c)} MoE blocks ran compressed, "
              f"{len(routes_d)} dense")
    parted: dict[int, tuple] = {}
    for layer, ((ic, _), (idn, gd)) in enumerate(zip(routes_c, routes_d)):
        if ic.shape[:2] != (b, s):
            _fail(f"{label}: a routing group is not one row ({ic.shape})")
        here: dict[int, tuple] = {}
        for g, t in (ic != idn).any(-1).nonzero().tolist():
            if g in parted:              # parted at an earlier layer
                continue
            moved = ic[g, t] != idn[g, t]
            was, now = gd[g, t, idn[g, t][moved]], gd[g, t, ic[g, t][moved]]
            gap = ((was - now).abs() / torch.maximum(was, now)).max().item()
            if gap > NEAR_TIE:
                _fail(f"{label}: row {g} routes token {t} at layer {layer} "
                      f"to experts {ic[g, t].tolist()} where the dense run "
                      f"takes {idn[g, t].tolist()}, whose gates lie "
                      f"{gap:.3e} apart (> {NEAR_TIE})")
            if gap > here.get(g, (0, 0, -1.0))[2]:
                here[g] = (layer, t, gap)
        parted.update(here)
    held = [r for r in range(b) if r not in parted]
    if not held:
        _fail(f"{label}: every row's routing parts: {parted}")
    scale = ld.abs().max().item()
    err = max((lc[r] - ld[r]).abs().max().item() for r in held)
    if not err <= 1e-3 * scale:
        _fail(f"{label}: fp32 compressed logits differ from dense by {err} "
              f"> 1e-3 * {scale} (rows {held})")
    return err / (1e-3 * scale), held, parted


def _family_kernels(cfg, store, pruned, card: str, dev, acc: dict) -> None:
    """Both variants of both sparse kernels against their plain versions
    at each kernel role of ``cfg`` (the served store's layer-0 entry for
    the plan's kernel; the layer's pruned weight pruned 2:4 for the other;
    the library multiplies the dense weight of the same function), M =
    4, 16 and 512, x fp32 and bf16 (:func:`_run_case`); each role timed
    at M = 4 and 512, bf16, into ``acc``'s sums under (arch, M, bf16)."""
    import torch
    from repro_torch.exec.compress import _layer_weight
    from repro_torch.kernels import ops
    from repro_torch.sparse import masks
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    worst = 0.0
    for role in _kernel_roles(cfg):
        w = _layer_weight(pruned, 0, role.role, -1)
        entry = store.get(0, role.role)
        wn = masks.nm_prune(w, 2, 4)
        cases = {"nm_spmm": (_nm_case(entry.data if entry.kind == "nm"
                                      else ops.compress_nm(wn, 2, 4)), wn)}
        if entry.kind == "bitmap":
            cases["bitmap_spmm"] = (_bitmap_case(entry.data), w)
        for kname, (case, w_dense) in cases.items():
            for m in FAMILY_MS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, role.n), generator=gen,
                                    device=dev).to(dtype)
                    timed = dtype == torch.bfloat16 and m != MIX_WIDE
                    worst = max(worst, _run_case(
                        acc, (cfg.name, m, dtype), kname,
                        f"{cfg.name} {role.role}", x, case, w_dense,
                        flush if timed else None, log=False))
        del w, wn, cases
    print(f"[family {cfg.name}] both sparse kernels, both variants, at "
          f"{len(_kernel_roles(cfg))} roles x M={list(FAMILY_MS)} x fp32 / "
          f"bf16: within the tolerance (largest share of it {worst:.4f}), "
          f"naive == pipelined")
    for name, a in acc.items():
        for (arch, m, dtype), s in sorted(
                ((k, s) for k, s in a.sums.items() if k[0] == cfg.name),
                key=lambda ks: ks[0][1]):
            bound, by = _bound_ms(s["bytes"], s["flops"])
            print(f"[family {cfg.name}] {name} M={m} x bf16, {s['roles']} "
                  f"roles summed: kernel {s['ms']:.4f} ms, plain "
                  f"{s['plain_ms']:.4f} ms, library {s['library_ms']:.4f} "
                  f"ms, bound {bound:.4f} ms ({by}; {bound / s['ms']:.1%} "
                  f"of it reached), on {card}")


def _family_serving(cfg, cm, pruned, kind: str, card: str, dev,
                    launches: dict) -> "torch.Tensor":
    """Phase 11's serving checks of one compressed model (see
    :func:`phase_families`); returns the greedy tokens."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    kname = "bitmap_spmm" if kind == "bitmap" else "nm_spmm"
    per_layer = len(_kernel_roles(cfg))
    expected = per_layer * cfg.n_layers * (1 + GEN)
    label = f"{cfg.name} {kind}"
    pg = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                            device=dev)

    def run(name, count=False):
        """One counted ``generate`` (its launches added to ``launches``
        with ``count``): tokens, prefill ms, decode ms/token."""
        ops.reset_launch_counts()
        toks, t_prefill, t_gen = cm.generate(pruned, prompts, GEN,
                                             device=dev)
        counts = ops.launch_counts()
        if counts[name] != expected or sum(counts.values()) != expected:
            _fail(f"{label} {name}: launch counts {counts}, expected "
                  f"{expected} of {name} only ({per_layer} x "
                  f"{cfg.n_layers} x (1 + {GEN}))")
        if count:
            launches[name] = launches.get(name, 0) + counts[name]
        return toks, 1e3 * t_prefill, 1e3 * t_gen / GEN

    # prefill, the first decode step, the capture, then replays
    toks, _, capture_step = run(kname, count=True)
    if toks.shape != (BATCH, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        _fail(f"{label}: tokens out of range: {toks.tolist()}")
    times = {"graph": ([], []), "eager": ([], [])}
    for _ in range(FAMILY_RUNS):
        for mode in ("graph", "eager"):
            with compiled.disable() if mode == "eager" \
                    else contextlib.nullcontext():
                out = run(kname)
            if not torch.equal(out[0], toks):
                _fail(f"{label} {mode}: tokens {out[0].tolist()} differ "
                      f"from {toks.tolist()}")
            times[mode][0].append(out[1])
            times[mode][1].append(out[2])
    for mode, (pre, dec) in times.items():
        print(f"[family {label} {mode}] over {FAMILY_RUNS} runs: prefill ms "
              f"{_spread(pre)}; decode ms/token {_spread(dec)} (the "
              f"capturing run {capture_step:.3f}); {expected} launches of "
              f"{kname} a run ({per_layer} x {cfg.n_layers} x (1 + {GEN})), "
              f"none of any other kernel — bf16, on {card}")
    with ops.pipeline_default(False):
        toks_n, _, _ = run(f"{kname}_naive", count=True)
    if not torch.equal(toks_n, toks):
        _fail(f"{label} naive: tokens {toks_n.tolist()} differ from the "
              f"pipelined run's {toks.tolist()}")
    _graph_equals_eager(cm, pruned, prompts, f"{label} bf16")
    print(f"[family {label}] naive kernels: tokens equal, {expected} "
          f"launches of {kname}_naive")

    # fp32: compressed against the dense model on the same pruned weights
    L.COMPUTE_DTYPE = torch.float32
    try:
        dense = Model(cfg)
        rc, rd = [], []
        with _routes(rc):
            lc, _ = cm.prefill(pruned, prompts, PROMPT)
        with _routes(rd):
            ld, _ = dense.prefill(pruned, prompts, PROMPT)
        share, held, parted = _held_rows(f"{label} fp32", lc, ld, rc, rd)
        agree = (lc.argmax(-1) == ld.argmax(-1)).float().mean().item()
        del lc, ld, rc, rd
        tc, _, _ = cm.generate(pruned, prompts, GEN, device=dev)
        td, _, _ = serve.generate(dense, pruned, prompts, GEN, PROMPT + GEN,
                                  device=dev)
        tok_agree = (tc == td).float().mean().item()
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    print(f"[family {label}] fp32 compressed vs dense prefill logits: "
          f"{share:.4f} of the bound 1e-3 max|logits| on rows {held}"
          f"{f'; rows whose routing parts at a near tie (row: layer, token, gap): {parted}' if parted else ''}; "
          f"greedy agreement: prefill argmax {agree:.4f}, generated tokens "
          f"{tok_agree:.4f}")
    return toks, prompts


def _family_mixer(cfg, cm, pruned, card: str, launches: dict) -> None:
    """granite: phase 6's stream (12 requests, 4 slots) graphed, eager and
    graphed again, pipelined and naive: every request's tokens equal."""
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled
    reqs = _mixer_requests(cfg)
    first = None
    for pipeline in (True, False):
        name = "bitmap_spmm" if pipeline else "bitmap_spmm_naive"
        label = f"{cfg.name} bitmap{'' if pipeline else ' naive'}"
        with ops.pipeline_default(pipeline):
            runs = [_serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                  f"{label} graph", card, capturing=True)]
            with compiled.disable():
                runs.append(_serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                          f"{label} eager", card))
            runs.append(_serve_stream(cm, pruned, reqs, MIX_SLOTS, name,
                                      f"{label} graph, second stream", card))
        launches[name] = launches.get(name, 0) + runs[0]["launches"]
        first = first or runs[0]["tokens"]
        for run in runs:
            for i, (a, b) in enumerate(zip(first, run["tokens"])):
                if not (a == b).all():
                    _fail(f"{label}: request m{i} tokens {b.tolist()} "
                          f"differ from {a.tolist()}")
        print(f"[family {label} mixer] tokens of all {MIX_REQUESTS} requests "
              f"equal: graph == eager == second graph"
              f"{'' if pipeline else ' == the pipelined variant'}")


def _family_guarded(cfg, cm, pruned, toks, prompts, card: str, dev,
                    launches: dict) -> None:
    """granite: one bit flipped in the last layer's last expert's
    ``moe.w_up`` entry: ``verify`` names the role, the guard demotes it
    (its expert entries go), and the tokens are the healthy run's: the
    experts run dense either way."""
    import torch
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime import inject
    role, layer, expert = "moe.w_up", cfg.n_layers - 1, cfg.moe.n_experts - 1
    bad = CompressedModel(cm.model, inject.bitflip_payload(
        cm.store, role, layer=layer, expert=expert))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got, _, _, rep = serve.generate(bad, pruned, prompts, GEN, PROMPT + GEN,
                                    guarded=True, device=dev)
    launches["bitmap_spmm"] += ops.launch_counts()["bitmap_spmm"]
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = len(_kernel_roles(cfg)) * cfg.n_layers * (1 + GEN)
    others = {r: s for r, s in rep.verify.items() if r != role}
    if rep.verify.get(role) != "checksum_mismatch" or \
            set(others.values()) != {"ok"} or \
            [(f["role"], f["code"]) for f in rep.fallbacks] != \
            [(role, "integrity_violation")] or not torch.equal(got, toks) \
            or counts["bitmap_spmm"] != want or sum(counts.values()) != want:
        _fail(f"{cfg.name} guarded expert bit flip: verify {rep.verify}, "
              f"fallbacks {rep.fallbacks}, tokens "
              f"{'equal' if torch.equal(got, toks) else 'differ'}, "
              f"launches {counts}")
    print(f"[family {cfg.name} guarded] one bit flipped in layer {layer} "
          f"expert {expert}'s {role} entry: verify says checksum_mismatch "
          f"for {role} (every other role ok), the role is demoted "
          f"(integrity_violation), tokens torch.equal to the healthy run's, "
          f"{want} launches of bitmap_spmm; {wall:.3f} s, verify included, "
          f"on {card}")


def _family(arch: str, layers: int, kinds: tuple, card: str, dev,
            acc: dict, launches: dict) -> None:
    """Phase 11 on one model (see :func:`phase_families`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.exec.compress import compress_params, prune_params
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers) if layers else full
    fp32_gb = 4 * full.params_count() / 1e9
    cut = (f"{layers} of {full.n_layers} layers (all {full.n_layers}: "
           f"{fp32_gb:.1f} GB of fp32 params, more than the card's 80 GB "
           f"beside a pruned copy and its store)" if layers
           else f"all {full.n_layers} layers")
    print(f"[family {arch}] family {cfg.family}, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads} x {cfg.head_dim} (kv {cfg.n_kv_heads}), "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f"{f', {cfg.moe.n_experts} experts, top {cfg.moe.top_k}' if cfg.moe else ''}"
          f"; full width, {cut}; plans {list(kinds)}; seeded random weights")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    for kind in kinds:
        t0 = time.perf_counter()
        plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind])
        t_search = time.perf_counter() - t0
        want = serve._fast_plan(full, 64, serve.PLAN_SPARSITY[kind])
        if [op.choice for op in plan.ops] != \
                [op.choice for op in want.ops] or \
                {op.choice.kind for op in plan.ops} != {kind}:
            _fail(f"{arch} {kind}: the cut config's plan chooses "
                  f"{[op.choice for op in plan.ops]}, the full config's "
                  f"{[op.choice for op in want.ops]}")
        t0 = time.perf_counter()
        pruned = prune_params(params, plan, cfg)
        torch.cuda.synchronize()
        t_prune = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = compress_params(pruned, plan, cfg)
        torch.cuda.synchronize()
        t_compress = time.perf_counter() - t0
        cm = CompressedModel(Model(cfg), store)
        experts = sum(1 for e in store if e.expert >= 0)
        print(f"[family {arch} {kind}] init {t_init:.2f} s, search "
              f"{t_search:.3f} s (the same choices as the full config's "
              f"search), prune {t_prune:.2f} s, compress {t_compress:.2f} s "
              f"(one checksum pass included); {len(store.entries)} entries "
              f"({experts} expert entries), store ratio "
              f"{store.achieved_ratio():.7f}; blocks "
              f"{[(op.role, op.choice.block_n, op.choice.block_k) for op in plan.ops] if kind == 'bitmap' else '2:4'}")
        if kind == kinds[0]:
            _family_kernels(cfg, store, pruned, card, dev, acc)
        toks, prompts = _family_serving(cfg, cm, pruned, kind, card, dev,
                                        launches)
        if arch == FAMILY_STREAM and kind == "bitmap":
            _family_mixer(cfg, cm, pruned, card, launches)
            _family_guarded(cfg, cm, pruned, toks, prompts, card, dev,
                            launches)
        print(f"[family {arch} {kind}] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del cm, store, pruned


def phase_families(card: str, dev, acc: dict) -> dict[str, int]:
    """Phase 11: every model the compressed plane serves beside
    chatglm3-6b (see the module docstring); its kernel cases go into
    phase 3's ``acc``.  Returns kernel -> launches: each model and plan's
    capturing ``generate`` and its naive one, granite's capturing mixer
    streams and its guarded run."""
    import gc
    import torch
    print(f"[family] batch {BATCH}, prompt {PROMPT}, {GEN} tokens, bf16 "
          f"unless named, {FAMILY_RUNS} runs a mode in turns; kernels' "
          f"sums over the roles a plan dispatches (7 a dense layer, 4 a "
          f"MoE one: the experts run dense), on {card}")
    launches: dict[str, int] = {}
    print(f"[family] no new kernel instance: the shapes below run the "
          f"instances phase 2 built and checked for spills")
    t_all = time.perf_counter()
    for arch, layers, kinds in FAMILIES:
        t0 = time.perf_counter()
        _family(arch, layers, kinds, card, dev, acc, launches)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[family {arch}] {time.perf_counter() - t0:.1f} s; after the "
              f"model is deleted: {torch.cuda.memory_allocated() / 2**30:.2f} "
              f"GiB allocated")
    print(f"[family] phase 11 took {time.perf_counter() - t_all:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the families the reference serves dense only
# ---------------------------------------------------------------------------

def _dense_runs(model, params, prompts, label: str, card: str):
    """``serve.generate`` once to capture, then graphed and eager in turns,
    ``DENSE_RUNS`` each.  The capturing run and the first eager one keep
    every step's logits (token ingest included), which must be
    ``torch.equal`` (graph == eager); every run's tokens must equal the
    first's.  Returns them."""
    import torch
    from repro_torch.launch import compiled, serve
    log: list = []

    class Recorded(compiled.CompiledStep):
        def __call__(self, *args):
            logits, cache = super().__call__(*args)
            log.append(logits.clone())
            return logits, cache

    def run(graphed: bool, record: bool = False):
        plain = serve.CompiledStep
        log.clear()
        if record:
            serve.CompiledStep = Recorded
        try:
            with contextlib.nullcontext() if graphed \
                    else compiled.disable():
                toks, t_ingest, t_gen = serve.generate(
                    model, params, prompts, GEN, PROMPT + GEN,
                    device=prompts.device)
        finally:
            serve.CompiledStep = plain
        return toks, 1e3 * t_ingest / PROMPT, 1e3 * t_gen / GEN, list(log)

    toks, _, _, steps = run(True, record=True)
    times = {True: ([], []), False: ([], [])}
    for r in range(DENSE_RUNS):
        for graphed in (True, False):
            got, i_ms, d_ms, steps_e = run(graphed, record=not graphed
                                           and r == 0)
            if not torch.equal(got, toks):
                _fail(f"{label} graphed={graphed}: tokens {got.tolist()} "
                      f"against the first run's {toks.tolist()}")
            if steps_e:
                for i, (lg, lg_e) in enumerate(zip(steps, steps_e)):
                    if not torch.equal(lg, lg_e):
                        _fail(f"{label}: step {i}'s logits differ between "
                              f"graph and eager by "
                              f"{(lg - lg_e).abs().max().item()}")
                if len(steps) != len(steps_e) or not steps:
                    _fail(f"{label}: {len(steps)} graphed steps recorded, "
                          f"{len(steps_e)} eager")
            times[graphed][0].append(i_ms)
            times[graphed][1].append(d_ms)
    held = list(compiled.graphs(model).values())
    print(f"[dense {label}] graph == eager: tokens and the logits of all "
          f"{len(steps)} steps ({PROMPT} ingest, {GEN} decode) torch.equal; "
          f"{len(held)} graph(s), ingest and decode at one key: "
          + ", ".join(f"capture {g.capture_ms:.3f} ms, {g.replays} replays"
                      for g in held))
    for graphed in (True, False):
        ing, dec = times[graphed]
        print(f"[dense {label} {'graphed' if graphed else 'eager'}] over "
              f"{DENSE_RUNS} runs: ingest ms/token {_spread(ing)}; decode "
              f"ms/token {_spread(dec)} — bf16, batch {BATCH}, prompt "
              f"{PROMPT} ingested token by token, {GEN} tokens, on {card}")
    return toks


def _teacher_forced(model, params, seq, at: slice):
    """fp32 logits of the full-sequence forward at positions ``at``."""
    import torch
    from repro_torch.models import layers as L
    x = model.hidden_states(params, seq)[:, at]
    return torch.matmul(x, params["embed"].to(L.COMPUTE_DTYPE).t()).float()


def _held_fp32(label: str, steps: list, want, first: int) -> float:
    """Each step's logits (positions ``first``...) against the
    teacher-forced ones, within 1e-3 max|want|; returns the worst share."""
    worst = 0.0
    scale = float(want.abs().max())
    for i, got in enumerate(steps):
        err = float((got - want[:, i]).abs().max())
        worst = max(worst, err / scale)
        if err > 1e-3 * scale:
            _fail(f"{label}: position {first + i}: max|decode - teacher "
                  f"forced| = {err} > 1e-3 * {scale}")
    return worst


def _dense_fp32(cfg, model, params, prompts, label: str) -> None:
    """fp32, TF32 off: every ingest and decode step's logits (graphed)
    against the teacher-forced forward over the same tokens."""
    import torch
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    prev = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        toks, steps = compiled.greedy(compiled.CompiledStep(model), model,
                                      params, prompts, GEN)
        seq = torch.cat([prompts, toks[:, :GEN - 1]], dim=1)
        want = _teacher_forced(model, params, seq, slice(None))
        worst = _held_fp32(f"{label} fp32", steps, want, 0)
    finally:
        L.COMPUTE_DTYPE = prev
    print(f"[dense {label} fp32] all {len(steps)} steps ({PROMPT} ingest, "
          f"{GEN - 1} decode; graphed) within {worst:.3e} max|logits| of "
          f"the teacher-forced forward (bound 1e-3)")


def _dense_wrap(cfg, model, params, label: str, dev) -> None:
    """Batch 1, fp32, TF32 off: ``WRAP_PAST`` positions past the full
    window, graphed.  From ``WRAP_BEFORE`` positions before the wrap the
    eager step replays the same tokens from a copy of the graph's cache
    (graph == eager, ``torch.equal``), and every step's logits there meet
    the teacher-forced forward's within 1e-3 max|logits|."""
    import torch
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    prev = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        win, n = cfg.window, cfg.window + WRAP_PAST
        first = win - WRAP_BEFORE
        pg = torch.Generator(device=dev).manual_seed(5)
        seq = torch.randint(0, cfg.vocab, (1, n), generator=pg, device=dev)
        step = compiled.CompiledStep(model)
        cache = model.init_cache(1, n, device=dev)
        pos = torch.empty((), dtype=torch.long, device=dev)
        kept, snapshot = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            if t == first:
                snapshot = model.init_cache(1, n, device=dev)
                for dst, src in zip(compiled.leaves(snapshot),
                                    compiled.leaves(cache)):
                    dst.copy_(src)
            logits, cache = step(params, cache, seq[:, t], pos.fill_(t))
            if t >= first:
                kept.append(logits.clone())
        torch.cuda.synchronize()
        t_graph = time.perf_counter() - t0
        ring = [t.shape[2] for t in compiled.leaves(cache) if t.ndim == 5
                and t.shape[2] == win]
        if not ring:
            _fail(f"{label} wrap: no cache leaf is a ring of {win}")
        eager = snapshot
        for i, t in enumerate(range(first, n)):
            lg, eager = model.decode_step(params, eager, seq[:, t],
                                          pos.fill_(t))
            if not torch.equal(lg, kept[i]):
                _fail(f"{label} wrap: position {t}: graph and eager differ "
                      f"by {(lg - kept[i]).abs().max().item()}")
        want = _teacher_forced(model, params, seq, slice(first, n))
        worst = _held_fp32(f"{label} wrap", kept, want, first)
    finally:
        L.COMPUTE_DTYPE = prev
    print(f"[dense {label} wrap] batch 1, fp32: {n} positions through the "
          f"graph in {t_graph:.2f} s ({1e3 * t_graph / n:.3f} ms/step), "
          f"the rings of {win} wrapped {WRAP_PAST} positions ago; "
          f"positions {first}..{n - 1}: graph == eager (torch.equal, the "
          f"eager step from a copy of the graph's cache) and within "
          f"{worst:.3e} max|logits| of the teacher-forced forward")


def _dense_mixer(cfg, model, params, label: str, card: str) -> None:
    """A stream of ``DENSE_MIX[0]`` requests over 4 slots, admitted by
    batch-1 token ingest through a graph, graphed and eager: equal
    tokens."""
    import numpy as np
    import torch
    from repro_torch.launch import compiled
    from repro_torch.launch.mixer import Mixer, Request
    n_req, lo, hi, max_new, max_len = DENSE_MIX
    rng = np.random.default_rng(3)
    reqs = [Request(uid=f"d{i}", prompt=rng.integers(0, cfg.vocab, int(p)),
                    max_new=max_new)
            for i, p in enumerate(rng.integers(lo, hi + 1, n_req))]
    out = {}
    for graphed in (True, False):
        with contextlib.nullcontext() if graphed else compiled.disable():
            mx = Mixer(model, params, slots=MIX_SLOTS, max_len=max_len)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = mx.run(reqs)
            torch.cuda.synchronize()
            out[graphed] = ([r.tokens for r in res], mx.stats(),
                            time.perf_counter() - t0)
    for a, b in zip(out[True][0], out[False][0]):
        if not np.array_equal(a, b):
            _fail(f"{label} mixer: graphed tokens {a.tolist()} against "
                  f"eager {b.tolist()}")
    st = out[True][1]
    print(f"[dense {label} mixer] {n_req} requests (prompts "
          f"{sorted(len(r.prompt) for r in reqs)}, {max_new} tokens each) "
          f"over {MIX_SLOTS} slots: {st['admits']} admissions, "
          f"{st['steps']} decode steps; graphed == eager tokens; stream "
          f"{out[True][2]:.2f} s graphed, {out[False][2]:.2f} s eager "
          f"(admission {st['t_admit_s']:.2f} s graphed) — bf16, on {card}")


def _dense_family(arch: str, layers: int, card: str, dev) -> None:
    """Phase 12 on one model (see :func:`phase_dense_families`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers) if layers else full
    fp32_gb = 4 * full.params_count() / 1e9
    why = (f"all {full.n_layers}: {fp32_gb:.1f} GB of fp32 params, more "
           f"than the card's 80 GB" if fp32_gb > 80
           else "the script's time")
    cut = (f"{layers} of {full.n_layers} layers ({why})" if layers
           else f"all {full.n_layers} layers")
    print(f"[dense {arch}] family {cfg.family}, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, window {cfg.window or 'none'}"
          f"{f', enc_seq {cfg.enc_seq}' if cfg.enc_seq else ''}; full "
          f"width, {cut}; seeded random weights, dense (the compressed "
          f"plane refuses the family, as the reference's does)")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    pg = torch.Generator(device=dev).manual_seed(2)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                            device=dev)
    toks = _dense_runs(model, params, prompts, arch, card)
    from repro_torch.launch import serve
    toks_g, _, _, rep = serve.generate(model, params, prompts, GEN,
                                       PROMPT + GEN, guarded=True,
                                       device=dev)
    if not rep.healthy or not torch.equal(toks_g, toks):
        _fail(f"{arch} guarded: {rep.stable_dict()}; tokens "
              f"{'equal' if torch.equal(toks_g, toks) else 'differ'}")
    print(f"[dense {arch}] healthy guarded run: report healthy, tokens "
          f"torch.equal to unguarded serve.generate")
    if cfg.family != "encdec":
        _dense_fp32(cfg, model, params, prompts, arch)
    else:
        print(f"[dense {arch}] no fp32 teacher forcing: the reference's "
              f"decode cross-attends to an empty cache with no positions, "
              f"so it does not compute its forward (held to graph == "
              f"eager only)")
    if cfg.window:
        _dense_wrap(cfg, model, params, arch, dev)
    if arch in DENSE_MIXED:
        _dense_mixer(cfg, model, params, arch, card)
    print(f"[dense {arch}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_dense_families(card: str, dev) -> None:
    """Phase 12: the four families the reference serves dense only (see
    the module docstring).  Launches none of the five kernels."""
    import gc
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t_all = time.perf_counter()
    for arch, layers in DENSE_FAMILIES:
        t0 = time.perf_counter()
        _dense_family(arch, layers, card, dev)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[dense {arch}] {time.perf_counter() - t0:.1f} s; after the "
              f"model is deleted: {torch.cuda.memory_allocated() / 2**30:.2f} "
              f"GiB allocated")
    counts = ops.launch_counts()
    if sum(counts.values()):
        _fail(f"phase 12 launched kernels: {counts}; these families are "
              f"served dense")
    print(f"[dense] no kernel of the five launched in the phase "
          f"({counts}); phase 12 took {time.perf_counter() - t_all:.1f} s")


def _train_steps(step_fn, state: list, pipe, steps: range, dev
                 ) -> tuple[list, list]:
    """``steps`` of ``step_fn`` on ``pipe``'s batches from ``state`` =
    [params, optimizer state], which it advances in place: the list is
    the only holder of the state, so a step's old and new state are the
    only copies alive.  Returns each step's loss and host ms
    (synchronised)."""
    import torch
    losses, ms = [], []
    for i in steps:
        batch = pipe.batch_at(i)
        t0 = time.perf_counter()
        loss, params, opt_state = step_fn(*state, batch)
        state[:] = params, opt_state
        del params, opt_state
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def _train_fp32(model, params, batch, card: str) -> None:
    """One fp32 step's loss and gradients with remat off, on and under
    ``saveremat`` (TF32 off since phase 1): every leaf within 1e-5
    max|leaf| of remat off; the peak memory each adds to what is live
    before it, no remat's the largest."""
    import torch
    from repro_torch import tree
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import layers as L
    from repro_torch.models import optflags
    prev = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    peaks, worst = {}, {}
    try:
        want = None
        for mode, remat, flags in (("no remat", False, ()),
                                   ("remat", True, ()),
                                   ("saveremat", True, ("saveremat",))):
            torch.cuda.empty_cache()
            # the step's own peak, above what is live before it (the
            # params, and the gradients kept from the first run)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with optflags.optimizations(flags):
                loss, grads = value_and_grad(
                    lambda p, b: model.loss(p, b, remat=remat), params,
                    batch)
            torch.cuda.synchronize()
            peaks[mode] = (torch.cuda.max_memory_allocated() - base) / 2**30
            if want is None:
                want = (float(loss), tree.leaves(grads))
                continue
            if abs(float(loss) - want[0]) > 1e-5 * abs(want[0]):
                _fail(f"train fp32 {mode}: loss {float(loss)} against "
                      f"{want[0]} without remat")
            share = 0.0
            for got, w in zip(tree.leaves(grads), want[1]):
                scale = float(w.abs().max())
                err = float((got - w).abs().max())
                if not err <= 1e-5 * scale:
                    _fail(f"train fp32 {mode}: a gradient leaf {err} off, "
                          f"bound 1e-5 * {scale}")
                share = max(share, err / scale if scale else 0.0)
            worst[mode] = share
            del grads
    finally:
        L.COMPUTE_DTYPE = prev
    if not peaks["no remat"] > max(peaks["remat"], peaks["saveremat"]):
        _fail(f"train fp32 peak memory {peaks}: no remat is not the largest")
    print(f"[train fp32] loss {want[0]:.6f}; gradients with remat / "
          f"saveremat within {worst['remat']:.3e} / {worst['saveremat']:.3e}"
          f" max|leaf| of no remat (bound 1e-5); peak GiB above the live "
          f"params (and kept gradients): " + ", ".join(
              f"{k} {v:.2f}" for k, v in peaks.items())
          + f" (saveremat {'>=' if peaks['saveremat'] >= peaks['remat'] else '<'}"
          f" remat); {card}")


def _train_resume(full, card: str, dev) -> None:
    """Deterministic algorithms: 8 steps with a checkpoint after step 5,
    then a restore and a replay of steps 5-7 (losses to rtol 1e-5)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import PipelineState, TokenPipeline
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(full, n_layers=TRAIN_CKPT_LAYERS)
    model = Model(cfg)
    params = model.init(seed=1, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=40)
    opt_state = adamw.init(params, opt_cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, device=dev)
    step_fn = build_train_step(model, opt_cfg)
    state = [params, opt_state]
    del params, opt_state
    # cuBLAS is deterministic only with this workspace setting, which
    # use_deterministic_algorithms checks for
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            first, _ = _train_steps(step_fn, state, pipe, range(5), dev)
            t0 = time.perf_counter()
            ckpt.save(d, 5, {"params": state[0], "opt": state[1]},
                      extra={"pipeline": PipelineState(5).to_dict()})
            save_s = time.perf_counter() - t0
            gb = sum(os.path.getsize(os.path.join(d, "step_00000005", f))
                     for f in os.listdir(os.path.join(d, "step_00000005")))
            more, _ = _train_steps(step_fn, state, pipe, range(5, 8), dev)
            t0 = time.perf_counter()
            restored, extra = ckpt.restore(
                d, {"params": state[0], "opt": state[1]})
            torch.cuda.synchronize(dev)
            restore_s = time.perf_counter() - t0
            state[:] = restored["params"], restored["opt"]
            del restored
            ps = PipelineState.from_dict(extra["pipeline"])
            replay, _ = _train_steps(step_fn, state, pipe,
                                     range(ps.step, 8), dev)
    finally:
        torch.use_deterministic_algorithms(False)
    first += more
    for i, (a, b) in enumerate(zip(replay, first[5:8])):
        if abs(a - b) > 1e-5 * abs(b):
            _fail(f"train resume: replayed step {5 + i} loss {a} against "
                  f"{b} (rtol 1e-5)")
    print(f"[train resume] {TRAIN_CKPT_LAYERS} of {full.n_layers} layers, "
          f"deterministic algorithms: save {save_s:.1f} s, restore "
          f"{restore_s:.1f} s ({gb / 1e9:.2f} GB); replayed steps 5-7 "
          f"{', '.join(f'{x:.6f}' for x in replay)} == first run "
          f"{', '.join(f'{x:.6f}' for x in first[5:8])} (rtol 1e-5); "
          f"{card}")


def _train_cli(card: str) -> None:
    """The CLI at ``--reduced``: a run that checkpoints, then a resumed
    one."""
    import io
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        base = ["--arch", "chatglm3-6b", "--reduced", "--batch", "4",
                "--seq", "64", "--ckpt-dir", d, "--ckpt-every", "2",
                "--log-every", "2"]
        for argv in (base + ["--steps", "4"],
                     base + ["--steps", "6", "--resume"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run = train.main(argv)
            text = out.getvalue()
            print(f"[train cli] {' '.join(argv[argv.index('--steps'):])}: "
                  + " | ".join(text.strip().splitlines()))
            if not all(math.isfinite(x) for x in run.losses):
                _fail(f"train cli: non-finite losses {run.losses}")
        if "[resume] step 4" not in text:
            _fail(f"train cli: the resumed run did not print '[resume] "
                  f"step 4': {text!r}")
    print(f"[train cli] resumed at step 4 from its checkpoint; {card}")


def phase_train(card: str, dev) -> dict:
    """Phase 13: training (see the module docstring).  Launches none of
    the five kernels.  Returns the bf16 run's ``peak_bytes`` (the
    allocator's peak over init and its 10 steps) and ``median_ms`` (a
    step, after the first), which phase 15 reads."""
    import dataclasses
    import gc
    import torch
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    ops.reset_launch_counts()
    t_all = time.perf_counter()
    full = get_config("chatglm3-6b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    n_params = cfg.params_count()
    print(f"[train] chatglm3-6b at full width (d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_kv_heads} KV heads), "
          f"{TRAIN_LAYERS} of {full.n_layers} layers ({n_params / 1e9:.2f} "
          f"G params; all {full.n_layers}: "
          f"{16 * full.params_count() / 1e9:.0f} GB of fp32 params, "
          f"gradients and moments, more than the card's 80 GB); seeded "
          f"random weights, batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, eager")
    model = Model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=40)
    torch.cuda.reset_peak_memory_stats()
    state = [model.init(seed=0, device=dev), None]
    state[1] = adamw.init(state[0], opt_cfg)
    losses, ms = _train_steps(build_train_step(model, opt_cfg), state,
                              pipe, range(TRAIN_STEPS), dev)
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 2**30
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not all(math.isfinite(x) for x in losses) or not last < first:
        _fail(f"train: losses {losses}: the last 5 do not fall below the "
              f"first 5")
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}: mean "
          f"of the first 5 {first:.4f} > last 5 {last:.4f}")
    print(f"[train] ms a step (remat, AdamW; {len(ms) - 1} steps after the "
          f"first, {ms[0]:.1f}): {_spread(ms[1:])}; "
          f"{TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GiB; {card}")
    state[1] = None
    gc.collect()
    torch.cuda.empty_cache()

    compress = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                 total_steps=40, grad_compress=True)
    torch.cuda.reset_peak_memory_stats()
    state[1] = adamw.init(state[0], compress)
    c_losses, c_ms = _train_steps(build_train_step(model, compress), state,
                                  pipe, range(3), dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    err_ok = all(bool(torch.isfinite(e).all())
                 for e in tree.leaves(state[1].err))
    if not err_ok or not all(math.isfinite(x) for x in c_losses):
        _fail(f"train grad_compress: losses {c_losses}, residuals finite "
              f"{err_ok}")
    print(f"[train grad_compress] 3 steps: losses "
          f"{', '.join(f'{x:.4f}' for x in c_losses)}, every residual leaf "
          f"finite; ms a step {', '.join(f'{x:.1f}' for x in c_ms)}; peak "
          f"{peak:.2f} GiB; {card}")
    params = state[0]
    del state
    gc.collect()
    torch.cuda.empty_cache()

    _train_fp32(model, params, pipe.batch_at(0), card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _train_resume(full, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _train_cli(card)
    counts = ops.launch_counts()
    if sum(counts.values()):
        _fail(f"phase 13 launched kernels: {counts}; training runs dense")
    print(f"[train] no kernel of the five launched in the phase "
          f"({counts}); phase 13 took {time.perf_counter() - t_all:.1f} s")
    return {"peak_bytes": peak_bytes, "median_ms": med}


# ---------------------------------------------------------------------------
# Phase 14: the last optimization flags and the mesh
# ---------------------------------------------------------------------------

def _ingest_greedy(step, model, params, prompts, gen: int):
    """Greedy tokens (B, gen) with the prompt ingested token by token
    through ``step`` (a ``CompiledStep`` or ``model.decode_step``), and a
    copy of every step's logits: the path of a model without a one-pass
    prefill, which block-stored FFN params do not have."""
    import torch
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + gen, device=prompts.device)
    pos = torch.empty((), dtype=torch.long, device=prompts.device)
    steps, toks = [], []
    for t in range(plen + gen - 1):
        tok = prompts[:, t] if t < plen else toks[-1]
        logits, cache = step(params, cache, tok, pos.fill_(t))
        steps.append(logits.clone())
        if t >= plen - 1:
            toks.append(logits.argmax(dim=-1))
    return torch.stack(toks, dim=1), steps


def _scattered_ffn(ffn: dict, d_model: int) -> dict:
    """Dense FFN weights from block-stored ones: each payload block added
    into a zero (d, f) weight at its block-row and block-column (the rows
    are all zero, so a column's T blocks sum into block-row 0)."""
    import torch
    out = {"w_down": ffn["w_down"]}
    for name in ("gate", "up"):
        payload, rows = ffn[f"payload_{name}"], ffn[f"rows_{name}"].long()
        n_layers, gk, t, bn, bk = payload.shape
        w = torch.zeros((n_layers, d_model // bn, gk, bn, bk),
                        dtype=payload.dtype, device=payload.device)
        li = torch.arange(n_layers, device=w.device)[:, None]
        gi = torch.arange(gk, device=w.device)[None, :]
        for j in range(t):
            w.index_put_((li, rows[:, :, j], gi), payload[:, :, j],
                         accumulate=True)
        out[f"w_{name}"] = w.permute(0, 1, 3, 2, 4).reshape(
            n_layers, d_model, gk * bk)
        del w
    return out


def _flags_sparseffn(card: str, dev) -> None:
    """Phase 14 (a): ``sparseffn`` on chatglm3-6b, all 28 layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b")
    flags = ("sparseffn",)
    torch.cuda.reset_peak_memory_stats()
    with optflags.optimizations(flags):
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        ffn = params["blocks"]["ffn"]
        print(f"[flags sparseffn] chatglm3-6b at full width, all "
              f"{cfg.n_layers} layers: block-stored gate / up payloads "
              f"{tuple(ffn['payload_gate'].shape)} (T = "
              f"{ffn['payload_gate'].shape[2]} of {cfg.d_model // 128} "
              f"block-rows), dense w_down; batch {BATCH}, "
              f"{FLAG_INGEST} positions ingested then {FLAG_INGEST} tokens "
              f"through decode_step; seeded random weights, bf16")
        pg = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (BATCH, FLAG_INGEST),
                                generator=pg, device=dev)
        graph = compiled.CompiledStep(model)
        toks, _ = _ingest_greedy(graph, model, params, prompts,
                                 FLAG_INGEST)             # the capture
        times, first = {"graph": [], "eager": []}, {}
        for _ in range(FLAG_RUNS):
            for mode, step in (("graph", graph),
                               ("eager", model.decode_step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, steps = _ingest_greedy(step, model, params, prompts,
                                            FLAG_INGEST)
                torch.cuda.synchronize()
                times[mode].append(1e3 * (time.perf_counter() - t0)
                                   / len(steps))
                if not torch.equal(out, toks):
                    _fail(f"sparseffn {mode}: tokens differ between runs")
                first.setdefault(mode, steps)
        n_steps = len(first["graph"])
        if not all(torch.equal(a, b)
                   for a, b in zip(first["graph"], first["eager"])):
            _fail("sparseffn: graph and eager logits differ")
    print(f"[flags sparseffn] graph == eager: tokens and the logits of all "
          f"{n_steps} steps torch.equal; ms a step (one token a row), "
          f"{FLAG_RUNS} runs in turns: graph {_spread(times['graph'])}, "
          f"eager {_spread(times['eager'])}; {card}")
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)
    dense_params = dict(params, blocks=dict(
        params["blocks"], ffn=_scattered_ffn(ffn, cfg.d_model)))
    dense = Model(cfg)
    prev = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        with optflags.optimizations(flags):
            forced = _forced_steps(compiled.CompiledStep(model), model,
                                   params, seq)
        want = _forced_steps(compiled.CompiledStep(dense), dense,
                             dense_params, seq)
    finally:
        L.COMPUTE_DTYPE = prev
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(forced, want))
    if not err <= 1e-3 * scale:
        _fail(f"sparseffn fp32: max|sparse - dense| = {err} > 1e-3 * "
              f"{scale}")
    print(f"[flags sparseffn fp32] all {len(forced)} steps' logits within "
          f"{err / scale:.3e} max|logits| of the dense model whose gate / "
          f"up weights are the payloads scattered and summed at their "
          f"block-rows (bound 1e-3); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _forced_steps(step, model, params, seq) -> list:
    """Every step's logits with ``seq`` fed token by token."""
    import torch
    cache = model.init_cache(seq.shape[0], seq.shape[1], device=seq.device)
    pos = torch.empty((), dtype=torch.long, device=seq.device)
    out = []
    for t in range(seq.shape[1]):
        logits, cache = step(params, cache, seq[:, t], pos.fill_(t))
        out.append(logits.clone())
    return out


def _flags_padheads(card: str, dev, acc: dict, launches: dict) -> None:
    """Phase 14 (b): ``padheads`` on deepseek-coder-33b, 4 layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.exec.compress import compress_params, prune_params
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, serve
    from repro_torch.models import layers as L
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    full = get_config("deepseek-coder-33b")
    cfg = dataclasses.replace(full, n_layers=FLAG_PAD_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    marks = [time.perf_counter()]
    with optflags.optimizations(("padheads",)):
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        heads = params["blocks"]["attn"]["wq"].shape[-1] // cfg.head_dim
        if heads != L.eff_heads(cfg.n_heads) or heads <= cfg.n_heads:
            _fail(f"padheads: wq holds {heads} heads of {cfg.n_heads}")
        pg = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                                device=dev)
        print(f"[flags padheads] deepseek-coder-33b at full width, "
              f"{FLAG_PAD_LAYERS} of {full.n_layers} layers (phase 11's "
              f"cut): {cfg.n_heads} query heads padded to {heads} (wq "
              f"{tuple(params['blocks']['attn']['wq'].shape[1:])}, wo "
              f"{tuple(params['blocks']['attn']['wo'].shape[1:])}); batch "
              f"{BATCH}, prompt {PROMPT}, {GEN} tokens, bf16")
        serve.generate(model, params, prompts, GEN, PROMPT + GEN,
                       device=dev)                         # the capture
        times = {"graph": ([], []), "eager": ([], [])}
        for _ in range(FLAG_RUNS):
            for mode in ("graph", "eager"):
                with compiled.disable() if mode == "eager" \
                        else contextlib.nullcontext():
                    _, t_pre, t_gen = serve.generate(
                        model, params, prompts, GEN, PROMPT + GEN,
                        device=dev)
                times[mode][0].append(1e3 * t_pre)
                times[mode][1].append(1e3 * t_gen / GEN)
        for mode, (pre, dec) in times.items():
            print(f"[flags padheads {mode}] prefill ms {_spread(pre)}; "
                  f"decode ms/token {_spread(dec)}; {card}")
        _graph_equals_eager(model, params, prompts,
                            "deepseek-coder-33b padheads bf16")
        prev = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = torch.float32
        try:
            toks, steps = compiled.greedy(compiled.CompiledStep(model),
                                          model, params, prompts, GEN)
            seq = torch.cat([prompts, toks[:, :GEN - 1]], dim=1)
            want = _teacher_forced(model, params, seq,
                                   slice(PROMPT, PROMPT + GEN - 1))
            worst = _held_fp32("padheads fp32", steps, want, PROMPT)
        finally:
            L.COMPUTE_DTYPE = prev
        print(f"[flags padheads fp32] all {len(steps)} decode steps "
              f"(graphed, after the prefill) within {worst:.3e} "
              f"max|logits| of the teacher-forced forward (bound 1e-3)")
        marks.append(time.perf_counter())
        # the compressed plane: the bitmap plan's wq blocks (1024 x 7168)
        # do not tile the padded wq, which the reference refuses too; the
        # 2:4 plan serves the padded weights through the N:M kernels
        bitmap = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY["bitmap"])
        try:
            prune_params(params, bitmap, cfg)
        except ValueError as e:
            print(f"[flags padheads bitmap] refused before any launch, as "
                  f"the reference refuses it: {e}")
        else:
            _fail("padheads: the bitmap plan's blocks tiled the padded wq")
        plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY["nm"])
        pruned = prune_params(params, plan, cfg)
        store = compress_params(pruned, plan, cfg)
        del params
        cm = CompressedModel(Model(cfg), store)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        gen = torch.Generator(device=dev).manual_seed(11)
        worst = 0.0
        for role in ("attn.wq", "attn.wo"):
            c = store.get(0, role).data
            w = pruned["blocks"]["attn"][role.split(".")[1]][0]
            for m in (M_DECODE, M_PREFILL):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, c.n), generator=gen,
                                    device=dev).to(dtype)
                    worst = max(worst, _run_case(
                        acc, None, "nm_spmm", f"padheads {role}", x,
                        _nm_case(c), w, log=False))
        print(f"[flags padheads nm] nm_spmm, pipelined and naive, at the "
              f"padded attn.wq {store.get(0, 'attn.wq').data.n} x "
              f"{store.get(0, 'attn.wq').data.k} and attn.wo "
              f"{store.get(0, 'attn.wo').data.n} x "
              f"{store.get(0, 'attn.wo').data.k}, M = {M_DECODE} / "
              f"{M_PREFILL}, x fp32 / bf16: within phase 3's tolerance "
              f"(largest share {worst:.4f}), naive == pipelined")
        marks.append(time.perf_counter())
        expected = 7 * cfg.n_layers * (1 + GEN)
        ops.reset_launch_counts()
        toks_c, t_pre, t_gen = cm.generate(pruned, prompts, GEN, device=dev)
        counts = ops.launch_counts()
        if counts["nm_spmm"] != expected or \
                sum(counts.values()) != expected:
            _fail(f"padheads nm: launch counts {counts}, expected "
                  f"{expected} of nm_spmm only")
        launches["nm_spmm"] = launches.get("nm_spmm", 0) + expected
    marks.append(time.perf_counter())
    parts = [b - a for a, b in zip(marks, marks[1:])]
    print(f"[flags padheads nm] served: {expected} launches of nm_spmm "
          f"(7 x {cfg.n_layers} x (1 + {GEN})), none of any other; the "
          f"capturing run's prefill {1e3 * t_pre:.1f} ms, decode "
          f"{1e3 * t_gen / GEN:.3f} ms/token; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; seconds: "
          f"dense serving and checks {parts[0]:.1f}, plans / prune / "
          f"compress {parts[1]:.1f}, kernel checks {parts[2]:.1f}, "
          f"compressed run {parts[3]:.1f}")


def _flags_bf16params(card: str, dev) -> None:
    """Phase 14 (c): ``bf16params`` on chatglm3-6b, all 28 layers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import bf16_params
    from repro_torch.launch import serve
    from repro_torch.models import optflags
    from repro_torch.models.transformer import Model
    cfg = get_config("chatglm3-6b")
    torch.cuda.reset_peak_memory_stats()
    with optflags.optimizations(("bf16params",)):
        model = Model(cfg)
        params = model.init(seed=0, device=dev)
        cast = bf16_params(params)
        pg = torch.Generator(device=dev).manual_seed(2)
        prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                                device=dev)
        first = {}
        for name, p in (("bf16 params", cast), ("fp32 params", params)):
            first[name] = serve.generate(model, p, prompts, GEN,
                                         PROMPT + GEN, device=dev)[0]
        times = {name: ([], []) for name in first}
        for _ in range(FLAG_RUNS):
            for name, p in (("bf16 params", cast), ("fp32 params", params)):
                toks, t_pre, t_gen = serve.generate(
                    model, p, prompts, GEN, PROMPT + GEN, device=dev)
                if not torch.equal(toks, first[name]):
                    _fail(f"bf16params {name}: tokens differ between runs")
                times[name][0].append(1e3 * t_pre)
                times[name][1].append(1e3 * t_gen / GEN)
        _graph_equals_eager(model, cast, prompts,
                            "chatglm3-6b bf16params")
    agree = (first["bf16 params"] == first["fp32 params"]).float().mean()
    print(f"[flags bf16params] chatglm3-6b at full width, all "
          f"{cfg.n_layers} layers, params cast once to bf16 "
          f"(convert.bf16_params) against fp32 params, bf16 compute; batch "
          f"{BATCH}, prompt {PROMPT}, {GEN} tokens, graphed, "
          f"{FLAG_RUNS} runs each in turns; greedy agreement "
          f"{agree.item():.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    for name, (pre, dec) in times.items():
        print(f"[flags bf16params {name}] prefill ms {_spread(pre)}; "
              f"decode ms/token {_spread(dec)}")


def _flags_mesh(card: str) -> None:
    """Phase 14 (d): no serving mesh on one card (on several, the
    reference's (gcd(batch, cards), 1)); ``serve --mesh`` serves the
    tokens of the run without it."""
    import io
    import torch
    from repro_torch.launch import mesh, serve
    n = torch.cuda.device_count()
    got = mesh.make_serve_mesh(BATCH)
    want = None if n == 1 else (math.gcd(BATCH, n), 1)
    if (got and got.shape) != want:
        _fail(f"make_serve_mesh({BATCH}) on {n} card(s) is "
              f"{got and got.shape}, not {want}")
    argv = ["--arch", "chatglm3-6b", "--batch", str(BATCH), "--prompt-len",
            "16", "--gen", "8"]
    samples = []
    for extra in ([], ["--mesh"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.main(argv + extra)
        samples.append([line for line in out.getvalue().splitlines()
                        if "sample out" in line])
    if not samples[0] or samples[0] != samples[1]:
        _fail(f"serve --mesh: {samples[1]} against {samples[0]}")
    print(f"[flags mesh] make_serve_mesh({BATCH}) is {want} on {n} "
          f"card(s); serve.main at full width with and without --mesh: "
          f"{samples[0][0].strip()} both; {card}")


def phase_flags(card: str, dev, acc: dict) -> dict[str, int]:
    """Phase 14: the last optimization flags and the mesh (see the module
    docstring).  Returns kernel -> launches of its served run."""
    import gc
    import torch
    launches: dict[str, int] = {}
    t_all = time.perf_counter()
    for part, fn, args in (("sparseffn", _flags_sparseffn, (card, dev)),
                           ("padheads", _flags_padheads,
                            (card, dev, acc, launches)),
                           ("bf16params", _flags_bf16params, (card, dev)),
                           ("mesh", _flags_mesh, (card,))):
        t0 = time.perf_counter()
        fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[flags {part}] {time.perf_counter() - t0:.1f} s; after: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    print(f"[flags] phase 14 took {time.perf_counter() - t_all:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the dry run and its cost counter
# ---------------------------------------------------------------------------

def _dryrun_cells(card: str) -> None:
    """Phase 15 (a): ``repro_torch.launch.dryrun``'s CLI on each of
    ``DRYRUN_CELLS`` at full width on the single production mesh, into a
    temporary directory: exit 0, every record ``ok``."""
    import io
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as d:
        for arch, shape in DRYRUN_CELLS:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                try:
                    dryrun.main(["--arch", arch, "--shape", shape, "--mesh",
                                 "single", "--out", d])
                    code = 0
                except SystemExit as e:
                    code = e.code
            with open(os.path.join(d, f"{arch}__{shape}__single.json")) as f:
                rec = json.load(f)
            if code != 0 or not rec["ok"] or rec.get("skipped"):
                _fail(f"dryrun {arch} {shape}: exit {code}, record "
                      f"{ {k: v for k, v in rec.items() if k != 'traceback'} }"
                      f"; {out.getvalue()[-2000:]}")
            mem = rec["memory_analysis"]
            print(f"[dryrun {arch} {shape}] full width, the single "
                  f"production mesh ({rec['devices']} devices, per-device "
                  f"terms {rec['flops']}, partitioned {rec['partitioned']}):"
                  f" traced in {rec['lower_s']} s ({rec['traced_ops']} ops); "
                  f"the step {rec['step_flops']:.6e} FLOPs, "
                  f"{rec['step_bytes']:.6e} bytes; per device: arguments "
                  f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB, outputs "
                  f"{mem['output_size_in_bytes'] / 2**30:.3f} GiB; on the "
                  f"host of {card}")


def phase_dryrun(card: str, dev, train: dict) -> None:
    """Phase 15: the dry run (see the module docstring).  ``train`` is
    phase 13's peak and median step.  Launches none of the five
    kernels."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.transformer import Model
    from repro_torch.optim import adamw
    ops.reset_launch_counts()
    t_all = time.perf_counter()
    _dryrun_cells(card)

    # (b) phase 13's cell on one device: the meta count against a step on
    # the card, the predicted peak against phase 13's
    cfg = dataclasses.replace(get_config("chatglm3-6b"),
                              n_layers=TRAIN_LAYERS)
    shape = ShapeCfg("phase13", TRAIN_SEQ, TRAIN_BATCH, "train")
    one = Mesh(("data", "model"), (1, 1))
    rec = dryrun.run_cell(cfg.name, shape.name, False, mesh=one, cfg=cfg,
                          shape=shape)
    if not rec["ok"]:
        _fail(f"dryrun phase 13's cell: {rec.get('error')}\n"
              f"{rec.get('traceback')}")
    ext = dryrun.step_cost(cfg, shape, one, extrapolate=True)
    if (ext.cost.flops, ext.cost.bytes) != (rec["flops"], rec["hlo_bytes"]):
        _fail(f"dryrun phase 13's cell: extrapolated from 1 and 2 layers "
              f"{ext.cost.flops} FLOPs, {ext.cost.bytes} bytes; traced at "
              f"{TRAIN_LAYERS} layers {rec['flops']}, {rec['hlo_bytes']}")
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=40)
    opt = adamw.init(params, opt_cfg)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, device=dev).batch_at(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, _, _), card_step = op_cost.count(
        build_train_step(model, opt_cfg), params, opt, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    loss = float(loss)
    del params, opt, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    if card_step.cost.flops != rec["flops"] or not math.isfinite(loss):
        _fail(f"dryrun phase 13's cell: {card_step.cost.flops} FLOPs "
              f"counted over a step on the card (loss {loss}), "
              f"{rec['flops']} on the meta device")
    predicted = rec["memory_analysis"]["peak_memory_in_bytes"]
    measured = train["peak_bytes"]
    print(f"[dryrun phase 13's cell] chatglm3-6b, {TRAIN_LAYERS} layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat, AdamW, one "
          f"device: traced on the meta device in {rec['lower_s']} s "
          f"({rec['traced_ops']} ops): {rec['flops']} FLOPs, "
          f"{rec['hlo_bytes']} bytes (extrapolated from 1 and 2 layers: "
          f"the same); one step on the card under the counter "
          f"({counted_s:.2f} s, loss {loss:.4f}): {card_step.cost.flops} "
          f"FLOPs == the meta count, {card_step.cost.bytes} bytes, live "
          f"peak {card_step.peak / 2**30:.3f} GiB")
    if predicted < (1 - PEAK_SHORTFALL) * measured:
        _fail(f"dryrun: predicted peak {predicted / 2**30:.3f} GiB falls "
              f"short of phase 13's measured "
              f"{measured / 2**30:.3f} GiB by more than "
              f"{PEAK_SHORTFALL:.0%}")
    tflops = rec["flops"] / (train["median_ms"] / 1e3) / 1e12
    print(f"[dryrun phase 13's cell] predicted peak "
          f"{predicted / 2**30:.3f} GiB against phase 13's measured "
          f"max_memory_allocated {measured / 2**30:.3f} GiB "
          f"(predicted / measured {predicted / measured:.4f}, bound >= "
          f"{1 - PEAK_SHORTFALL:.2f}); achieved {tflops:.2f} TFLOP/s "
          f"({rec['flops']} counted FLOPs over phase 13's median step "
          f"{train['median_ms']:.1f} ms); {card}")
    counts = ops.launch_counts()
    if sum(counts.values()):
        _fail(f"phase 15 launched kernels: {counts}")
    print(f"[dryrun] no kernel of the five launched in the phase "
          f"({counts}); phase 15 took {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: serving and training over a data mesh
# ---------------------------------------------------------------------------

def _data_meshes(dev) -> list:
    """Phase 16's meshes, (label, mesh): (2, 1) repeating ``dev`` and, on
    a host of two or more cards, (2, 1) over the first two."""
    import torch
    from repro_torch.launch import mesh
    out = [(f"(2, 1) repeating {dev}",
            mesh.Mesh(("data", "model"), (2, 1),
                      mesh.grid([dev, dev], (2, 1))))]
    if torch.cuda.device_count() >= 2:
        out.append(("(2, 1) over cuda:0 and cuda:1",
                    mesh.make_small_mesh(2, 1)))
    return out


def _mesh_plan(cfg, kind: str, kname: str, card: str, dev
               ) -> dict[str, int]:
    """Phase 16 on one shipped plan; returns the launches of its first
    mesh's capturing run (pipelined) and of its naive run."""
    import torch
    from repro_torch.exec.compress import compress_params, prune_params
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, data_parallel, serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    from repro_torch.runtime import guard, inject

    one = 7 * cfg.n_layers * (1 + GEN)     # one replica's launches a run
    rows = BATCH // 2
    plan = shipped_plan(cfg, kind)
    params = Model(cfg).init(seed=0, device=dev)
    pruned = prune_params(params, plan, cfg)
    del params
    cm = CompressedModel(Model(cfg), compress_params(pruned, plan, cfg))
    pg = torch.Generator(device=dev).manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                            device=dev)
    log: list = []

    class Recorded(compiled.CompiledStep):
        def __call__(self, *args):
            logits, cache = super().__call__(*args)
            log.append((id(self.model), logits.clone()))
            return logits, cache

    def run(model, x, record=False, graphed=True):
        """One counted run: tokens, prefill ms, decode ms/token, launch
        counts and, recorded, every step's logits by the model object
        that stepped them."""
        plain = serve.CompiledStep
        log.clear()
        if record:
            serve.CompiledStep = Recorded
        try:
            ops.reset_launch_counts()
            with contextlib.nullcontext() if graphed else compiled.disable():
                toks, tp, tg = serve.generate(model, pruned, x, GEN,
                                              PROMPT + GEN, device=dev)
            counts = ops.launch_counts()
        finally:
            serve.CompiledStep = plain
        steps: dict = {}
        for key, lg in log:
            steps.setdefault(key, []).append(lg)
        return toks, 1e3 * tp, 1e3 * tg / GEN, counts, steps

    def only(counts, name, n, label):
        if counts[name] != n or sum(counts.values()) != n:
            _fail(f"mesh {kind} {label}: launch counts {counts}; expected "
                  f"{n} of {name} only")

    def same(a, b) -> bool:
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    launches: dict[str, int] = {}
    for label, mesh_ in _data_meshes(dev):
        reps = data_parallel.replicate_model(cm, pruned, mesh_)
        toks, _, _, counts, steps = run(reps, prompts, record=True)
        only(counts, kname, 2 * one, f"{label} capturing run")
        launches.setdefault(kname, counts[kname])
        # each replica against its rows served alone on one device
        pre = reps.prefill(reps.params, prompts, PROMPT + GEN)[0]
        for i, rm in enumerate(reps.models):
            x = prompts[i * rows:(i + 1) * rows]
            at, _, _, c1, st1 = run(cm, x, record=True)
            only(c1, kname, one, f"replica {i} alone")
            alone_pre = cm.prefill(pruned, x, PROMPT + GEN)[0]
            if not torch.equal(toks[i * rows:(i + 1) * rows], at) or \
                    not same(steps[id(rm)], st1[id(cm)]) or \
                    not torch.equal(pre[i * rows:(i + 1) * rows],
                                    alone_pre.to(pre.device)):
                _fail(f"mesh {kind} {label}: replica {i}'s tokens, decode "
                      f"or prefill logits differ from its rows served "
                      f"alone")
        del pre
        # graph == eager, every replica's every step
        et, _, _, counts, esteps = run(reps, prompts, record=True,
                                       graphed=False)
        only(counts, kname, 2 * one, f"{label} eager")
        if not torch.equal(et, toks) or any(
                not same(esteps[id(rm)], steps[id(rm)])
                for rm in reps.models):
            _fail(f"mesh {kind} {label}: graph and eager differ")
        print(f"[mesh {kind}] {label}: tokens, prefill logits and every "
              f"decode step's logits of each replica torch.equal to its "
              f"{rows} rows served alone on {dev}; graph == eager; "
              f"{2 * one} launches of {kname} (2 x 7 x {cfg.n_layers} x "
              f"(1 + {GEN})); on {card}")
    reps = data_parallel.replicate_model(cm, pruned, _data_meshes(dev)[0][1])
    run(reps, prompts)                     # captures the replicas' graphs
    run(cm, prompts)                       # and one device's at batch 4
    rec: dict = {"mesh graphed": [], "mesh eager": [], "one device": []}
    for _ in range(MESH_RUNS):
        for mode, model, graphed in (("mesh graphed", reps, True),
                                     ("mesh eager", reps, False),
                                     ("one device", cm, True)):
            _, tp, tg, _, _ = run(model, prompts, graphed=graphed)
            rec[mode].append((tp, tg))
    print(f"[mesh {kind}] bf16, {MESH_RUNS} runs a mode in turns, prefill "
          f"ms / decode ms/token, median (min-max): " + "; ".join(
              f"{mode} {_spread([t[0] for t in r])} / "
              f"{_spread([t[1] for t in r])}" for mode, r in rec.items())
          + f"; on {card}")
    with ops.pipeline_default(False):
        nt, *_, counts, _ = run(reps, prompts)
    only(counts, f"{kname}_naive", 2 * one, "naive")
    launches[f"{kname}_naive"] = counts[f"{kname}_naive"]
    if not torch.equal(nt, toks):
        _fail(f"mesh {kind}: the naive kernels' tokens differ")
    # fp32: the replicas' prefill logits against the dense model's on the
    # same pruned weights, the whole batch on one device
    L.COMPUTE_DTYPE = torch.float32
    try:
        lc = reps.prefill(reps.params, prompts, PROMPT)[0]
        ld = Model(cfg).prefill(pruned, prompts, PROMPT)[0]
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    share = (lc - ld).abs().max().item() / (1e-3 * ld.abs().max().item())
    del lc, ld
    if not share <= 1:
        _fail(f"mesh {kind}: fp32 prefill logits {share:.3f} of 1e-3 "
              f"max|logits| from the dense model")
    # guarded: healthy, and with replica 1's payload bit flipped
    ops.reset_launch_counts()
    gt, rep = guard.guarded_generate(reps, None, prompts, GEN, device=dev)
    counts = ops.launch_counts()
    only(counts, kname, 2 * one, "guarded")
    if not rep.healthy or not torch.equal(gt, toks):
        _fail(f"mesh {kind} guarded: healthy={rep.healthy}, tokens "
              f"{'equal' if torch.equal(gt, toks) else 'differ'}")
    role = plan.ops[0].role
    flipped = reps.each(lambda m: m)
    flipped.models[1] = CompressedModel(
        reps.models[1].model, inject.bitflip_payload(reps.models[1].store,
                                                     role))
    ops.reset_launch_counts()
    ft, frep = guard.guarded_generate(flipped, None, prompts, GEN,
                                      device=dev)
    counts = ops.launch_counts()
    only(counts, kname, 2 * 6 * cfg.n_layers * (1 + GEN), "bit flipped")
    dt, *_ = run(reps.each(lambda m: m.demoted([role])), prompts)
    if frep.verify[role] != "checksum_mismatch" or \
            [f["code"] for f in frep.fallbacks] != ["integrity_violation"] \
            or not torch.equal(ft, dt):
        _fail(f"mesh {kind} bit flip on replica 1: {frep.stable_dict()}, "
              f"tokens {'equal' if torch.equal(ft, dt) else 'differ'}")
    print(f"[mesh {kind}] fp32 prefill logits {share:.4f} of 1e-3 "
          f"max|logits| from the dense model; guarded healthy: tokens "
          f"equal, {2 * one} launches; replica 1's {role} bit flipped: "
          f"checksum_mismatch, the role demoted on both replicas, the "
          f"demoted model's tokens; naive: tokens equal, {2 * one} "
          f"launches; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    return launches


def _mesh_train(cfg, card: str, dev) -> None:
    """Phase 16's training: ``train.train`` on (2, 1) repeating ``dev``
    against one device, fp32."""
    import io
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import data_parallel, train
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model
    tcfg = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)
    params = Model(tcfg).init(seed=0, device=dev)
    args = train.parse_args([
        "--arch", "chatglm3-6b", "--steps", str(MESH_TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr",
        str(TRAIN_LR), "--log-every", "1", "--device", str(dev)])
    mesh_ = _data_meshes(dev)[0][1]
    seconds = {}
    L.COMPUTE_DTYPE = torch.float32
    ops.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            # one device first: it pays the first step's warm-up
            t0 = time.perf_counter()
            alone = train.train(tcfg, params, args, device=dev)
            seconds["one device"] = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            meshed = train.train(tcfg, params, args, device=dev, mesh=mesh_)
            seconds["mesh"] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    if sum(ops.launch_counts().values()):
        _fail(f"mesh train: kernels launched {ops.launch_counts()}")
    gap = max(abs(a - b) for a, b in zip(meshed.losses, alone.losses))
    if len(meshed.replicas) != 2 or \
            not data_parallel.params_equal(meshed.replicas) or \
            len(meshed.losses) != len(alone.losses) or gap > 1e-5:
        _fail(f"mesh train: losses {meshed.losses} against one device's "
              f"{alone.losses}; replicas equal "
              f"{data_parallel.params_equal(meshed.replicas)}")
    print(f"[mesh train] chatglm3-6b {MESH_TRAIN_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, fp32, {MESH_TRAIN_STEPS} steps on "
          f"(2, 1) repeating {dev}: the replicas' params bit for bit equal "
          f"after every step; losses {[round(x, 6) for x in meshed.losses]}"
          f", largest gap to one device over the whole batch {gap:.3e}; "
          f"{seconds['mesh']:.1f} s against {seconds['one device']:.1f} s "
          f"on one device (run first, with the warm-up); the mesh's peak "
          f"{peak:.2f} GiB; no kernel launched; "
          f"{card}")


def phase_mesh(cfg, card: str, dev) -> dict[str, int]:
    """Phase 16: serving and training over a data mesh (see the module
    docstring).  Returns kernel -> launches of its mesh run."""
    import gc
    import torch
    t_all = time.perf_counter()
    launches: dict[str, int] = {}
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        launches.update(_mesh_plan(cfg, kind, kname, card, dev))
        gc.collect()
        torch.cuda.empty_cache()
    _mesh_train(cfg, card, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] phase 16 took {time.perf_counter() - t_all:.1f} s "
          f"({', '.join(label for label, _ in _data_meshes(dev))})")
    return launches


# ---------------------------------------------------------------------------
# Phase 17: tensor-parallel serving over a mesh's model axis
# ---------------------------------------------------------------------------

def _tp_mesh(dev, data: int, model: int, devs=None):
    """A (data, model) mesh over ``devs`` (``dev`` repeated by default)."""
    from repro_torch.launch import mesh
    devs = devs or [dev] * (data * model)
    return mesh.Mesh(("data", "model"), (data, model),
                     mesh.grid(devs, (data, model)))


def _tp_meshes(dev) -> list:
    """Phase 17's (1, 2) meshes, (label, mesh): repeating ``dev`` and, on
    a host of two or more cards, over the first two."""
    import torch
    out = [(f"(1, 2) repeating {dev}", _tp_mesh(dev, 1, 2))]
    if torch.cuda.device_count() >= 2:
        out.append(("(1, 2) over cuda:0 and cuda:1", _tp_mesh(
            dev, 1, 2, [torch.device("cuda", 0), torch.device("cuda", 1)])))
    else:
        print(f"[tp] (1, 2) over two cards: untried, this host has "
              f"{torch.cuda.device_count()} card")
    return out


def _tp_kernels(tp, kname: str, acc: dict) -> float:
    """Both variants of ``kname`` at every shard's layer-0 entry of every
    kernel role, M = 4 and 512, x fp32 and bf16, against the plain
    version (:func:`_run_case`, untimed); returns the largest share of
    the tolerance."""
    import torch
    from repro_torch.device import device_ctx
    gen = torch.Generator(device=tp.devices[0]).manual_seed(17)
    worst = 0.0
    for s, (shard, d) in enumerate(zip(tp.shards, tp.devices)):
        for e in shard.store:
            if e.layer != 0 or e.kind == "dense" or e.expert >= 0:
                continue
            case = _bitmap_case(e.data) if e.kind == "bitmap" \
                else _nm_case(e.data)
            for m in (M_DECODE, M_PREFILL):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, e.data.n), generator=gen,
                                    device=tp.devices[0]).to(d, dtype)
                    with device_ctx(d):
                        worst = max(worst, _run_case(
                            acc, None, kname, f"tp shard {s} {e.role}", x,
                            case, None, log=False))
    return worst


def _tp_fp32_agreement(tag: str, groups, cm, pruned, prompts) -> str:
    """fp32 greedy tokens of the groups' eager decode against one device's
    (the compressed model's eager step), and at the first step where they
    part (its first row) the one device's top-2 logit gap beside the two
    runs' largest logit difference on that row there: a gap within twice
    that difference is a near tie the all-reduces' summation order can
    swap; a wider one fails the run."""
    import torch
    from repro_torch.launch import compiled
    from repro_torch.models import layers as L

    def logits_run(step, model, params):
        first = model.prefill(params, prompts, PROMPT + GEN)[0][:, -1]
        toks, steps = compiled.greedy(step, model, params, prompts, GEN)
        return toks, [first] + steps

    L.COMPUTE_DTYPE = torch.float32
    try:
        toks_tp, logits_tp = logits_run(groups.step(compiled.CompiledStep),
                                        groups, groups.params)
        toks_one, logits_one = logits_run(cm.decode_step, cm, pruned)
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    same = toks_tp == toks_one.to(toks_tp.device)
    out = (f"fp32 greedy agreement with one device "
           f"{same.float().mean().item():.4f}")
    parted = (~same).nonzero().tolist()
    if not parted:
        return out
    row, i = min(parted, key=lambda ri: (ri[1], ri[0]))
    one = logits_one[i][row].float()
    top2 = torch.topk(one, 2).values
    gap = (top2[0] - top2[1]).item()
    diff = (logits_tp[i][row].to(one.device) - one).abs().max().item()
    out = (f"{out}; first parted at token {i} of row {row}: one device's "
           f"top-2 logit gap {gap:.6g} ({gap / one.abs().max().item():.3e} "
           f"of max|logits|), the runs' largest logit difference there "
           f"{diff:.6g}")
    if gap > 2 * diff:
        _fail(f"{tag}: {out}: not a near tie")
    return f"{out}: a near tie"


def _tp_plan(cfg, kind: str, kname: str, card: str, dev, acc: dict
             ) -> dict[str, int]:
    """Phase 17 on one plan (chatglm3-6b's shipped plan, a MoE model's
    searched one); returns the launches of its first mesh's run,
    pipelined and naive."""
    import gc
    import torch
    from repro_torch.exec.compress import compress_params, prune_params
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, data_parallel, serve
    from repro_torch.launch import tensor_parallel as tpm
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    moe = cfg.moe is not None
    tag = f"tp {cfg.name} {kind}" if moe else f"tp {kind}"
    # one device's launches a run: the plan's kernel at each kernel role
    one = len(_kernel_roles(cfg)) * cfg.n_layers * (1 + GEN)
    secs: dict[str, float] = {}            # wall seconds by part
    t0 = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        secs[part] = secs.get(part, 0.0) + now - t0
        t0 = now

    plan = serve._fast_plan(cfg, 64, serve.PLAN_SPARSITY[kind]) if moe \
        else shipped_plan(cfg, kind)
    params = Model(cfg).init(seed=0, device=dev)
    pruned = prune_params(params, plan, cfg)
    del params
    cm = CompressedModel(Model(cfg), compress_params(pruned, plan, cfg))
    pg = torch.Generator(device=dev).manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pg,
                            device=dev)

    def run(model, graphed=True):
        """One counted run: tokens, prefill ms, decode ms/token, launch
        counts (``model`` a mesh's groups serves its own params)."""
        ops.reset_launch_counts()
        with contextlib.nullcontext() if graphed else compiled.disable():
            toks, tp_, tg = serve.generate(model, pruned, prompts, GEN,
                                           PROMPT + GEN, device=dev)
        return toks, 1e3 * tp_, 1e3 * tg / GEN, ops.launch_counts()

    def only(counts, name, n, label):
        if counts[name] != n or sum(counts.values()) != n:
            _fail(f"{tag} {label}: launch counts {counts}; expected "
                  f"{n} of {name} only")

    def fp32_share(groups, t: int) -> tuple[float, dict]:
        """The groups' fp32 prefill logits against the dense model's on
        the same pruned weights, as a share of 1e-3 max|logits|; a MoE
        model's on the rows whose routing does not part at a near tie
        (:func:`_held_rows`: its shards must route alike), with the rows
        that part."""
        L.COMPUTE_DTYPE = torch.float32
        rc, rd = [], []
        try:
            with _routes(rc):
                lc = groups.prefill(groups.params, prompts, PROMPT)[0]
            with _routes(rd):
                ld = Model(cfg).prefill(pruned, prompts, PROMPT)[0]
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        if moe:
            # each shard's routes lie on its own device: compare on one
            if len(rc) != t * len(rd) or any(
                    not torch.equal(rc[j][0].to(dev), rc[j - j % t][0].to(dev))
                    for j in range(len(rc))):
                _fail(f"{tag}: the shards' routing differs")
            share, _, parted = _held_rows(f"{tag} fp32", lc.to(ld.device),
                                          ld, rc[::t], rd)
            return share, parted
        share = (lc.to(ld.device) - ld).abs().max().item() \
            / (1e-3 * ld.abs().max().item())
        if not share <= 1:
            _fail(f"tp {kind}: fp32 prefill logits {share:.3f} of 1e-3 "
                  f"max|logits| from the dense model")
        return share, {}

    def parted_note(parted: dict) -> str:
        return (f" (rows whose routing parts at a near tie, row: (layer, "
                f"token, gap): {parted})" if parted else "")

    base, *_ = run(cm)                     # one device, graphed (captures)
    lap("plan, prune, compress, one device")
    launches: dict[str, int] = {}
    first = None                           # the first mesh's tokens
    for n, (label, mesh_) in enumerate(_tp_meshes(dev)):
        before = secs.get("split", 0.0)
        groups = data_parallel.serving_replicas(cm, pruned, mesh_, dev,
                                                "phase 17")
        tp = groups.models[0]
        lap("split")
        built = secs["split"] - before
        worst = _tp_kernels(tp, kname, acc) if n == 0 else None
        lap("kernels vs plain")
        toks, _, _, counts = run(groups)
        only(counts, kname, 2 * one, label)
        launches.setdefault(kname, counts[kname])
        agree = (toks == base).float().mean().item()
        first = toks if first is None else first
        with ops.pipeline_default(False):
            nt, _, _, counts = run(groups)
        only(counts, f"{kname}_naive", 2 * one, f"{label} naive")
        launches.setdefault(f"{kname}_naive", counts[f"{kname}_naive"])
        if not torch.equal(nt, toks):
            _fail(f"{tag} {label}: the naive kernels' tokens differ")
        lap("runs")
        share, parted = fp32_share(groups, 2)
        lap("fp32")
        if moe:
            cut = (f"shard 1 holds experts {tp.layout.experts(1)} of "
                   f"{cfg.moe.n_experts} and "
                   + (f"embedding rows {tp.layout.vocab_rows(1)}"
                      if tp.layout.vocab_split else
                      f"the whole embedding ({cfg.vocab} rows)"))
        else:
            bits = [tpm.Layout(cfg, 2).cut(r, 1) for r in ("attn.wq",
                                                           "ffn.w_down")]
            cut = (f"shard 1 cuts wq at columns {bits[0][1:]}, w_down at "
                   f"rows {bits[1][1:]}")
        print(f"[{tag}] {label}: split in {built:.1f} s ({cut}); "
              + (f"every shard role's kernels within the tolerance of the "
                 f"plain version at M={M_DECODE} / {M_PREFILL}, fp32 / bf16 "
                 f"(largest share {worst:.4f}), naive == pipelined; "
                 if worst is not None else "")
              + f"{2 * one} launches of {kname} (2 x "
              f"{len(_kernel_roles(cfg))} x {cfg.n_layers} x (1 + {GEN})), "
              f"the naive kernels' too with the same tokens; "
              f"greedy agreement with one device {agree:.4f}"
              + (f", tokens {'' if torch.equal(toks, first) else 'not '}"
                 f"equal to the first mesh's" if n else "")
              + f"; fp32 prefill logits {share:.4f} of 1e-3 max|logits| "
              f"from the dense model{parted_note(parted)}; on {card}")
        if n == 0:
            agreement = _tp_fp32_agreement(tag, groups, cm, pruned, prompts)
            print(f"[{tag}] {label}: {agreement}; on {card}")
            lap("fp32 greedy")
            _tp_guarded(cfg, kind, kname, groups, toks, prompts, one, card,
                        dev)
            lap("guarded")
        _tp_timing(tag, label, cm, groups, run, card, one_eager=not moe)
        lap("timing")
        del groups, tp
        gc.collect()
        torch.cuda.empty_cache()
    if kind == "nm":
        for shape in ((1, 4),) if moe else ((2, 2), (1, 4)):
            groups = data_parallel.serving_replicas(
                cm, pruned, _tp_mesh(dev, *shape), dev, "phase 17")
            toks, _, _, counts = run(groups)
            only(counts, kname, shape[0] * shape[1] * one, f"{shape}")
            agree = (toks == base).float().mean().item()
            share, parted = fp32_share(groups, shape[1])
            held = (f"; each shard holds {cfg.moe.n_experts // shape[1]} "
                    f"experts" if moe else "")
            print(f"[{tag}] {shape} repeating {dev}: "
                  f"{counts[kname]} launches of {kname}{held}; greedy "
                  f"agreement with one device {agree:.4f}; fp32 prefill "
                  f"logits {share:.4f} of 1e-3 max|logits| from the dense "
                  f"model{parted_note(parted)}; on {card}")
            del groups
            gc.collect()
            torch.cuda.empty_cache()
        lap("(1, 4)" if moe else "(2, 2) and (1, 4)")
    print(f"[{tag}] wall seconds: " + ", ".join(
        f"{part} {v:.1f}" for part, v in secs.items()))
    return launches


def _tp_guarded(cfg, kind: str, kname: str, groups, toks, prompts,
                one: int, card: str, dev) -> None:
    """Guarded serving over the groups: healthy, and with one bit flipped
    in the store of one shard (a dense stack's shard 1, in its first
    planned role; a MoE model's in the last layer's last expert's
    ``moe.w_up`` entry, on the shard that holds that expert)."""
    import torch
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.kernels import ops
    from repro_torch.launch import data_parallel, serve
    from repro_torch.launch import tensor_parallel as tpm
    from repro_torch.runtime import guard, inject, integrity

    tag = f"tp {cfg.name} {kind}" if cfg.moe else f"tp {kind}"
    ops.reset_launch_counts()
    gt, rep = guard.guarded_generate(groups, None, prompts, GEN, device=dev)
    counts = ops.launch_counts()
    if counts[kname] != 2 * one or sum(counts.values()) != 2 * one or \
            not rep.healthy or not torch.equal(gt, toks):
        _fail(f"{tag} guarded: launches {counts}, healthy="
              f"{rep.healthy}, tokens "
              f"{'equal' if torch.equal(gt, toks) else 'differ'}")
    tp = groups.models[0]
    if cfg.moe:
        where = dict(role="moe.w_up", layer=cfg.n_layers - 1,
                     expert=cfg.moe.n_experts - 1)
        s = next(i for i in range(len(tp.shards))
                 if where["expert"] < tp.layout.experts(i)[1])
        # the experts run dense: demoting their role moves no launch
        want = 2 * one
    else:
        where = dict(role=tp.shards[0].store.plan.ops[0].role)
        s = 1
        want = 2 * 6 * cfg.n_layers * (1 + GEN)
    role = where["role"]
    shards = list(tp.shards)
    shards[s] = CompressedModel(shards[s].model, inject.bitflip_payload(
        shards[s].store, **where))
    flipped = groups.each(lambda m: m)
    flipped.models[0] = tpm.TensorParallel(shards, tp.layout, tp.devices)
    if cfg.moe:
        found = [integrity.verify_report(st)[role]
                 for st in data_parallel.stores(flipped)]
        if found != ["checksum_mismatch" if i == s else "ok"
                     for i in range(len(found))]:
            _fail(f"{tag}: shard {s}'s flipped {role} entry: the shards' "
                  f"stores report {found}")
    ops.reset_launch_counts()
    ft, frep = guard.guarded_generate(flipped, None, prompts, GEN,
                                      device=dev)
    counts = ops.launch_counts()
    dt, *_ = serve.generate(groups.each(lambda m: m.demoted([role])), None,
                            prompts, GEN, PROMPT + GEN, device=dev)
    if counts[kname] != want or frep.verify[role] != "checksum_mismatch" \
            or [f["code"] for f in frep.fallbacks] != \
            ["integrity_violation"] or not torch.equal(ft, dt) or \
            (cfg.moe and not torch.equal(ft, toks)):
        _fail(f"{tag} bit flip on shard {s}: launches {counts}, "
              f"{frep.stable_dict()}, tokens "
              f"{'equal' if torch.equal(ft, dt) else 'differ'}")
    what = (f"layer {where['layer']} expert {where['expert']}'s {role} "
            f"entry bit flipped on shard {s}, the one that holds it "
            f"(every other shard's store verifies): checksum_mismatch, the "
            f"role demoted on every shard ({want} launches), the healthy "
            f"run's tokens" if cfg.moe else
            f"shard 1's {role} bit flipped: checksum_mismatch, the role "
            f"demoted on both shards ({want} launches), the demoted model's "
            f"tokens")
    print(f"[{tag}] guarded healthy: tokens equal, {2 * one} launches; "
          f"{what}; on {card}")


def _tp_timing(tag: str, label: str, cm, groups, run, card: str,
               one_eager: bool = True) -> None:
    """``TP_RUNS`` runs a mode in turns: the groups (eager: no graph is
    captured for a tensor-parallel step) against one device graphed (and
    with ``one_eager``, eager); then the peak memory of each shard device
    over a run."""
    import torch
    modes = [("tp eager", groups, True), ("one device graphed", cm, True)]
    if one_eager:
        modes.append(("one device eager", cm, False))
    rec: dict = {mode: [] for mode, _, _ in modes}
    for _ in range(TP_RUNS):
        for mode, model, graphed in modes:
            _, tp_, tg, _ = run(model, graphed)
            rec[mode].append((tp_, tg))
    devs = sorted({d for m in groups.models for d in m.devices}, key=str)
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    run(groups)
    peaks = ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.2f}"
                      f" GiB" for d in devs)
    print(f"[{tag}] {label}: bf16, {TP_RUNS} runs a mode in turns, "
          f"prefill ms / decode ms/token, median (min-max): " + "; ".join(
              f"{mode} {_spread([t[0] for t in r])} / "
              f"{_spread([t[1] for t in r])}" for mode, r in rec.items())
          + f"; peak over a tp run (both shards' devices): {peaks}; on "
          f"{card}")


def _tp_moe(card: str, dev, acc: dict) -> dict[str, int]:
    """Phase 17's MoE part: ``TP_MOE_ARCH`` cut to ``TP_MOE_LAYERS``
    layers on both plans.  Returns kernel -> launches of its first mesh's
    runs."""
    import gc
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    moe = dataclasses.replace(get_config(TP_MOE_ARCH),
                              n_layers=TP_MOE_LAYERS)
    launches: dict[str, int] = {}
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        for name, n in _tp_plan(moe, kind, kname, card, dev, acc).items():
            launches[name] = launches.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[tp] the MoE part ({moe.name}, {moe.n_layers} of "
          f"{get_config(TP_MOE_ARCH).n_layers} layers) took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def _tp_ring_wrap(tag: str, model, params, groups, dev) -> str:
    """Batch 1, fp32: one device's cache seeded at random, each shard's
    its KV-head slices of it; from ``TP_WRAP_BEFORE`` positions before
    the rings' wrap to ``TP_WRAP_PAST`` past it, the group's step against
    one device's eager step from the same cache, each step's logits
    within 1e-3 max|logits|.  Returns the worst share."""
    import torch
    from repro_torch.models import layers as L
    tp = groups.models[0]
    win = model.cfg.window
    first, n = win - TP_WRAP_BEFORE, TP_WRAP_BEFORE + TP_WRAP_PAST
    L.COMPUTE_DTYPE = torch.float32
    try:
        one = model.init_cache(1, first + n, device=dev)
        gen = torch.Generator(device=dev).manual_seed(11)
        for group in one.values():
            for leaf in group.values():
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=dev))
        cache = tp.init_cache(1, first + n)
        for s, shard in cache.items():
            lo, k = tp.layout.kv_heads(s)
            for g, group in shard.items():
                if group["k"].shape[2] != one[g]["k"].shape[2]:
                    _fail(f"{tag} wrap: shard {s}'s {g} cache is "
                          f"{group['k'].shape[2]} long, one device's "
                          f"{one[g]['k'].shape[2]}")
                for name, leaf in group.items():
                    leaf.copy_(one[g][name].narrow(3, lo, k))
        toks = torch.randint(0, model.cfg.vocab, (n, 1), generator=gen,
                             device=dev)
        pos = torch.empty((), dtype=torch.long, device=dev)
        worst = 0.0
        for i in range(n):
            want, one = model.decode_step(params, one, toks[i],
                                          pos.fill_(first + i))
            got, cache = tp.decode_step(groups.params[0], cache, toks[i],
                                        pos)
            scale = want.abs().max().item()
            share = (got.to(want.device) - want).abs().max().item() \
                / (1e-3 * scale)
            worst = max(worst, share)
            if not share <= 1:
                _fail(f"{tag} wrap: position {first + i}: {share:.4f} of "
                      f"1e-3 max|logits| from one device's step")
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    return (f"the wrap at the full window ({win}): batch 1, fp32, positions "
            f"{first}..{first + n - 1} (ring slots {first % win}.."
            f"{(first + n - 1) % win}) from one device's seeded cache and "
            f"its KV-head slices, each step within {worst:.4f} of 1e-3 "
            f"max|logits| of one device's eager step")


def _tp_ring_guarded(tag: str, groups, toks, prompts, dev) -> str:
    """``guarded_generate`` over the groups healthy, and with a NaN at a
    decode position once (the failed step also writes NaN into every
    shard's ring and global slot): retried, the healthy run's tokens."""
    import dataclasses as dc
    import torch
    from repro_torch.launch import tensor_parallel as tpm
    from repro_torch.models.transformer import step_writes
    from repro_torch.runtime import guard

    @dc.dataclass(eq=False)
    class NanOnce(tpm.TensorParallel):
        at: int = -1

        def decode_step(self, params, cache, tokens, pos):
            logits, cache = super().decode_step(params, cache, tokens, pos)
            if int(pos) == self.at:
                self.at = -1
                for t in step_writes(cache, int(pos)):
                    t.fill_(float("nan"))
                logits = torch.full_like(logits, float("nan"))
            return logits, cache

    gt, rep = guard.guarded_generate(groups, None, prompts, GEN, device=dev)
    if not rep.healthy or not torch.equal(gt, toks):
        _fail(f"{tag} guarded: {rep.stable_dict()}, tokens "
              f"{'equal' if torch.equal(gt, toks) else 'differ'}")
    at = prompts.shape[1] + GEN // 2
    tp = groups.models[0]
    faulty = groups.each(lambda m: m)
    faulty.models[0] = NanOnce(tp.shards, tp.layout, tp.devices, at=at)
    ft, frep = guard.guarded_generate(faulty, None, prompts, GEN,
                                      device=dev)
    if frep.retries != 1 or frep.switched_to_dense_at is not None or \
            not torch.equal(ft, toks):
        _fail(f"{tag} guarded NaN at {at}: {frep.stable_dict()}, tokens "
              f"{'equal' if torch.equal(ft, toks) else 'differ'}")
    return (f"guarded healthy: tokens equal; a NaN at decode position {at} "
            f"(written into every shard's ring and global slot too): one "
            f"retry, the healthy run's tokens")


def _tp_gemma3(card: str, dev) -> None:
    """Phase 17's gemma3 part: ``TP_RING_ARCH`` cut to ``TP_RING_LAYERS``
    layers, dense (the compressed plane refuses it, as the reference's
    does), its prompt ingested token by token through the group's step
    (see the module docstring).  No kernel may launch."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import compiled, data_parallel, serve
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    t0 = time.perf_counter()
    full = get_config(TP_RING_ARCH)
    cfg = dataclasses.replace(full, n_layers=TP_RING_LAYERS)
    tag = f"tp {cfg.name}"
    ops.reset_launch_counts()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    pg = torch.Generator(device=dev).manual_seed(6)
    plen = TP_RING_PROMPT
    prompts = torch.randint(0, cfg.vocab, (BATCH, plen), generator=pg,
                            device=dev)

    def run(m, graphed=True):
        """One run: tokens, ingest ms (the prefill), decode ms/token."""
        with contextlib.nullcontext() if graphed else compiled.disable():
            toks, tp_, tg = serve.generate(m, params, prompts, GEN,
                                           plen + GEN, device=dev)
        return toks, 1e3 * tp_, 1e3 * tg / GEN, {}

    base, *_ = run(model)                  # one device, graphed (captures)
    seq = torch.cat([prompts, base[:, :-1].long()], dim=1)
    L.COMPUTE_DTYPE = torch.float32
    try:
        want = _forced_steps(model.decode_step, model, params, seq)
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    print(f"[{tag}] full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, window {cfg.window}), {cfg.n_layers} of "
          f"{full.n_layers} layers, seeded random weights, dense; batch "
          f"{BATCH}, prompt {plen} ingested token by token, {GEN} tokens, "
          f"bf16; one device graphed first ({time.perf_counter() - t0:.1f} "
          f"s with init); on {card}")
    meshes = _tp_meshes(dev) + [(f"(1, 4) repeating {dev}",
                                 _tp_mesh(dev, 1, 4))]
    for n, (label, mesh_) in enumerate(meshes):
        t1 = time.perf_counter()
        groups = data_parallel.serving_replicas(model, params, mesh_, dev,
                                                "phase 17")
        tp = groups.models[0]
        built = time.perf_counter() - t1
        toks, *_ = run(groups)
        agree = (toks == base).float().mean().item()
        L.COMPUTE_DTYPE = torch.float32
        try:
            got = _forced_steps(groups.decode_step, groups, groups.params,
                                seq)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        share = max((g.to(w.device) - w).abs().max().item()
                    / (1e-3 * w.abs().max().item())
                    for g, w in zip(got, want))
        if not share <= 1:
            _fail(f"{tag} {label}: fp32 logits {share:.4f} of 1e-3 "
                  f"max|logits| from one device's")
        lo, k = tp.layout.kv_heads(len(tp.shards) - 1)
        print(f"[{tag}] {label}: split in {built:.1f} s (the last shard "
              f"holds {tp.shards[0].cfg.n_heads} query heads and KV heads "
              f"{lo}..{lo + k - 1}, vocab rows "
              f"{tp.layout.vocab_rows(len(tp.shards) - 1)}); bf16 greedy "
              f"agreement with one device {agree:.4f}; fp32, the "
              f"{len(want)} steps ({plen} ingest, {GEN - 1} decode) along "
              f"one device's tokens within {share:.4f} of 1e-3 max|logits| "
              f"of one device's eager step; on {card}")
        if n == 0:
            print(f"[{tag}] {label}: "
                  f"{_tp_ring_wrap(tag, model, params, groups, dev)}; "
                  f"{_tp_ring_guarded(tag, groups, toks, prompts, dev)}; "
                  f"on {card}")
        if n < len(meshes) - 1:
            _tp_timing(tag, label, model, groups, run, card,
                       one_eager=False)
        del groups, tp
        gc.collect()
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if sum(counts.values()):
        _fail(f"{tag}: kernels launched: {counts}; gemma3 is served dense")
    print(f"[tp] the gemma3 part ({cfg.name}, {cfg.n_layers} of "
          f"{full.n_layers} layers) launched none of the five kernels and "
          f"took {time.perf_counter() - t0:.1f} s")


def phase_tensor_parallel(cfg, card: str, dev, acc: dict) -> dict[str, int]:
    """Phase 17: serving over a mesh's ``model`` axis (see the module
    docstring).  Returns kernel -> launches of its first mesh's runs."""
    import gc
    import torch
    t_all = time.perf_counter()
    launches: dict[str, int] = {}
    for kind, kname in (("bitmap", "bitmap_spmm"), ("nm", "nm_spmm")):
        launches.update(_tp_plan(cfg, kind, kname, card, dev, acc))
        gc.collect()
        torch.cuda.empty_cache()
    for name, n in _tp_moe(card, dev, acc).items():
        launches[name] = launches.get(name, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    _tp_gemma3(card, dev)
    print(f"[tp] phase 17 took {time.perf_counter() - t_all:.1f} s")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this run needs a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        _fail(f"the port's sources are not at {SRC}")
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config

    seconds: dict[str, float] = {}        # wall seconds a phase

    def timed(phase: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[phase] = time.perf_counter() - t0
        return out

    card = timed("1", phase_environment)
    timed("2", phase_build)
    cfg = get_config("chatglm3-6b")
    dev = torch.device("cuda", 0)
    acc = timed("3", phase_kernels, cfg, card, dev)
    flash = timed("4", phase_flash, cfg, card, dev)
    launches = timed("5", phase_serving, cfg, card, dev)
    mixer_launches = timed("6", phase_mixer, dataclasses.replace(
        cfg, n_layers=MIX_LAYERS), card, dev)
    guarded_launches = timed("7", phase_guarded, dataclasses.replace(
        cfg, n_layers=GUARD_LAYERS), card, dev)
    forwards: dict[str, dict] = {}
    gqa_cfg = dataclasses.replace(cfg, n_layers=GQA_LAYERS)

    def calibration_forwards(kind, cm, pruned, prompts):
        kname = "bitmap_spmm" if kind == "bitmap" else "nm_spmm"
        forwards[kind] = _calibration_forwards(gqa_cfg, kind, kname, cm,
                                               pruned, prompts, card, dev)

    gqa_launches = timed("8 (+ 10's forwards)", phase_gqagroup, gqa_cfg,
                         card, dev, then=calibration_forwards)
    telemetry_launches = timed("9", phase_telemetry, cfg, card, dev)
    timed("10", phase_search, cfg, card, forwards)
    families_launches = timed("11", phase_families, card, dev, acc)
    timed("12", phase_dense_families, card, dev)
    train = timed("13", phase_train, card, dev)
    flags_launches = timed("14", phase_flags, card, dev, acc)
    timed("15", phase_dryrun, card, dev, train)
    mesh_launches = timed("16", phase_mesh, dataclasses.replace(
        cfg, n_layers=MESH_LAYERS), card, dev)
    tp_launches = timed("17", phase_tensor_parallel, dataclasses.replace(
        cfg, n_layers=TP_LAYERS), card, dev, acc)
    print("[time] wall seconds a phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; sum {sum(seconds.values()):.1f}")
    search_launches: dict[str, int] = {}
    for f in forwards.values():
        for name, n in f["launches"].items():
            search_launches[name] = search_launches.get(name, 0) + n

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
                 "search_launches": search_launches.get(name, 0),
                 "families_launches": families_launches.get(name, 0),
                 "flags_launches": flags_launches.get(name, 0),
                 "mesh_launches": mesh_launches.get(name, 0),
                 "tp_launches": tp_launches.get(name, 0),
                 "max_abs_err": a.max_abs_err}
        for key, m in (("decode", M_DECODE), ("prefill", M_PREFILL)):
            s = a.sums[(cfg.name, m, torch.bfloat16)]
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
        entry["families"] = {}
        for (arch, m, dtype), s in a.sums.items():
            if arch == cfg.name or dtype != torch.bfloat16:
                continue
            bound, by = _bound_ms(s["bytes"], s["flops"])
            entry["families"].setdefault(arch, {})[f"M={m}"] = {
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": bound, "bound_by": by,
                "library_ms": s["library_ms"], "roles": s["roles"]}
        kernels.append(entry)
    # flash: headline shape BH=128 S=2048 causal bf16; every shape listed
    head = flash["head"]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": sources["flash_attention"][0],
        "replaces": sources["flash_attention"][1],
        "launches": flash["launches"], "families_launches": 0,
        "flags_launches": 0, "mesh_launches": 0, "tp_launches": 0,
        "max_abs_err": flash["max_abs_err"],
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
