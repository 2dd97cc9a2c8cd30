"""Batched serving loop: one-pass prefill + KV-cache greedy decode, for
the dense :class:`~repro_torch.models.transformer.Model` and the
execution plane's :class:`~repro_torch.exec.dispatch.CompressedModel`
(same surface), with per-phase tokens/s reporting.  On the card each
decode step after a key's first replays a CUDA graph
(:mod:`repro_torch.launch.compiled`, the counterpart of the reference's
``jax.jit`` of the step); ``compiled.disable()`` serves it eagerly.

LEFT-padded ragged prompts are served via ``prompt_pad_id``: each row is
prefilled alone at its real length, written into its row of a shared cache
and decoded with a per-row position vector (the mixer's admission
primitive).  For continuous batching over a request STREAM (admit/evict
into a running decode batch, sampled decoding) see
:mod:`repro_torch.launch.mixer` and the ``--mixer`` CLI mode.
``guarded=True`` (``--guarded``) serves through the robustness layer of
:mod:`repro_torch.runtime.guard` and reports a ``HealthReport``.

Usage (on the card; ``--device cpu`` runs the plain PyTorch versions)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
      [--reduced] --batch 4 --prompt-len 128 --gen 16 [--compressed \\
      [--plan bitmap|nm]] [--eos ID] [--guarded [--deadline S]] \\
      [--mixer --slots 2 --temperature 0.8 --top-k 20 --deadline S] \\
      [--trace PATH] [--metrics PATH] [--device cuda]

``--compressed`` co-searches a plan (:func:`_fast_plan`, the reference
CLI's small budget; ``--plan`` picks the sparsity model it searches under)
and serves its compressed store.

``--trace PATH`` writes the serving run's span trace as Chrome trace-event
JSON to PATH and its deterministic projection to PATH.stable.json;
``--metrics PATH`` a metrics snapshot to PATH and its Prometheus text to
PATH.prom.  Either installs :func:`repro_torch.obs.profile.kernel_timer`
(and, with ``--compressed``, the dispatcher's ``instrument()``), which
keeps decode eager: every executed dispatch is counted.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cosearch import CoSearchConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.core.sparsity import NM, BlockBernoulli, Sparsity
from repro_torch.device import resolve, synchronize
from repro_torch.exec.compress import compress_params, prune_params
from repro_torch.exec.dispatch import CompressedModel, instrument
from repro_torch.exec.plans import ExecPlan, build_exec_plan
from repro_torch.launch.compiled import CompiledStep
from repro_torch.launch.mixer import (Mixer, Request, prefill_request,
                                      write_slot)
from repro_torch.models.transformer import Model
from repro_torch.obs import metrics as omet
from repro_torch.obs import trace as otr
from repro_torch.obs.profile import kernel_timer


def _rate(n: float, t: float) -> float:
    """tokens / seconds with a floor on the denominator (a tiny run can
    time ~0 s)."""
    return n / max(t, 1e-9)


def _prompt_offsets(prompts: torch.Tensor, prompt_pad_id: Optional[int]
                    ) -> np.ndarray:
    """Per-row first-real-token offsets of a LEFT-padded prompt batch.

    With ``prompt_pad_id`` None every prompt is taken as unpadded (offset
    0).  Otherwise each row must be ``[pad... real...]`` with at least one
    real token — pads after the first real token (right/interior padding)
    are rejected loudly instead of silently mis-positioning the row."""
    b, plen = prompts.shape
    if prompt_pad_id is None:
        return np.zeros(b, np.int64)
    pn = prompts.cpu().numpy()
    real = pn != prompt_pad_id
    offsets = np.argmax(real, axis=1)
    for r in range(b):
        if not real[r].any():
            raise ValueError(f"prompt row {r} is all padding "
                             f"(pad_id={prompt_pad_id})")
        if not real[r, offsets[r]:].all():
            raise ValueError(
                f"prompt row {r} has pad tokens after its first real "
                f"token; prompts must be LEFT-padded (pad_id="
                f"{prompt_pad_id})")
    return offsets


def _generate(model, params, prompts: torch.Tensor, gen: int, max_len: int,
              eos_id: Optional[int] = None, pad_id: int = -1,
              prompt_pad_id: Optional[int] = None):
    b, plen = prompts.shape
    if plen > max_len or plen + gen > max_len:
        raise ValueError(f"prompt ({plen}) + gen ({gen}) exceeds "
                         f"max_len ({max_len})")
    offsets = _prompt_offsets(prompts, prompt_pad_id)
    dev = prompts.device
    tid = otr.trace_id()

    t0 = time.perf_counter()
    with otr.span("prefill", trace_id=tid, batch=b, plen=plen,
                  ragged=bool(offsets.any())):
        if offsets.any():
            # ragged left-padded rows: admit each row alone at its REAL
            # length into its row of the shared cache, then decode with a
            # per-row position vector — the continuous-batching admission
            # primitive (launch.mixer)
            cache = model.init_cache(b, max_len, device=dev)
            lasts = []
            for r in range(b):
                with otr.span("admit", trace_id=tid, row=r,
                              prompt_len=plen - int(offsets[r])):
                    last, rcache = prefill_request(
                        model, params, prompts[r:r + 1, int(offsets[r]):],
                        max_len)
                    write_slot(cache, rcache, r)
                lasts.append(last)
            logits = torch.stack(lasts)
            first = torch.as_tensor(plen - offsets, device=dev)  # per-row
        else:
            first = None                                      # lockstep
            all_logits, cache = model.prefill(params, prompts, max_len)
            logits = all_logits[:, -1]
        synchronize(dev)
    t_prefill = time.perf_counter() - t0

    out = []                      # int32 tokens, as the reference returns
    tok = logits.argmax(dim=-1)   # int64: the next step's embedding index
    done = torch.zeros(b, dtype=torch.bool, device=dev)  # rows past EOS
    step = CompiledStep(model)
    pos = torch.empty(() if first is None else (b,), dtype=torch.long,
                      device=dev)
    t1 = time.perf_counter()
    with otr.span("decode", trace_id=tid, batch=b, gen=gen):
        for i, t in enumerate(range(plen, plen + gen)):
            if eos_id is None:
                out.append(tok.int())
            else:
                # a row's EOS token is emitted, later positions hold
                # pad_id, and once every row is done the remaining steps
                # are skipped
                out.append(torch.where(done, pad_id, tok).int())
                done |= tok == eos_id
                if bool(done.all()):
                    break
            # on the device: no host-to-device copy
            if first is None:
                pos.fill_(t)
            else:
                torch.add(first, i, out=pos)
            logits, cache = step(params, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        synchronize(dev)
    t_gen = time.perf_counter() - t1
    omet.counter_inc("serve_static_tokens_total", b * len(out))
    if len(out) < gen:
        out.extend([torch.full((b,), pad_id, dtype=torch.int32,
                               device=dev)] * (gen - len(out)))
    return torch.stack(out, dim=1), t_prefill, t_gen


def generate(model, params, prompts, gen: int, max_len: int, *,
             guarded: bool = False, eos_id: Optional[int] = None,
             pad_id: int = -1, prompt_pad_id: Optional[int] = None,
             device="cuda", **guard_kwargs):
    """Greedy decode for a batch of prompts on ``device``.

    ``model`` is anything with the serving surface (``prefill`` /
    ``init_cache`` / ``decode_step``): the dense Model or a
    CompressedModel.  Returns (tokens (B, gen) int32, t_prefill_s,
    t_gen_s).  Prompts are equal-length by default; pass ``prompt_pad_id``
    to serve LEFT-padded ragged rows (each row prefills alone at its real
    length and decodes at its own position).  ``eos_id`` ends rows early:
    the EOS token is emitted, later positions hold ``pad_id``, and decode
    stops once every row is done.

    ``guarded=True`` routes through the robustness layer
    (:func:`repro_torch.runtime.guard.guarded_generate`: store
    verification, per-role dense demotion, NaN/Inf retry, deadline) and
    appends the :class:`~repro_torch.runtime.guard.HealthReport` to the
    return tuple; ``guard_kwargs`` (``verify=``, ``deadline_s=``,
    ``max_retries=``, ``dense_model=``) pass through."""
    if guarded:
        from repro_torch.runtime.guard import guarded_generate
        if prompt_pad_id is not None:
            raise NotImplementedError(
                "guarded serving takes equal-length prompts; serve ragged "
                "streams through repro_torch.launch.mixer")
        toks, report = guarded_generate(model, params, prompts, gen,
                                        max_len, eos_id=eos_id,
                                        pad_id=pad_id, device=device,
                                        **guard_kwargs)
        return toks, report.t_prefill_s, report.t_decode_s, report
    if guard_kwargs:
        raise TypeError(f"generate: {sorted(guard_kwargs)} need "
                        f"guarded=True")
    dev = resolve(device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    return _generate(model, params, prompts, gen, max_len, eos_id=eos_id,
                     pad_id=pad_id, prompt_pad_id=prompt_pad_id)


#: the sparsity model ``--plan`` searches under: block-pruned weights at
#: density 0.5 in 32 x 32 blocks, or 2:4
PLAN_SPARSITY: dict[str, Sparsity] = {"bitmap": BlockBernoulli(0.5, 32 * 32),
                                      "nm": NM(2, 4)}
#: the small search budget of the CLI's plans (the reference's
#: ``_fast_plan``); calibration re-searches under it too
FAST_SEARCH = CoSearchConfig(objective="edp",
                             engine=EngineConfig(max_levels=2,
                                                 max_allocs_per_pattern=16),
                             spatial_top=2, max_pairs=6)


def _fast_plan(cfg, tokens: int, sparsity: Optional[Sparsity] = None
               ) -> ExecPlan:
    """A small-budget co-searched plan for CLI/demo serving (the
    reference's, at fp32 value width); ``sparsity`` defaults to the
    bitmap model."""
    if sparsity is None:
        sparsity = PLAN_SPARSITY["bitmap"]
    return build_exec_plan(cfg, sparsity, tokens=tokens,
                           search_cfg=FAST_SEARCH, value_bits=32)


def compressed_model(cfg, params, plan: Optional[ExecPlan] = None,
                     device="cuda"):
    """Plan → prune → compress → :class:`CompressedModel` in one call.

    With no ``plan`` the bitmap plan is co-searched for ``cfg`` at 64
    tokens (:func:`_fast_plan`), as the reference does.  ``params``
    must already lie on ``device``.  Returns (compressed_model,
    pruned_params) — serve with the PRUNED tree."""
    dev = resolve(device)
    if params["embed"].device != dev:
        raise ValueError(f"params lie on {params['embed'].device}, "
                         f"not on {dev}")
    if plan is None:
        plan = _fast_plan(cfg, 64)
    pruned = prune_params(params, plan, cfg)
    store = compress_params(pruned, plan, cfg)
    return CompressedModel(Model(cfg), store), pruned


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--compressed", action="store_true",
                    help="co-search a plan and serve the compressed store")
    ap.add_argument("--plan", choices=tuple(PLAN_SPARSITY), default="bitmap",
                    help="the sparsity model --compressed searches under: "
                         "block-pruned (bitmap kernels) or 2:4 (N:M)")
    ap.add_argument("--guarded", action="store_true",
                    help="serve through the robustness layer (verify + "
                         "retry + dense degradation) and print the health "
                         "report")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request wall-clock budget in seconds "
                         "(guarded / mixer modes)")
    ap.add_argument("--mixer", action="store_true",
                    help="continuous batching: serve a mixed-length request "
                         "stream through repro_torch.launch.mixer instead of "
                         "one static lockstep batch")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots for --mixer (default: --batch)")
    ap.add_argument("--eos", type=int, default=None,
                    help="EOS token id: rows/requests stop early once it is "
                         "emitted (tail padded with pad_id)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for --mixer requests "
                         "(0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k cutoff for sampled --mixer decoding "
                         "(0 = full vocab)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="capture a span trace of the run and write Chrome "
                         "trace-event JSON (load in chrome://tracing) plus "
                         "PATH.stable.json, the deterministic projection")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="collect serving metrics and write a JSON snapshot "
                         "to PATH plus Prometheus text exposition to "
                         "PATH.prom")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    label = f"{cfg.name} (d_model={cfg.d_model}, layers={cfg.n_layers})"
    ratio = None
    if args.compressed:
        plan = _fast_plan(cfg, 64, PLAN_SPARSITY[args.plan])
        model, params = compressed_model(cfg, params, plan, device=dev)
        ratio = model.store.achieved_ratio()
        fb = model.store.plan.fallback_counts()
        label += f" [compressed: ratio={ratio:.3f} fallbacks={fb or 'none'}]"
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)

    # telemetry (--trace / --metrics): the contexts wrap the serving run
    # only, so model build and planning stay out of the exports
    tel = contextlib.ExitStack()
    tracer = otr.Tracer() if args.trace is not None else None
    registry = omet.MetricsRegistry() if args.metrics is not None else None
    exec_counters = None
    if tracer is not None:
        tel.enter_context(otr.tracing(tracer))
    if registry is not None:
        tel.enter_context(omet.collecting(registry))
    if tracer is not None or registry is not None:
        tel.enter_context(kernel_timer(registry=registry, tracer=tracer))
        if args.compressed:
            exec_counters = tel.enter_context(instrument())

    def _telemetry_done(mx=None) -> None:
        """Close the capture contexts, fold the passive sources in,
        export."""
        tel.close()
        if registry is not None:
            if exec_counters is not None:
                omet.ingest_instrument(registry, exec_counters)
            omet.collect_caches(registry)
            if mx is not None:
                omet.ingest_straggler(registry, mx.straggler)
            if ratio is not None:
                registry.gauge_set("serve_achieved_compression_ratio", ratio)
            registry.save(args.metrics)
            with open(args.metrics + ".prom", "w") as fh:
                fh.write(registry.prometheus_text())
            print(f"  metrics: {args.metrics} (+ {args.metrics}.prom)")
        if tracer is not None:
            tracer.save_chrome(args.trace)
            tracer.save_stable(args.trace + ".stable.json")
            print(f"  trace: {args.trace} ({len(tracer.events)} events; "
                  f"stable projection at {args.trace}.stable.json)")

    if args.mixer:
        slots = args.slots or args.batch
        # mixed-length stream: prompt lengths cycle below --prompt-len so
        # admissions land at distinct positions (the point of the mixer)
        reqs = []
        for i in range(args.batch):
            plen = max(1, args.prompt_len - (i % 4) * (args.prompt_len // 5))
            reqs.append(Request(
                uid=f"req{i}", prompt=rng.integers(0, cfg.vocab, (plen,)),
                max_new=args.gen, temperature=args.temperature,
                top_k=args.top_k, seed=i))
        mx = Mixer(model, params, slots=slots,
                   max_len=args.prompt_len + args.gen, eos_id=args.eos,
                   deadline_s=args.deadline)
        results = mx.run(reqs)
        st = mx.stats()
        print(f"[serve/mixer] {label}: slots={slots} requests={len(reqs)} "
              f"on {where}")
        for req, res in zip(reqs, results):
            print(f"  {res.uid}: prompt={len(req.prompt)} "
                  f"tok={res.n_tokens}/{len(res.tokens)} slot={res.slot} "
                  f"admit_step={res.admit_step} "
                  f"eos={res.report.eos_hit} out={res.tokens[:6].tolist()}")
        print(f"  admit   {st['admits']} requests in {st['t_admit_s']:.3f}s")
        print(f"  decode  {st['tokens']} tok in {st['t_decode_s']:.3f}s "
              f"over {st['steps']} steps "
              f"({_rate(st['tokens'], st['t_decode_s']):.1f} tok/s) "
              f"slot_reuse_admits={st['slot_reuse_admits']}")
        _telemetry_done(mx)
        return

    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    report = None
    if args.guarded:
        toks, t_prefill, t_gen, report = generate(
            model, params, prompts, args.gen, args.prompt_len + args.gen,
            guarded=True, deadline_s=args.deadline, eos_id=args.eos,
            device=dev)
    else:
        toks, t_prefill, t_gen = generate(
            model, params, prompts, args.gen, args.prompt_len + args.gen,
            eos_id=args.eos, device=dev)
    n_pref = args.batch * args.prompt_len
    n_gen = args.batch * args.gen
    print(f"[serve] {label}: batch={args.batch} on {where}")
    print(f"  prefill {n_pref} tok in {t_prefill:.3f}s "
          f"({_rate(n_pref, t_prefill):.1f} tok/s)")
    print(f"  decode  {n_gen} tok in {t_gen:.3f}s "
          f"({_rate(n_gen, t_gen):.1f} tok/s)")
    print(f"  sample out: {toks[0, :8].tolist()}")
    if report is not None:
        print(f"  health: healthy={report.healthy} "
              f"verify={report.verify or 'skipped'} "
              f"fallbacks={report.fallback_counts() or 'none'} "
              f"retries={report.retries} dense_steps={report.dense_steps} "
              f"deadline_hit={report.deadline_hit} "
              f"steps={report.steps}/{report.gen}")
    _telemetry_done()


if __name__ == "__main__":
    main()
