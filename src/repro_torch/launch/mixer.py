"""Continuous-batching request mixer over the (compressed) serving plane.

The port of the reference's ``repro.launch.mixer``.  The static serving loop
(:mod:`repro_torch.launch.serve`) serves one lockstep batch: every request
enters together, decodes in step, and leaves together.  The mixer serves a
STREAM: variable-length prompts are admitted into free *slots* of one
running decode batch, decode advances all occupied slots in a single
compiled :meth:`decode_step` call per token, and slots are evicted (EOS /
token budget / deadline) and immediately refilled from the queue.

Slot model — no new cache layout, the batch axis IS the slot axis:

  * ``model.init_cache(slots, max_len, device=...)`` allocates one cache
    region per slot on the params' device (KV, rings, recurrent states:
    every leaf of two or more dimensions carries the slot on axis 1);
    per-slot position counters live host-side.
  * **Admission** prefill runs at batch 1 (one-pass ``model.prefill``;
    exact token-by-token decode ingest, through a batch-1 compiled step,
    for a model without one: ring windows, the recurrent families) and
    the resulting single-row cache is written into the slot, in place, with
    :func:`write_slot` — the same primitive ``launch.serve.generate`` uses
    for ragged left-padded prompts.
  * **Decode** calls the compiled step
    (:class:`~repro_torch.launch.compiled.CompiledStep`: a CUDA graph on
    the card) with a ``(slots,)`` position VECTOR: RoPE, cache writes and
    the length mask follow each row's own position, so the step stays ONE
    graph for every slot occupancy.  Free slots ride along at position 0
    with token 0; per-slot length masking keeps their writes (and any
    stale KV an evicted request left behind) out of every softmax.  The
    graph returns a cache over its own static K / V; a slot write between
    two replays lands in it in place, so the handle stays valid and no
    admission copies the cache.
  * **Eviction** frees the slot without clearing it — isolation comes
    from the mask.

Works for the dense :class:`~repro_torch.models.transformer.Model` and the
execution plane's :class:`~repro_torch.exec.dispatch.CompressedModel`
alike.  Greedy decode of a request through the mixer is token-identical to
the request served alone through the static serving loop at fp32 on the CPU;
on the card the kernels' summation order depends on the batch (M = slots
at decode), so there the two agree to a logit tolerance.  Sampled decode
(temperature / top-k) is seeded per request and keyed by token index, so a
replayed stream reproduces exactly regardless of slot placement; its draws
are not the reference's (which keys a JAX PRNG).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import synchronize
from repro_torch.launch.compiled import CompiledStep, check_current, leaves
from repro_torch.obs import metrics as omet
from repro_torch.obs import trace as otr
from repro_torch.runtime.fault import StragglerMonitor
from repro_torch.runtime.guard import HealthReport


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request in the mixer's stream.

    ``temperature <= 0`` decodes greedy; otherwise tokens are sampled from
    ``softmax(logits / temperature)`` restricted to the ``top_k`` highest
    logits (0 = full vocabulary), seeded per request (``seed``) and keyed
    by token index — deterministic across runs and slot placements."""

    uid: str
    prompt: Sequence[int]
    max_new: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome: ``tokens`` is (max_new,) int32 with ``pad_id``
    after EOS / deadline expiry (the static serving loop's tail semantics);
    ``report`` is the per-request :class:`HealthReport` (request_id set,
    admission time in ``t_prefill_s``, decode residency in
    ``t_decode_s``)."""

    uid: str
    tokens: np.ndarray
    slot: int
    admit_step: int
    report: HealthReport

    @property
    def n_tokens(self) -> int:
        return int(self.report.steps)


# ---------------------------------------------------------------------------
# Admission primitives (shared with launch.serve's ragged-prompt path)
# ---------------------------------------------------------------------------

def prefill_request(model, params, prompt: torch.Tensor, max_len: int,
                    prefill_fn=None, step_fn=None):
    """Batch-1 prefill of one request: (last_logits (V,), single-row cache).

    Prefers the one-pass ``model.prefill``; a model without it (its
    ``prefill`` raises ``NotImplementedError``) falls back to the exact
    token-by-token decode ingest.  ``prefill_fn(params, prompt)`` /
    ``step_fn`` replace ``model.prefill`` at ``max_len`` /
    ``model.decode_step``."""
    if prompt.ndim != 2 or prompt.shape[0] != 1 or prompt.shape[1] < 1:
        raise ValueError(f"prefill_request wants a (1, plen>=1) prompt; "
                         f"got {tuple(prompt.shape)}")
    try:
        fn = prefill_fn or functools.partial(model.prefill, max_len=max_len)
        logits, cache = fn(params, prompt)
        return logits[0, -1], cache
    except NotImplementedError:
        lg, cache = ingest(model, params, prompt, max_len,
                           step_fn or model.decode_step)
        return lg[0], cache


def ingest(model, params, prompts: torch.Tensor, max_len: int, step):
    """Token-by-token ingest of ``prompts`` (B, plen) into a fresh cache
    through ``step`` (``model.decode_step`` or a compiled step), the
    position a device tensor: (the last step's logits (B, V), cache)."""
    b, plen = prompts.shape
    cache = model.init_cache(b, max_len, device=prompts.device)
    pos = torch.empty((), dtype=torch.long, device=prompts.device)
    for t in range(plen):
        logits, cache = step(params, cache, prompts[:, t], pos.fill_(t))
    return logits, cache


def write_slot(cache, row_cache, slot: int):
    """Write a batch-1 cache into batch row ``slot`` of a slotted cache,
    in place, cast to the cache's dtype, and return ``cache`` itself.

    Every cache tensor of two or more dimensions carries batch on axis 1
    (layer-stacked KV (L, B, S, nk, hd), recurrent states); the 0-d ones
    are shared and kept.
    Writing in place keeps a compiled step's cache handle valid: the row
    lands in the graph's own K / V (:mod:`repro_torch.launch.compiled`).
    A handle whose graph has since taken another cache raises instead:
    the write would land in that sequence's K / V."""
    check_current(cache)
    if isinstance(cache, dict):
        for name, c in cache.items():
            write_slot(c, row_cache[name], slot)
    elif cache.ndim >= 2:
        cache.narrow(1, slot, row_cache.shape[1]).copy_(row_cache)
    return cache


def sample_token(logits: torch.Tensor, req: Request, index: int) -> int:
    """Greedy or seeded temperature/top-k sampling of one token.

    Drawn on the host in fp32 from the row's CPU copy, by Gumbel-max with
    a generator seeded from ``SeedSequence([req.seed, index])``: a pure
    function of the logits, the request and its token index, so the draw
    does not depend on slot placement, batch composition or wall-clock.
    Greedy is the first maximum; top-k keeps every logit tied with the
    k-th."""
    lg = logits.detach().to("cpu", torch.float32)
    if req.temperature <= 0.0:
        return int(torch.argmax(lg))
    lg = lg / req.temperature
    if req.top_k:
        kth = torch.topk(lg, min(req.top_k, lg.shape[-1])).values[-1]
        lg = torch.where(lg >= kth, lg, float("-inf"))
    rng = np.random.default_rng(
        np.random.SeedSequence([req.seed % 2**64, index]))
    gumbel = rng.gumbel(size=lg.shape[-1]).astype(np.float32)
    return int(np.argmax(lg.numpy() + gumbel))


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

class Mixer:
    """Continuous-batching scheduler: ``slots`` concurrent requests over
    one slotted decode cache on the params' device.

    ``model`` is anything with the serving surface (``prefill`` /
    ``init_cache`` / ``decode_step``): the dense Model or a
    CompressedModel.  ``eos_id`` ends a request when sampled; ``pad_id``
    fills result tails; ``deadline_s`` (optional) evicts requests that
    exceed their wall-clock budget, tail padded.

    Telemetry (zero-cost when off): with an ambient tracer
    (:func:`repro_torch.obs.trace.tracing`) every request emits admit /
    prefill / slot-write spans, per-token events, and an evict event, all
    linked by the ``trace_id`` its :class:`HealthReport` carries; with an
    ambient registry (:func:`repro_torch.obs.metrics.collecting`) the
    stream's admission/eviction/token counters, per-step decode latency
    histogram and slot-occupancy gauge record live, and each finished
    request's report is folded in.  ``straggler`` (default: a fresh
    :class:`~repro_torch.runtime.fault.StragglerMonitor`) watches every
    decode step's wall time; spikes land in the metrics snapshot
    (``mixer_straggler_spikes_total``) and the trace (as unstable
    events, excluded from ``stable_trace``)."""

    def __init__(self, model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, pad_id: int = -1,
                 deadline_s: Optional[float] = None,
                 straggler: Optional[StragglerMonitor] = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if getattr(model.cfg, "family", None) == "encdec":
            raise NotImplementedError(
                "mixer: encoder-decoder families need per-request encoder "
                "frames; not supported yet")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.deadline_s = deadline_s
        self.straggler = straggler if straggler is not None \
            else StragglerMonitor()
        self.device = params["embed"].device

        self.cache = model.init_cache(slots, max_len, device=self.device)
        for leaf in leaves(self.cache):
            if leaf.ndim >= 2 and leaf.shape[1] != slots:
                raise NotImplementedError(
                    f"mixer: cache leaf {tuple(leaf.shape)} does not carry "
                    f"the slot axis at position 1; family unsupported")
        self._step_fn = CompiledStep(model)
        self._prefill_fn = functools.partial(model.prefill, max_len=max_len)
        # batch-1 token ingest for a model without a one-pass prefill
        # (ring windows, recurrent states): a compiled step of its own key,
        # the counterpart of the reference's jitted decode_step
        self._ingest_fn = CompiledStep(model)

        # host-side per-slot state
        self.pos = np.zeros(slots, np.int64)        # next decode position
        self.pending = np.zeros(slots, np.int64)    # next token to consume
        self.active = np.zeros(slots, bool)
        self._req: list[Optional[Request]] = [None] * slots
        self._emitted: list[list[int]] = [[] for _ in range(slots)]
        self._admit_step = np.zeros(slots, np.int64)
        self._t_admitted = np.zeros(slots, float)
        self._reports: list[Optional[HealthReport]] = [None] * slots

        # stream accounting
        self.step_count = 0
        self.tokens_out = 0
        self.t_admit = 0.0
        self.t_decode = 0.0
        self.events: list[dict] = []
        self.results: dict[str, RequestResult] = {}

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request) -> int:
        """Prefill ``req`` into the lowest free slot; returns the slot.
        Raises if no slot is free or the request cannot fit ``max_len``."""
        free = np.nonzero(~self.active)[0]
        if free.size == 0:
            raise RuntimeError("mixer: no free slot (use run() to queue)")
        slot = int(free[0])
        prompt = torch.as_tensor(req.prompt).to(self.device, torch.long) \
            .reshape(1, -1)
        plen = int(prompt.shape[1])
        if req.max_new < 1:
            raise ValueError(f"request {req.uid!r}: max_new must be >= 1")
        if plen + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.uid!r}: prompt ({plen}) + max_new "
                f"({req.max_new}) exceeds max_len ({self.max_len})")
        if req.uid in self.results or any(
                r is not None and r.uid == req.uid for r in self._req):
            raise ValueError(f"duplicate request uid {req.uid!r}")

        tid = otr.trace_id(req.uid)
        t0 = time.perf_counter()
        with otr.span("admit", trace_id=tid, request_id=req.uid, slot=slot,
                      prompt_len=plen, step=self.step_count):
            with otr.span("prefill", trace_id=tid, request_id=req.uid):
                last, rcache = prefill_request(
                    self.model, self.params, prompt, self.max_len,
                    prefill_fn=self._prefill_fn, step_fn=self._ingest_fn)
            with otr.span("slot_write", trace_id=tid, request_id=req.uid,
                          slot=slot):
                write_slot(self.cache, rcache, slot)
            synchronize(self.device)          # time the admission's work
        report = HealthReport(gen=req.max_new, request_id=str(req.uid),
                              trace_id=tid)
        report.t_prefill_s = time.perf_counter() - t0
        self.t_admit += report.t_prefill_s
        omet.counter_inc("mixer_admissions_total")
        omet.counter_inc("mixer_tokens_admitted_total", plen)

        self.active[slot] = True
        self._req[slot] = req
        self._emitted[slot] = []
        self.pos[slot] = plen
        self._admit_step[slot] = self.step_count
        self._t_admitted[slot] = time.perf_counter()
        self._reports[slot] = report
        self.events.append({"event": "admit", "uid": req.uid, "slot": slot,
                            "step": self.step_count, "prompt_len": plen})
        omet.gauge_set("mixer_slot_occupancy", int(self.active.sum()))
        # the first token comes straight from prefill logits
        self._emit(slot, sample_token(last, req, 0))
        return slot

    # -- decode --------------------------------------------------------------
    def _step(self) -> None:
        """One decode token for every occupied slot (free slots ride along
        at position 0 with token 0; their output is discarded)."""
        t0 = time.perf_counter()
        with otr.span("decode_step", step=self.step_count,
                      occupied=int(self.active.sum())):
            toks = torch.tensor(self.pending, device=self.device)
            pos = torch.tensor(self.pos, device=self.device)
            logits, self.cache = self._step_fn(self.params, self.cache,
                                               toks, pos)
            greedy = logits.argmax(dim=-1).cpu().numpy()  # one host sync
        self.step_count += 1
        dt = time.perf_counter() - t0
        omet.counter_inc("mixer_decode_steps_total")
        omet.observe("mixer_decode_step_seconds", dt)
        if self.straggler.observe(self.step_count, dt):
            # timing-derived, hence stable=False: two runs of the same
            # stream may legitimately spike at different steps
            otr.event("straggler_spike", stable=False,
                      step=self.step_count, dt_s=dt)
            omet.counter_inc("mixer_straggler_spikes_total")
        now = time.perf_counter()
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            req = self._req[slot]
            self.pos[slot] += 1
            if self.deadline_s is not None and \
                    now - self._t_admitted[slot] > self.deadline_s:
                rep = self._reports[slot]
                rep.deadline_hit = True
                rep.record_fallback(
                    "*", "deadline_exceeded",
                    detail=f"{len(self._emitted[slot])}/{req.max_new} "
                           f"tokens within {self.deadline_s}s")
                self._evict(slot, "deadline")
                continue
            if req.temperature > 0.0:
                tok = sample_token(logits[slot], req,
                                   len(self._emitted[slot]))
            else:
                tok = int(greedy[slot])
            self._emit(slot, tok)
        self.t_decode += time.perf_counter() - t0

    def _emit(self, slot: int, tok: int) -> None:
        req = self._req[slot]
        self._emitted[slot].append(tok)
        self.tokens_out += 1
        otr.event("token", trace_id=self._reports[slot].trace_id,
                  request_id=req.uid, index=len(self._emitted[slot]) - 1)
        if self.eos_id is not None and tok == self.eos_id:
            self._reports[slot].eos_hit = True
            self._evict(slot, "eos")
        elif len(self._emitted[slot]) >= req.max_new:
            self._evict(slot, "budget")
        else:
            self.pending[slot] = tok

    def _evict(self, slot: int, reason: str) -> None:
        """Free the slot (KV left in place; per-slot length masking keeps
        it out of every successor's softmax) and finalize the result."""
        req = self._req[slot]
        rep = self._reports[slot]
        emitted = self._emitted[slot]
        rep.steps = len(emitted)
        rep.t_decode_s = time.perf_counter() - self._t_admitted[slot]
        rep.t_total_s = rep.t_prefill_s + rep.t_decode_s
        tokens = np.full(req.max_new, self.pad_id, np.int32)
        tokens[: len(emitted)] = emitted
        self.results[req.uid] = RequestResult(
            uid=req.uid, tokens=tokens, slot=slot,
            admit_step=int(self._admit_step[slot]), report=rep)
        self.events.append({"event": "evict", "uid": req.uid, "slot": slot,
                            "step": self.step_count, "reason": reason,
                            "tokens": len(emitted)})
        otr.event("evict", trace_id=rep.trace_id, request_id=req.uid,
                  slot=slot, reason=reason, tokens=len(emitted))
        omet.counter_inc("mixer_evictions_total", reason=reason)
        reg = omet.current_metrics()
        if reg is not None:
            omet.ingest_health(reg, rep)
        self.active[slot] = False
        self._req[slot] = None
        self._reports[slot] = None
        self.pending[slot] = 0
        self.pos[slot] = 0
        omet.gauge_set("mixer_slot_occupancy", int(self.active.sum()))

    # -- scheduler loop ------------------------------------------------------
    def run(self, requests: Sequence[Request]) -> list[RequestResult]:
        """Serve the whole stream: admit into free slots (FIFO, lowest slot
        first), decode until queue and slots drain.  Results come back in
        request order."""
        queue = deque(requests)
        order = [r.uid for r in requests]
        if len(set(order)) != len(order):
            raise ValueError("request uids must be unique")
        while queue or self.active.any():
            while queue and not self.active.all():
                self.admit(queue.popleft())
            if self.active.any():
                self._step()
        return [self.results[uid] for uid in order]

    def stats(self) -> dict:
        """Stream-level accounting for benchmarks and the CLI."""
        admits = sum(1 for e in self.events if e["event"] == "admit")
        evicts = sum(1 for e in self.events if e["event"] == "evict")
        reused = sum(1 for e in self.events
                     if e["event"] == "admit" and e["step"] > 0)
        return {"steps": self.step_count, "tokens": self.tokens_out,
                "admits": admits, "evictions": evicts,
                "slot_reuse_admits": reused,
                "t_admit_s": self.t_admit, "t_decode_s": self.t_decode,
                "straggler_spikes": len(self.straggler.flagged),
                "step_ewma_s": self.straggler.ewma}
