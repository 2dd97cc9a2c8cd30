"""Guarded serving: verify → demote → retry → degrade to dense; the port
of the reference's ``repro.runtime.guard``.

:func:`guarded_generate` wraps the serving loop's prefill + greedy decode
loop (:mod:`repro_torch.launch.serve`) with the robustness layer:

  1. **Verify before dispatch** — :meth:`CompressedStore.verify`'s checks
     (the port has no layer-stacked store, the reference's second
     source); roles that fail are demoted to dense weights
     (``CompressedModel.demoted``) and recorded as
     ``integrity_violation`` fallbacks.  One corrupt role costs its
     compression ratio, not the batch.
  2. **Kernel-failure guard** — :func:`repro_torch.exec.dispatch.kernel_guard`
     turns injected kernel faults (a
     :class:`~repro_torch.kernels.ops.KernelFault`) into per-role dense
     fallbacks, recorded as ``kernel_failure``.  Only a fault hook raises
     one, so the guard is installed only while a fault hook is: otherwise
     it could never fire, and its presence would keep the decode step off
     its CUDA graph.
  3. **Step guard** — every prefill/decode step runs under
     :class:`repro_torch.runtime.fault.StepGuard`: bounded retry on
     non-finite logits (:class:`NonFiniteError`) and injected kernel
     faults; persistent failure switches the request to the dense model
     for the REST of the generation (``nonfinite_logits`` /
     ``step_failure``).  Any other exception propagates: the reference
     retries every ``RuntimeError``, but on the card those include a
     kernel that fails to build and every CUDA launch error (sticky, so a
     retry is futile), and the plain matmul must never serve in a
     kernel's place.  For the same reason a compressed step whose logits
     stay non-finite is first run once more with every kernel replaced by
     its plain version over the same store (the witness, launching
     nothing): finite logits there put the fault in a kernel, and
     :class:`KernelNonFiniteError` is raised; non-finite ones put it in
     the data (a poisoned payload or activations), which the dense model
     serves around, as in the reference.
  4. **Deadline** — an optional per-request wall-clock budget checked each
     decode step; on expiry the tail is padded with ``pad_id`` and the
     report says so (``deadline_exceeded``).

On the card the decode steps replay CUDA graphs
(:class:`repro_torch.launch.compiled.CompiledStep`), as in the unguarded
loop: a healthy guarded run launches what an unguarded one does.  The
step writes its cache in place, where the reference jits the guarded step
without donation, so that its pre-step cache survives a retry.  Before
each step the guard therefore copies, on the device, what the step will
write (:func:`repro_torch.models.transformer.step_writes`: every K / V
leaf's slot at the step's position or ring slot, and the recurrent states
whole), and a failed step puts it back: the retry, and the dense model's
step on a dense switch (which takes the compressed graph's cache, one
copy into its own graph), restart from the cache as it was before the
step.  That matters beyond K / V at ``pos``, which a repeat rewrites
anyway: a recurrent state advanced by the failed step would advance
twice, and a ring's slot overwritten past its wrap still held a key in
the window.  The one host read a step takes the finite check of its
logits and, with ``eos_id``, whether every row is done once its token is
in.  The host takes it only after it has enqueued the next decode step on
this step's greedy token, so the card does not idle while the host reads
the check and launches the next graph.  A step that fails discards that
next step and puts back what it wrote too (a NaN it wrote at a masked
position would survive the attention's zero weight); a stop on EOS or the
deadline discards it as well.  A discarded step's kernel launches are
counted, as they ran.  The prefill runs eagerly (the reference jits it); a model
without one ingests the prompt token by token through the same guarded
step.

Everything observable lands in the :class:`HealthReport` returned
alongside the tokens; its :meth:`HealthReport.stable_dict` projection
(timings dropped) is deterministic for a fixed seed.  Dense fallbacks are
CORRECT, not merely safe: serving runs on the pruned parameter tree, so
the dense matmul computes what the compressed kernel encodes.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import time
from typing import Optional

import torch

from repro_torch.device import resolve, synchronize
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import step_writes
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import fault, integrity
from repro_torch.runtime.fault import NonFiniteError


class KernelNonFiniteError(RuntimeError):
    """A compressed step's logits stayed non-finite while the same step
    with every kernel replaced by its plain version over the same store
    gives finite ones: the fault lies in a kernel, so the dense model does
    not serve in its place.  Not retried."""


class _NoPrefill(Exception):
    """Internal: the model has no one-pass prefill (token-by-token ingest
    instead).  Deliberately NOT a RuntimeError — ``NotImplementedError``
    is one, and the StepGuard must not burn retries on a capability."""


@dataclasses.dataclass
class HealthReport:
    """Everything the guarded serving path observed for one request batch.

    ``fallbacks`` rows are ``{"role", "layer", "code", "detail"}`` with
    role ``"*"`` for whole-step events; ``verify`` maps each planned role
    to ``"ok"`` or the :class:`IntegrityError` reason.
    ``switched_to_dense_at`` is the decode position where the request
    degraded to the dense model (``-1`` = during prefill, ``None`` =
    never).  Under mixed traffic (:mod:`repro_torch.launch.mixer`) one report
    is produced PER REQUEST: ``request_id`` names it and ``eos_hit``
    records an EOS-terminated generation (``steps`` < ``gen`` with no
    deadline).  ``trace_id`` links the report to its spans in the active
    :class:`repro_torch.obs.trace.Tracer` (None when tracing was off — the id
    is deterministic, derived from the request id or a tracer counter).
    Timings are wall-clock seconds; everything else is deterministic for
    a fixed seed — :meth:`stable_dict` drops the timings so two runs can
    be diffed exactly, and :meth:`timings_dict` is the complementary
    projection (``stable_dict() | timings_dict() == to_dict()``)."""

    verify: dict = dataclasses.field(default_factory=dict)
    fallbacks: list = dataclasses.field(default_factory=list)
    retries: int = 0
    dense_steps: int = 0
    switched_to_dense_at: Optional[int] = None
    deadline_hit: bool = False
    eos_hit: bool = False
    steps: int = 0
    gen: int = 0
    request_id: Optional[str] = None
    trace_id: Optional[str] = None
    t_prefill_s: float = 0.0
    t_decode_s: float = 0.0
    t_total_s: float = 0.0

    def record_fallback(self, role: str, code: str, detail: str = "",
                        layer: Optional[int] = None) -> None:
        self.fallbacks.append({"role": role, "layer": layer,
                               "code": code, "detail": detail})

    def fallback_counts(self) -> dict[str, int]:
        """Occurrences by reason code (same shape as
        :meth:`ExecPlan.fallback_counts`)."""
        out: dict[str, int] = {}
        for fb in self.fallbacks:
            out[fb["code"]] = out.get(fb["code"], 0) + 1
        return out

    def fallback_reasons(self) -> list:
        """The fallbacks as plan-plane :class:`FallbackReason` values."""
        from repro_torch.exec.plans import FallbackReason
        return [FallbackReason(fb["code"], fb["detail"])
                for fb in self.fallbacks]

    @property
    def healthy(self) -> bool:
        """No fallbacks, no retries, nothing non-ok in verify."""
        return (not self.fallbacks and not self.retries
                and not self.deadline_hit
                and all(v == "ok" for v in self.verify.values()))

    @property
    def latency_per_token_s(self) -> float:
        return self.t_decode_s / self.steps if self.steps else 0.0

    # -- JSON ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    _TIMING_KEYS = ("t_prefill_s", "t_decode_s", "t_total_s")

    def stable_dict(self) -> dict:
        """The deterministic projection: everything except wall-clock."""
        out = self.to_dict()
        for k in self._TIMING_KEYS:
            del out[k]
        return out

    def timings_dict(self) -> dict:
        """The wall-clock half :meth:`stable_dict` drops, structured:
        ``stable_dict() | timings_dict()`` reconstructs :meth:`to_dict`
        exactly."""
        return {k: getattr(self, k) for k in self._TIMING_KEYS}

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "HealthReport":
        return HealthReport(**d)

    @staticmethod
    def from_json(s: str) -> "HealthReport":
        return HealthReport.from_dict(json.loads(s))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _failure_code(error_repr: str) -> str:
    return "nonfinite_logits" if "NonFiniteError" in error_repr \
        else "step_failure"


def guarded_generate(model, params, prompts, gen: int,
                     max_len: Optional[int] = None, *,
                     dense_model=None, verify: bool = True,
                     deadline_s: Optional[float] = None,
                     max_retries: int = 1, pad_id: int = -1,
                     eos_id: Optional[int] = None, mesh=None,
                     device="cuda") -> tuple[torch.Tensor, HealthReport]:
    """Greedy batched generation with the full robustness layer, on
    ``device``.

    ``model`` is a :class:`CompressedModel` (the usual case) or a dense
    ``Model``; ``dense_model`` is the degradation target (defaults to the
    compressed model's own inner dense model — correct because serving
    runs on the pruned tree).  ``prompts`` are equal-length.  Returns
    ``(tokens (B, gen) int32, HealthReport)``; positions not produced
    before ``deadline_s`` hold ``pad_id``.  With ``eos_id``, a row's
    tokens after its EOS hold ``pad_id`` and decode stops early once EVERY
    row has emitted EOS (``report.eos_hit``) instead of burning the
    remaining steps.

    A ``mesh`` of more than one device serves data-parallel, as
    :func:`repro_torch.launch.serve.generate` does (a
    :class:`~repro_torch.launch.data_parallel.Replicated` ``model`` serves
    its replicas as they are): every replica's store is verified and a
    role that fails on any replica is demoted on all of them; a step whose
    logits are non-finite on any replica is retried, and switched to the
    dense model, as a whole; the deadline and the report are global.  A
    mesh whose ``model`` axis is larger than 1 serves each replica as a
    tensor-parallel group (:mod:`repro_torch.launch.tensor_parallel`; a
    MoE model's experts split over the shards, each expert entry on the
    shard that holds the expert): the store it was split from and every
    shard's store are verified, a role that fails on any of them is
    demoted on every shard of every replica, a step non-finite on any
    shard is retried whole (what it wrote into every shard's cache, each
    ring's slot too, put back first), and ``dense_model`` degrades to the
    dense model split as the groups are.  A ``model`` axis serves the
    uniform attention stacks (dense, MoE, vlm; a ``window`` too) and
    gemma3; recurrentgemma, mamba2, whisper and any optflag raise
    ``NotImplementedError`` before anything is verified or served; a mesh
    of one device serves as ``None`` does."""
    from repro_torch.exec.dispatch import CompressedModel
    from repro_torch.launch import data_parallel as dp

    t_start = time.perf_counter()
    dev = resolve(device)
    cm = model
    split_from = []     # the store this call split over shards, if any
    if mesh is not None and mesh.size > 1:
        cm = dp.serving_replicas(model, params, mesh, dev,
                                 "guarded_generate")
        if cm is not model and isinstance(model, CompressedModel) and \
                isinstance(cm.models[0], dp.TensorParallel):
            # a shard's checksums are taken from its cut of this store:
            # they cannot see a corruption the store held before the cut
            split_from = [model.store]
    if isinstance(cm, dp.Replicated):
        params, dev = cm.params, cm.devices[0]
        if dense_model is not None and \
                not isinstance(dense_model, dp.Replicated):
            dense_model = dp.with_model(cm, dense_model)
    prompts = torch.as_tensor(prompts, device=dev).long()
    tid = obs_trace.trace_id()
    report = HealthReport(gen=gen, trace_id=tid)
    if max_len is None:
        max_len = prompts.shape[1] + gen

    compressed = dp.compressed(cm)
    if compressed and dense_model is None:
        dense_model = dp.each(cm, lambda m: m.model)
    with obs_trace.span("guarded_request", trace_id=tid,
                        batch=int(prompts.shape[0]), gen=gen,
                        compressed=compressed):
        if compressed and verify:
            stores = split_from + dp.stores(cm)
            with obs_trace.span("verify", trace_id=tid), \
                    concurrent.futures.ThreadPoolExecutor(len(stores)) as pool:
                # the stores side by side (sha256 releases the GIL)
                results = list(pool.map(integrity.role_errors, stores))
            # a role's first failure on any store, in replica (and shard)
            # order
            errors = {}
            for per_replica in results:
                for role, err in per_replica:
                    report.verify.setdefault(role, "ok")
                    if err is not None and role not in errors:
                        report.verify[role], errors[role] = err.reason, err
            for role in sorted(errors):
                err = errors[role]
                report.record_fallback(role, "integrity_violation",
                                       detail=err.reason, layer=err.layer)
                obs_trace.event("demote", trace_id=tid, role=role,
                                code="integrity_violation",
                                reason=err.reason)
            if errors:
                cm = dp.each(cm, lambda m: m.demoted(errors))
        toks = _drive(cm, dense_model, params, prompts, gen, max_len,
                      report, deadline_s, max_retries, pad_id, t_start,
                      compressed, eos_id)
    report.t_total_s = time.perf_counter() - t_start
    reg = obs_metrics.current_metrics()
    if reg is not None:
        obs_metrics.ingest_health(reg, report)
    return toks, report


def _drive(cm, dense, params, prompts: torch.Tensor, gen: int, max_len: int,
           report: HealthReport, deadline_s: Optional[float],
           max_retries: int, pad_id: int, t_start: float,
           compressed: bool, eos_id: Optional[int] = None) -> torch.Tensor:
    from repro_torch.exec import dispatch
    from repro_torch.launch import compiled
    from repro_torch.launch import data_parallel as dp

    b, plen = prompts.shape
    dev = prompts.device
    tid = report.trace_id
    demoted_roles: set[str] = set()

    def sink(role: str, exc: Exception) -> None:
        # the port's guard hears every failing call; one fallback row per
        # role is the useful signal.  The detail names the hook's error,
        # which the KernelFault chains, as the reference's sink sees it.
        if role not in demoted_roles:
            demoted_roles.add(role)
            report.record_fallback(role, "kernel_failure",
                                   detail=repr(exc.__cause__ or exc))
            obs_trace.event("demote", trace_id=tid, role=role,
                            code="kernel_failure")

    step_c = dp.step_of(cm, compiled.CompiledStep)
    step_d = None
    if dense is not None and dense is not cm:
        step_d = dp.step_of(dense, compiled.CompiledStep)
    guard = fault.StepGuard(max_retries=max_retries, on_restore=lambda: None)
    dense_guard = fault.StepGuard(max_retries=max_retries,
                                  on_restore=lambda: None)
    use_dense = False
    end = plen + gen                  # the decode loop's last step is end - 1
    pos_t = torch.empty((), dtype=torch.long, device=dev)
    # each step's checks reach the host through (pinned) memory of its own,
    # so the host can wait for them after enqueuing the next step: finite
    # logits, and (with eos_id) every row done once this step's token is in
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    flags = torch.zeros((2, 2), dtype=torch.bool,
                        pin_memory=dev.type == "cuda")
    ahead = None                      # (pos, fn, launched) enqueued early
    all_done = False                  # the last checked step's EOS flag

    def launch(fn, cache, tok, pos: int):
        """Enqueue one step: (logits, cache, event after its checks,
        undo).  ``undo()`` puts back what the step wrote: it writes its
        cache in place, and neither a recurrent state's advance nor a
        ring's overwrite of a key still in the window repeats cleanly."""
        saved = [t.clone() for t in step_writes(cache, pos)]

        def undo(nc=None):
            for tree in (cache,) if nc is None or nc is cache \
                    else (nc, cache):
                for dst, src in zip(step_writes(tree, pos), saved):
                    dst.copy_(src)

        pos_t.fill_(pos)
        try:
            lg, nc = fn(params, cache, tok, pos_t)
        except BaseException:
            undo()
            raise
        flags[pos % 2, 0].copy_(torch.isfinite(lg).all(), non_blocking=True)
        if eos_id is not None:
            # ``done`` holds at least the EOS of every token before ``tok``
            # when this is enqueued (the loop marks a token before it steps
            # on it, and a step ahead is enqueued after its predecessor's
            # mark), so this is the loop's state after the step's token
            flags[pos % 2, 1].copy_(
                (done | (tok == eos_id)
                 | (lg.argmax(dim=-1) == eos_id)).all(), non_blocking=True)
        ev = None
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        return lg, nc, ev, lambda: undo(nc)

    def attempt(fn, cache, tok, pos: int, speculate: bool):
        nonlocal ahead, all_done
        if ahead is not None and ahead[0] == pos and ahead[1] is fn:
            lg, nc, ev, undo = ahead[2]
        else:
            lg, nc, ev, undo = launch(fn, cache, tok, pos)
        ahead = None
        if speculate and pos + 1 < end:
            # the next decode step, enqueued on this one's greedy token
            # before the host waits for this one's checks: the card does
            # not idle while the host reads them and launches the next graph
            try:
                ahead = (pos + 1, fn,
                         launch(fn, nc, lg.argmax(dim=-1), pos + 1))
            except BaseException:
                undo()
                raise
        if ev is not None:
            ev.synchronize()
        if not bool(flags[pos % 2, 0]):
            # back to the cache as it was before this step: first the step
            # ahead (it read this step's writes and token), then this one,
            # so that the retry or the dense model restarts from it
            if ahead is not None:
                ahead[2][3]()
            ahead = None
            undo()
            raise NonFiniteError(f"non-finite logits at position {pos}")
        all_done = bool(flags[pos % 2, 1])
        return lg, nc

    def witness(where: str, run, last: str) -> None:
        """After a compressed step kept giving non-finite logits: the same
        step with every kernel replaced by its plain version over the same
        store (eager, no launch), ``run`` of that model.  Finite logits
        there put the fault in a kernel, which the dense model must not
        hide."""
        lg = run(dp.each(cm, lambda m: dataclasses.replace(m, plain=True)))
        if _finite(lg):
            raise KernelNonFiniteError(
                f"non-finite logits at {where} from the compressed kernels, "
                f"finite from their plain versions over the same store: "
                f"{last}")

    def _note_retries(g, n0: int, pos: int) -> None:
        for ev in g.events[n0:]:
            if ev.action == "retry":
                obs_trace.event("retry", trace_id=tid, pos=pos,
                                code=_failure_code(ev.error))

    def guarded_step(pos: int, cache, tok, speculate: bool = False):
        nonlocal use_dense
        if not use_dense:
            n0 = len(guard.events)
            res = guard.run(pos, lambda: attempt(step_c, cache, tok, pos,
                                                 speculate))
            _note_retries(guard, n0, pos)
            if res is not None:
                return res
            last = guard.events[-1].error
            if compressed and _failure_code(last) == "nonfinite_logits":
                witness(f"position {pos}", lambda m: m.decode_step(
                    params, cache, tok, pos_t.fill_(pos))[0], last)
            if step_d is None:
                raise RuntimeError(
                    f"guarded decode failed at position {pos} with no "
                    f"dense fallback available: {last}")
            use_dense = True
            report.switched_to_dense_at = pos
            report.record_fallback("*", _failure_code(last), detail=last)
            obs_trace.event("dense_switch", trace_id=tid, pos=pos,
                            code=_failure_code(last))
        n1 = len(dense_guard.events)
        res = dense_guard.run(pos, lambda: attempt(step_d, cache, tok, pos,
                                                   speculate))
        _note_retries(dense_guard, n1, pos)
        if res is None:
            raise RuntimeError(
                f"dense fallback failed at position {pos}: "
                f"{dense_guard.events[-1].error}")
        report.dense_steps += 1
        return res

    guard_ctx = dispatch.kernel_guard(sink) if compressed \
        and kops.fault_hook_installed() else contextlib.nullcontext()
    with guard_ctx:
        # ---- prefill (guarded; falls back to guarded token ingest) --------
        with obs_trace.span("prefill", trace_id=tid, batch=b, plen=plen):
            t0 = time.perf_counter()

            def attempt_prefill():
                try:
                    all_lg, c = cm.prefill(params, prompts, max_len)
                except NotImplementedError as e:
                    raise _NoPrefill() from e
                lg = all_lg[:, -1]
                if not _finite(lg):
                    raise NonFiniteError("non-finite prefill logits")
                return lg, c

            try:
                n0 = len(guard.events)
                res = guard.run(-1, attempt_prefill)
                _note_retries(guard, n0, -1)
                if res is None:
                    last = guard.events[-1].error
                    if compressed and \
                            _failure_code(last) == "nonfinite_logits":
                        witness("the prefill", lambda m: m.prefill(
                            params, prompts, max_len)[0][:, -1], last)
                    if step_d is None:
                        raise RuntimeError(
                            f"guarded prefill failed with no dense fallback "
                            f"available: {last}")
                    use_dense = True
                    report.switched_to_dense_at = -1
                    report.record_fallback("*", _failure_code(last),
                                           detail=last)
                    obs_trace.event("dense_switch", trace_id=tid, pos=-1,
                                    code=_failure_code(last))
                    all_lg, cache = dense.prefill(params, prompts, max_len)
                    logits = all_lg[:, -1]
                    if not _finite(logits):
                        raise NonFiniteError(
                            "dense prefill logits non-finite")
                else:
                    logits, cache = res
            except _NoPrefill:
                # a family without a one-pass prefill: exact decode-path
                # ingest, every step under the same guard
                cache = cm.init_cache(b, max_len, device=dev)
                logits = None
                for t in range(plen):
                    logits, cache = guarded_step(t, cache, prompts[:, t])
            synchronize(dev)
            report.t_prefill_s = time.perf_counter() - t0

        # ---- greedy decode ------------------------------------------------
        with obs_trace.span("decode", trace_id=tid, batch=b, gen=gen):
            out = []
            tok = logits.argmax(dim=-1)   # int64: the next step's embedding
            t1 = time.perf_counter()
            for t in range(plen, end):
                if deadline_s is not None and \
                        time.perf_counter() - t_start > deadline_s:
                    report.deadline_hit = True
                    report.record_fallback(
                        "*", "deadline_exceeded",
                        detail=f"{len(out)}/{gen} tokens within "
                               f"{deadline_s}s")
                    obs_trace.event("deadline", trace_id=tid, pos=t)
                    break
                if eos_id is None:
                    out.append(tok.int())
                else:
                    # the EOS token itself is emitted; everything AFTER a
                    # row's EOS holds pad_id (the deadline tail's
                    # semantics), and once every row is done the remaining
                    # steps are skipped
                    out.append(torch.where(done, pad_id, tok).int())
                    done |= tok == eos_id
                    # the previous step's flag, read with its finite check
                    # (after the prefill's host read nothing is in flight)
                    if bool(done.all()) if t == plen else all_done:
                        report.eos_hit = True
                        break
                logits, cache = guarded_step(t, cache, tok, speculate=True)
                tok = logits.argmax(dim=-1)
            synchronize(dev)
            report.t_decode_s = time.perf_counter() - t1

    report.steps = len(out)
    report.retries = sum(1 for e in guard.events if e.action == "retry") + \
        sum(1 for e in dense_guard.events if e.action == "retry")
    if len(out) < gen:
        out.extend([torch.full((b,), pad_id, dtype=torch.int32,
                               device=dev)] * (gen - len(out)))
    return torch.stack(out, dim=1)
