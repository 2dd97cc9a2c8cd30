"""Plan-driven matmul dispatch: compressed kernels inside the real model.

Every FFN/attention projection of :mod:`repro_torch.models` routes through
:func:`repro_torch.models.layers.proj`.  :class:`CompressedModel` installs
a :class:`_Dispatcher` there and drives the dense model's own layer loops;
the loops publish the running layer's index
(:func:`repro_torch.models.layers.layer_ctx`) and the dispatcher looks up
that layer's entry in the :class:`~repro_torch.exec.compress.CompressedStore`
and calls the matching kernel (``bitmap_spmm`` / ``nm_spmm``: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors; the pipelined
or naive variant as :func:`repro_torch.kernels.ops.resolve_pipeline`
says).  Dense-kind and unplanned roles fall through to the dense matmul.

:func:`instrument` collects per-role :class:`OpCounters`; eager PyTorch
records once per (layer, role) call, like the reference's unrolled
per-layer forward.  :func:`kernel_guard` turns injected kernel faults into
per-role dense fallbacks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch.exec.compress import CompressedStore
from repro_torch.kernels import bitmap_spmm as bm_cuda
from repro_torch.kernels import nm_spmm as nm_cuda
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# ---------------------------------------------------------------------------
# Measured traffic counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpCounters:
    """Accumulated measured traffic of one dispatch role."""

    calls: int = 0
    w_fetch_bits: float = 0.0     # payload + metadata, realized encoding
    x_bits: float = 0.0
    y_bits: float = 0.0
    macs: float = 0.0             # useful MACs (compressed operand elems × M)
    decode_ops: float = 0.0       # metadata units decoded (blocks / indices)
    # distinct bits cross HBM once per call; stream bits count every pass
    # the chosen CUDA kernels make over the payload (one per row of tiles
    # of their grid), so stream / distinct is the realized refetch factor
    w_distinct_bits: float = 0.0
    w_stream_bits: float = 0.0

    @property
    def w_fetch_bits_per_call(self) -> float:
        return self.w_fetch_bits / self.calls if self.calls else 0.0

    @property
    def w_stream_bits_per_call(self) -> float:
        return self.w_stream_bits / self.calls if self.calls else 0.0

    @property
    def refetch_factor(self) -> float:
        """Measured stream / distinct ratio (≥ 1)."""
        if not self.w_distinct_bits:
            return 1.0
        return self.w_stream_bits / self.w_distinct_bits


_ACTIVE_COUNTERS: Optional[dict[str, OpCounters]] = None


@contextlib.contextmanager
def instrument() -> Iterator[dict[str, OpCounters]]:
    """Collect per-role :class:`OpCounters` for every dispatched
    projection inside the context."""
    global _ACTIVE_COUNTERS
    prev = _ACTIVE_COUNTERS
    counters: dict[str, OpCounters] = {}
    _ACTIVE_COUNTERS = counters
    try:
        yield counters
    finally:
        _ACTIVE_COUNTERS = prev


def _record(role: str, x2: torch.Tensor, y_k: int, w_bits: float,
            macs: float, decode_ops: float, stream_passes: int = 1) -> None:
    """Record one dispatch; ``stream_passes`` is how many times its
    kernels stream the whole payload (``stream_passes`` of
    :mod:`repro_torch.kernels.bitmap_spmm` / :mod:`~.nm_spmm`: the CUDA
    grid's rows of tiles, on either device; the reference counts its TPU
    grid's, M / tile_M)."""
    if _ACTIVE_COUNTERS is None:
        return
    c = _ACTIVE_COUNTERS.setdefault(role, OpCounters())
    c.calls += 1
    c.w_fetch_bits += w_bits
    c.x_bits += float(x2.numel() * x2.element_size() * 8)
    c.y_bits += float(x2.shape[0] * y_k * 32)        # kernels emit f32
    c.macs += macs
    c.decode_ops += decode_ops
    c.w_distinct_bits += w_bits
    c.w_stream_bits += w_bits * stream_passes


# ---------------------------------------------------------------------------
# Kernel-failure guard
# ---------------------------------------------------------------------------

_KERNEL_GUARD = None


@contextlib.contextmanager
def kernel_guard(sink) -> Iterator[None]:
    """Per-role dense fallback for injected kernel faults.

    While active, a :class:`~repro_torch.kernels.ops.KernelFault` (a
    failure injected through
    :func:`repro_torch.kernels.ops.kernel_fault_hook`) raised by a
    compressed kernel call inside the dispatcher is reported to
    ``sink(role, exc)`` and that projection falls through to the dense
    matmul over the (pruned) weight, instead of failing the forward.  The
    port dispatches eagerly while the guard is active (a compiled decode
    step too: :func:`serves_eagerly`), so the sink hears of every failing
    call (per layer and step; the reference's hears once per trace).  Any other
    exception, a kernel that fails to build or launch among them, always
    propagates: the card never serves a projection through the plain
    matmul in its kernel's place."""
    global _KERNEL_GUARD
    prev = _KERNEL_GUARD
    _KERNEL_GUARD = sink
    try:
        yield
    finally:
        _KERNEL_GUARD = prev


def _guarded_kernel(role: str, fn) -> Optional[torch.Tensor]:
    """Run one kernel dispatch under the active guard (if any)."""
    if _KERNEL_GUARD is None:
        return fn()
    try:
        return fn()
    except kops.KernelFault as e:
        _KERNEL_GUARD(role, e)
        return None


def serves_eagerly() -> bool:
    """Whether a compiled decode step must run eagerly: ``instrument()``,
    :func:`kernel_guard`, a kernel fault / dispatch hook or a rebound
    ``layers.proj`` (activation poisoning) is active.  Each acts in Python
    at every dispatch, which a CUDA graph's replay does not run
    (:mod:`repro_torch.launch.compiled`)."""
    return _ACTIVE_COUNTERS is not None or _KERNEL_GUARD is not None \
        or kops.hooks_installed() or L.proj_rebound()


# ---------------------------------------------------------------------------
# The dispatcher (a repro_torch.models.layers.proj hook)
# ---------------------------------------------------------------------------

class _Dispatcher:
    """Per-(layer, role) hook: the layer comes from the layer loop's
    published index.

    Bitmap roles run with one static bound per role, the max over layers
    of the blocks in any block-column (the reference's unrolled
    dispatcher's ``t_max``): the naive kernel's loop bound.  MoE expert
    entries never reach a kernel (the MoE block multiplies the experts
    densely, as in the reference) and take no part in it."""

    def __init__(self, store: CompressedStore, plain: bool = False):
        self.store = store
        self.plain = plain
        self._t_max: dict[str, int] = {}
        for e in store:
            if e.kind == "bitmap" and e.expert < 0:   # experts run dense
                self._t_max[e.role] = max(self._t_max.get(e.role, 1),
                                          e.data.max_per_col)

    def __call__(self, x: torch.Tensor, w: torch.Tensor, role: str
                 ) -> Optional[torch.Tensor]:
        entry = self.store.get(L.current_layer_ctx(), role)
        if entry is None:
            return None                       # unplanned role: dense matmul
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        m = x2.shape[0]
        d = entry.data
        if self.plain and entry.kind == "bitmap":   # the witness: no launch
            y = ref.bitmap_spmm_ref(x2, d.blocks, d.counts, d.row_ids, d.n,
                                    d.k)
        elif self.plain and entry.kind == "nm":
            y = ref.nm_spmm_ref(x2, d.values, d.indices, d.n_sel, d.m_group)
        elif entry.kind == "bitmap":
            y = _guarded_kernel(role, lambda: kops.bitmap_spmm(
                x2, d, t_max=self._t_max[role]))
            if y is None:                     # guarded kernel failure: dense
                return None
            if _ACTIVE_COUNTERS is not None:
                _record(role, x2, d.k, w_bits=entry.stored_bits,
                        macs=float(m) * d.nnzb * d.bn * d.bk,
                        decode_ops=float(d.nnzb),
                        stream_passes=bm_cuda.stream_passes(
                            m, d.bk, d.k, d.blocks.data_ptr() % 16 == 0))
        elif entry.kind == "nm":
            y = _guarded_kernel(role, lambda: kops.nm_spmm(x2, d))
            if y is None:                     # guarded kernel failure: dense
                return None
            if _ACTIVE_COUNTERS is not None:
                _record(role, x2, d.k, w_bits=entry.stored_bits,
                        macs=float(m) * d.values.numel(),
                        decode_ops=float(d.indices.numel()),
                        stream_passes=nm_cuda.stream_passes(
                            m, d.k, kops.resolve_pipeline(None)))
        else:
            _record(role, x2, w.shape[-1], w_bits=entry.stored_bits,
                    macs=float(m) * w.numel(), decode_ops=0.0)
            return None                       # dense-kind: the dense matmul
        return y.to(x.dtype).reshape(*lead, y.shape[-1])


@contextlib.contextmanager
def installed(disp: Optional[_Dispatcher]) -> Iterator[Optional[_Dispatcher]]:
    """``disp`` made the projection hook for the scope (none, for
    ``None``), the previous hook put back after."""
    prev = L._PROJ_HOOK
    L.set_proj_hook(disp)
    try:
        yield disp
    finally:
        L.set_proj_hook(prev)


@contextlib.contextmanager
def active(store: CompressedStore, plain: bool = False
           ) -> Iterator[_Dispatcher]:
    """Install the dispatch hook for ``store``.  With ``plain``, each
    compressed projection is computed by its kernel's plain version
    (:mod:`repro_torch.kernels.ref`) over the same entry, on any device
    and with no launch: the guarded serving path's witness for a kernel's
    non-finite output (:mod:`repro_torch.runtime.guard`), never a serving
    path."""
    with installed(_Dispatcher(store, plain)) as disp:
        yield disp


# ---------------------------------------------------------------------------
# Compressed forward / serving surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressedModel:
    """A served model: the dense :class:`~repro_torch.models.transformer.Model`
    with every planned projection taken from a :class:`CompressedStore`.
    Mirrors the dense model's serving surface, for every family the model
    serves (``dense``, ``moe``, ``vlm``); MoE expert matmuls run dense
    over the pruned weights (their entries are accounting only), as in
    the reference.  With ``plain`` every compressed projection runs its
    kernel's plain version over the same entry (:func:`active`): the
    guarded serving path's witness, never a serving path."""

    model: T.Model
    store: CompressedStore
    plain: bool = False

    @property
    def cfg(self):
        return self.model.cfg

    def verify(self) -> dict[str, str]:
        """Verify the store this model serves from (checksums +
        structure).  Raises the first
        :class:`repro_torch.runtime.integrity.IntegrityError`; returns
        ``{role: "ok"}`` otherwise.  The reference verifies its
        layer-stacked store too; the port has none."""
        return self.store.verify()

    def demoted(self, roles) -> "CompressedModel":
        """A new model with the given roles served DENSE (entries dropped
        from the store).  The guarded serving path calls this after an
        integrity violation so one corrupt role costs its compression
        ratio, not the whole batch.  A new store is a new graph key
        (:func:`repro_torch.launch.compiled.key`): the demoted model
        captures graphs of its own."""
        return CompressedModel(self.model, self.store.without_roles(roles))

    def hidden_states(self, params, tokens: torch.Tensor) -> torch.Tensor:
        with active(self.store, self.plain):
            return self.model.hidden_states(params, tokens)

    def logits(self, params, tokens: torch.Tensor) -> torch.Tensor:
        with active(self.store, self.plain):
            return self.model.logits(params, tokens)

    def prefill(self, params, tokens: torch.Tensor, max_len: int):
        with active(self.store, self.plain):
            return self.model.prefill(params, tokens, max_len)

    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.model.init_cache(batch, max_len, device=device)

    def decode_step(self, params, cache, tokens: torch.Tensor, pos):
        with active(self.store, self.plain):
            return self.model.decode_step(params, cache, tokens, pos)

    def generate(self, params, prompts: torch.Tensor, gen: int,
                 max_len: Optional[int] = None, **kwargs):
        """Greedy batched generation through
        :func:`repro_torch.launch.serve.generate`.  Returns
        (tokens (B, gen), t_prefill_s, t_gen_s)."""
        from repro_torch.launch import serve
        if max_len is None:
            max_len = prompts.shape[1] + gen
        return serve.generate(self, params, prompts, gen, max_len, **kwargs)

    def serve_mixed(self, params, requests, *, slots: int,
                    max_len: int, **kwargs):
        """Continuous-batching serve of a request STREAM over the
        compressed plane (delegates to
        :class:`repro_torch.launch.mixer.Mixer`, as :meth:`generate`
        delegates to the static serving loop).  Returns ``(results,
        mixer)`` — per-request :class:`RequestResult`\\ s in request
        order plus the drained mixer (events / stats)."""
        from repro_torch.launch.mixer import Mixer
        mx = Mixer(self, params, slots=slots, max_len=max_len, **kwargs)
        return mx.run(requests), mx
