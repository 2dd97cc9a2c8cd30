"""Public wrappers of the kernels, with the knobs and hooks around them.

``bitmap_spmm(x, w)`` / ``nm_spmm(x, w)`` / ``flash_attention(q, k, v)``
launch the hand-written CUDA kernel when their input lies on a CUDA device
— or raise, there is no fallback — and run the plain PyTorch version of
:mod:`repro_torch.kernels.ref` when it lies on the CPU.  Each wrapper adds
one to its kernel's launch count where it launches the kernel, and nowhere
else (:func:`launch_counts`), so a run can show that its main path went
through the kernels.  A CUDA graph's capture runs the wrappers without
launching: its counts are taken back out and added once per replay
(:func:`captured_launches`, :func:`add_launches`).

The knobs and hooks are those of ``repro.kernels.ops``:

* ``pipeline`` picks the sparse kernels' variant: the pipelined ports
  (default) or the naive ports (``pipeline=False``); ``pipeline=None``
  resolves through :func:`resolve_pipeline`, whose default
  :func:`pipeline_default` switches for whole serving paths.  Both
  variants compute the same function, so on the CPU both run the same
  plain version.
* :func:`kernel_fault_hook` is called as ``fn(kind)`` before every sparse
  dispatch on either device; what it raises surfaces as a
  :class:`KernelFault` (fault injection for the serving guard).
* :func:`kernel_dispatch_hook` is called as ``fn(kind, seconds)`` after
  every dispatch.

The kernels have no backward.  A wrapper given an input that requires
grad while grad is enabled raises ``NotImplementedError`` on either device,
as the reference's ``jax.grad`` through a ``pallas_call`` raises: its
output would carry no ``grad_fn``, and the weights below it would get no
gradient without a word.

The reference's TPU tile knobs (``bm``, ``bn``, ``bk`` of the sparse
wrappers) have no counterpart: the CUDA tiles are the kernels' own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.kernels import bitmap_spmm as _bitmap_cuda
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _flash_cuda
from repro_torch.kernels import nm_spmm as _nm_cuda
from repro_torch.kernels import ref

_LAUNCHES = {"bitmap_spmm": 0, "bitmap_spmm_naive": 0, "nm_spmm": 0,
             "nm_spmm_naive": 0, "flash_attention": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Take the launches counted inside the context back out of the
    counts and into the dict it yields (filled on exit).  A CUDA graph's
    capture runs the wrappers, which count, but launches nothing: each
    replay of the graph then adds the dict with :func:`add_launches`."""
    before = dict(_LAUNCHES)
    captured: dict[str, int] = {}
    try:
        yield captured
    finally:
        for name in _LAUNCHES:
            captured[name] = _LAUNCHES[name] - before[name]
            _LAUNCHES[name] = before[name]


def add_launches(counts: dict[str, int]) -> None:
    """Count ``counts`` launches per kernel: one replay of a graph whose
    capture :func:`captured_launches` recorded."""
    for name, n in counts.items():
        _LAUNCHES[name] += n


def kernel_cache_stats() -> dict[str, int]:
    """Hits and misses of the loaded-library cache
    (:func:`repro_torch.kernels.build.library`: one library per CUDA
    source, looked up at every launch), and its entries: the counterpart
    of the reference's jitted-wrapper cache counters."""
    return build.cache_stats()


def clear_kernel_cache() -> None:
    """Forget the loaded libraries and zero the counters; the next launch
    loads its library again (built files are kept)."""
    build.clear_cache()


# ---------------------------------------------------------------------------
# Kernel variant knob
# ---------------------------------------------------------------------------

_PIPELINE_DEFAULT = True


def resolve_pipeline(pipeline: bool | None) -> bool:
    """Resolve the dispatch-level ``pipeline`` knob (None → default)."""
    return _PIPELINE_DEFAULT if pipeline is None else bool(pipeline)


@contextlib.contextmanager
def pipeline_default(on: bool):
    """Temporarily change what ``pipeline=None`` resolves to, so whole
    serving paths, which never thread the knob, run the naive kernels."""
    global _PIPELINE_DEFAULT
    prev = _PIPELINE_DEFAULT
    _PIPELINE_DEFAULT = bool(on)
    try:
        yield
    finally:
        _PIPELINE_DEFAULT = prev


# ---------------------------------------------------------------------------
# Hooks
# ---------------------------------------------------------------------------

_FAULT_HOOK = None


class KernelFault(RuntimeError):
    """A kernel failure injected through :func:`kernel_fault_hook`."""


@contextlib.contextmanager
def kernel_fault_hook(fn):
    """Install a hook called as ``fn(kind)`` at every sparse-kernel dispatch
    (``kind`` ∈ {"bitmap", "nm"}), before the kernel or plain version runs;
    an exception from it is raised as a :class:`KernelFault` chained to it,
    where a real launch failure surfaces.
    :func:`repro_torch.exec.dispatch.kernel_guard` turns such injected
    faults, and only those, into per-role dense fallbacks."""
    global _FAULT_HOOK
    prev = _FAULT_HOOK
    _FAULT_HOOK = fn
    try:
        yield
    finally:
        _FAULT_HOOK = prev


def _fault_check(kind: str) -> None:
    if _FAULT_HOOK is None:
        return
    try:
        _FAULT_HOOK(kind)
    except Exception as e:
        raise KernelFault(f"{kind}: {e}") from e


_DISPATCH_HOOK = None
_DISPATCH_EVENTS = False


@contextlib.contextmanager
def kernel_dispatch_hook(fn, device_events: bool = False):
    """Install a hook called as ``fn(kind, seconds)`` after every kernel
    dispatch (``kind`` ∈ {"bitmap", "nm", "flash"}).  ``seconds`` is the
    host-side time of the call: PyTorch launches asynchronously, so on a
    CUDA device it is the launch cost, not the kernel's device time; on
    the CPU it includes the plain version's execution.  With
    ``device_events``, a dispatch on a CUDA tensor passes ``(start, end)``
    instead: two CUDA events recorded on the current stream around the
    launch, for the hook to read once the device has passed them
    (:func:`repro_torch.obs.profile.kernel_timer`).  Zero cost
    uninstalled: one ``None`` check per dispatch."""
    global _DISPATCH_HOOK, _DISPATCH_EVENTS
    prev = _DISPATCH_HOOK, _DISPATCH_EVENTS
    _DISPATCH_HOOK, _DISPATCH_EVENTS = fn, bool(device_events)
    try:
        yield
    finally:
        _DISPATCH_HOOK, _DISPATCH_EVENTS = prev


def fault_hook_installed() -> bool:
    """Whether a :func:`kernel_fault_hook` is installed: the only source
    of a :class:`KernelFault`."""
    return _FAULT_HOOK is not None


def hooks_installed() -> bool:
    """Whether a fault or dispatch hook is installed: both act in Python
    at every dispatch."""
    return fault_hook_installed() or _DISPATCH_HOOK is not None


def _refuse_grad(kind: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kind}: the kernel has no backward; an input requires grad "
            f"(a loss through a compressed store)")


def _dispatch(kind: str, fn, *args):
    if _DISPATCH_HOOK is None:
        return fn(*args)
    if _DISPATCH_EVENTS and args[0].is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        _DISPATCH_HOOK(kind, (start, end))
        return out
    t0 = time.perf_counter()
    out = fn(*args)
    _DISPATCH_HOOK(kind, time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# Bitmap block-sparse
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BitmapCompressed:
    """`B(N₁)-B(K₁)-None(N₂,K₂)` weights: payload + pre-decoded metadata."""

    blocks: torch.Tensor       # (nnzb, bn, bk)
    counts: torch.Tensor       # (K/bk,) int32
    row_ids: torch.Tensor      # (nnzb,) int32
    offsets: torch.Tensor      # (K/bk,) int32
    n: int
    k: int
    bn: int
    bk: int
    max_per_col: int
    nnzb: int                  # stored blocks, counts.sum(), a host int

    @property
    def compression_ratio(self) -> float:
        dense = self.n * self.k
        stored = self.blocks.shape[0] * self.bn * self.bk
        meta = (self.n // self.bn) * (self.k // self.bk) / 8 / 2  # bits→bytes/2B
        return (stored + meta) / dense


def compress_bitmap(w: torch.Tensor, bn: int = 128, bk: int = 128
                    ) -> BitmapCompressed:
    """Compress on ``w``'s own device."""
    blocks, counts, row_ids, offsets, _ = ref.compress_bitmap(w, bn, bk)
    return BitmapCompressed(
        blocks=blocks, counts=counts, row_ids=row_ids, offsets=offsets,
        n=w.shape[0], k=w.shape[1], bn=bn, bk=bk,
        max_per_col=int(counts.max()) if counts.numel() else 1,
        nnzb=int(counts.sum()))


def _bitmap(x: torch.Tensor, w: BitmapCompressed, t_max: int,
            pipeline: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.bitmap_spmm_ref(x, w.blocks, w.counts, w.row_ids, w.n,
                                   w.k)
    y = _bitmap_cuda.launch(x, w.blocks, w.counts, w.row_ids, w.offsets,
                            w.k, w.max_per_col, t_max=t_max,
                            pipeline=pipeline)
    _LAUNCHES["bitmap_spmm" if pipeline else "bitmap_spmm_naive"] += 1
    return y


def bitmap_spmm(x: torch.Tensor, w: BitmapCompressed,
                t_max: int | None = None,
                pipeline: bool | None = None) -> torch.Tensor:
    """Y = X @ W_blocksparse, (M, K) float32.

    ``t_max`` (default ``w.max_per_col``, at least 1) is the naive
    variant's static bound on the blocks walked per block-column; a layer
    loop passes its per-role max over layers.  A bound below
    ``w.max_per_col`` would drop blocks, so the naive variant refuses it
    (the reference's naive kernel silently truncates).  The pipelined
    variant walks ``counts[kj]`` and ignores ``t_max``."""
    _refuse_grad("bitmap_spmm", x, w.blocks)
    _fault_check("bitmap")
    t_max = max(int(w.max_per_col if t_max is None else t_max), 1)
    pipe = resolve_pipeline(pipeline)
    if not pipe and t_max < w.max_per_col:
        raise ValueError(f"bitmap_spmm: t_max={t_max} is below the longest "
                         f"block-column ({w.max_per_col} blocks)")
    return _dispatch("bitmap", _bitmap, x, w, t_max, pipe)


# ---------------------------------------------------------------------------
# N:M structured
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NMCompressed:
    values: torch.Tensor       # (N·n/m, K)
    indices: torch.Tensor      # (N·n/m, K) int8 ∈ [0, m)
    n: int
    k: int
    n_sel: int = 2
    m_group: int = 4

    @property
    def compression_ratio(self) -> float:
        # values halve; 2-bit indices ≈ n_sel/m_group · 2/16 of dense bits
        return self.n_sel / self.m_group * (1 + 2 / 16)


def compress_nm(w: torch.Tensor, n_sel: int = 2, m_group: int = 4
                ) -> NMCompressed:
    """Compress on ``w``'s own device."""
    vals, idx = ref.compress_nm(w, n_sel, m_group)
    return NMCompressed(values=vals, indices=idx, n=w.shape[0], k=w.shape[1],
                        n_sel=n_sel, m_group=m_group)


def _nm(x: torch.Tensor, w: NMCompressed, pipeline: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.nm_spmm_ref(x, w.values, w.indices, w.n_sel, w.m_group)
    y = _nm_cuda.launch(x, w.values, w.indices, w.n_sel, w.m_group,
                        pipeline=pipeline)
    _LAUNCHES["nm_spmm" if pipeline else "nm_spmm_naive"] += 1
    return y


def nm_spmm(x: torch.Tensor, w: NMCompressed,
            pipeline: bool | None = None) -> torch.Tensor:
    """Y = X @ expand(values, indices), (M, K) float32."""
    _refuse_grad("nm_spmm", x, w.values)
    _fault_check("nm")
    return _dispatch("nm", _nm, x, w, resolve_pipeline(pipeline))


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    o = _flash_cuda.launch(q, k, v, causal)
    _LAUNCHES["flash_attention"] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bq: int = 128, bk: int = 128
                    ) -> torch.Tensor:
    """softmax(Q Kᵀ/√D) V over q (BH, Sq, D), k / v (BH, Skv, D), batch and
    heads flattened (a GQA repeat is the caller's); returns (BH, Sq, D) in
    q's type.  The causal mask is aligned top-left (key ``j`` visible to
    query ``i`` iff ``j <= i``), as the reference kernel's.

    ``bq`` / ``bk`` are the reference's TPU tiles: the calls it refuses
    (Sq not a multiple of ``min(bq, Sq)``, Skv not a multiple of
    ``min(bk, Skv)``) raise ``ValueError`` here too, so both accept the
    same calls; the CUDA kernel's tiles are its own."""
    _refuse_grad("flash_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be (BH, S, D)")
    sq, skv = q.shape[1], k.shape[1]
    tq, tk = min(bq, sq), min(bk, skv)
    if tq < 1 or tk < 1 or sq % tq or skv % tk:
        raise ValueError(f"flash_attention: Sq={sq} / Skv={skv} are not "
                         f"multiples of the tiles ({tq}, {tk})")
    return _dispatch("flash", _flash, q, k, v, causal)
