"""The compiled decode step: ``decode_step`` captured in a CUDA graph and
replayed once per token.

The counterpart of the reference's ``jax.jit(model.decode_step,
donate_argnums=(1,))`` (``repro/launch/serve.py``).  Eager PyTorch launches
the ~2.8k device ops of a full-width decode step one by one from the host;
a replay launches them as one graph.

:class:`CompiledStep` wraps a model (the dense ``Model`` or a
``CompressedModel``) and is called like its ``decode_step``:
``step(params, cache, tokens, pos) -> (logits, cache)``.  On a CUDA device
its first call for a key (:func:`key`) runs the step eagerly on a side
stream, which builds the kernels, warms cuBLAS and the allocator, and is
the call's result, then captures the same step into a graph that reads
static buffers: tokens (B,) int64, ``pos`` (0-d, or (B,) per-row), the
logits and the cache, whatever its tree (K / V, rings, recurrent states,
0-d leaves such as ``cross_ready``).  Every later call copies its tokens
and ``pos`` into those buffers and replays the graph.  The same step
ingests a prompt token by token for a model without a one-pass prefill
(:mod:`repro_torch.launch.serve`).

* The cache is donated, as the reference's ``donate_argnums=(1,)``: a
  cache the graph did not hand out (a new prefill) is copied into the
  graph's static cache, and the step returns a cache over the static
  leaves.  Unlike ``jax.jit``'s, whose every output is a buffer of its
  own, that cache is valid only until a call at the same key copies
  another cache in: one graph serves one sequence at a time.  Passing a
  cache the graph handed out before such a copy raises instead of
  decoding another sequence's cache (:meth:`Graph.adopt`).  A write into
  the returned cache in place between two calls (the mixer's slot writes,
  :func:`repro_torch.launch.mixer.write_slot`) lands in the static
  leaves and keeps the handle valid: the next call replays on it without a copy.
  Such a write through a handle of an earlier copy-in raises as well
  (:func:`check_current`): it would land in another sequence's cache.
  The logits are returned as a fresh tensor.
* Graphs are kept in the model object, so they and their memory pools
  are released with it (:func:`graphs`).  One is captured per key and
  at most :data:`MAX_GRAPHS` are held per model: a new key past that
  releases the least recently used graph.
* A graph replays no Python, so every hook that acts at each dispatch
  would act at the capture only (the reference's hooks likewise act at
  trace time).  The step therefore serves eagerly while one is active
  (``instrument()``, ``kernel_guard``, ``kernel_fault_hook``,
  ``kernel_dispatch_hook``, ``inject.poison_activations``:
  :func:`repro_torch.exec.dispatch.serves_eagerly`),
  inside :func:`disable` (the counterpart of ``jax.disable_jit()``) and on
  the CPU.
* The launch counts stay exact: the capture's counts are taken back out
  and each replay adds them again
  (:func:`repro_torch.kernels.ops.captured_launches`).
* A failed capture raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any

import torch

from repro_torch.exec import dispatch
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import optflags

_DISABLED = False
# graphs held per model: each pins its static cache and its memory pool
MAX_GRAPHS = 8
_STALE = ("this cache was returned by a compiled decode step whose graph has "
          "since taken another cache at the same key; its leaves now hold "
          "that sequence (a returned cache is valid until the next call with "
          "another cache)")


@contextlib.contextmanager
def disable():
    """Serve every :class:`CompiledStep` eagerly inside the context."""
    global _DISABLED
    prev = _DISABLED
    _DISABLED = True
    try:
        yield
    finally:
        _DISABLED = prev


def compiles(device: torch.device) -> bool:
    """Whether a step on ``device`` runs through a graph: a CUDA device,
    outside :func:`disable`, with no per-dispatch hook active."""
    return device.type == "cuda" and not _DISABLED \
        and not dispatch.serves_eagerly()


class _HandedOut(dict):
    """A cache a graph returned: its static leaves, marked with the graph
    (a weak reference: a handle does not keep a released graph's pool) and
    the copy-in it belongs to."""

    __slots__ = ("graph", "serial")


def check_current(cache: dict) -> None:
    """Raise when ``cache`` was handed out by a graph that has since taken
    another cache: its leaves hold that sequence now, so neither a replay
    nor a write through it may use them."""
    g = cache.graph() if isinstance(cache, _HandedOut) else None
    if g is not None and cache.serial != g.serial:
        raise RuntimeError(_STALE)


@dataclasses.dataclass
class Graph:
    """One captured decode step and the static buffers it reads and
    writes.  ``params`` and ``store`` are held because the graph reads
    their memory."""

    graph: Any                     # torch.cuda.CUDAGraph
    params: Any
    store: Any
    tokens: torch.Tensor
    pos: torch.Tensor
    cache: dict                    # the static cache leaves
    logits: torch.Tensor
    launches: dict[str, int]       # kernel launches one replay runs
    capture_ms: float              # host ms of the capture, synchronised
    replays: int = 0
    serial: int = 0                # copy-ins into ``cache`` so far

    def adopt(self, cache: dict) -> dict:
        """The cache a replay for ``cache`` writes and returns.  The cache
        this graph handed out last continues its sequence; any cache it
        did not hand out is copied into the static one, leaf by leaf, and
        a new handle on the static leaves is returned for it.  A cache
        handed out before that copy raises: its leaves are another
        sequence's now."""
        if isinstance(cache, _HandedOut) and cache.graph() is self:
            check_current(cache)
            return cache
        for dst, src in zip(leaves(self.cache), leaves(cache)):
            dst.copy_(src)
        self.serial += 1
        return self.handle()

    def handle(self) -> dict:
        """A new cache over the static leaves, for the latest copy-in."""
        out = _HandedOut(_tree_map(lambda t: t, self.cache))
        out.graph, out.serial = weakref.ref(self), self.serial
        return out


def _tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf (dicts copied)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of a cache tree, in a fixed order (the dicts'
    keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def graphs(model) -> dict[tuple, Graph]:
    """The graphs captured for ``model``, by :func:`key`, the least
    recently used first.  They live in the model's own ``__dict__`` (the
    dataclass may be frozen), so deleting the model releases them and
    their memory pools."""
    return model.__dict__.setdefault("_decode_graphs", {})


def key(model, params, cache: dict, tokens: torch.Tensor, pos) -> tuple:
    """What a graph is captured for: batch, the shape and dtype of every
    cache leaf (a ring's length, a recurrent state's), the rank of
    ``pos``, the compute dtype, the resolved kernel variant, the identity
    of ``params`` and of the compressed store (None for the dense model)
    and the active optimization flags (``gqagroup`` changes the step's
    ops)."""
    return (tokens.shape[0],
            tuple((tuple(t.shape), t.dtype) for t in leaves(cache)),
            pos.ndim if isinstance(pos, torch.Tensor) else 0,
            L.COMPUTE_DTYPE, ops.resolve_pipeline(None), id(params),
            id(getattr(model, "store", None)), optflags.active())


_CAPTURE_STREAMS: dict[int, Any] = {}


def _capture_stream(device: torch.device):
    """One side stream per device for every warm-up and capture: cuBLAS
    keeps a workspace for each stream it has run on, for the life of the
    process."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def _set(dst: torch.Tensor, src) -> None:
    if isinstance(src, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    else:
        dst.fill_(src)


class CompiledStep:
    """``model.decode_step`` served from CUDA graphs (see the module
    docstring).  Construct one per serving loop; the graphs stay with the
    model."""

    def __init__(self, model):
        self.model = model

    def __call__(self, params, cache: dict, tokens: torch.Tensor, pos
                 ) -> tuple[torch.Tensor, dict]:
        if not compiles(tokens.device):
            return self.model.decode_step(params, cache, tokens, pos)
        k = key(self.model, params, cache, tokens, pos)
        held = graphs(self.model)
        g = held.pop(k, None)
        if g is None:
            while len(held) >= MAX_GRAPHS:
                del held[next(iter(held))]
            return self._capture(k, params, cache, tokens, pos)
        held[k] = g                          # now the most recently used
        out = g.adopt(cache)
        _set(g.tokens, tokens)
        _set(g.pos, pos)
        g.graph.replay()
        g.replays += 1
        ops.add_launches(g.launches)
        return g.logits.clone(), out

    def _capture(self, k: tuple, params, cache: dict, tokens: torch.Tensor,
                 pos) -> tuple[torch.Tensor, dict]:
        dev = tokens.device
        # the graph's own cache: no other graph or caller writes it
        cache = _tree_map(torch.clone, cache)
        static_tokens = tokens.to(torch.long, copy=True)
        static_pos = torch.empty(tuple(pos.shape) if isinstance(
            pos, torch.Tensor) else (), dtype=torch.long, device=dev)
        _set(static_pos, pos)
        main = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            # this call's result, run eagerly on the capture's stream: it
            # builds the kernels and makes cuBLAS's handle and workspace
            # for that stream before the capture
            logits, _ = self.model.decode_step(params, cache, static_tokens,
                                               static_pos)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # a capture records the step on the same buffers and runs nothing,
        # so the cache keeps what the warm-up wrote at pos (a recurrent
        # state advanced once)
        with ops.captured_launches() as launches, \
                torch.cuda.graph(graph, stream=side):
            out, _ = self.model.decode_step(params, cache, static_tokens,
                                            static_pos)
        torch.cuda.synchronize(dev)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        main.wait_stream(side)
        logits.record_stream(main)
        g = Graph(graph=graph, params=params,
                  store=getattr(self.model, "store", None),
                  tokens=static_tokens, pos=static_pos, cache=cache,
                  logits=out, launches=launches, capture_ms=capture_ms)
        graphs(self.model)[k] = g
        return logits, g.handle()


def greedy(step, model, params, prompts: torch.Tensor, gen: int,
           per_row: bool = False) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Greedy tokens (B, gen) after a prefill of ``prompts`` and a copy of
    each decode step's logits, every decode step taken by ``step``: a
    :class:`CompiledStep`, or ``model.decode_step`` for the eager step, so
    that the two can be held to each other.  ``pos`` is a device tensor;
    with ``per_row`` it is (B,) and row i decodes i places behind row 0.
    A model without a one-pass prefill ingests the prompt through ``step``
    too, at a scalar ``pos`` (its own key), and those steps' logits come
    first in the list."""
    b, plen = prompts.shape
    dev = prompts.device
    steps = []
    try:
        logits, cache = model.prefill(params, prompts, plen + gen)
        logits = logits[:, -1]
    except NotImplementedError:
        cache = model.init_cache(b, plen + gen, device=dev)
        at = torch.empty((), dtype=torch.long, device=dev)
        for t in range(plen):
            logits, cache = step(params, cache, prompts[:, t], at.fill_(t))
            steps.append(logits.clone())
    tok = logits.argmax(dim=-1)
    behind = torch.arange(b, device=dev)
    pos = torch.empty((b,) if per_row else (), dtype=torch.long, device=dev)
    toks = [tok]
    for t in range(plen, plen + gen - 1):
        pos.copy_(t - behind) if per_row else pos.fill_(t)
        logits, cache = step(params, cache, tok, pos)
        steps.append(logits.clone())
        tok = logits.argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), steps
