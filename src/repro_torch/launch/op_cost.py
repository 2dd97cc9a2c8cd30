"""Roofline terms of a traced step from its dispatched aten ops: the
counterpart of the reference's ``repro.launch.hlo_cost``.

The reference parses the compiled HLO text of a jitted step and walks its
call graph, multiplying each while body by its ``known_trip_count``.  The
port has no HLO: a step is eager PyTorch.  :class:`OpCost` is a
``TorchDispatchMode`` that sees every aten op the step dispatches (the
backward pass and the remat recompute included), on any device; on the
meta device a full-width step costs no memory and runs no arithmetic.
It counts the reference's terms by the reference's rules:

  * FLOPs: every dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``convolution``; ``matmul``, ``einsum`` and ``linear`` reach these)
    as 2 · |result| · |contracting dims|;
  * bytes: the same PERFECT-FUSION roofline model: dot operands and
    result; the moved update of ``index_put_``, ``copy_`` into a view,
    ``scatter`` and ``index_copy_`` (the reference's
    dynamic-update-slice and scatter); the result of ``gather``,
    ``index_select``, ``embedding``, ``index``, the reductions (a
    softmax's two), ``cat`` / ``stack``, ``sort`` and ``topk`` (their
    values; the int64 indices a port's sort also returns are not
    counted).  Views and every elementwise op are
    free.  A dot operand that only views, copies or casts another tensor
    (a transposed weight, a bf16 cast of an fp32 weight, a GQA-repeated
    cache) counts the distinct bytes of what it was made from: a fused
    kernel reads those, once;
  * collectives: :data:`COLLECTIVES`, the reference's keys.  The port
    runs one process on one device, so every term is 0;
  * live bytes: every storage a dispatched op creates (and every tensor
    given to :meth:`OpCost.track`) is live from its creation until its
    last tensor dies, counted once across its views; the peak is the
    counterpart of ``memory_analysis().peak_memory_in_bytes``.

Trip counts: the reference multiplies a scanned layer body by its trip
count.  The port's layers are Python loops, so tracing a full-depth
stack dispatches every layer; :mod:`repro_torch.launch.dryrun` traces the
model cut to one and to two repeating units and extrapolates its FLOPs
and bytes (:meth:`Counted.extrapolate`: the units run the same ops at
the same shapes, so that is exact; the peak is not linear in depth).

No counterpart: ``_parse``, ``_dot_flops``, ``analyze(text)`` and
``analyze_compiled`` read HLO text, which the port does not have.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten

# dots: (index of the lhs operand, index of the rhs operand)
_DOTS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
         aten.baddbmm: (1, 2), aten.convolution: (0, 1)}
# in-place updates (the reference's dynamic-update-slice and scatter):
# the index of the moved update operand
_UPDATES = {aten.index_put_: 2, aten.index_put: 2, aten.scatter: 3,
            aten.scatter_add: 3, aten.index_copy: 3, aten.index_copy_: 3}
# ops whose (first) result is traffic: gathers, the reductions (cumsum is
# XLA's reduce-window), concatenations (stack too), sorts
_RESULTS = {aten.gather, aten.index_select, aten.embedding, aten.index,
            aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
            aten.argmax, aten.argmin, aten.prod, aten.logsumexp,
            aten.cumsum, aten.cat, aten.stack, aten.sort, aten.topk}
# softmax: its two reductions (max and sum), as XLA lowers it
_SOFTMAX = {aten._softmax, aten._log_softmax}
# ops that move or cast one tensor into a new one: a fused consumer
# reads what they read
_MOVES = {aten.clone, aten._to_copy, aten._unsafe_view, aten.lift_fresh}


@dataclasses.dataclass
class Cost:
    """The reference's per-step terms (integers: the counts are exact)."""

    flops: int = 0
    bytes: int = 0
    coll: dict = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    coll_count: int = 0

    def add(self, other: "Cost", mult: int = 1) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for c in COLLECTIVES:
            self.coll[c] += other.coll[c] * mult
        self.coll_count += other.coll_count * mult

    @property
    def coll_bytes(self) -> int:
        return sum(self.coll.values())


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a strided tensor reads: a broadcast
    (stride 0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return (n if t.numel() else 0) * t.element_size()


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpCost(TorchDispatchMode):
    """Counts :class:`Cost` and live / peak bytes over the ops dispatched
    inside ``with OpCost() as oc:`` (see the module docstring).  Results:
    ``oc.cost``, ``oc.peak``, ``oc.live`` (bytes now), ``oc.ops``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._source = WeakIdKeyDictionary()

    # ---- live bytes ----
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        self._storages[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def track(self, tree: Any) -> None:
        """Count the tensors of ``tree`` (a step's arguments) as live."""
        for t in _tensors(tree):
            self._hold(t)

    # ---- bytes a fused reader reads ----
    def _read(self, t: torch.Tensor) -> int:
        got = self._source.get(t)
        return distinct_bytes(t) if got is None else got

    def _trace_source(self, func, args, out) -> None:
        """A move's result reads what its input reads; a view's, its share
        of that."""
        if not args or not isinstance(args[0], torch.Tensor):
            return
        moves = func._overloadpacket in _MOVES
        if not moves and not _is_view(func):
            return
        read = self._read(args[0])
        whole = distinct_bytes(args[0])
        for o in _tensors(out):
            self._source[o] = read if moves or not whole \
                else read * distinct_bytes(o) // whole

    # ---- the terms ----
    def _count(self, func, args, kwargs, out) -> None:
        op = func._overloadpacket
        c = self.cost
        if op in _DOTS:
            li, ri = _DOTS[op]
            lhs, rhs = args[li], args[ri]
            if op is aten.convolution:      # (input, weight, ..., transposed)
                contract = rhs.numel() // rhs.shape[0]
                c.flops += 2 * (lhs if args[6] else out).numel() * contract
            else:
                c.flops += 2 * out.numel() * lhs.shape[-1]
            c.bytes += self._read(lhs) + self._read(rhs) + nbytes(out)
        elif op in _UPDATES:
            i = _UPDATES[op]
            upd = args[i] if i < len(args) else kwargs.get("src")
            if isinstance(upd, torch.Tensor):
                c.bytes += nbytes(upd)
            else:               # a scalar scattered at every index
                c.bytes += args[2].numel() * args[0].element_size()
        elif op is aten.copy_:
            if args[0]._is_view():
                c.bytes += nbytes(args[0])
        elif op in _RESULTS:
            c.bytes += nbytes(_tensors(out)[0])
        elif op in _SOFTMAX:
            c.bytes += 2 * nbytes(out) // max(out.shape[args[1]], 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        self._count(func, args, kwargs, out)
        self._trace_source(func, args, out)
        for t in _tensors(out):
            self._hold(t)
        return out


@dataclasses.dataclass
class Counted:
    """What one traced call cost: the terms, the peak of live bytes (its
    arguments included; ``None`` where extrapolated) and the ops
    dispatched."""

    cost: Cost
    peak: Optional[int]
    ops: int

    def extrapolate(self, two: "Counted", n: int) -> "Counted":
        """``n`` units from this trace of one and ``two``'s of two: the
        fixed part plus ``n - 1`` times the difference (exact for the
        terms: the units dispatch the same ops at the same shapes).  The
        peak is not linear in the units (where it falls moves), so it is
        not extrapolated."""
        cost = Cost()
        cost.add(self.cost)
        cost.add(two.cost, n - 1)
        cost.add(self.cost, 1 - n)
        return Counted(cost, None, self.ops + (n - 1) * (two.ops - self.ops))


def count(fn, *args, **kwargs) -> tuple[Any, Counted]:
    """``fn(*args, **kwargs)`` under :class:`OpCost`, its arguments live
    from the start.  Returns (its result, :class:`Counted`)."""
    with OpCost() as oc:
        oc.track((args, kwargs))
        out = fn(*args, **kwargs)
    return out, Counted(oc.cost, oc.peak, oc.ops)
