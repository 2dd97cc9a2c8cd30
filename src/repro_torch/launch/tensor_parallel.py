"""Tensor-parallel serving over a mesh's ``model`` axis, one process
driving every shard: the counterpart of what GSPMD does for the reference
under ``partition.param_specs`` (Megatron-style: ``wq`` / ``wk`` / ``wv`` /
``w_gate`` / ``w_up`` split by columns, ``wo`` / ``w_down`` by rows, the
embedding by vocab rows where t divides the vocab and whole elsewhere, the
norms replicated; a MoE layer's expert stacks split on their expert axis,
its router replicated).

* :class:`Layout` — how a uniform full-attention stack splits over t
  shards: query heads, ``d_ff`` (or a MoE layer's experts: shard s holds
  experts ``[s·E/t, (s+1)·E/t)``) and the vocab in t contiguous pieces;
  each shard holds the KV heads its query heads group to (t = 4 on
  chatglm3-6b's two KV heads: KV head ``s // 2``, duplicated on two
  shards).  Where t divides ``n_kv_heads`` that is ``param_specs``' split;
  elsewhere it is the ``replkv`` idea restricted to the heads a shard
  uses.  A vocab that t does not divide is not split: every shard holds
  the whole embedding (granite-moe-3b-a800m's 49,155 rows).  A t that
  does not divide the heads, ``d_ff`` or the experts, or whose head groups
  straddle shards, raises ``ValueError``.
* :func:`shard_params` / :func:`shard_store` — a shard's params and its
  compressed store, every tensor a contiguous copy of its own.  A stored
  bitmap block that a shard's boundary crosses is cut (its block shape
  becomes the gcd of the block and the cut); N:M groups are cut on group
  boundaries only.  A shard's store decompresses to the slice of the full
  store, bit for bit, holds the whole expert entries of its experts under
  their global expert index, and records its own checksums.
* :func:`all_reduce` / :func:`all_gather` — the collectives, in shard
  order: a left fold ``((p0 + p1) + p2) + ...`` in the activation's dtype
  on the first shard's device, the sum copied to every shard's device; a
  concatenation on the first device.
* :class:`TensorParallel` — one model served over t shards, with the
  serving surface (``prefill``, ``init_cache``, ``decode_step``,
  ``verify``, ``demoted``, ``cfg``).  Layer by layer and shard by shard
  it runs each sublayer's partial output
  (:func:`repro_torch.models.transformer.attn_out` / ``ffn_out`` /
  ``attn_step_out`` / ``ffn_step_out``; a MoE shard routes over every
  expert and sums over its own), all-reduces it and adds the residual;
  the embedding is a masked lookup in each shard's vocab rows,
  all-reduced (one row plus zeros: exact), and the logits each shard's
  vocab slice, all-gathered; a whole embedding is looked up by each shard
  itself and gives the logits on the first shard.  Each shard's cache
  holds its KV heads (gemma3's local rings and global caches alike);
  each compressed shard dispatches its attention and dense FFN
  projections to the kernels over its own store (a MoE layer's experts
  run dense, as on one device).  Its decode runs eagerly: no CUDA graph
  is captured.

Served: the uniform attention stacks (``dense``, ``moe``, ``vlm``; dense
``Model`` or ``CompressedModel``), a ``window`` too, and gemma3's 5 local
: 1 global stack (dense only, as on one device), with no optflag on.
gemma3 and a windowed stack have no one-pass prefill (``prefill`` raises
``NotImplementedError``, as ``Model.prefill`` does): the serving loop
ingests their prompts token by token through the group's
``decode_step``.  The recurrent (recurrentgemma), SSM and
encoder-decoder families and any optflag raise ``NotImplementedError``
before any work.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import device_ctx
from repro_torch.exec import dispatch
from repro_torch.exec.compress import (CompressedStore, CompressedTensor,
                                       _stored_bits)
from repro_torch.exec.dispatch import CompressedModel
from repro_torch.exec.plans import ExecPlan
from repro_torch.kernels.ops import BitmapCompressed, NMCompressed
from repro_torch.models import layers as L
from repro_torch.models import optflags, sharding
from repro_torch.models import transformer as T
from repro_torch.runtime import integrity

class Shards(dict):
    """One value per shard (or replica), by index: a cache, params, steps.
    A dict, so the cache helpers that walk a cache tree
    (:func:`repro_torch.models.transformer.step_writes`,
    :func:`repro_torch.launch.compiled.leaves`) walk every shard's."""


def unserved(cfg: ModelConfig) -> Optional[str]:
    """Why a ``model`` axis does not serve ``cfg`` (with the optflags now
    on), or ``None`` when it does."""
    if cfg.family not in ("dense", "moe", "vlm") or \
            (cfg.hybrid is not None and not T._gemma3(cfg)):
        return (f"{cfg.name} is family {cfg.family!r}"
                + (" with a hybrid pattern" if cfg.hybrid else ""))
    flags = optflags.active()
    if flags:
        return f"optflags {sorted(flags)} are on"
    return None


def check_served(cfg: ModelConfig, t: int, what: str) -> None:
    """Raise ``NotImplementedError`` where a ``model`` axis of ``t`` does
    not serve ``cfg`` (:func:`unserved`)."""
    reason = unserved(cfg)
    if reason:
        raise NotImplementedError(
            f"{what}: tensor parallelism ({{'model': {t}}}) serves uniform "
            f"attention stacks and gemma3 with no optflag on; {reason}")


@dataclasses.dataclass(frozen=True)
class Layout:
    """How ``cfg`` splits over ``t`` shards (see the module docstring)."""

    cfg: ModelConfig
    t: int

    def __post_init__(self):
        cfg, t = self.cfg, self.t
        if t < 1:
            raise ValueError(f"a model axis of {t} shards")
        extents = [("n_heads", cfg.n_heads)]
        extents += [("n_experts", cfg.moe.n_experts)] if cfg.moe \
            else [("d_ff", cfg.d_ff)]
        for name, extent in extents:
            if extent % t:
                raise ValueError(f"{cfg.name}: {name} = {extent} does not "
                                 f"split over {t} shards")
        nk = max(cfg.n_kv_heads, 1)
        if cfg.n_heads % nk:
            raise ValueError(f"{cfg.name}: {cfg.n_heads} query heads do not "
                             f"group over {nk} KV heads")
        if self.heads % self.group and self.group % self.heads:
            raise ValueError(
                f"{cfg.name}: over {t} shards of {self.heads} query heads "
                f"the groups of {self.group} query heads a KV head straddle "
                f"shards")

    @property
    def heads(self) -> int:
        """Query heads a shard."""
        return self.cfg.n_heads // self.t

    @property
    def group(self) -> int:
        """Query heads a KV head."""
        return self.cfg.n_heads // max(self.cfg.n_kv_heads, 1)

    def kv_heads(self, s: int) -> tuple[int, int]:
        """Shard ``s``'s KV heads: (first, count)."""
        return s * self.heads // self.group, max(self.heads // self.group, 1)

    @property
    def vocab_split(self) -> bool:
        """Whether the embedding splits by vocab rows (t divides the
        vocab); else every shard holds it whole, as ``param_specs``
        replicates it."""
        return self.cfg.vocab % self.t == 0

    def experts(self, s: int) -> tuple[int, int]:
        """Shard ``s``'s experts ``[lo, hi)`` of a MoE layer."""
        e = self.cfg.moe.n_experts // self.t
        return s * e, (s + 1) * e

    def cut(self, role: str, s: int) -> tuple[int, int, int]:
        """(axis, lo, hi): shard ``s``'s slice of a weight ``(..., n, k)``
        of ``role`` along ``axis`` (-1 columns, -2 rows; -3 the expert
        axis of a MoE expert stack ``(..., E, n, k)``)."""
        if role in ("moe.w_gate", "moe.w_up", "moe.w_down"):
            return (-3, *self.experts(s))
        hd, f = self.cfg.head_dim, self.cfg.d_ff // self.t
        q = (s * self.heads * hd, (s + 1) * self.heads * hd)
        if role == "attn.wq":
            return (-1, *q)
        if role in ("attn.wk", "attn.wv"):
            first, n = self.kv_heads(s)
            return -1, first * hd, (first + n) * hd
        if role in ("ffn.w_gate", "ffn.w_up"):
            return -1, s * f, (s + 1) * f
        if role == "attn.wo":
            return (-2, *q)
        if role == "ffn.w_down":
            return -2, s * f, (s + 1) * f
        raise ValueError(f"no tensor-parallel split for role {role!r}")

    def vocab_rows(self, s: int) -> tuple[int, int]:
        """Shard ``s``'s rows of the embedding (all of them where the
        vocab does not split)."""
        if not self.vocab_split:
            return 0, self.cfg.vocab
        v = self.cfg.vocab // self.t
        return s * v, (s + 1) * v

    def shard_cfg(self) -> ModelConfig:
        """A shard's config: its heads, KV heads, ``d_ff`` and vocab rows,
        with ``d_head`` pinned (``head_dim`` would follow ``d_model //
        n_heads``).  A MoE shard keeps ``moe`` whole (it routes over every
        expert) and ``d_ff``, which no MoE layer reads; ``window`` and
        ``hybrid`` stay, so a shard's model builds the rings and layer
        stacks one device builds."""
        cfg = self.cfg
        v0, v1 = self.vocab_rows(0)
        return dataclasses.replace(
            cfg, n_heads=self.heads, n_kv_heads=self.kv_heads(0)[1],
            d_ff=cfg.d_ff if cfg.moe else cfg.d_ff // self.t,
            vocab=v1 - v0, d_head=cfg.head_dim)


def _own(x: torch.Tensor, device=None) -> torch.Tensor:
    """A contiguous copy of its own of ``x`` on ``device`` (``x``'s by
    default): a fresh allocation, aligned as the kernels need."""
    out = torch.empty(x.shape, dtype=x.dtype,
                      device=x.device if device is None else device)
    return out.copy_(x)


def _role_leaves(blocks: dict):
    """(role, group, leaf) of every projection in a layer stack; a MoE
    layer's FFN leaves are the ``moe.*`` roles (its router
    ``moe.router``)."""
    for group in ("attn", "ffn"):
        prefix = "moe" if group == "ffn" and "router" in blocks[group] \
            else group
        for leaf in blocks[group]:
            yield f"{prefix}.{leaf}", group, leaf


def _stacks(params: dict) -> list:
    """(path, stack) of every layer stack of ``params``: ``blocks`` (a
    uniform stack), or gemma3's local layers ``super/local`` ``(n_super,
    5, ...)``, global ones ``super/global`` ``(n_super, ...)`` and local
    ``tail`` ``(2, ...)``; ``ValueError`` for any other tree."""
    top = set(params) - {"embed", "final_norm"}
    if top == {"blocks"}:
        stacks = [(("blocks",), params["blocks"])]
    elif top == {"super", "tail"} and set(params["super"]) == {"local",
                                                               "global"}:
        stacks = [(("super", "local"), params["super"]["local"]),
                  (("super", "global"), params["super"]["global"]),
                  (("tail",), params["tail"])]
    else:
        raise ValueError(f"shard_params: no tensor-parallel split for "
                         f"{sorted(top)}")
    for _, stack in stacks:
        extra = set(stack) - {"ln1", "ln2", "attn", "ffn"}
        if extra:
            raise ValueError(f"shard_params: no tensor-parallel split for "
                             f"{sorted(extra)}")
    return stacks


def _shard_stack(blocks: dict, layout: Layout, s: int, device) -> dict:
    """Shard ``s``'s cut of one layer stack (its leaves' leading layer
    axes kept: every cut is on a trailing axis)."""
    out: dict = {"ln1": _own(blocks["ln1"], device),
                 "ln2": _own(blocks["ln2"], device), "attn": {}, "ffn": {}}
    for role, group, leaf in _role_leaves(blocks):
        w = blocks[group][leaf]
        if role == "moe.router":
            out[group][leaf] = _own(w, device)
            continue
        axis, lo, hi = layout.cut(role, s)
        out[group][leaf] = _own(w.narrow(w.ndim + axis, lo, hi - lo),
                                device)
    return out


def shard_params(params: dict, layout: Layout, s: int, device=None) -> dict:
    """Shard ``s``'s params on ``device`` (the params' by default): column
    slices of ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``, row slices
    of ``wo`` / ``w_down``, a MoE layer's expert stacks cut to its experts
    and its router whole, rows ``[s·V/t, (s+1)·V/t)`` of ``embed`` (all of
    them where the vocab does not split), the norms whole; each a
    contiguous copy of its own.  The layer stacks are ``blocks`` or
    gemma3's ``super/local``, ``super/global`` and ``tail``, each cut
    alike."""
    v0, v1 = layout.vocab_rows(s)
    out: dict = {"embed": _own(params["embed"][v0:v1], device),
                 "final_norm": _own(params["final_norm"], device)}
    for path, stack in _stacks(params):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _shard_stack(stack, layout, s, device)
    return out


def _bitmap_of(blocks: torch.Tensor, counts: list, row_ids: list, n: int,
               k: int, bn: int, bk: int, device) -> BitmapCompressed:
    """A :class:`BitmapCompressed` from cut blocks and host metadata, as
    ``compress_bitmap`` lays it out (one zero block and row id 0 where no
    block is stored)."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    offsets = [0, *itertools.accumulate(counts)][:len(counts)]
    if not row_ids:
        blocks = torch.zeros((1, bn, bk), dtype=blocks.dtype, device=device)
        row_ids = [0]
    return BitmapCompressed(
        blocks=blocks, counts=i32(counts), row_ids=i32(row_ids),
        offsets=i32(offsets), n=n, k=k, bn=bn, bk=bk,
        max_per_col=max(counts) if counts else 1, nnzb=sum(counts))


def _cut_bitmap(d: BitmapCompressed, axis: int, lo: int, hi: int,
                device) -> BitmapCompressed:
    """Shard ``[lo, hi)`` of a bitmap weight's columns (``axis`` -1) or
    rows (-2): every stored block that meets the slice, cut to the block
    shape ``gcd(block, lo, hi - lo)`` along that axis; blocks stay in
    column-major order, a column's row ids ascending."""
    counts = d.counts.tolist()
    offsets = d.offsets.tolist()
    rids = d.row_ids[:d.nnzb].tolist()
    if axis == -1:
        bk = math.gcd(d.bk, lo, hi - lo)
        parts, new_counts, new_rids = [], [], []
        for c in range(lo, hi, bk):
            kj, o = divmod(c, d.bk)
            a, n = offsets[kj], counts[kj]
            parts.append(d.blocks[a:a + n, :, o:o + bk])
            new_counts.append(n)
            new_rids.extend(rids[a:a + n])
        blocks = torch.empty((sum(new_counts), d.bn, bk),
                             dtype=d.blocks.dtype, device=device)
        at = 0
        for p in parts:
            blocks[at:at + p.shape[0]].copy_(p)
            at += p.shape[0]
        return _bitmap_of(blocks, new_counts, new_rids, d.n, hi - lo, d.bn,
                          bk, device)
    bn = math.gcd(d.bn, lo, hi - lo)
    per = d.bn // bn
    take_b, take_p, new_rids, new_counts = [], [], [], []
    for kj, (a, n) in enumerate(zip(offsets, counts)):
        kept = 0
        for b in range(a, a + n):
            for p in range(per):
                r0 = rids[b] * d.bn + p * bn
                if lo <= r0 < hi:
                    take_b.append(b)
                    take_p.append(p)
                    new_rids.append((r0 - lo) // bn)
                    kept += 1
        new_counts.append(kept)
    sub = d.blocks.view(d.blocks.shape[0], per, bn, d.bk)
    idx = (torch.tensor(take_b, dtype=torch.long, device=d.blocks.device),
           torch.tensor(take_p, dtype=torch.long, device=d.blocks.device))
    blocks = _own(sub[idx], device)
    return _bitmap_of(blocks, new_counts, new_rids, hi - lo, d.k, bn, d.bk,
                      device)


def _cut_nm(d: NMCompressed, role: str, axis: int, lo: int, hi: int,
            device) -> NMCompressed:
    """Shard ``[lo, hi)`` of an N:M weight's columns or rows; rows are cut
    on group boundaries only."""
    if axis == -1:
        return dataclasses.replace(
            d, values=_own(d.values[:, lo:hi], device),
            indices=_own(d.indices[:, lo:hi], device), k=hi - lo)
    m = d.m_group
    if lo % m or hi % m:
        raise ValueError(f"{role}: the shard's rows [{lo}, {hi}) cut an "
                         f"{d.n_sel}:{m} group")
    r0, r1 = lo // m * d.n_sel, hi // m * d.n_sel
    return dataclasses.replace(
        d, values=_own(d.values[r0:r1], device),
        indices=_own(d.indices[r0:r1], device), n=hi - lo)


def _to(x: Any, dev: Optional[torch.device], clone: bool) -> Any:
    """``x`` with every tensor on ``dev`` (its own device for ``None``; a
    copy of its own with ``clone``), through dicts, lists, tuples and
    dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True) if clone else x.to(dev)
    if isinstance(x, dict):
        return type(x)((k, _to(v, dev, clone)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev, clone) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev, clone) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev, clone)
            for f in dataclasses.fields(x) if f.init})
    return x


def shard_store(store: CompressedStore, plan: ExecPlan, cfg: ModelConfig,
                layout: Layout, s: int, device=None) -> CompressedStore:
    """Shard ``s``'s :class:`CompressedStore` on ``device`` (the store's by
    default): each entry of ``store`` cut to the shard's columns (column
    roles) or rows (row roles), its stored bits recounted; the whole
    expert entries of the shard's experts, under their global expert
    index (so a fault names the expert one device names); its plan is
    ``plan`` with the shard's own checksums, recorded as
    ``compress_params`` records them."""
    if layout.cfg != cfg:
        raise ValueError(f"shard_store: the layout is of {layout.cfg.name}, "
                         f"not of {cfg.name}")
    entries: dict = {}
    lo_e, hi_e = layout.experts(s) if cfg.moe else (0, 0)
    for key, e in store.entries.items():
        if e.expert >= 0:
            if lo_e <= e.expert < hi_e:
                entries[key] = _to(e, device, clone=True)
            continue
        axis, lo, hi = layout.cut(e.role, s)
        d = e.data
        if e.kind == "bitmap":
            data = _cut_bitmap(d, axis, lo, hi, device or d.blocks.device)
            full, n, k = d.n * d.k, data.n, data.k
        elif e.kind == "nm":
            data = _cut_nm(d, e.role, axis, lo, hi,
                           device or d.values.device)
            full, n, k = d.n * d.k, data.n, data.k
        else:
            data = _own(d.narrow(d.ndim + axis, lo, hi - lo), device)
            full, (n, k) = d.numel(), data.shape
        vb = round(e.dense_bits / full)          # the weights' value bits
        entries[key] = CompressedTensor(
            layer=e.layer, role=e.role, expert=e.expert, kind=e.kind,
            data=data, dense_bits=float(n * k * vb),
            stored_bits=_stored_bits(e.kind, data, vb))
    shard = CompressedStore(plan, entries)
    shard.plan = dataclasses.replace(
        plan, checksums=integrity.checksum_store(shard))
    return shard


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of ``parts`` as a left fold ``((p0 + p1) + p2) + ...`` in
    their dtype on ``parts[0]``'s device, then copied to every part's
    device (one copy a device): one tensor a part, in order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device, non_blocking=True)
    on = {total.device: total}
    out = []
    for p in parts:
        if p.device not in on:
            on[p.device] = total.to(p.device, non_blocking=True)
        out.append(on[p.device])
    return out


def all_gather(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in order on the first part's
    device."""
    dev = parts[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class TensorParallel:
    """``shards[s]`` (a ``Model`` or ``CompressedModel`` of the shard
    config) on ``devices[s]`` serves its slice of every layer.  The
    serving surface takes the shards' params and a cache as
    :class:`Shards`; every tensor it returns lies on ``devices[0]``.  With
    ``plain`` every compressed projection runs its kernel's plain version
    over the shard's store: the guarded serving path's witness, never a
    serving path."""

    shards: list
    layout: Layout
    devices: list
    plain: bool = False

    def __post_init__(self):
        self._disp = [dispatch._Dispatcher(m.store, self.plain or m.plain)
                      if isinstance(m, CompressedModel) else None
                      for m in self.shards]

    @property
    def cfg(self) -> ModelConfig:
        return self.layout.cfg

    @property
    def model(self) -> "TensorParallel":
        """The dense model over the same shards' params: the guard's
        degradation target."""
        return TensorParallel(
            [m.model if isinstance(m, CompressedModel) else m
             for m in self.shards], self.layout, self.devices)

    def with_model(self, model) -> "TensorParallel":
        """``model`` (a dense ``Model`` of this config) split as this one
        is, over the same shards' params."""
        if isinstance(model, CompressedModel) or model.cfg != self.cfg:
            raise ValueError(f"with_model: {model!r} is not a dense model "
                             f"of {self.cfg.name}")
        return self.model

    def verify(self) -> dict[str, str]:
        """Verify every shard's store; raise the first
        :class:`~repro_torch.runtime.integrity.IntegrityError`."""
        out: dict[str, str] = {}
        for m in self.shards:
            out.update(m.verify())
        return out

    def demoted(self, roles) -> "TensorParallel":
        """The given roles served dense on every shard."""
        return TensorParallel([m.demoted(roles) for m in self.shards],
                              self.layout, self.devices, self.plain)

    @contextlib.contextmanager
    def _on(self, s: int):
        """Shard ``s``'s scope: its device, its store's dispatcher, and
        its local view of the sharding rules."""
        with device_ctx(self.devices[s]), dispatch.installed(self._disp[s]), \
                sharding.local_view():
            yield

    def _check(self) -> None:
        check_served(self.cfg, self.layout.t, "TensorParallel")

    def _experts(self, s: int):
        """Shard ``s``'s expert range (``None`` for a dense FFN)."""
        return self.layout.experts(s) if self.cfg.moe else None

    def _embed(self, params: Shards, tokens: list) -> list:
        """Each shard's masked lookup in its vocab rows, all-reduced; with
        the whole embedding on every shard, each shard's own lookup (the
        sum of t copies would be t times the row)."""
        if not self.layout.vocab_split:
            out = []
            for s, tok in enumerate(tokens):
                with self._on(s):
                    out.append(params[s]["embed"][tok].to(L.COMPUTE_DTYPE))
            return out
        parts = []
        for s, tok in enumerate(tokens):
            v0, v1 = self.layout.vocab_rows(s)
            with self._on(s):
                local = tok - v0
                inside = (local >= 0) & (local < v1 - v0)
                rows = params[s]["embed"][torch.where(inside, local, 0)]
                parts.append(torch.where(inside[..., None], rows, 0.0)
                             .to(L.COMPUTE_DTYPE))
        return all_reduce(parts)

    def _sublayer(self, xs: list, fn) -> list:
        """``x + all_reduce(fn(s, x_s))`` on every shard."""
        outs = []
        for s, x in enumerate(xs):
            with self._on(s):
                outs.append(fn(s, x))
        return [x + a for x, a in zip(xs, all_reduce(outs))]

    def _logits(self, params: Shards, xs: list, head) -> torch.Tensor:
        """Each shard's vocab slice of the logits, all-gathered; the first
        shard's own where it holds the whole embedding."""
        if not self.layout.vocab_split:
            xs = xs[:1]
        parts = []
        for s, x in enumerate(xs):
            with self._on(s):
                x = L.rms_norm(x, params[s]["final_norm"], self.cfg.norm_eps)
                parts.append(head(x, params[s]["embed"]))
        return parts[0] if len(parts) == 1 else all_gather(parts, -1)

    def init_cache(self, batch: int, max_len: int, device=None) -> Shards:
        """Each shard's cache of its KV heads on its device (``device`` is
        the shards' own), in one device's layout: a uniform stack's
        ``{"self"}`` (``max_len`` long, a ``window`` too), gemma3's
        ``{"local"}`` rings of ``min(window, max_len)`` and ``{"global"}``
        caches."""
        return Shards((s, m.init_cache(batch, max_len, device=d))
                      for s, (m, d) in enumerate(zip(self.shards,
                                                     self.devices)))

    def prefill(self, params: Shards, tokens: torch.Tensor, max_len: int):
        """(logits (B, S, V) float32, cache) as ``Model.prefill``: uniform
        full-attention stacks only.  gemma3 and a stack with a ``window``
        raise ``NotImplementedError``, as ``Model.prefill`` does: the
        serving loop, the mixer's admission and the guard then ingest the
        prompt token by token through :meth:`decode_step`, which writes
        the rings (a one-pass body here would attend without them)."""
        self._check()
        cfg, scfg = self.cfg, self.shards[0].cfg
        if not T._uniform_stack(cfg) or cfg.window:
            raise NotImplementedError(
                f"TensorParallel.prefill: uniform full-attention stacks "
                f"only; {cfg.name} ingests its prompt token by token")
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({max_len})")
        cache = self.init_cache(b, max_len)
        toks = [tokens.to(d, non_blocking=True) for d in self.devices]
        positions = [torch.arange(s, device=d) for d in self.devices]
        freqs = [L.rope_freqs(cfg, d) for d in self.devices]
        xs = self._embed(params, toks)
        for i in range(cfg.n_layers):
            with L.layer_ctx(i):
                def attn_part(j, x):
                    a, k, v = T.attn_out(
                        x, T._take(params[j]["blocks"], i), scfg, freqs[j],
                        positions[j], return_kv=True)
                    cache[j]["self"]["k"][i, :, :s] = k
                    cache[j]["self"]["v"][i, :, :s] = v
                    return a
                xs = self._sublayer(xs, attn_part)
                xs = self._sublayer(xs, lambda j, x: T.ffn_out(
                    x, T._take(params[j]["blocks"], i), scfg,
                    self._experts(j)))
        logits = self._logits(params, xs, lambda x, e: torch.matmul(
            x, e.to(L.COMPUTE_DTYPE).t()).float())
        return logits, cache

    def _layer_step(self, xs: list, p, kv, poss: list, cposs: list,
                    freqs: list) -> list:
        """One layer of a decode step on every shard: the attention half,
        writing shard j's K / V into ``kv(j)`` at ``cposs[j]``, then the
        FFN half, each partial output all-reduced (``p(j)``: shard j's
        layer params)."""
        scfg = self.shards[0].cfg

        def attn(j, x):
            kc, vc = kv(j)
            return T.attn_step_out(x, p(j), scfg, freqs[j], poss[j], kc, vc,
                                   cposs[j])
        xs = self._sublayer(xs, attn)
        return self._sublayer(xs, lambda j, x: T.ffn_step_out(
            x, p(j), scfg, self._experts(j)))

    def decode_step(self, params: Shards, cache: Shards,
                    tokens: torch.Tensor, pos):
        """One token for the whole batch, as ``Model.decode_step``: each
        shard's cache written in place; (logits (B, V), cache).  A uniform
        stack writes slot ``pos`` (``pos % S`` with a ``window``); gemma3
        runs each super-block's 5 local layers into their rings at ``pos
        % window`` and its global layer at ``pos``, then the local tail."""
        self._check()
        cfg = self.cfg
        pos = T.decode_pos(tokens, pos)
        toks = [tokens.to(d, non_blocking=True) for d in self.devices]
        poss = [pos.to(d, non_blocking=True) for d in self.devices]
        freqs = [L.rope_freqs(cfg, d) for d in self.devices]
        xs = self._embed(params, toks)
        if T._gemma3(cfg):
            win = cache[0]["local"]["k"].shape[2]
            lposs = [p % win for p in poss]
            n_super = cache[0]["global"]["k"].shape[0]

            def ring(li):
                return lambda j: (cache[j]["local"]["k"][li],
                                  cache[j]["local"]["v"][li])
            for i in range(n_super):
                for jj in range(5):
                    xs = self._layer_step(
                        xs, lambda j: T._take(T._take(
                            params[j]["super"]["local"], i), jj),
                        ring(i * 5 + jj), poss, lposs, freqs)
                xs = self._layer_step(
                    xs, lambda j: T._take(params[j]["super"]["global"], i),
                    lambda j: (cache[j]["global"]["k"][i],
                               cache[j]["global"]["v"][i]),
                    poss, poss, freqs)
            for t in range(params[0]["tail"]["ln1"].shape[0]):
                xs = self._layer_step(
                    xs, lambda j: T._take(params[j]["tail"], t),
                    ring(n_super * 5 + t), poss, lposs, freqs)
        else:
            size = cache[0]["self"]["k"].shape[2]
            cposs = [p % size for p in poss] if cfg.window else poss
            for i in range(cfg.n_layers):
                with L.layer_ctx(i):
                    xs = self._layer_step(
                        xs, lambda j: T._take(params[j]["blocks"], i),
                        lambda j: (cache[j]["self"]["k"][i],
                                   cache[j]["self"]["v"][i]),
                        poss, cposs, freqs)
        return self._logits(params, xs, L.logits_head), cache


def build(model, params: dict, devices: list, what: str = "build"
          ) -> tuple[TensorParallel, Shards]:
    """``model`` (a ``Model`` or ``CompressedModel``) over ``params`` split
    over ``devices``, one shard each: the :class:`TensorParallel` and its
    shards' params.  Refuses what a ``model`` axis does not serve
    (``NotImplementedError``) and a split that does not divide
    (``ValueError``) before it copies anything."""
    cfg = model.cfg
    check_served(cfg, len(devices), what)
    layout = Layout(cfg, len(devices))
    scfg = layout.shard_cfg()
    ps = Shards((s, shard_params(params, layout, s, dev))
                for s, dev in enumerate(devices))
    if not isinstance(model, CompressedModel):
        return TensorParallel([T.Model(scfg) for _ in devices], layout,
                              list(devices)), ps
    # the shards' checksums (host copies and sha256, which releases the
    # GIL) are taken side by side
    with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
        stores = list(pool.map(lambda s: shard_store(
            model.store, model.store.plan, cfg, layout, s, devices[s]),
            range(len(devices))))
    return TensorParallel([CompressedModel(T.Model(scfg), st,
                                           plain=model.plain)
                           for st in stores], layout, list(devices)), ps
