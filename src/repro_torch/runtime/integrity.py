"""Payload integrity for the compressed serving plane: a copy of the
reference's ``repro.runtime.integrity`` on torch payloads.

A compressed store is a single point of silent corruption: one flipped
bitmap count or truncated N:M index buffer produces garbage tokens, not a
crash.  This module makes corruption LOUD, in two layers:

  * **Content checksums** — :func:`checksum_store` digests every role's
    compressed payload (sha256 over the *logical* encoding: counts,
    offsets, the first ``nnzb`` row ids and blocks; the N:M values and
    indices).  The digests equal the reference's byte for byte on the
    same payloads: the same header strings (numpy's dtype string, such as
    ``'<f4'``), the metadata and the N:M indices widened to int64.
    ``compress.compress_params`` records them in the plan
    (``ExecPlan.checksums``, JSON round-tripped);
    ``CompressedStore.verify`` recomputes and compares.
  * **Structural invariants** — cheap shape/range checks that need no
    reference digest: per-column counts non-negative and ≤ the block-grid
    rows, offsets exactly the exclusive cumsum of counts (hence monotone),
    row ids inside the grid, payload within capacity, N:M indices inside
    ``[0, m_group)``.  These run even for plans that predate checksums.

Violations raise a structured :class:`IntegrityError` carrying
``(layer, role, reason)`` so the guarded serving path
(:mod:`repro_torch.runtime.guard`) can demote exactly the failing role to
dense weights instead of serving garbage — or crashing the whole batch.

The port has no layer-stacked store, so the reference's stacked checks
have no counterpart: :func:`role_errors` takes a per-layer store.  Each
entry is copied to the host once, and the roles are checked in a thread
pool (``hashlib`` releases the GIL on large updates), so a full-width
store verifies in a few seconds.  Everything here is duck-typed over the
store dataclasses (no import of :mod:`repro_torch.exec`, which imports
*us* lazily).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
from typing import Callable, Optional

import numpy as np
import torch


class IntegrityError(RuntimeError):
    """A compressed payload failed verification.

    Structured: ``role`` and ``reason`` are always set; ``layer`` is the
    first offending layer when known (``None`` for role-wide digest
    mismatches where the layer cannot be localized)."""

    def __init__(self, role: str, reason: str,
                 layer: Optional[int] = None, detail: str = ""):
        self.role = role
        self.reason = reason
        self.layer = layer
        self.detail = detail
        where = f"layer {layer} " if layer is not None else ""
        msg = f"integrity violation at {where}role {role!r}: {reason}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


def _np(a) -> np.ndarray:
    """``a`` as a host numpy array (a copy off the device; a view of a CPU
    tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _dtype_str(a) -> str:
    """numpy's dtype string of ``a`` (``'<f4'``), without copying it."""
    if isinstance(a, torch.Tensor):
        return torch.empty(0, dtype=a.dtype).numpy().dtype.str
    return np.asarray(a).dtype.str


# ---------------------------------------------------------------------------
# Structural invariants
# ---------------------------------------------------------------------------

def check_bitmap_structure(role: str, layer: int, counts, offsets, row_ids,
                           blocks, n: int, k: int, bn: int, bk: int) -> None:
    """Invariants of one layer's bitmap CSC encoding (cheap, O(grid)).
    ``blocks`` is read for its capacity only."""
    gn, gk = n // bn, k // bk
    counts = _np(counts)
    offsets = _np(offsets)
    if counts.shape != (gk,) or offsets.shape != (gk,):
        raise IntegrityError(role, "metadata_shape_mismatch", layer,
                             f"counts {counts.shape} offsets {offsets.shape} "
                             f"for grid ({gn},{gk})")
    if counts.size and int(counts.min()) < 0:
        raise IntegrityError(role, "negative_count", layer)
    if counts.size and int(counts.max()) > gn:
        raise IntegrityError(role, "count_exceeds_blocks", layer,
                             f"max count {int(counts.max())} > {gn} "
                             f"block rows per column")
    nnzb = int(counts.sum())
    capacity = int(blocks.shape[0])
    if nnzb > capacity:
        raise IntegrityError(role, "payload_overflow", layer,
                             f"counts sum to {nnzb} blocks but payload "
                             f"holds {capacity}")
    expect = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64) \
        if counts.size else np.zeros(0, np.int64)
    if not np.array_equal(offsets.astype(np.int64), expect):
        raise IntegrityError(role, "offsets_not_cumsum", layer,
                             "offsets are not the exclusive cumsum of "
                             "counts (truncated or non-monotone)")
    rid = _np(row_ids[:nnzb])
    if rid.size and (int(rid.min()) < 0 or int(rid.max()) >= gn):
        raise IntegrityError(role, "row_id_out_of_range", layer,
                             f"row ids must lie in [0, {gn})")


def check_nm_structure(role: str, layer: int, values, indices,
                       n: int, k: int, n_sel: int, m_group: int) -> None:
    """Invariants of one layer's N:M encoding.  ``values`` is read for its
    shape only."""
    expect = (n * n_sel // m_group, k)
    if tuple(values.shape) != expect or tuple(indices.shape) != expect:
        raise IntegrityError(role, "payload_shape_mismatch", layer,
                             f"values {tuple(values.shape)} indices "
                             f"{tuple(indices.shape)} expected {expect}")
    indices = _np(indices)
    if indices.size and (int(indices.min()) < 0
                         or int(indices.max()) >= m_group):
        raise IntegrityError(role, "nm_index_out_of_range", layer,
                             f"indices must lie in [0, {m_group})")


# ---------------------------------------------------------------------------
# Content checksums
# ---------------------------------------------------------------------------

def _digest_bitmap(h, layer: int, expert: int, counts, offsets, row_ids,
                   blocks, n: int, k: int, bn: int, bk: int) -> None:
    counts = _np(counts)
    nnzb = int(counts.sum())
    h.update(f"bitmap:{layer}:{expert}:{n}x{k}/{bn}x{bk}:"
             f"{_dtype_str(blocks)}".encode())
    h.update(np.ascontiguousarray(counts, np.int64))
    h.update(np.ascontiguousarray(_np(offsets), np.int64))
    h.update(np.ascontiguousarray(_np(row_ids[:nnzb]), np.int64))
    h.update(np.ascontiguousarray(_np(blocks[:nnzb])))


def _digest_nm(h, layer: int, expert: int, values, indices,
               n: int, k: int, n_sel: int, m_group: int) -> None:
    h.update(f"nm:{layer}:{expert}:{n}x{k}:{n_sel}:{m_group}:"
             f"{_dtype_str(values)}".encode())
    h.update(np.ascontiguousarray(_np(values)))
    h.update(np.ascontiguousarray(_np(indices), np.int64))


def _digest_dense(h, layer: int, expert: int, w) -> None:
    w = _np(w)
    h.update(f"dense:{layer}:{expert}:{w.shape}:{w.dtype.str}".encode())
    h.update(np.ascontiguousarray(w))


def _digest_entry(h, e) -> None:
    d = e.data
    if e.kind == "bitmap":
        _digest_bitmap(h, e.layer, e.expert, d.counts, d.offsets, d.row_ids,
                       d.blocks, d.n, d.k, d.bn, d.bk)
    elif e.kind == "nm":
        _digest_nm(h, e.layer, e.expert, d.values, d.indices,
                   d.n, d.k, d.n_sel, d.m_group)
    else:
        _digest_dense(h, e.layer, e.expert, d)


def _check_and_digest(h, e) -> None:
    """Structure check of one entry (raising), then its digest into ``h``
    unless ``h`` is None, with each array the two share copied to the
    host once."""
    d = e.data
    if e.kind == "bitmap":
        counts, offsets, row_ids = map(_np, (d.counts, d.offsets,
                                             d.row_ids))
        check_bitmap_structure(e.role, e.layer, counts, offsets, row_ids,
                               d.blocks, d.n, d.k, d.bn, d.bk)
        if h is not None:
            _digest_bitmap(h, e.layer, e.expert, counts, offsets, row_ids,
                           d.blocks, d.n, d.k, d.bn, d.bk)
    elif e.kind == "nm":
        indices = _np(d.indices)
        check_nm_structure(e.role, e.layer, d.values, indices,
                           d.n, d.k, d.n_sel, d.m_group)
        if h is not None:
            _digest_nm(h, e.layer, e.expert, d.values, indices,
                       d.n, d.k, d.n_sel, d.m_group)
    elif h is not None:
        _digest_dense(h, e.layer, e.expert, d)


def _per_role(store, fn: Callable[[str, list], object]) -> list:
    """``[(role, fn(role, entries))]`` in sorted role order, entries in
    (layer, expert) order; the roles run in a thread pool."""
    by_role: dict[str, list] = {}
    for e in store:
        by_role.setdefault(e.role, []).append(e)
    roles = sorted(by_role)
    if not roles:
        return []
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(len(roles), os.cpu_count() or 1)) as pool:
        futures = [pool.submit(fn, role, sorted(
            by_role[role], key=lambda e: (e.layer, e.expert)))
            for role in roles]
        return [(role, f.result()) for role, f in zip(roles, futures)]


def checksum_store(store) -> dict[str, str]:
    """Per-role sha256 hexdigests of a :class:`CompressedStore`'s payloads.

    Entries of a role digest in (layer, expert) order.  The digest covers
    only the logical encoding (``[:nnzb]`` slices for bitmap), equal to
    the reference's on the same payloads."""
    def digest(role: str, entries: list) -> str:
        h = hashlib.sha256()
        for e in entries:
            _digest_entry(h, e)
        return h.hexdigest()
    return dict(_per_role(store, digest))


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------

def role_errors(store) -> list[tuple[str, Optional[IntegrityError]]]:
    """(role, first violation or None) for every role of a store.

    Structure is checked entry by entry, then the content digest is
    compared against ``store.plan.checksums`` — a plan without recorded
    checksums (older, or synthetic) gets structure-only verification."""
    recorded = dict(getattr(store.plan, "checksums", None) or {})

    def check(role: str, entries: list) -> Optional[IntegrityError]:
        h = hashlib.sha256() if role in recorded else None
        try:
            for e in entries:
                _check_and_digest(h, e)
        except IntegrityError as err:
            return err
        if h is not None and h.hexdigest() != recorded[role]:
            return IntegrityError(role, "checksum_mismatch",
                                  detail="payload bytes differ from the "
                                         "digest recorded at compress time")
        return None
    return _per_role(store, check)


def verify(store) -> dict[str, str]:
    """Verify every role; raise the first :class:`IntegrityError`.

    Returns ``{role: "ok"}`` on success."""
    out: dict[str, str] = {}
    for role, err in role_errors(store):
        if err is not None:
            raise err
        out[role] = "ok"
    return out


def verify_report(store) -> dict[str, str]:
    """Non-raising verify: ``{role: "ok" | reason}`` for every role."""
    return {role: "ok" if err is None else err.reason
            for role, err in role_errors(store)}
