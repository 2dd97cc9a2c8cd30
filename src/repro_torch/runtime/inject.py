"""Deterministic fault injection for the compressed serving plane: the
reference's ``repro.runtime.inject`` on torch payloads.

Every detection and recovery path in :mod:`repro_torch.runtime.integrity`
/ :mod:`repro_torch.runtime.guard` is exercised by tests through this
harness, not hoped for.  All corruption is seeded
(``np.random.default_rng(seed)``: the same element and the same bit as the
reference's injector, so the same payload comes out with the same bytes)
and PURE: store-level injectors return a NEW store sharing the original
plan (whose recorded checksums are deliberately left stale — that is what
verification catches) and every untouched entry; the corrupted tensor is a
copy on the payload's own device.  Context managers restore state on exit.

Fault classes:

  * :func:`bitflip_payload`      — flip one payload bit (checksum catch);
  * :func:`poison_payload_nan`   — NaN one payload value (checksum catch,
    or — with verification off — the guarded decode's non-finite logit
    guard and dense retry);
  * :func:`corrupt_structure`    — break a structural invariant (truncated
    offsets, inflated counts, out-of-range row/N:M indices), caught with
    no reference digest at all;
  * :func:`poison_activations`   — NaN/Inf a projection's output on the
    COMPRESSED path only (the dense fallback stays clean, so recovery is
    observable);
  * :func:`kernel_failure`       — raise from the sparse-kernel fault hook
    (:func:`repro_torch.kernels.ops.kernel_fault_hook`), which surfaces as
    a :class:`~repro_torch.kernels.ops.KernelFault` where a launch failure
    would; the dispatchers' ``kernel_guard`` demotes it per role.

The reference's ``bitflip_stacked`` has no counterpart: the port has no
layer-stacked store.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def _payload(entry) -> tuple[torch.Tensor, torch.Tensor]:
    """A copy of ``entry``'s payload tensor and the view of its
    consequential part (real blocks only) in that copy."""
    if entry.kind == "bitmap":
        nnzb = int(entry.data.counts.sum())
        if nnzb == 0:
            raise ValueError(f"role {entry.role!r} layer {entry.layer} has "
                             "an empty payload; nothing to corrupt")
        blocks = entry.data.blocks.clone()
        return blocks, blocks[:nnzb]
    payload = (entry.data.values if entry.kind == "nm"
               else entry.data).clone()
    return payload, payload


def _with_payload(entry, payload: torch.Tensor):
    """``entry`` with its payload tensor replaced."""
    if entry.kind == "bitmap":
        data = dataclasses.replace(entry.data, blocks=payload)
    elif entry.kind == "nm":
        data = dataclasses.replace(entry.data, values=payload)
    else:
        data = payload
    return dataclasses.replace(entry, data=data)


def _replace_entry(store, key, entry):
    entries = dict(store.entries)
    entries[key] = entry
    return type(store)(store.plan, entries)


def _flip_bit(real: torch.Tensor, rng: np.random.Generator) -> None:
    """Flip one seeded bit of ``real`` (contiguous) in place."""
    as_bytes = real.reshape(-1).view(torch.uint8)
    bit = int(rng.integers(0, as_bytes.numel() * 8))
    as_bytes[bit // 8] ^= 1 << (bit % 8)


def bitflip_payload(store, role: str, layer: int = 0, expert: int = -1,
                    seed: int = 0):
    """A new store with ONE seeded bit flipped in (layer, role)'s payload.

    The plan's recorded checksums are untouched, so ``store.verify()``
    reports ``checksum_mismatch`` for the role."""
    key = (layer, role, expert)
    entry = store.entries[key]
    payload, real = _payload(entry)
    _flip_bit(real, np.random.default_rng(seed))
    return _replace_entry(store, key, _with_payload(entry, payload))


def poison_payload_nan(store, role: str, layer: int = 0, expert: int = -1,
                       seed: int = 0):
    """A new store with one seeded payload value of (layer, role) → NaN.

    Undetectable structurally; with verification skipped, the NaN reaches
    the logits and the guarded decode's non-finite guard must recover."""
    key = (layer, role, expert)
    entry = store.entries[key]
    payload, real = _payload(entry)
    if not real.is_floating_point():
        raise ValueError(f"role {role!r} payload is {real.dtype}, "
                         "cannot hold NaN")
    flat = real.reshape(-1)
    flat[int(np.random.default_rng(seed).integers(0, flat.numel()))] = \
        float("nan")
    return _replace_entry(store, key, _with_payload(entry, payload))


#: corruption mode → the integrity reason it must be detected as
STRUCTURAL_MODES = {
    "truncate_offsets": "offsets_not_cumsum",
    "inflate_counts": "count_exceeds_blocks",
    "row_ids_oob": "row_id_out_of_range",
    "nm_indices_oob": "nm_index_out_of_range",
}


def corrupt_structure(store, role: str, mode: str, layer: int = 0,
                      expert: int = -1):
    """A new store with (layer, role)'s METADATA structurally broken.

    These violations are caught by the invariant checks alone — strip the
    plan's checksums in tests to prove it.  Modes: see
    :data:`STRUCTURAL_MODES` (keys are modes, values the expected
    ``IntegrityError.reason``)."""
    key = (layer, role, expert)
    entry = store.entries[key]
    d = entry.data
    if mode == "truncate_offsets":
        # a truncated/shifted offset table misaligns against the counts;
        # off-by-one the tail so the break is consequential for ANY counts
        # (zeroing the tail is a no-op when the leading counts are zero)
        offsets = d.offsets.clone()
        offsets[-1] += 1
        data = dataclasses.replace(d, offsets=offsets)
    elif mode == "inflate_counts":
        counts = d.counts.clone()
        counts[0] = d.n // d.bn + 1            # more blocks than grid rows
        data = dataclasses.replace(d, counts=counts)
    elif mode == "row_ids_oob":
        row_ids = d.row_ids.clone()
        row_ids[0] = d.n // d.bn               # one past the grid
        data = dataclasses.replace(d, row_ids=row_ids)
    elif mode == "nm_indices_oob":
        indices = d.indices.clone()
        indices.view(-1)[0] = d.m_group        # one past the group
        data = dataclasses.replace(d, indices=indices)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}: "
                         f"{sorted(STRUCTURAL_MODES)}")
    return _replace_entry(store, key, dataclasses.replace(entry, data=data))


@contextlib.contextmanager
def poison_activations(role: str, mode: str = "nan"):
    """Poison one projection role's OUTPUT with NaN/Inf — compressed path
    only.

    Rebinds :func:`repro_torch.models.layers.proj` so the poison applies
    only while a dispatch hook is installed (i.e. inside a
    ``CompressedModel`` forward); the dense model — and therefore the
    guarded serving path's dense retry — computes clean values, making
    recovery testable.  A CUDA graph replays no Python, so while the
    rebinding stands every compiled step serves eagerly
    (:func:`repro_torch.exec.dispatch.serves_eagerly`)."""
    bad = {"nan": float("nan"), "inf": float("inf")}[mode]
    orig = L.proj

    def poisoned(x, w, r):
        y = orig(x, w, r)
        if r == role and L._PROJ_HOOK is not None:
            y = y.clone()
            y[..., 0] = bad
        return y

    L.proj = poisoned
    try:
        yield
    finally:
        L.proj = orig


@contextlib.contextmanager
def kernel_failure(kinds=("bitmap", "nm"), message: str = "injected kernel "
                   "failure"):
    """Make every sparse-kernel dispatch of the given kinds raise.

    Surfaces where a real launch failure would (the kernel wrapper call,
    as a :class:`~repro_torch.kernels.ops.KernelFault` chained to the
    hook's error); with :func:`repro_torch.exec.dispatch.kernel_guard`
    active the failure demotes the affected roles to dense instead of
    killing the forward."""

    def hook(kind: str) -> None:
        if kind in kinds:
            raise RuntimeError(f"{message}: {kind}")

    with kops.kernel_fault_hook(hook):
        yield
