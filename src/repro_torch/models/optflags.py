"""Beyond-baseline optimization flags: a copy of the reference's
``repro.models.optflags`` (the same eight names, thread-local, off by
default; an unknown flag raises ``ValueError``).

Each flag is one of three things in the port, so that a flag either
computes what the reference computes on one device or raises:

  gqagroup   — implemented: decode attention per KV-head group over the
               cache in its stored layout
               (:func:`repro_torch.models.attention.decode_attention_gqa`),
               with no ``_repeat_kv`` copy of either cache.
  maskedkv   — implemented by the port's default: the reference's one-hot
               masked blend writes the new K / V at the cache position and
               keeps every other slot, which is what the port's in-place
               ``index_put_`` writes with or without the flag.
  padheads   — inert where it changes no head count (a multiple of
               ``TP_DEGREE``, as chatglm3-6b's 32 heads); raises
               ``NotImplementedError`` where it would pad one
               (:func:`check_served`), as on the reduced config's 4.
  saveremat  — implemented in training: the remat of ``Model.loss``
               keeps the residual stream at each block's attention and FFN
               outputs (the reference's ``ar_out``) and recomputes the rest
               (:func:`repro_torch.models.transformer._run_body`); it
               changes no value, and serving (no grad) never reads it.
  replkv,    — inert: they act on a TP mesh, which the port does not have;
  seqpar       on one device the reference's are inert too.
  sparseffn, — raise ``NotImplementedError`` from the model entry points
  bf16params   while active (:func:`check_served`): they change what the
               reference serves on one device (the bitmap-stored FFN
               params, bf16 params), which the port does not have yet.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()

ALL_FLAGS = ("padheads", "replkv", "saveremat", "maskedkv", "sparseffn",
             "seqpar", "gqagroup", "bf16params")

#: production model-axis size: ``padheads`` rounds head counts up to it
TP_DEGREE = 16

#: flags whose serving the port lacks
UNSERVED = ("sparseffn", "bf16params")


def active() -> frozenset:
    return getattr(_state, "flags", frozenset())


def enabled(flag: str) -> bool:
    return flag in active()


@contextlib.contextmanager
def optimizations(flags):
    flags = frozenset(flags)
    unknown = flags - set(ALL_FLAGS)
    if unknown:
        raise ValueError(f"unknown optimization flags: {sorted(unknown)}")
    prev = active()
    _state.flags = flags
    try:
        yield
    finally:
        _state.flags = prev


def check_served(n_heads: int) -> None:
    """Raise ``NotImplementedError`` if an active flag would change what a
    model of ``n_heads`` attention heads serves in a way the port does not
    compute: ``sparseffn``, ``bf16params``, or ``padheads`` where it pads
    the head count."""
    on = sorted(set(UNSERVED) & active())
    if on:
        raise NotImplementedError(f"optimization flags {on} are not ported")
    if enabled("padheads") and n_heads % TP_DEGREE:
        raise NotImplementedError(
            f"padheads would pad {n_heads} heads to a multiple of "
            f"{TP_DEGREE}; the port serves unpadded heads only")
