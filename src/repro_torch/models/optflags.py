"""Beyond-baseline optimization flags: a copy of the reference's
``repro.models.optflags`` (the same eight names, thread-local, off by
default; an unknown flag raises ``ValueError``).

Under each flag the port computes what the reference computes on one
device, and raises where the reference raises:

  gqagroup   — decode attention per KV-head group over the cache in its
               stored layout
               (:func:`repro_torch.models.attention.decode_attention_gqa`),
               with no ``_repeat_kv`` copy of either cache.
  maskedkv   — the port's default: the reference's one-hot masked blend
               writes the new K / V at the cache position and keeps every
               other slot, which is what the port's in-place
               ``index_put_`` writes with or without the flag.
  padheads   — the query head count is padded up to a multiple of
               ``TP_DEGREE`` (:func:`repro_torch.models.layers.eff_heads`;
               56 to 64, the reduced configs' 4 to 16): ``wq`` / ``wo`` are
               drawn at the padded width, with real random weights in the
               padded heads, and every attention path reads that width.
               The compressed plane prunes, compresses and serves the
               padded weights through the kernels, as the reference does.
               Where the reference's shapes do not meet (the
               encoder-decoder's cross-attention decode reshapes with the
               unpadded count; a padded count that is no multiple of the KV
               heads) the port raises ``ValueError`` too.
  saveremat  — training: the remat of ``Model.loss`` keeps the residual
               stream at each block's attention and FFN outputs (the
               reference's ``ar_out``) and recomputes the rest
               (:func:`repro_torch.models.transformer._run_body`); it
               changes no value, and serving (no grad) never reads it.
  sparseffn  — ``Model.init`` gives every ``sparse_ffn`` config without
               ``moe`` block-stored FFN params
               (:func:`repro_torch.models.layers.sparse_mlp_params`), which
               ``decode_step`` multiplies by gather and einsum
               (:func:`repro_torch.models.layers.sparse_mlp_decode`).  The
               full-sequence paths (``prefill``, ``hidden_states``,
               ``loss``, and so ``generate``'s prefill) meet no ``w_gate``
               there and raise ``KeyError``, as the reference's do.
  replkv     — read by :func:`repro_torch.models.partition.param_specs`
               only: K / V projections whose head count does not divide
               the model axis get replicated specs.
  seqpar     — acts on a sharded residual stream, which one device does
               not have; inert, as the reference's is on one device.
  bf16params — read by the reference's dry run only, which casts every
               floating param to bf16 before tracing its decode cell
               (:func:`repro_torch.convert.bf16_params` is that cast);
               inert at the model entry points and in the compressed
               plane.
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()

ALL_FLAGS = ("padheads", "replkv", "saveremat", "maskedkv", "sparseffn",
             "seqpar", "gqagroup", "bf16params")


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

