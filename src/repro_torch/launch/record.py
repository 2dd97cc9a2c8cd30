"""Each request's logits in a mixer's stream, kept as the stream runs, so
that one stream can be held against another (the same requests on another
device, at another batch, or through the dense model).

Used by ``chip_smoke.py``'s mixer phase and the card tests.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch


def record_logits(mx, keep: Optional[Callable[[torch.Tensor], object]] = None
                  ) -> dict[str, list]:
    """Wrap ``mx`` (a :class:`~repro_torch.launch.mixer.Mixer`) so that its
    next stream keeps, by request uid, the admission's last prefill logits
    and then the request's row of every decode step it takes part in.
    ``keep`` maps a logits row (V,) to what is kept (default: a clone on
    its device).  The rows are taken from the step's returned logits,
    outside any graph; the dict fills as ``mx.run`` serves.  The wrappers
    hold the mixer weakly: a reference cycle would keep its model, params
    and graphs on the device until the garbage collector ran."""
    keep = keep or torch.Tensor.clone
    logits: dict[str, list] = {}
    admitting: list[str] = []
    mixer = weakref.ref(mx)
    admit, prefill, step = type(mx).admit, mx._prefill_fn, mx._step_fn

    def rec_admit(req):
        admitting.append(req.uid)
        return admit(mixer(), req)

    def rec_prefill(params, prompt):
        out, cache = prefill(params, prompt)
        logits[admitting[-1]] = [keep(out[0, -1])]
        return out, cache

    def rec_step(params, cache, toks, pos):
        out, cache = step(params, cache, toks, pos)
        m = mixer()
        for slot in m.active.nonzero()[0]:
            logits[m._req[slot].uid].append(keep(out[slot]))
        return out, cache

    mx.admit, mx._prefill_fn, mx._step_fn = rec_admit, rec_prefill, rec_step
    return logits
