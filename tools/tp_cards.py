#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 17 MoE part alone, on a host of two or more
cards, where its (1, 2) meshes run both repeating ``cuda:0`` and over
``cuda:0`` and ``cuda:1``.

    python3 tools/tp_cards.py

Builds the kernels (phase 2), then runs :func:`chip_smoke._tp_moe`
(granite-moe-3b-a800m at full width cut to ``TP_MOE_LAYERS`` layers, both
plans) with every check of the smoke run; a failed check ends it with a
non-zero exit code.  It prints the card's name and power limit and, last,
the part's launches by kernel.  Without two cards it exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if torch.cuda.device_count() < 2:
        cs._fail(f"{torch.cuda.device_count()} cards: this run needs two")
    card = cs.phase_environment()
    cs.phase_build()
    acc = {name: cs._Acc() for name in ("bitmap_spmm", "bitmap_spmm_naive",
                                         "nm_spmm", "nm_spmm_naive")}
    launches = cs._tp_moe(card, torch.device("cuda", 0), acc)
    print(json.dumps({"launches": launches,
                      "max_abs_err": {k: a.max_abs_err
                                      for k, a in acc.items()}}))


if __name__ == "__main__":
    main()
