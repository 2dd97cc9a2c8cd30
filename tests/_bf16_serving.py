"""The bf16 serving fixture: reduced chatglm3-6b served on the shipped
bitmap plan (``src/repro_torch/plans/chatglm3-6b.reduced.bitmap.json``),
greedy, at the default bf16 compute dtype.

The reference's run is kept as a small committed file,
``fixtures/chatglm3_6b_reduced_bitmap_bf16.json``, so that a machine without
JAX (the card's) can hold the port to it: the greedy tokens, the top logits
of every step (the prefill's last position, then each decode step) with
their vocabulary ids, and the bound of ``tests/test_torch_bf16.py``'s
compressed-prefill test: the reference's own jit-vs-eager spread on the
dense prefill logits, to which each step adds one bf16 ulp of its largest
top logit.  ``tests/test_torch_bf16_fixture.py`` regenerates the record
from the reference and requires the committed file to equal it.

The weights and prompts come from ``np.random.default_rng`` in the
reference's parameter layout, so both sides rebuild them without JAX: this
module imports numpy only, and the port's run imports torch inside
:func:`port_run`.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

SEED = 0
BATCH, PROMPT, GEN = 2, 8, 6
TOP = 8                                 # logits kept per step and row
FIXTURE = pathlib.Path(__file__).with_name("fixtures") / \
    "chatglm3_6b_reduced_bitmap_bf16.json"


def reference_params(cfg, seed: int = SEED) -> dict:
    """A dense-family parameter tree in the reference's layout (``embed``,
    ``final_norm``, ``blocks`` with a leading layer axis, weights (d_in,
    d_out)), fp32: weights normal / sqrt(fan_in) as ``Model.init`` scales
    them, norms zero."""
    rng = np.random.default_rng(seed)
    d, nl = cfg.d_model, cfg.n_layers
    q, kv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head

    def w(*shape):
        return (rng.standard_normal((nl, *shape)) / math.sqrt(shape[0])) \
            .astype(np.float32)

    zeros = np.zeros((nl, d), np.float32)
    return {
        "embed": (rng.standard_normal((cfg.vocab, d)) / math.sqrt(d))
        .astype(np.float32),
        "final_norm": np.zeros((d,), np.float32),
        "blocks": {
            "ln1": zeros.copy(), "ln2": zeros.copy(),
            "attn": {"wq": w(d, q), "wk": w(d, kv), "wv": w(d, kv),
                     "wo": w(q, d)},
            "ffn": {"w_gate": w(d, cfg.d_ff), "w_up": w(d, cfg.d_ff),
                    "w_down": w(cfg.d_ff, d)},
        },
    }


def prompts(cfg, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed + 1).integers(0, cfg.vocab,
                                                    (BATCH, PROMPT))


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def record(tokens: np.ndarray, step_logits: list, spread: float) -> dict:
    """The fixture's content from a run: tokens (B, GEN); one (B, V) logit
    array per step; the reference's dense jit-vs-eager spread."""
    steps = []
    for lg in step_logits:
        lg = np.asarray(lg, np.float32)
        ids = np.argsort(-lg, axis=-1, kind="stable")[:, :TOP]
        steps.append({"ids": ids.tolist(),
                      "logits": [[float(v) for v in row] for row in
                                 np.take_along_axis(lg, ids, -1)]})
    return {"batch": BATCH, "prompt": PROMPT, "gen": GEN, "seed": SEED,
            "tokens": np.asarray(tokens).tolist(), "spread": float(spread),
            "steps": steps}


def load() -> dict:
    return json.loads(FIXTURE.read_text())


def dump(rec: dict) -> str:
    return json.dumps(rec, indent=1) + "\n"


def misses(rec: dict, tokens: np.ndarray, step_logits: list) -> list[str]:
    """What a run gets wrong against the fixture: tokens that differ, and
    every step whose logits at the fixture's ids leave the bound (spread +
    one bf16 ulp of the step's largest |top logit|)."""
    out = []
    if np.asarray(tokens).tolist() != rec["tokens"]:
        out.append(f"tokens {np.asarray(tokens).tolist()} != "
                   f"{rec['tokens']}")
    for s, (st, lg) in enumerate(zip(rec["steps"], step_logits)):
        want = np.asarray(st["logits"], np.float32)
        got = np.take_along_axis(np.asarray(lg, np.float32),
                                 np.asarray(st["ids"]), -1)
        err = float(np.abs(got - want).max())
        tol = rec["spread"] + bf16_ulp(float(np.abs(want).max()))
        if not err <= tol:
            out.append(f"step {s}: max |logit - reference| {err} > {tol}")
    if len(step_logits) != len(rec["steps"]):
        out.append(f"{len(step_logits)} steps, not {len(rec['steps'])}")
    return out


def port_run(device: str) -> tuple[np.ndarray, list]:
    """The port's greedy run on ``device``: tokens (B, GEN) and one (B, V)
    fp32 logit array per step, with the reference's decode loop (a token
    from the prefill's last position, then one decode step per further
    token)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.exec.plans import shipped_plan
    from repro_torch.launch import serve

    cfg = get_config("chatglm3-6b").reduced()
    params = params_from_numpy(reference_params(cfg), device)
    cm, pruned = serve.compressed_model(cfg, params,
                                        shipped_plan(cfg, "bitmap"),
                                        device=device)
    toks = torch.as_tensor(prompts(cfg), device=params["embed"].device)
    with torch.no_grad():
        logits, cache = cm.prefill(pruned, toks, PROMPT + GEN)
        logits = logits[:, -1]
        steps, out = [], []
        for t in range(PROMPT, PROMPT + GEN):
            steps.append(logits.float().cpu().numpy())
            tok = logits.argmax(dim=-1)
            out.append(tok.cpu().numpy())
            if t < PROMPT + GEN - 1:
                logits, cache = cm.decode_step(pruned, cache, tok, t)
    return np.stack(out, axis=1), steps
