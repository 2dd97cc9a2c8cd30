"""Batched serving loop: one-pass prefill + KV-cache greedy decode, for
the dense :class:`~repro_torch.models.transformer.Model` and the
execution plane's :class:`~repro_torch.exec.dispatch.CompressedModel`
(same surface), with per-phase tokens/s reporting.  On the card each
decode step after a key's first replays a CUDA graph
(:mod:`repro_torch.launch.compiled`, the counterpart of the reference's
``jax.jit`` of the step); ``compiled.disable()`` serves it eagerly.

Equal-length prompts only: left-padded ragged prompts need the
continuous-batching mixer's slot writes, which are not ported yet.

Usage (on the card; ``--device cpu`` runs the plain PyTorch versions)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
      [--reduced] --batch 4 --prompt-len 128 --gen 16 [--compressed] \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.exec.compress import compress_params, prune_params
from repro_torch.exec.dispatch import CompressedModel
from repro_torch.exec.plans import ExecPlan, shipped_plan
from repro_torch.launch.compiled import CompiledStep
from repro_torch.models.transformer import Model


def _rate(n: float, t: float) -> float:
    """tokens / seconds with a floor on the denominator (a tiny run can
    time ~0 s)."""
    return n / max(t, 1e-9)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generate(model, params, prompts: torch.Tensor, gen: int, max_len: int,
              eos_id: Optional[int] = None, pad_id: int = -1):
    b, plen = prompts.shape
    if plen > max_len or plen + gen > max_len:
        raise ValueError(f"prompt ({plen}) + gen ({gen}) exceeds "
                         f"max_len ({max_len})")
    dev = prompts.device

    t0 = time.perf_counter()
    all_logits, cache = model.prefill(params, prompts, max_len)
    logits = all_logits[:, -1]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []                      # int32 tokens, as the reference returns
    tok = logits.argmax(dim=-1)   # int64: the next step's embedding index
    done = torch.zeros(b, dtype=torch.bool, device=dev)  # rows past EOS
    step = CompiledStep(model)
    pos = torch.empty((), dtype=torch.long, device=dev)
    t1 = time.perf_counter()
    for t in range(plen, plen + gen):
        if eos_id is None:
            out.append(tok.int())
        else:
            # a row's EOS token is emitted, later positions hold pad_id, and
            # once every row is done the remaining steps are skipped
            out.append(torch.where(done, pad_id, tok).int())
            done |= tok == eos_id
            if bool(done.all()):
                break
        pos.fill_(t)              # on the device: no host-to-device copy
        logits, cache = step(params, cache, tok, pos)
        tok = logits.argmax(dim=-1)
    _sync(dev)
    t_gen = time.perf_counter() - t1
    if len(out) < gen:
        out.extend([torch.full((b,), pad_id, dtype=torch.int32,
                               device=dev)] * (gen - len(out)))
    return torch.stack(out, dim=1), t_prefill, t_gen


def generate(model, params, prompts, gen: int, max_len: int, *,
             eos_id: Optional[int] = None, pad_id: int = -1,
             prompt_pad_id: Optional[int] = None, device="cuda"):
    """Greedy decode for a batch of equal-length prompts on ``device``.

    ``model`` is anything with the serving surface (``prefill`` /
    ``decode_step``): the dense Model or a CompressedModel.  Returns
    (tokens (B, gen) int32, t_prefill_s, t_gen_s).  ``eos_id`` ends rows
    early: the EOS token is emitted, later positions hold ``pad_id``, and
    decode stops once every row is done."""
    if prompt_pad_id is not None:
        raise NotImplementedError(
            "ragged (left-padded) prompts need the continuous-batching "
            "mixer's slot writes, which the port does not have yet")
    dev = resolve(device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    return _generate(model, params, prompts, gen, max_len, eos_id=eos_id,
                     pad_id=pad_id)


def compressed_model(cfg, params, plan: Optional[ExecPlan] = None,
                     device="cuda"):
    """Plan → prune → compress → :class:`CompressedModel` in one call.

    ``plan`` defaults to the bitmap plan shipped for ``cfg``.  ``params``
    must already lie on ``device``.  Returns (compressed_model,
    pruned_params) — serve with the PRUNED tree."""
    dev = resolve(device)
    if params["embed"].device != dev:
        raise ValueError(f"params lie on {params['embed'].device}, "
                         f"not on {dev}")
    if plan is None:
        plan = shipped_plan(cfg, "bitmap")
    pruned = prune_params(params, plan, cfg)
    store = compress_params(pruned, plan, cfg)
    return CompressedModel(Model(cfg), store), pruned


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--compressed", action="store_true",
                    help="serve the shipped bitmap plan's compressed store")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg)
    params = model.init(seed=0, device=dev)
    label = f"{cfg.name} (d_model={cfg.d_model}, layers={cfg.n_layers})"
    if args.compressed:
        model, params = compressed_model(cfg, params, device=dev)
        label += f" [compressed: ratio={model.store.achieved_ratio():.3f}]"
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    toks, t_prefill, t_gen = generate(
        model, params, prompts, args.gen, args.prompt_len + args.gen,
        device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n_pref = args.batch * args.prompt_len
    n_gen = args.batch * args.gen
    print(f"[serve] {label}: batch={args.batch} on {where}")
    print(f"  prefill {n_pref} tok in {t_prefill:.3f}s "
          f"({_rate(n_pref, t_prefill):.1f} tok/s)")
    print(f"  decode  {n_gen} tok in {t_gen:.3f}s "
          f"({_rate(n_gen, t_gen):.1f} tok/s)")
    print(f"  sample out: {toks[0, :8].tolist()}")


if __name__ == "__main__":
    main()
