"""AdamW with a cosine schedule, global-norm clipping and optional int8
gradient compression with error feedback: the port of the reference's
``repro.optim.adamw``, on the same pytrees (nested dicts of tensors).

The arithmetic and its rounding points are the reference's: fp32 moments,
the bias corrections ``1 - b ** step`` in fp32, weight decay on every leaf
(norms included), ``round`` half to even.  :func:`apply` is functional:
it returns new params and a new state and writes into neither, so a step
that fails part way (or is retried, or restored from a checkpoint) starts
again from the state as it was.  Every elementwise pass walks a leaf in
slices of ``SLICE`` elements, so the temporaries of one pass take a slice,
not a leaf: the largest leaves of a full-width model are gigabytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree

PyTree = Any

#: elements of a leaf one elementwise pass takes at a time
SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_compress: bool = False      # int8 + error feedback


class OptState(NamedTuple):
    step: torch.Tensor               # 0-d int32
    mu: PyTree
    nu: PyTree
    err: Optional[PyTree]            # error-feedback residual (compression)


def init(params: PyTree, cfg: AdamWConfig) -> OptState:
    """Zero moments (and residuals under ``grad_compress``) like
    ``params``, on their device."""
    def zeros(t):
        return torch.zeros_like(t)
    first = tree.leaves(params)[0]
    return OptState(torch.zeros((), dtype=torch.int32, device=first.device),
                    tree.map_leaves(zeros, params),
                    tree.map_leaves(zeros, params),
                    tree.map_leaves(zeros, params) if cfg.grad_compress
                    else None)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, as the reference divides: on CUDA PyTorch
    multiplies by the reciprocal of a Python scalar divisor, one rounding
    more (a quantization scale an ulp off rounds some ``g / scale`` near a
    half the other way)."""
    return x / x.new_full((), c, dtype=torch.float32)


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``lr`` then cosine decay to ``lr ·
    min_lr_frac``, in fp32 as the reference's."""
    step = torch.as_tensor(step)
    warm = torch.clamp(_div(step, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(_div(step - cfg.warmup_steps,
                            max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _slices(n: int):
    return [slice(a, min(a + SLICE, n)) for a in range(0, n, SLICE)]


def _whole(g: torch.Tensor):
    """A leaf as a function of a slice of its flat elements."""
    flat = g.reshape(-1)
    return lambda sl: flat[sl]


def _norm(leaves: list, parts: list) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` over each leaf's ``part``: fp32 squares and
    root, as the reference's, the sums in fp64.  An fp32 sum's order is
    the library's (XLA's and torch's differ), and the step's squared clip
    scale doubles its error in the second moment."""
    total = 0
    for g, part in zip(leaves, parts):
        for sl in _slices(g.numel()):
            total = total + torch.sum(torch.square(part(sl).float()),
                                      dtype=torch.float64)
    return torch.sqrt(torch.as_tensor(total).float())


def _global_norm(grads: PyTree) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` (:func:`_norm`)."""
    gs = tree.leaves(grads)
    return _norm(gs, [_whole(g) for g in gs])


def _int8(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``q = clip(round(g / s), ±127)`` with
    ``s = max(max|g|, 1e-8) / 127`` (``torch.round`` rounds half to even,
    as ``jnp.round``)."""
    scale = _div(torch.clamp(torch.max(torch.abs(g)), min=1e-8), 127.0)
    return _int8(g, scale), scale


def _compress_leaf(g: torch.Tensor, e: torch.Tensor):
    """``Q(g + e)`` of one leaf, kept as its int8 values and scale, and the
    new residual ``g + e - Q(g + e)`` (fp32).  Returns (a function giving
    ``q · scale`` in ``g``'s dtype for a slice of the flat elements, the
    residual)."""
    gf, ef = g.reshape(-1), e.reshape(-1)
    slices = _slices(gf.numel())

    def t_at(sl):
        return gf[sl].float() + ef[sl]
    amax = torch.zeros((), dtype=torch.float32, device=g.device)
    for sl in slices:
        amax = torch.maximum(amax, torch.max(torch.abs(t_at(sl))))
    scale = _div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.empty(gf.shape, dtype=torch.int8, device=g.device)
    new_err = torch.empty(gf.shape, dtype=torch.float32, device=g.device)
    for sl in slices:
        t = t_at(sl)
        q[sl] = _int8(t, scale)
        new_err[sl] = t - q[sl].float() * scale

    def deq(sl):
        return (q[sl].float() * scale).to(g.dtype)
    return deq, new_err.reshape(e.shape)


def compress_grads(grads: PyTree, err: PyTree) -> tuple[PyTree, PyTree]:
    """int8 quantization with error feedback: g' = Q(g + e); e' = g + e -
    g'.  Under pjit the reference all-reduces the quantized values; here
    (one device) the round trip is what the optimizer sees.  Returns (g',
    e')."""
    gs = tree.leaves(grads)
    out = [_compress_leaf(g, e) for g, e in zip(gs, tree.leaves(err))]
    deq = [d(slice(None)).reshape(g.shape) for (d, _), g in zip(out, gs)]
    return tree.unflatten(grads, deq), \
        tree.unflatten(err, [e for _, e in out])


def apply(params: PyTree, grads: PyTree, state: OptState, cfg: AdamWConfig
          ) -> tuple[PyTree, OptState]:
    """One AdamW step: new params and a new :class:`OptState`; neither
    ``params`` nor ``state`` is written."""
    gs = tree.leaves(grads)
    if cfg.grad_compress and state.err is not None:
        out = [_compress_leaf(g, e)
               for g, e in zip(gs, tree.leaves(state.err))]
        parts = [d for d, _ in out]
        new_err = tree.unflatten(state.err, [e for _, e in out])
    else:
        parts = [_whole(g) for g in gs]
        new_err = state.err

    gnorm = _norm(gs, parts)
    scale = torch.clamp(gnorm.new_full((), cfg.clip_norm)
                        / torch.clamp(gnorm, min=1e-8), max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    new_p, new_m, new_v = [], [], []
    for p, part, m, v in zip(tree.leaves(params), parts,
                             tree.leaves(state.mu), tree.leaves(state.nu)):
        pf, mf, vf = p.reshape(-1), m.reshape(-1), v.reshape(-1)
        op, om, ov = (torch.empty_like(pf), torch.empty_like(mf),
                      torch.empty_like(vf))
        for sl in _slices(pf.numel()):
            g = part(sl).float() * scale
            m1 = b1 * mf[sl] + (1 - b1) * g
            v1 = b2 * vf[sl] + (1 - b2) * torch.square(g)
            mhat = m1 / bc1
            vhat = v1 / bc2
            op[sl] = (pf[sl].float() - lr * (
                mhat / (torch.sqrt(vhat) + cfg.eps)
                + cfg.weight_decay * pf[sl])).to(p.dtype)
            om[sl], ov[sl] = m1, v1
        new_p.append(op.reshape(p.shape))
        new_m.append(om.reshape(m.shape))
        new_v.append(ov.reshape(v.shape))
    return tree.unflatten(params, new_p), OptState(
        step, tree.unflatten(state.mu, new_m),
        tree.unflatten(state.nu, new_v), new_err)
