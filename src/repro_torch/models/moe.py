"""Mixture-of-Experts: token-choice top-k routing with GShard-style
capacity dispatch, as the reference's ``repro.models.moe``.

Dispatch is a (tokens, experts, capacity) one-hot contracted against the
tokens, so there is no data-dependent scatter: the step reads nothing back
to the host and a decode step captures into a CUDA graph like the dense
one.  Tokens route in groups of ``router_group``; each expert takes at most
``_capacity`` tokens a group, in slot-major order, and the rest are
dropped.  The expert matmuls are dense, as in the reference: an expert's
plan entry is compressed and accounted for, never dispatched to a kernel.

Under expert parallelism (:mod:`repro_torch.launch.tensor_parallel`) a
shard holds the expert stacks of a contiguous range of experts and passes
it as ``experts=(lo, hi)``: it routes over all ``n_experts`` as one device
does (the same gates, slots and drops) and returns the part of ``y`` its
experts give, which the shards' all-reduce sums.

Where the reference relies on JAX's semantics the port spells them out:
``jax.lax.top_k`` puts the lower index first among equal gates (a stable
descending sort here; ``torch.topk`` promises no order among ties, and the
router's bf16 logits tie often), and the one-hots compare against an
``arange`` (``torch.nn.functional.one_hot`` checks its input on the host).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def moe_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """Router ``(d, E)`` and expert weights ``(E, d, f)`` / ``(E, f, d)``
    with optional leading (layer) dims, on ``gen.device``."""
    m = cfg.moe
    assert m is not None
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    lead = tuple(lead)
    return {
        "router": L._init(gen, lead + (d, e), d),
        "w_gate": L._init(gen, lead + (e, d, f), d),
        "w_up": L._init(gen, lead + (e, d, f), d),
        "w_down": L._init(gen, lead + (e, f, d), f),
    }


def _capacity(group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(group * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(4, min(c, group))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(xg: torch.Tensor, p: dict, cfg: ModelConfig) -> tuple:
    """The router on token groups ``xg`` (g, t, d): the fp32 gates (g, t,
    E), and the top-k weights, renormalised, and experts (g, t, k)."""
    k = cfg.moe.top_k
    logits = torch.matmul(xg, p["router"].to(L.COMPUTE_DTYPE)).float()
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    gates = ex / ex.sum(dim=-1, keepdim=True)
    # the lower index first among equal gates, as jax.lax.top_k
    topw, tope = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, tope = topw[..., :k], tope[..., :k]
    topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, topw, tope


def _expert_range(p: dict, cfg: ModelConfig, experts) -> tuple[int, int]:
    """``experts`` as (lo, hi), all of them by default; its width must be
    the expert stacks' (``p["w_gate"].shape[-3]``)."""
    lo, hi = (0, cfg.moe.n_experts) if experts is None else experts
    held = p["w_gate"].shape[-3]
    if not 0 <= lo < hi <= cfg.moe.n_experts or hi - lo != held:
        raise ValueError(f"moe: experts [{lo}, {hi}) of "
                         f"{cfg.moe.n_experts} over expert stacks of {held}")
    return lo, hi


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              experts: tuple[int, int] | None = None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).  Top-k routing with capacity dropping.
    With ``experts=(lo, hi)``, ``p``'s expert stacks are experts
    ``[lo, hi)`` and the result is their part of the sum over experts."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    lo, hi = _expert_range(p, cfg, experts)
    grp = min(m.router_group, s)
    if (b * s) % grp:
        # the reference's reshape into whole routing groups fails here
        raise TypeError(
            f"moe_block: {b} x {s} tokens do not fill whole routing groups "
            f"of {grp} (router_group={m.router_group})")
    ng = (b * s) // grp
    xg = x.reshape(ng, grp, d)
    cap = _capacity(grp, cfg)
    cd = L.COMPUTE_DTYPE

    _, topw, tope = _route(xg, p, cfg)                       # (g, t, k)

    # position of each (token, slot) in its expert's buffer, via a cumsum
    # over the flattened (slot-major) one-hot; tokens beyond capacity are
    # dropped
    onehot = _one_hot(tope, e, torch.float32)                # (g, t, k, E)
    slot_major = onehot.transpose(1, 2).reshape(ng, k * grp, e)
    pos = torch.cumsum(slot_major, dim=1) - slot_major       # (g, k·t, E)
    pos = pos.reshape(ng, k, grp, e).transpose(1, 2)         # (g, t, k, E)
    pos = (pos * onehot).sum(dim=-1)                         # (g, t, k)
    keep = (pos < cap) & (topw > 0.0)
    pos = torch.where(keep, pos, torch.zeros_like(pos)).long()

    cap_oh = _one_hot(pos, cap, cd)                          # (g, t, k, C)
    oh = onehot.to(cd)
    # each (token, expert) pair takes at most one slot, so these sums over
    # the slots have one term: exact in any dtype
    disp = torch.einsum("gtke,gtkc->gtec", oh, cap_oh * keep[..., None].to(cd))
    comb = torch.einsum("gtke,gtkc->gtec", oh,
                        cap_oh * (topw * keep).to(cd)[..., None])
    if hi - lo != e:                                         # a shard's
        disp, comb, e = disp[:, :, lo:hi], comb[:, :, lo:hi], hi - lo

    xe = torch.einsum("gtd,gtec->gecd", xg, disp)            # (g, E, C, d)
    xe = xe.transpose(0, 1).reshape(e, ng * cap, d)          # (E, g·C, d)
    h = torch.bmm(xe, p["w_gate"].to(cd))
    u = torch.bmm(xe, p["w_up"].to(cd))
    h = L.silu(h) * u
    ye = torch.bmm(h, p["w_down"].to(cd))                    # (E, g·C, d)
    ye = ye.reshape(e, ng, cap, d).transpose(0, 1)           # (g, E, C, d)
    y = torch.einsum("gecd,gtec->gtd", ye, comb)
    return y.reshape(b, s, d)


def moe_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """Single-token MoE: x (B, d).  s = 1 makes each token its own routing
    group, so capacity dropping degenerates to pure top-k (no drops) and
    every expert runs its ``_capacity(1) = 4`` slots."""
    return moe_block(x[:, None, :], p, cfg, experts)[:, 0, :]
