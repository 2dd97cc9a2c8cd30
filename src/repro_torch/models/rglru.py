"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427): the port of
the reference's ``repro.models.rglru``.

The recurrence  h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)  with
a_t = exp(−c · softplus(Λ) · r_t).  The reference scans it with
``jax.lax.associative_scan``; the port runs a sequential loop over time in
fp32, so the two agree to fp32 rounding, not bit for bit.

The full recurrent block is: x → {linear branch (GeLU), recurrent branch
(causal conv1d → RG-LRU)} → elementwise product → out-projection.  Every
op keeps the reference's dtype and rounding points (compute-dtype matmuls
and conv adds, fp32 gates and recurrence, ``h`` rounded to the compute
dtype between decode steps).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_C = 8.0  # RG-LRU gate sharpness constant (paper value)
CONV_K = 4


def rglru_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """The reference's leaves under leading (layer) dims ``lead``."""
    d = cfg.d_model
    dr = d  # recurrence width
    lead = tuple(lead)
    return {
        "w_x": L.init_scaled(gen, lead, (d, dr)),
        "w_y": L.init_scaled(gen, lead, (d, dr)),
        "w_out": L.init_scaled(gen, lead, (dr, d)),
        "conv": L.init_scaled(gen, lead, (CONV_K, dr)),
        "w_a": L.init_scaled(gen, lead, (dr, dr)),
        "w_i": L.init_scaled(gen, lead, (dr, dr)),
        "lam": torch.full(lead + (dr,), 3.0, dtype=L.PARAM_DTYPE,
                          device=gen.device),
    }


def _gates(x: torch.Tensor, p: dict):
    """(a, beta) in fp32 and the input gate i in the compute dtype."""
    r = L.sigmoid(L.dense(x, p["w_a"]))
    i = L.sigmoid(L.dense(x, p["w_i"]))
    log_a = -_C * L.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    # maximum, not clamp: at a tie with the floor it splits the gradient
    # as jnp.maximum does (clamp passes it whole); a 0-d fill, which a CUDA
    # graph captures (a host scalar tensor would be a host copy)
    one_minus = 1.0 - torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.maximum(one_minus, one_minus.new_full((), 1e-6)))
    return a, beta, i


def rglru_scan(x: torch.Tensor, a: torch.Tensor, beta: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + beta_t x_t, sequentially in fp32.  x / a /
    beta: (B, S, D); h0: (B, D).  Returns (h (B, S, D) in x's dtype,
    h_final fp32)."""
    bx = beta.float() * x.float()
    a = a.float()
    h = h0.float()
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    hh = torch.stack(hs, dim=1)
    return hh.to(x.dtype), hh[:, -1]


def rglru_block(x: torch.Tensor, p: dict, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrent block over a sequence.  x: (B, S, d).  Returns (y,
    h_final, conv_tail): the last two are what a decode cache would hold."""
    xr = L.dense(x, p["w_x"])
    gate = L.gelu(L.dense(x, p["w_y"]))
    conv = L.causal_conv(xr, p["conv"].to(L.COMPUTE_DTYPE))
    a, beta, i_gate = _gates(conv, p)
    h, h_last = rglru_scan(conv * i_gate, a, beta,
                           conv.new_zeros((conv.shape[0], conv.shape[2])))
    y = L.dense(h * gate, p["w_out"])
    conv_tail = xr[:, -(p["conv"].shape[0] - 1):, :]
    return y, h_last, conv_tail


def rglru_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 h: torch.Tensor, conv_state: torch.Tensor) -> torch.Tensor:
    """Single-token step.  x: (B, d); h: (B, dr); conv_state (B, K-1, dr).
    ``h`` and ``conv_state`` are advanced IN PLACE (the reference returns
    new ones); returns the block output (B, d)."""
    xr = L.dense(x, p["w_x"])
    gate = L.gelu(L.dense(x, p["w_y"]))
    conv = L.conv_step(conv_state, xr, p["conv"].to(L.COMPUTE_DTYPE))
    a, beta, i_gate = _gates(conv, p)
    h_new = (a * h.float() + beta * (conv * i_gate).float()).to(x.dtype)
    h.copy_(h_new)
    return L.dense(h_new * gate, p["w_out"])
