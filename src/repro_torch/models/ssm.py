"""Mamba-2 SSD (state-space duality) layer: the port of the reference's
``repro.models.ssm``.

The sequence is split into chunks; within a chunk the recurrence is
computed as masked matmuls, and chunk states are carried by a loop over
chunks.  Per-head scalar decay A, one B / C group shared across heads.
Decode is the O(1) recurrent step on the carried state (B, heads,
head_dim, d_state), held in the compute dtype as in the reference.

Every op keeps the reference's dtype and rounding points: compute-dtype
projections, conv adds and products, fp32 step sizes and decays, and its
three-operand einsums contracted pairwise in the order JAX picks for the
reduced configs (each intermediate rounded to the compute dtype).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def ssm_params(gen: torch.Generator, cfg: ModelConfig, lead=()) -> dict:
    """The reference's leaves under leading (layer) dims ``lead``
    (``A_log = log(1..nh)``, ``D = 1``, as in the reference)."""
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    d_in = d * s.expand
    nh = d_in // s.head_dim
    lead = tuple(lead)
    dev = gen.device

    def const(v):
        return v.to(dev).expand(lead + v.shape).clone()

    return {
        "w_in": L.init_scaled(gen, lead, (d, 2 * d_in + 2 * s.d_state + nh)),
        "w_out": L.init_scaled(gen, lead, (d_in, d)),
        "conv": L.init_scaled(gen, lead, (s.d_conv, d_in + 2 * s.d_state)),
        "A_log": const(torch.log(torch.arange(1, nh + 1,
                                              dtype=L.PARAM_DTYPE))),
        "D": const(torch.ones(nh, dtype=L.PARAM_DTYPE)),
        "dt_bias": const(torch.zeros(nh, dtype=L.PARAM_DTYPE)),
        "norm": const(torch.zeros(d_in, dtype=L.PARAM_DTYPE)),
    }


def _split_proj(xz: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nh = d_in // s.head_dim
    x, z, Bm, Cm, dt = torch.split(
        xz, [d_in, d_in, s.d_state, s.d_state, nh], dim=-1)
    return x, z, Bm, Cm, dt, nh, d_in


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    xh: (B, S, H, P) values; dt: (B, S, H) softplus'd step (fp32); A: (H,)
    decay rate (negative); Bm / Cm: (B, S, N) input / output projections.
    Returns y: (B, S, H, P) and the final state (B, H, P, N).  S must be a
    multiple of ``chunk`` (the reference reshapes without padding and
    fails otherwise)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    nc = s // chunk
    cdt = L.COMPUTE_DTYPE
    dev = xh.device
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    state = torch.zeros((b, h, p, n), dtype=cdt, device=dev)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xi, dti, Bi, Ci = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dti * A[None, None, :]                     # (B, L, H) <= 0
        cum = torch.cumsum(dA, dim=1)
        seg = cum[:, -1, :]                             # (B, H) chunk decay
        # mask BEFORE the exp: the upper triangle has diff > 0
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, L, L, H)
        diff = torch.where(mask[None, :, :, None], diff,
                           torch.full_like(diff, -math.inf))
        l_mat = torch.exp(diff)
        scores = torch.einsum("bin,bjn->bij", Ci, Bi)   # (B, L, L)
        gated = (scores[..., None].float() * l_mat
                 * dti[:, None, :, :]).to(cdt)
        y_diag = torch.einsum("bijh,bjhp->bihp", gated, xi)
        # the carried state's contribution to each position:
        # einsum("bln,blh,bhpn->blhp") as JAX contracts it, C ⊗ w first
        w_in = torch.exp(cum).to(cdt)
        cw = Ci.to(cdt)[:, :, :, None] * w_in[:, :, None, :]   # (B,L,N,H)
        y_off = torch.einsum("blnh,bhpn->blhp", cw, state)
        # state update: einsum("bln,blh,blhp->bhpn"), (w · dt) ⊗ x first
        w_end = torch.exp(seg[:, None, :] - cum)        # (B, L, H)
        wx = (w_end * dti).to(cdt)[..., None] * xi       # (B, L, H, P)
        st_in = torch.einsum("bln,blhp->bhpn", Bi.to(cdt), wx)
        state = state * torch.exp(seg)[..., None, None].to(state.dtype) \
            + st_in
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1), state


def ssm_block(x: torch.Tensor, p: dict, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 mixer over a sequence.  x: (B, S, d) → (y, final
    state)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    xz = L.dense(x, p["w_in"])
    xi, z, Bm, Cm, dt, nh, d_in = _split_proj(xz, cfg)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_out = L.silu(L.causal_conv(conv_in, p["conv"].to(L.COMPUTE_DTYPE)))
    xi, Bm, Cm = torch.split(conv_out, [d_in, s_cfg.d_state,
                                        s_cfg.d_state], dim=-1)
    xh = xi.reshape(b, s, nh, s_cfg.head_dim)
    dt = L.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, min(s_cfg.chunk, s))
    y = y + xh * p["D"].to(L.COMPUTE_DTYPE)[None, None, :, None]
    y = y.reshape(b, s, d_in) * L.silu(z)              # gated output
    return L.dense(y, p["w_out"]), state


def ssm_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
               state: torch.Tensor, conv_state: torch.Tensor
               ) -> torch.Tensor:
    """The O(1) recurrent step.  x: (B, d); state: (B, H, P, N);
    conv_state: (B, K-1, conv channels).  ``state`` and ``conv_state`` are
    advanced IN PLACE (the reference returns new ones); returns the block
    output (B, d)."""
    s_cfg = cfg.ssm
    b, _ = x.shape
    cdt = L.COMPUTE_DTYPE
    xz = L.dense(x, p["w_in"])
    xi, z, Bm, Cm, dt, nh, d_in = _split_proj(xz, cfg)
    conv_in = torch.cat([xi, Bm, Cm], dim=-1)          # (B, C)
    conv_out = L.silu(L.conv_step(conv_state, conv_in, p["conv"].to(cdt)))
    xi, Bm, Cm = torch.split(conv_out, [d_in, s_cfg.d_state,
                                        s_cfg.d_state], dim=-1)
    xh = xi.reshape(b, nh, s_cfg.head_dim)
    dt = L.softplus(dt.float() + p["dt_bias"])         # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                 # (B, H)
    # einsum("bhp,bn,bh->bhpn") as JAX contracts it: B ⊗ dt first
    bdt = Bm.to(cdt)[:, :, None] * dt.to(cdt)[:, None, :]     # (B, N, H)
    upd = xh[:, :, :, None] * bdt.permute(0, 2, 1)[:, :, None, :]
    new = state * decay[..., None, None].to(state.dtype) + upd
    state.copy_(new)
    y = torch.einsum("bhpn,bn->bhp", new, Cm.to(cdt))
    y = y + xh * p["D"].to(cdt)[None, :, None]
    y = y.reshape(b, d_in) * L.silu(z)
    return L.dense(y, p["w_out"])
