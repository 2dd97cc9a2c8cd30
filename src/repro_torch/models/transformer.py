"""Model assembly for the uniform attention stacks: the families
``dense``, ``moe`` and ``vlm`` (a dense backbone; the vision frontend is a
stub in the reference too) without a ``hybrid`` layer pattern.

The reference scans stacked layer params with ``lax.scan``; the port runs
the same stacked layout with a Python loop over the layer axis, publishing
each layer's index through :func:`repro_torch.models.layers.layer_ctx` so
the execution plane's projection hook can resolve per-layer compressed
weights.  The other known families (``ssm``, ``hybrid``, ``encdec``) and
sliding-window attention raise ``NotImplementedError``; an unknown family
raises the reference's ``ValueError``.  Nothing is served as another
family.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import optflags

PyTree = Any

#: Families the reference's cache/decode machinery knows; anything else
#: fails loudly instead of getting the uniform dense cache.
KNOWN_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in KNOWN_FAMILIES:
        raise ValueError(
            f"unknown model family {cfg.family!r} for {cfg.name}: cannot "
            f"build a decode cache (known: {', '.join(KNOWN_FAMILIES)})")


def _uniform_stack(cfg: ModelConfig) -> bool:
    """True when the model is one homogeneous attention stack (the
    families the port serves)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.hybrid is None


def _unserved(cfg: ModelConfig) -> str | None:
    """Why the port does not serve ``cfg``, or None when it does: the one
    rule that the model and the compressed plane
    (:mod:`repro_torch.exec.compress`) both apply."""
    if not _uniform_stack(cfg):
        return (f"{cfg.name}: family={cfg.family!r} hybrid={cfg.hybrid!r} "
                f"is not ported yet (ROADMAP Queue 1 item 9); the port "
                f"serves the uniform attention stacks (dense, moe, vlm)")
    if cfg.window:
        return (f"{cfg.name}: sliding-window (ring cache) attention is not "
                f"ported yet (window={cfg.window}; ROADMAP Queue 1 item 9)")
    if cfg.family == "moe" and cfg.moe is None:
        return (f"{cfg.name}: family='moe' without a moe block would serve "
                f"a dense FFN")
    return None


def _check_served(cfg: ModelConfig) -> None:
    _check_family(cfg)
    reason = _unserved(cfg)
    if reason:
        raise NotImplementedError(reason)


def _ffn_apply(x, p, cfg: ModelConfig):
    if cfg.moe:
        return moe_mod.moe_block(x, p, cfg)
    return L.mlp(x, p)


def _layer(params: PyTree, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``blocks`` tree (views)."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])


def _attn_layer(x, p, cfg: ModelConfig, freqs, positions,
                return_kv: bool = False):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a = attn.attention_block(h, p["attn"], cfg, freqs, positions,
                             return_kv=return_kv)
    if return_kv:
        a, k, v = a
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    out = x + _ffn_apply(h, p["ffn"], cfg)
    if return_kv:
        return out, k, v
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _check_served(self.cfg)

    def _check_flags(self) -> None:
        """Raise for an active optimization flag the port does not serve
        (:func:`repro_torch.models.optflags.check_served`)."""
        optflags.check_served(self.cfg.n_heads)

    # ---------------- params ----------------
    def init(self, seed: int = 0, device="cuda") -> PyTree:
        """Random params drawn on ``device`` from a seeded
        ``torch.Generator`` (normal / sqrt(fan_in), zero norms), stacked
        along a leading layer axis like the reference's pytree (a MoE
        layer's ``ffn`` holds the router ``(L, d, E)`` and the experts
        ``(L, E, d, f)`` / ``(L, E, f, d)``)."""
        self._check_flags()
        cfg = self.cfg
        dev = resolve(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        d, nl = cfg.d_model, cfg.n_layers
        zeros = dict(dtype=L.PARAM_DTYPE, device=dev)
        return {
            "embed": L._init(gen, (cfg.vocab, d), d),
            "final_norm": torch.zeros((d,), **zeros),
            "blocks": {
                "ln1": torch.zeros((nl, d), **zeros),
                "ln2": torch.zeros((nl, d), **zeros),
                "attn": L.attn_params(gen, cfg, lead=(nl,)),
                "ffn": (moe_mod.moe_params if cfg.moe else L.mlp_params)(
                    gen, cfg, lead=(nl,)),
            },
        }

    # ---------------- forward ----------------
    def hidden_states(self, params: PyTree, tokens: torch.Tensor
                      ) -> torch.Tensor:
        self._check_flags()
        cfg = self.cfg
        s = tokens.shape[1]
        x = L.embed(tokens, params["embed"])
        positions = torch.arange(s, device=tokens.device)
        freqs = L.rope_freqs(cfg, tokens.device)
        for i in range(cfg.n_layers):
            with L.layer_ctx(i):
                x = _attn_layer(x, _layer(params, i), cfg, freqs, positions)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        x = self.hidden_states(params, tokens)
        return torch.matmul(
            x, params["embed"].to(L.COMPUTE_DTYPE).t()).float()

    # ---------------- decode ----------------
    def prefill(self, params: PyTree, tokens: torch.Tensor, max_len: int
                ) -> tuple[torch.Tensor, PyTree]:
        """Full-sequence forward that also fills a fresh decode cache with
        each layer's post-RoPE, pre-GQA-repeat (K, V), so
        ``decode_step(pos=s)`` continues seamlessly.  Returns
        (logits (B, S, V) float32, cache)."""
        self._check_flags()
        cfg = self.cfg
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({max_len})")
        cache = self.init_cache(b, max_len, device=tokens.device)
        x = L.embed(tokens, params["embed"])
        positions = torch.arange(s, device=tokens.device)
        freqs = L.rope_freqs(cfg, tokens.device)
        for i in range(cfg.n_layers):
            with L.layer_ctx(i):
                x, k, v = _attn_layer(x, _layer(params, i), cfg, freqs,
                                      positions, return_kv=True)
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = torch.matmul(
            x, params["embed"].to(L.COMPUTE_DTYPE).t()).float()
        return logits, cache

    def init_cache(self, batch: int, max_len: int, device="cuda") -> PyTree:
        """Zeroed KV cache ``{"self": {"k", "v"}}`` of shape
        (L, B, max_len, n_kv_heads, head_dim) in the compute dtype."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, max(cfg.n_kv_heads, 1),
                 cfg.head_dim)
        dev = resolve(device)
        return {"self": {
            "k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=dev)}}

    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, pos) -> tuple[torch.Tensor, PyTree]:
        """One token for the whole batch.  tokens: (B,); pos: a scalar for
        a lockstep batch or a (B,) per-row position vector.  The cache is
        updated in place and returned.  Returns (logits (B, V), cache).
        With ``pos`` a tensor on the tokens' device the step reads nothing
        back to the host and copies nothing to the device, so a CUDA graph
        can capture it (:mod:`repro_torch.launch.compiled`)."""
        self._check_flags()
        cfg = self.cfg
        pos = torch.as_tensor(pos, device=tokens.device)
        if pos.ndim not in (0, 1) or \
                (pos.ndim == 1 and pos.shape[0] != tokens.shape[0]):
            raise ValueError(
                f"decode_step: pos must be a scalar or a per-slot vector "
                f"matching the batch ({tokens.shape[0]},); got "
                f"{tuple(pos.shape)}")
        x = params["embed"][tokens].to(L.COMPUTE_DTYPE)
        freqs = L.rope_freqs(cfg, tokens.device)
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        for i in range(cfg.n_layers):
            p = _layer(params, i)
            with L.layer_ctx(i):
                hn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                x = x + attn.attention_decode_block(
                    hn, p["attn"], cfg, freqs, pos, kc[i], vc[i])
                hn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
                x = x + (moe_mod.moe_decode(hn, p["ffn"], cfg) if cfg.moe
                         else L.mlp(hn, p["ffn"]))
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.logits_head(x, params["embed"]), cache
