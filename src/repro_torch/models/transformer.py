"""Model assembly for every family of the reference's registry.

The reference scans stacked layer params with ``lax.scan``; the port runs
the same stacked layouts with Python loops over the layer axes:

* the uniform attention stacks (``dense``, ``moe``, ``vlm`` without a
  ``hybrid`` pattern; a ``window`` makes their attention local): ``blocks``
  stacked ``(L, ...)``.  Each layer's index is published through
  :func:`repro_torch.models.layers.layer_ctx`, so the execution plane's
  projection hook resolves per-layer compressed weights;
* gemma3 (5 local : 1 global, ring caches for the local layers):
  ``super/{local (n_super, 5, ...), global (n_super, ...)}`` and ``tail``;
* the hybrid recurrentgemma (RG-LRU : local attention, 2 : 1):
  ``super/{rec1, rec2, attn}`` and ``tail`` of recurrent layers;
* ``ssm`` (Mamba-2): ``blocks`` without ``ln2`` (no FFN);
* ``encdec`` (whisper): a bidirectional ``enc_blocks`` stack, ``enc_norm``
  and decoder ``blocks`` with cross-attention (``cross``, ``ln3``).

Only the uniform stacks without a window have a one-pass ``prefill``, as
in the reference; the others ingest a prompt token by token through
``decode_step`` (:mod:`repro_torch.launch.serve`).  Every decode step
writes its cache leaves in place and reads nothing back to the host, so a
CUDA graph captures it for every family (:mod:`repro_torch.launch.compiled`).

Training (``Model.loss``) runs ``hidden_states`` with remat, the
counterpart of the reference's ``_ckpt``: while grad is enabled every body
the reference wraps in ``jax.checkpoint`` runs under
``torch.utils.checkpoint`` (:func:`_run_body`), and under the
``saveremat`` flag each such body is cut at the reference's ``ar_out``
points instead, so that only the residual stream at the attention and FFN
outputs is kept for the backward pass.  Remat changes no value.

Under optflag ``sparseffn`` the ``sparse_ffn`` configs without ``moe``
get block-stored FFN params (:func:`repro_torch.models.layers.sparse_mlp_params`),
which ``decode_step`` alone serves: the full-sequence paths meet no
``w_gate`` and raise ``KeyError``, as the reference's do.  Under
``padheads`` the attention weights and paths take the padded head count
(:func:`repro_torch.models.layers.eff_heads`).

Two behaviours are the reference's and kept as they are: a uniform stack
with a ``window`` gets a ``max_len``-long cache (its decode attends over
the whole prefix, while ``hidden_states`` masks to the window), and the
encoder-decoder's decode cross-attends to the zero ``cross`` cache that
``init_cache`` makes and nothing fills, with no positions at all (its
``rope_fraction`` is 0 and decode adds no sinusoid).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import optflags
from repro_torch.models import rglru as rg
from repro_torch.models import ssm as ssm_mod

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
    families with a one-pass prefill and a compressed plane)."""
    return cfg.family in ("dense", "moe", "vlm") and cfg.hybrid is None


def _gemma3(cfg: ModelConfig) -> bool:
    """The reference picks gemma3's local/global layout by name."""
    return cfg.name.startswith("gemma3")


def _unserved(cfg: ModelConfig) -> str | None:
    """Why the port does not serve ``cfg``, or None when it does: the one
    refusal of the port's own, which the model and the compressed plane
    (:mod:`repro_torch.exec.compress`) both apply."""
    if cfg.family == "moe" and cfg.moe is None:
        return (f"{cfg.name}: family='moe' without a moe block would serve "
                f"a dense FFN")
    return None


def _check_served(cfg: ModelConfig) -> None:
    _check_family(cfg)
    reason = _unserved(cfg)
    if reason:
        raise NotImplementedError(reason)


def _ffn_apply(x, p, cfg: ModelConfig, experts=None):
    if cfg.moe:
        return moe_mod.moe_block(x, p, cfg, experts)
    return L.mlp(x, p)


def _take(tree: PyTree, i: int) -> PyTree:
    """Index ``i`` of the leading axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def attn_out(x, p, cfg: ModelConfig, freqs, positions, causal=True,
             window=0, return_kv=False):
    """A layer's attention sublayer before its residual add:
    ``attention(ln1(x))`` (with ``return_kv``, also its post-RoPE,
    pre-GQA-repeat (K, V)).  A tensor-parallel shard's partial sum
    (:mod:`repro_torch.launch.tensor_parallel`)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    return attn.attention_block(h, p["attn"], cfg, freqs, positions,
                                causal=causal, window=window,
                                return_kv=return_kv)


def ffn_out(x, p, cfg: ModelConfig, experts=None):
    """A layer's FFN sublayer before its residual add: ``ffn(ln2(x))``;
    a MoE layer's over the expert range ``experts`` (all by default:
    :func:`repro_torch.models.moe.moe_block`)."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return _ffn_apply(h, p["ffn"], cfg, experts)


def _attn_half(x, p, cfg: ModelConfig, freqs, positions, causal=True,
               window=0):
    """A layer up to its attention output (the reference's first
    ``ar_out``): ``x + attention(ln1(x))``."""
    return x + attn_out(x, p, cfg, freqs, positions, causal, window)


def _ffn_half(x, p, cfg: ModelConfig, positions, kv_override=None):
    """The rest of a layer from there: the cross-attention of a decoder
    layer, then ``x + ffn(ln2(x))`` (the second ``ar_out``)."""
    if kv_override is not None:
        h = L.rms_norm(x, p["ln3"], cfg.norm_eps)
        x = x + attn.attention_block(h, p["cross"], cfg, None, positions,
                                     causal=False, kv_override=kv_override)
    return x + ffn_out(x, p, cfg)


def _attn_layer_kv(x, p, cfg: ModelConfig, freqs, positions):
    """A causal self-attention layer that also returns its post-RoPE,
    pre-GQA-repeat (K, V): the prefill's."""
    a, k, v = attn_out(x, p, cfg, freqs, positions, return_kv=True)
    return _ffn_half(x + a, p, cfg, positions), k, v


def attn_step_out(h, p, cfg: ModelConfig, freqs, pos, kc, vc, cache_pos):
    """A decode step's attention sublayer before its residual add, writing
    the step's K / V into ``kc`` / ``vc`` at ``cache_pos``."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    return attn.attention_decode_block(hn, p["attn"], cfg, freqs, pos, kc,
                                       vc, cache_pos)


def ffn_step_out(h, p, cfg: ModelConfig, experts=None):
    """A decode step's FFN sublayer before its residual add (``experts``
    as :func:`ffn_out`'s)."""
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if cfg.moe:
        return moe_mod.moe_decode(hn, p["ffn"], cfg, experts)
    if "payload_gate" in p["ffn"]:
        return L.sparse_mlp_decode(hn, p["ffn"])
    return L.mlp(hn, p["ffn"])


def _attn_pieces(p, cfg: ModelConfig, freqs, positions, causal=True,
                 window=0, kv_override=None) -> list[Callable]:
    """An attention layer as :func:`_run_body`'s pieces, cut at its
    attention output."""
    return [lambda h: _attn_half(h, p, cfg, freqs, positions, causal,
                                 window),
            lambda h: _ffn_half(h, p, cfg, positions, kv_override)]


def _rec_layer(x, p, cfg: ModelConfig):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _, _ = rg.rglru_block(h, p["rec"], cfg)
    x = x + y
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(h, p["ffn"])


def _ssm_layer(x, p, cfg: ModelConfig):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _ = ssm_mod.ssm_block(h, p["ssm"], cfg)
    return x + y


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Reads:
    """What a layer body reads besides its arguments: the compute dtype,
    the projection (rebindable) and its hook, the published layer, the
    active flags.  ``torch.utils.checkpoint`` reruns the body during
    ``backward()``, by when the ``with`` blocks that set these may have
    exited (and on the card the backward runs on autograd's own thread,
    which sees none of the thread-local flags); JAX fixes them at trace
    time.  The recompute runs under the values the forward read."""

    compute_dtype: torch.dtype
    proj: Callable
    hook: Any
    layer: Any
    flags: frozenset

    @staticmethod
    def now() -> "_Reads":
        return _Reads(L.COMPUTE_DTYPE, L.proj, L._PROJ_HOOK, L._LAYER_CTX,
                      optflags.active())

    def put(self) -> None:
        L.COMPUTE_DTYPE, L.proj = self.compute_dtype, self.proj
        L._PROJ_HOOK, L._LAYER_CTX = self.hook, self.layer
        optflags._state.flags = self.flags

    def run(self, fn: Callable, x):
        prev = _Reads.now()
        self.put()
        try:
            return fn(x)
        finally:
            prev.put()


def _checkpointed(fn: Callable, x):
    """``fn(x)`` whose internals the backward pass recomputes from ``x``
    (and the tensors ``fn`` closes over) under the forward's reads."""
    reads = _Reads.now()
    return checkpoint(lambda h: reads.run(fn, h), x, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_mode(remat: bool) -> Optional[str]:
    """How the bodies run: None (plainly: no grad, or ``remat=False``),
    ``"full"`` (one checkpoint a body, ``jax.checkpoint``) or ``"save"``
    (``saveremat``: one checkpoint a piece)."""
    if not remat or not torch.is_grad_enabled():
        return None
    return "save" if optflags.enabled("saveremat") else "full"


def _run_body(x, pieces: Sequence[Callable], mode: Optional[str]):
    """One body the reference wraps in ``_ckpt``, given as pieces that end
    at its ``ar_out`` points (a body without one is a single piece).
    ``"full"`` checkpoints the whole body: the backward keeps its input
    and recomputes the rest.  ``"save"`` checkpoints each piece: the
    backward also keeps the residual stream after each ``ar_out`` (the
    reference keeps the ``ar_out`` tensors themselves; either gives the
    rest back with one add) and recomputes the same internals."""
    if mode == "full":
        def body(h):
            for piece in pieces:
                h = piece(h)
            return h
        return _checkpointed(body, x)
    for piece in pieces:
        x = _checkpointed(piece, x) if mode == "save" else piece(x)
    return x


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """(1, s, d) sin / cos position table in the compute dtype."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((s, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe[None].to(L.COMPUTE_DTYPE)


def _kv_leaves(tree: PyTree):
    """Every ``{"k", "v"}`` dict of a cache tree, and every other tensor."""
    if isinstance(tree, dict):
        if set(tree) == {"k", "v"}:
            yield True, tree["k"]
            yield True, tree["v"]
            return
        for v in tree.values():
            yield from _kv_leaves(v)
    else:
        yield False, tree


def step_writes(cache: PyTree, pos: int) -> list[torch.Tensor]:
    """Views of everything a lockstep decode step at ``pos`` writes in
    ``cache``: each K / V leaf's slot ``pos % S`` (a ring's slot, or
    ``pos`` itself in a full cache) and every other leaf of two or more
    dimensions whole (the recurrent states and conv tails).  A copy of
    them taken before the step is all it takes to undo it
    (:mod:`repro_torch.runtime.guard`)."""
    out = []
    for kv, t in _kv_leaves(cache):
        if kv:
            out.append(t[:, :, pos % t.shape[2]])
        elif t.ndim >= 2:
            out.append(t)
    return out


def decode_pos(tokens: torch.Tensor, pos) -> torch.Tensor:
    """A decode step's ``pos`` as a tensor on the tokens' device: a scalar
    (lockstep) or one position a row; anything else raises
    ``ValueError``."""
    pos = torch.as_tensor(pos, device=tokens.device)
    if pos.ndim not in (0, 1) or \
            (pos.ndim == 1 and pos.shape[0] != tokens.shape[0]):
        raise ValueError(
            f"decode_step: pos must be a scalar or a per-slot vector "
            f"matching the batch ({tokens.shape[0]},); got "
            f"{tuple(pos.shape)}")
    return pos


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        _check_served(self.cfg)

    # ---------------- params ----------------
    def _layer_params(self, gen, kind: str, lead) -> dict:
        cfg = self.cfg
        lead = tuple(lead)
        zeros = dict(dtype=L.PARAM_DTYPE, device=gen.device)
        p: dict = {"ln1": torch.zeros(lead + (cfg.d_model,), **zeros),
                   "ln2": torch.zeros(lead + (cfg.d_model,), **zeros)}
        if kind in ("attn", "cross"):
            p["attn"] = L.attn_params(gen, cfg, lead=lead)
            if kind == "cross":
                p["cross"] = L.attn_params(gen, cfg, lead=lead)
                p["ln3"] = torch.zeros(lead + (cfg.d_model,), **zeros)
            if cfg.moe:
                p["ffn"] = moe_mod.moe_params(gen, cfg, lead=lead)
            elif optflags.enabled("sparseffn") and cfg.sparse_ffn:
                p["ffn"] = L.sparse_mlp_params(gen, cfg, lead=lead)
            else:
                p["ffn"] = L.mlp_params(gen, cfg, lead=lead)
        elif kind == "rec":
            p["rec"] = rg.rglru_params(gen, cfg, lead=lead)
            p["ffn"] = L.mlp_params(gen, cfg, lead=lead)
        elif kind == "ssm":
            p["ssm"] = ssm_mod.ssm_params(gen, cfg, lead=lead)
            del p["ln2"]
        else:
            raise ValueError(kind)
        return p

    def init(self, seed: int = 0, device="cuda") -> PyTree:
        """Random params drawn on ``device`` from a seeded
        ``torch.Generator`` (normal / sqrt(fan_in), zero norms), in the
        reference's tree: layers stacked along leading axes (gemma3's
        local layers ``(n_super, 5, ...)``), a MoE layer's ``ffn`` the
        router ``(L, d, E)`` and the experts ``(L, E, d, f)`` /
        ``(L, E, f, d)``.  On the meta device the tree has the shapes
        and dtypes only."""
        cfg = self.cfg
        dev = resolve(device)
        gen = L.generator(dev, seed)
        d = cfg.d_model
        params: dict = {
            "embed": L._init(gen, (cfg.vocab, d), d),
            "final_norm": torch.zeros((d,), dtype=L.PARAM_DTYPE, device=dev),
        }
        if _uniform_stack(cfg):
            params["blocks"] = self._layer_params(gen, "attn",
                                                  (cfg.n_layers,))
        elif _gemma3(cfg):
            n_super = (cfg.n_layers - len(cfg.hybrid.tail)) // 6
            params["super"] = {
                "local": self._layer_params(gen, "attn", (n_super, 5)),
                "global": self._layer_params(gen, "attn", (n_super,))}
            params["tail"] = self._layer_params(
                gen, "attn", (len(cfg.hybrid.tail),))
        elif cfg.family == "hybrid":
            n_super = (cfg.n_layers - len(cfg.hybrid.tail)) // 3
            params["super"] = {
                "rec1": self._layer_params(gen, "rec", (n_super,)),
                "rec2": self._layer_params(gen, "rec", (n_super,)),
                "attn": self._layer_params(gen, "attn", (n_super,))}
            params["tail"] = self._layer_params(
                gen, "rec", (len(cfg.hybrid.tail),))
        elif cfg.family == "ssm":
            params["blocks"] = self._layer_params(gen, "ssm",
                                                  (cfg.n_layers,))
        elif cfg.family == "encdec":
            params["enc_blocks"] = self._layer_params(gen, "attn",
                                                      (cfg.enc_layers,))
            params["blocks"] = self._layer_params(gen, "cross",
                                                  (cfg.n_layers,))
            params["enc_norm"] = torch.zeros((d,), dtype=L.PARAM_DTYPE,
                                             device=dev)
        else:
            raise ValueError(cfg.family)
        return params

    # ---------------- forward ----------------
    def hidden_states(self, params: PyTree, tokens: torch.Tensor,
                      enc_frames: Optional[torch.Tensor] = None,
                      remat: bool = True) -> torch.Tensor:
        """The final-normed hidden states (B, S, d) of a full sequence;
        the encoder-decoder also takes its encoder frames (B, enc_seq,
        d).  ``remat`` (the reference's default too) checkpoints every
        layer body while grad is enabled (:func:`_run_body`); it changes
        no value, and without grad it does nothing."""
        cfg = self.cfg
        mode = _remat_mode(remat)
        dev = tokens.device
        s = tokens.shape[1]
        x = L.embed(tokens, params["embed"])
        positions = torch.arange(s, device=dev)
        freqs = L.rope_freqs(cfg, dev)
        if cfg.family == "encdec":
            assert enc_frames is not None, "encdec needs encoder frames"
            enc = enc_frames.to(L.COMPUTE_DTYPE) + _sinusoid(
                cfg.enc_seq, cfg.d_model, dev)
            enc_pos = torch.arange(cfg.enc_seq, device=dev)
            for i in range(cfg.enc_layers):
                enc = _run_body(enc, _attn_pieces(
                    _take(params["enc_blocks"], i), cfg, None, enc_pos,
                    causal=False), mode)
            enc = L.rms_norm(enc, params["enc_norm"], cfg.norm_eps)
            x = x + _sinusoid(s, cfg.d_model, dev)
            for i in range(cfg.n_layers):
                x = _run_body(x, _attn_pieces(
                    _take(params["blocks"], i), cfg, None, positions,
                    kv_override=(enc, enc)), mode)
        elif _gemma3(cfg):
            sup = params["super"]
            for i in range(sup["global"]["ln1"].shape[0]):
                local = _take(sup["local"], i)
                for j in range(5):
                    x = _run_body(x, _attn_pieces(
                        _take(local, j), cfg, freqs, positions,
                        window=cfg.window), mode)
                x = _run_body(x, _attn_pieces(
                    _take(sup["global"], i), cfg, freqs, positions), mode)
            for i in range(params["tail"]["ln1"].shape[0]):
                x = _run_body(x, _attn_pieces(
                    _take(params["tail"], i), cfg, freqs, positions,
                    window=cfg.window), mode)
        elif cfg.family == "hybrid":
            sup = params["super"]
            for i in range(sup["attn"]["ln1"].shape[0]):
                p = _take(sup, i)
                attn_first, ffn_rest = _attn_pieces(
                    p["attn"], cfg, freqs, positions, window=cfg.window)

                def recs_and_attn(h, p=p, attn_first=attn_first):
                    h = _rec_layer(h, p["rec1"], cfg)
                    return attn_first(_rec_layer(h, p["rec2"], cfg))
                # the reference checkpoints the whole super block
                x = _run_body(x, [recs_and_attn, ffn_rest], mode)
            for i in range(params["tail"]["ln1"].shape[0]):
                p = _take(params["tail"], i)
                x = _run_body(x, [lambda h, p=p: _rec_layer(h, p, cfg)],
                              mode)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                p = _take(params["blocks"], i)
                x = _run_body(x, [lambda h, p=p: _ssm_layer(h, p, cfg)],
                              mode)
        else:
            for i in range(cfg.n_layers):
                with L.layer_ctx(i):
                    x = _run_body(x, _attn_pieces(
                        _take(params["blocks"], i), cfg, freqs, positions,
                        window=cfg.window), mode)
        return L.rms_norm(x, params["final_norm"], cfg.norm_eps)

    def loss(self, params: PyTree, batch: dict, remat: bool = True
             ) -> torch.Tensor:
        """The mean next-token cross-entropy of ``batch`` (``tokens``,
        ``labels``, and ``enc_frames`` for the encoder-decoder) over
        ``hidden_states`` with remat (:func:`layers.unembed_loss`)."""
        x = self.hidden_states(params, batch["tokens"],
                               batch.get("enc_frames"), remat=remat)
        return L.unembed_loss(x, params["embed"], batch["labels"])

    def logits(self, params: PyTree, tokens: torch.Tensor,
               enc_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.hidden_states(params, tokens, enc_frames)
        return torch.matmul(
            x, params["embed"].to(L.COMPUTE_DTYPE).t()).float()

    # ---------------- decode ----------------
    def prefill(self, params: PyTree, tokens: torch.Tensor, max_len: int
                ) -> tuple[torch.Tensor, PyTree]:
        """Full-sequence forward that also fills a fresh decode cache with
        each layer's post-RoPE, pre-GQA-repeat (K, V), so
        ``decode_step(pos=s)`` continues seamlessly.  Returns
        (logits (B, S, V) float32, cache).  Uniform full-attention stacks
        only, as in the reference: ring windows and the recurrent and
        encoder-decoder families ingest token by token."""
        cfg = self.cfg
        if not _uniform_stack(cfg) or cfg.window:
            raise NotImplementedError(
                "prefill: uniform full-attention stacks only")
        b, s = tokens.shape
        if s > max_len:
            raise ValueError(f"prompt ({s}) exceeds max_len ({max_len})")
        cache = self.init_cache(b, max_len, device=tokens.device)
        x = L.embed(tokens, params["embed"])
        positions = torch.arange(s, device=tokens.device)
        freqs = L.rope_freqs(cfg, tokens.device)
        for i in range(cfg.n_layers):
            with L.layer_ctx(i):
                x, k, v = _attn_layer_kv(x, _take(params["blocks"], i),
                                         cfg, freqs, positions)
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = torch.matmul(
            x, params["embed"].to(L.COMPUTE_DTYPE).t()).float()
        return logits, cache

    def init_cache(self, batch: int, max_len: int, device="cuda") -> PyTree:
        """Zeroed decode caches in the compute dtype, in the reference's
        layouts (K / V leaves (L, B, S, n_kv_heads, head_dim)):

        * uniform stacks: ``{"self": {k, v}}``, ``max_len`` long (a
          ``window`` too, as in the reference);
        * gemma3: ``{"local": {k, v}}`` rings of ``min(window, max_len)``
          for its 5·n_super + 2 local layers, ``{"global": {k, v}}`` full;
        * hybrid: ``{"attn": {k, v}}`` rings, the RG-LRU states ``h``
          (L_rec, B, d) and conv tails ``conv`` (L_rec, B, 3, d);
        * ssm: ``state`` (L, B, heads, head_dim, d_state) and ``conv``
          (L, B, d_conv - 1, channels);
        * encdec: ``self`` and ``cross`` (``enc_seq`` long) K / V and the
          0-d ``cross_ready`` (int32)."""
        cfg = self.cfg
        _check_family(cfg)
        dev = resolve(device)
        dt = L.COMPUTE_DTYPE
        hd, nk = cfg.head_dim, max(cfg.n_kv_heads, 1)

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(n_layers, length):
            return {"k": zeros(n_layers, batch, length, nk, hd),
                    "v": zeros(n_layers, batch, length, nk, hd)}

        if cfg.family == "ssm":
            s = cfg.ssm
            d_in = cfg.d_model * s.expand
            nh = d_in // s.head_dim
            return {"state": zeros(cfg.n_layers, batch, nh, s.head_dim,
                                   s.d_state),
                    "conv": zeros(cfg.n_layers, batch, s.d_conv - 1,
                                  d_in + 2 * s.d_state)}
        if _gemma3(cfg):
            n_super = (cfg.n_layers - 2) // 6
            return {"local": kv(n_super * 5 + 2, min(cfg.window, max_len)),
                    "global": kv(n_super, max_len)}
        if cfg.family == "hybrid":
            n_super = (cfg.n_layers - 2) // 3
            win = min(cfg.window, max_len) if cfg.window else max_len
            n_rec = n_super * 2 + 2
            return {"attn": kv(n_super, win),
                    "h": zeros(n_rec, batch, cfg.d_model),
                    "conv": zeros(n_rec, batch, rg.CONV_K - 1, cfg.d_model)}
        if cfg.family == "encdec":
            return {"self": kv(cfg.n_layers, max_len),
                    "cross": kv(cfg.n_layers, cfg.enc_seq),
                    "cross_ready": zeros(dtype=torch.int32)}
        return {"self": kv(cfg.n_layers, max_len)}

    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, pos) -> tuple[torch.Tensor, PyTree]:
        """One token for the whole batch.  tokens: (B,); pos: a scalar for
        a lockstep batch or a (B,) per-row position vector.  The cache is
        updated in place and returned.  Returns (logits (B, V), cache).
        With ``pos`` a tensor on the tokens' device the step reads nothing
        back to the host and copies nothing to the device, so a CUDA graph
        can capture it (:mod:`repro_torch.launch.compiled`)."""
        cfg = self.cfg
        _check_family(cfg)
        dev = tokens.device
        pos = decode_pos(tokens, pos)
        x = params["embed"][tokens].to(L.COMPUTE_DTYPE)
        freqs = L.rope_freqs(cfg, dev)

        def attn_step(h, p, kc, vc, cache_pos):
            h = h + attn_step_out(h, p, cfg, freqs, pos, kc, vc, cache_pos)
            return h + ffn_step_out(h, p, cfg)

        def rec_step(h, p, i):
            hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
            h = h + rg.rglru_decode(hn, p["rec"], cfg, cache["h"][i],
                                    cache["conv"][i])
            hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
            return h + L.mlp(hn, p["ffn"])

        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                p = _take(params["blocks"], i)
                hn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                x = x + ssm_mod.ssm_decode(hn, p["ssm"], cfg,
                                           cache["state"][i],
                                           cache["conv"][i])
        elif _gemma3(cfg):
            lk, lv = cache["local"]["k"], cache["local"]["v"]
            gk, gv = cache["global"]["k"], cache["global"]["v"]
            win = lk.shape[2]
            lpos = pos % win if win > 0 else torch.zeros_like(pos)
            n_super = gk.shape[0]
            sup = params["super"]
            for i in range(n_super):
                local = _take(sup["local"], i)
                for j in range(5):
                    li = i * 5 + j
                    x = attn_step(x, _take(local, j), lk[li], lv[li], lpos)
                x = attn_step(x, _take(sup["global"], i), gk[i], gv[i], pos)
            for t in range(params["tail"]["ln1"].shape[0]):
                li = n_super * 5 + t
                x = attn_step(x, _take(params["tail"], t), lk[li], lv[li],
                              lpos)
        elif cfg.family == "hybrid":
            ak, av = cache["attn"]["k"], cache["attn"]["v"]
            apos = pos % ak.shape[2]
            n_super = ak.shape[0]
            sup = params["super"]
            for i in range(n_super):
                x = rec_step(x, _take(sup["rec1"], i), 2 * i)
                x = rec_step(x, _take(sup["rec2"], i), 2 * i + 1)
                x = attn_step(x, _take(sup["attn"], i), ak[i], av[i], apos)
            for t in range(params["tail"]["ln1"].shape[0]):
                x = rec_step(x, _take(params["tail"], t), 2 * n_super + t)
        elif cfg.family == "encdec":
            sk, sv = cache["self"]["k"], cache["self"]["v"]
            ck, cv = cache["cross"]["k"], cache["cross"]["v"]
            rep = cfg.n_heads // max(cfg.n_kv_heads, 1)
            wq_width = params["blocks"]["cross"]["wq"].shape[-1]
            if wq_width != cfg.n_heads * cfg.head_dim:
                # padheads: the reference reshapes the padded query with
                # the unpadded head count, and its shapes do not meet
                raise ValueError(
                    f"cross-attention decode takes {cfg.n_heads} heads of "
                    f"{cfg.head_dim}; wq is {wq_width} wide")
            # every encoder position is valid
            enc_len = torch.full((), ck.shape[2], dtype=torch.long,
                                 device=dev)
            for i in range(cfg.n_layers):
                p = _take(params["blocks"], i)
                hn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                x = x + attn.attention_decode_block(hn, p["attn"], cfg, freqs,
                                                    pos, sk[i], sv[i])
                hn = L.rms_norm(x, p["ln3"], cfg.norm_eps)
                q = L.dense(hn, p["cross"]["wq"])
                q = q.reshape(-1, cfg.n_heads, cfg.head_dim)
                y = attn.decode_attention(q, attn._repeat_kv(ck[i], rep),
                                          attn._repeat_kv(cv[i], rep),
                                          enc_len)
                x = x + L.dense(y.reshape(y.shape[0], -1), p["cross"]["wo"])
                hn = L.rms_norm(x, p["ln2"], cfg.norm_eps)
                x = x + L.mlp(hn, p["ffn"])
        else:
            kc, vc = cache["self"]["k"], cache["self"]["v"]
            cache_pos = pos % kc.shape[2] if cfg.window else pos
            for i in range(cfg.n_layers):
                with L.layer_ctx(i):
                    x = attn_step(x, _take(params["blocks"], i), kc[i],
                                  vc[i], cache_pos)
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return L.logits_head(x, params["embed"]), cache


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins, no allocation): the dry run's inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeCfg, device="meta") -> dict:
    """The inputs of one (arch x shape) cell, as the reference's
    ``input_specs``: int32 token (and label) batches and, for the
    encoder-decoder, fp32 stub frontend embeddings (train / prefill); one
    token a row and a 0-d int32 position (decode).  The decode cache
    itself comes from :meth:`Model.init_cache` on the same device.  On
    the meta device the tensors have shapes and dtypes only."""
    dev = resolve(device)
    b, s = shape.global_batch, shape.seq_len

    def empty(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=dev)

    if shape.kind in ("train", "prefill"):
        out = {"tokens": empty(b, s)}
        if shape.kind == "train":
            out["labels"] = empty(b, s)
        if cfg.family == "encdec":
            out["enc_frames"] = empty(b, cfg.enc_seq, cfg.d_model,
                                      dtype=torch.float32)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"tokens": empty(b), "pos": empty()}
