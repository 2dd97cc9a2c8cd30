"""Optflag ``sparseffn`` in the port against the reference, on the
``reduced()`` configs.

Under the flag both packages' ``Model.init`` give every ``sparse_ffn``
config without ``moe`` block-stored FFN params: per block-column a padded
payload of T blocks, block-row ids that are all zero, a dense ``w_down``
and an int32 ``_meta``.  Both packages get the reference's weights
through numpy.

* ``_bsp_matmul`` and ``sparse_mlp_decode`` alone, on block-row ids that
  are not zero (the gather is exercised): fp32 to 1e-5 · max|want|; bf16
  to the reference's jit-vs-eager spread plus one bf16 ulp.
* ``decode_step`` over six positions from an empty cache, on every
  reduced config that takes these params: fp32 to 1e-5 · max|want|; at
  bf16 one step from a cache the reference filled, to the spread bound,
  with the same greedy tokens.  The step reads nothing back to the host
  (what a CUDA graph's capture needs).
* The full-sequence paths (``prefill``, ``hidden_states``, ``loss`` and
  ``serve.generate``, which prefills) and ``prune_params`` meet no
  ``w_gate`` and raise ``KeyError`` in both packages; gemma3, whose ring
  windows ingest the prompt token by token, generates the reference's
  tokens.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import exec as rexec
from repro.configs import get_config as rget_config
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import optflags as roptflags
from repro.models.transformer import Model as RModel
from repro_torch.configs import get_config
from repro_torch.exec import prune_params
from repro_torch.exec.plans import shipped_plan
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model

#: the reduced configs whose init takes block-stored FFN params
SPARSE_ARCHS = ["chatglm3-6b", "deepseek-coder-33b", "gemma3-27b",
                "internlm2-20b", "pixtral-12b"]
FLAGS = ("sparseffn",)
B, STEPS, CACHE = 2, 6, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(rattn, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol: float = 1e-5) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _held(got, jit, eager) -> None:
    """Within the reference's jit-vs-eager spread plus one bf16 ulp."""
    got, want = _np(got), _np(jit)
    tol = np.abs(want - _np(eager)).max() + _bf16_ulp(np.abs(want).max())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def _to_port(tree):
    """A reference tree as the port's CPU tensors (bf16 kept bf16)."""
    def one(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))) \
                .to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(one, tree)


def _weights(arch):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    with roptflags.optimizations(FLAGS):
        rparams = RModel(rcfg).init(jax.random.key(1))
    return rcfg, cfg, rparams, _to_port(rparams)


def _tokens(vocab):
    return np.random.default_rng(7).integers(0, vocab, (B, STEPS))


def _ref_decode(rcfg, rparams, toks, steps=STEPS, jit=True):
    model = RModel(rcfg)
    with roptflags.optimizations(FLAGS):
        cache = model.init_cache(B, CACHE)
        step = jax.jit(model.decode_step) if jit else model.decode_step
        out = []
        for t in range(steps):
            lg, cache = step(rparams, cache,
                             jnp.asarray(toks[:, t], jnp.int32),
                             jnp.asarray(t, jnp.int32))
            out.append(_np(lg))
    return np.stack(out), cache


def _port_decode(cfg, params, toks, steps=STEPS, cache=None, start=0):
    model = Model(cfg)
    with optflags.optimizations(FLAGS):
        if cache is None:
            cache = model.init_cache(B, CACHE, device="cpu")
        out = []
        for t in range(start, start + steps):
            lg, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[:, t]), t)
            out.append(_np(lg))
    return np.stack(out), cache


def _layout(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace(
        "torch.", "")), tree)


def test_the_references_configs_take_block_stored_ffn_params():
    """The same reduced configs get the params, in the same tree."""
    from repro_torch.configs import list_archs
    got = []
    for arch in list_archs():
        rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
        with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
            want = jax.eval_shape(lambda: RModel(rcfg).init(
                jax.random.key(0)))
            tree = Model(cfg).init(device="meta")
        assert _layout(tree) == _layout(want), arch
        if any("payload_gate" in jax.tree_util.keystr(path) for path, _ in
               jax.tree_util.tree_flatten_with_path(want)[0]):
            got.append(arch)
    assert got == SPARSE_ARCHS


def _bsp_operands(dtype):
    """x (3, 256): 2 block-rows of 128; payload (3, 2, 128, 128): 3
    block-columns of 2 blocks, at block-rows that are not zero."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    payload = (rng.standard_normal((3, 2, 128, 128)) / 11.3).astype(
        np.float32)
    rows = np.array([[1, 0], [1, 1], [0, 1]], np.int32)
    jx = jnp.asarray(x).astype(jdt := {"fp32": jnp.float32,
                                       "bf16": jnp.bfloat16}[dtype])
    tx = torch.from_numpy(x).to({"fp32": torch.float32,
                                 "bf16": torch.bfloat16}[dtype])
    return jx, tx, payload, rows, jdt


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bsp_matmul_matches_the_reference(dtype, monkeypatch):
    jx, tx, payload, rows, jdt = _bsp_operands(dtype)
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", tx.dtype)
    args = (jnp.asarray(payload), jnp.asarray(rows))
    want = jax.jit(RL._bsp_matmul)(jx, *args)
    got = L._bsp_matmul(tx, torch.from_numpy(payload),
                        torch.from_numpy(rows))
    assert got.dtype == tx.dtype and got.shape == (3, 384)
    if dtype == "fp32":
        _close(got, want)
    else:
        with jax.disable_jit():
            eager = RL._bsp_matmul(jx, *args)
        _held(got, want, eager)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sparse_mlp_decode_matches_the_reference(dtype, monkeypatch):
    jx, tx, payload, rows, jdt = _bsp_operands(dtype)
    monkeypatch.setattr(RL, "COMPUTE_DTYPE", jdt)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", tx.dtype)
    w_down = (np.random.default_rng(12).standard_normal((384, 256))
              / 19.6).astype(np.float32)
    rp = {"payload_gate": payload, "rows_gate": rows,
          "payload_up": payload[::-1].copy(), "rows_up": rows[::-1].copy(),
          "w_down": w_down, "_meta": np.array([128, 128], np.int32)}
    jp = jax.tree.map(jnp.asarray, rp)
    want = jax.jit(RL.sparse_mlp_decode)(jx, jp)
    got = L.sparse_mlp_decode(tx, _to_port(rp))
    assert got.dtype == tx.dtype and got.shape == (3, 256)
    if dtype == "fp32":
        _close(got, want)
    else:
        with jax.disable_jit():
            eager = RL.sparse_mlp_decode(jx, jp)
        _held(got, want, eager)


@pytest.mark.parametrize("arch", SPARSE_ARCHS)
def test_decode_matches_the_reference_at_fp32(arch, fp32):
    rcfg, cfg, rparams, params = _weights(arch)
    toks = _tokens(cfg.vocab)
    want, rcache = _ref_decode(rcfg, rparams, toks)
    got, cache = _port_decode(cfg, params, toks)
    _close(got, want)
    for g, w in zip(jax.tree.leaves(cache), jax.tree.leaves(rcache)):
        _close(g, w)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma3-27b"])
def test_decode_matches_the_reference_at_bf16(arch):
    """The last of six steps from the cache the reference's jitted steps
    filled: the port, the reference jitted and op by op."""
    assert RL.COMPUTE_DTYPE == jnp.bfloat16
    rcfg, cfg, rparams, params = _weights(arch)
    toks = _tokens(cfg.vocab)
    _, rcache = _ref_decode(rcfg, rparams, toks, steps=STEPS - 1)
    model = RModel(rcfg)
    args = (jnp.asarray(toks[:, -1], jnp.int32),
            jnp.asarray(STEPS - 1, jnp.int32))
    with roptflags.optimizations(FLAGS):
        want, _ = jax.jit(model.decode_step)(rparams, rcache, *args)
        with jax.disable_jit():
            eager, _ = model.decode_step(rparams, rcache, *args)
    got, _ = _port_decode(cfg, params, toks, steps=1,
                          cache=_to_port(rcache), start=STEPS - 1)
    _held(got[0], want, eager)
    assert np.array_equal(got[0].argmax(-1), _np(want).argmax(-1))


class _HostReads(TorchDispatchMode):
    """Records every op that reads a device value on the host, copies a
    host value to the device, or sizes its output from device data."""

    SYNCS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.repeat_interleave.Tensor",
             "aten.lift_fresh.default"}

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.SYNCS:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma3-27b"])
def test_the_step_reads_nothing_back_to_the_host(arch):
    _, cfg, _, params = _weights(arch)
    model = Model(cfg)
    cache = model.init_cache(B, CACHE, device="cpu")
    toks, pos = torch.tensor([3, 5]), torch.tensor(2)
    with optflags.optimizations(FLAGS), _HostReads() as mode:
        model.decode_step(params, cache, toks, pos)
    assert mode.found == []


@pytest.mark.parametrize("entry", ["prefill", "hidden_states", "loss",
                                   "generate", "prune_params"])
def test_full_sequence_paths_fail_as_the_reference(entry):
    """So does the compressed plane: its plan's FFN roles find no
    ``w_gate`` to prune (the store never holds the int32 leaves)."""
    rcfg, cfg, rparams, params = _weights("chatglm3-6b")
    plan = shipped_plan(cfg, "bitmap")
    rplan = rexec.ExecPlan.from_json(plan.to_json())
    toks = _tokens(cfg.vocab)[:, :4]
    rmodel, model = RModel(rcfg), Model(cfg)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    calls = {
        "prefill": (lambda: rmodel.prefill(rparams, jt, 8),
                    lambda: model.prefill(params, tt, 8)),
        "hidden_states": (lambda: rmodel.hidden_states(rparams, jt),
                          lambda: model.hidden_states(params, tt)),
        "loss": (lambda: rmodel.loss(rparams, {"tokens": jt, "labels": jt}),
                 lambda: model.loss(params, {"tokens": tt, "labels": tt})),
        "generate": (lambda: rserve.generate(rmodel, rparams, jt, 2, 8),
                     lambda: serve.generate(model, params, tt, 2, 8,
                                            device="cpu")),
        "prune_params": (lambda: rexec.prune_params(rparams, rplan, rcfg),
                         lambda: prune_params(params, plan, cfg)),
    }[entry]
    with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
        with pytest.raises(KeyError, match="w_gate"):
            calls[0]()
        with pytest.raises(KeyError, match="w_gate"):
            calls[1]()


def test_a_windowed_model_generates_the_references_tokens(fp32):
    """gemma3's rings ingest the prompt token by token through
    ``decode_step``, which serves the block-stored FFN."""
    rcfg, cfg, rparams, params = _weights("gemma3-27b")
    toks = _tokens(cfg.vocab)[:, :4]
    with roptflags.optimizations(FLAGS), optflags.optimizations(FLAGS):
        want, _, _ = rserve.generate(RModel(rcfg), rparams,
                                     jnp.asarray(toks, jnp.int32), 4, 8)
        got, _, _ = serve.generate(Model(cfg), params,
                                   torch.from_numpy(toks), 4, 8,
                                   device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(want))
