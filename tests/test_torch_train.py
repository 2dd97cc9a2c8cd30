"""The port's training forward and backward against the reference's, at
fp32 on every family's ``reduced()`` config.

* ``Model.loss`` and its gradients (``launch.train.value_and_grad``)
  against ``jax.value_and_grad(model.loss)`` jitted, on the reference's
  ``Model.init`` weights through numpy and a batch both pipelines draw
  (whisper with its ``enc_frames``): the loss within 1e-5 relative, each
  gradient leaf within 1e-4 · max|leaf|.  Every module's compute dtype is
  patched to fp32 (the reference's ``layers``, ``attention``, ``rglru``,
  ``ssm`` and ``moe`` import it by name).
* Remat: gradients with remat off, on and under ``saveremat`` are equal
  bit for bit, with ``backward()`` run after the flag and the dtype patch
  are gone; the
  recompute sees the projection hook and the layer the forward saw.
* ``layers.unembed_loss`` at an S that drops positions (the reference's
  behaviour, kept).
* The kernels have no backward: the port's wrappers refuse an input that
  requires grad, as ``jax.grad`` through the reference's interpret-mode
  ``pallas_call`` raises.
* The derivatives the port spells out: ``softplus`` at 0 and ``sigmoid``
  where ``exp(-x)`` overflows, against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.kernels import ops as rops
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models import moe as rmoe
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro.models.transformer import Model as RModel
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch.train import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.transformer import Model

#: one config of each layout: dense, gemma3's local / global, MoE, vlm,
#: Mamba-2, RG-LRU hybrid, encoder-decoder
ARCHS = ["chatglm3-6b", "gemma3-27b", "granite-moe-3b-a800m", "pixtral-12b",
         "mamba2-780m", "recurrentgemma-2b", "whisper-tiny"]
# S past the reduced window (64), a multiple of the SSD chunk (16) and of
# the MoE routing group (16)
B, S = 2, 80


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_fp32(mp) -> None:
    for mod in (RL, rattn, rrg, rssm, rmoe):
        mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    mp.setattr(L, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def fp32(monkeypatch):
    _patch_fp32(monkeypatch)


def _batches(cfg, step: int = 3):
    """The same batch from both pipelines (they must be equal)."""
    enc = cfg.enc_seq if cfg.family == "encdec" else 0
    want = RPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B,
                     enc_seq=enc, d_model=cfg.d_model).batch_at(step)
    got = TokenPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B,
                        enc_seq=enc, d_model=cfg.d_model,
                        device="cpu").batch_at(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    return got, want


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")
    batch, rbatch = _batches(cfg)
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rparams=rparams,
                params=params, batch=batch, rbatch=rbatch)


def _leaves_close(got, want, tol: float) -> None:
    got, want = tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def test_loss_and_grads_match_the_reference(fam, fp32):
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        RModel(fam["rcfg"]).loss))(fam["rparams"], fam["rbatch"])
    loss, grads = value_and_grad(Model(fam["cfg"]).loss, fam["params"],
                                 fam["batch"])
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(
        float(want_loss))
    _leaves_close(grads, want_grads, 1e-4)


def _grads(model, params, batch, remat: bool, flags=()):
    """Gradients with ``backward()`` run after the flags and the fp32
    patch are gone: a recompute that read them afresh would run in bf16
    without the flag."""
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with pytest.MonkeyPatch.context() as mp:
        _patch_fp32(mp)
        with optflags.optimizations(flags):
            loss = model.loss(tree.unflatten(params, live), batch,
                              remat=remat)
    assert L.COMPUTE_DTYPE == torch.bfloat16 and not optflags.active()
    loss.backward()
    # a leaf the loss does not read (mamba2's ``norm``) gets no grad
    return float(loss.detach()), [torch.zeros_like(p) if p.grad is None
                                  else p.grad for p in live]


def test_remat_modes_give_the_same_gradients(fam):
    model, params, batch = Model(fam["cfg"]), fam["params"], fam["batch"]
    l0, g0 = _grads(model, params, batch, remat=False)
    for flags in ((), ("saveremat",)):
        l1, g1 = _grads(model, params, batch, remat=True, flags=flags)
        assert l1 == l0
        # the recompute runs the same ops on the same values
        assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_the_recompute_sees_the_forwards_hook_and_layer():
    """A projection hook installed (and a layer published) only while the
    forward runs is called again by the recompute, with the same layer."""
    cfg = get_config("chatglm3-6b").reduced()
    params = Model(cfg).init(seed=0, device="cpu")
    batch, _ = _batches(cfg)
    calls = []

    def hook(x, w, role):
        calls.append((role, L.current_layer_ctx()))
        return None                       # fall through to the dense one

    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    L.set_proj_hook(hook)
    try:
        loss = Model(cfg).loss(tree.unflatten(params, live), batch)
    finally:
        L.set_proj_hook(None)
    forward = list(calls)
    assert len(forward) == 7 * cfg.n_layers
    assert {layer for _, layer in forward} == set(range(cfg.n_layers))
    loss.backward()
    assert calls[len(forward):] and sorted(calls[len(forward):]) == \
        sorted(forward)


def test_remat_changes_no_serving_value():
    """With grad enabled (and params that do not require it) the forward
    goes through the checkpoints and gives the no-grad logits bit for
    bit."""
    cfg = get_config("chatglm3-6b").reduced()
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 24)))
    with optflags.optimizations(("saveremat",)):
        with torch.no_grad():
            want = model.logits(params, toks)
        got = model.logits(params, toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s,chunk", [(1025, 512), (100, 512), (96, 32)])
def test_unembed_loss_drops_what_the_reference_drops(s, chunk, fp32):
    """n_chunks = max(s // chunk, 1) chunks of s // n_chunks: at 1025 /
    512 the last position is dropped, and the mean divides by the 1024
    kept."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    labels = rng.integers(0, 64, (2, s)).astype(np.int32)
    want, (wgx, wgt) = jax.value_and_grad(RL.unembed_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(labels), chunk)
    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    got = L.unembed_loss(tx, tt, torch.from_numpy(labels), chunk)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in ((tx.grad, wgx), (tt.grad, wgt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    n_chunks = max(s // chunk, 1)
    kept = n_chunks * (s // n_chunks)
    logits = torch.from_numpy(x[:, :kept]) @ torch.from_numpy(table).t()
    plain = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 64), torch.from_numpy(labels[:, :kept]).reshape(
            -1).long())
    assert abs(float(got) - float(plain)) <= 1e-5 * float(plain)
    if kept < s:
        assert tx.grad[:, kept:].abs().max() == 0


def _sparse_inputs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    w[:128] = 0
    x = rng.normal(size=(16, 256)).astype(np.float32)
    return w, x


def test_the_references_grad_through_a_pallas_kernel_raises():
    w, x = _sparse_inputs()
    comp, nm = rops.compress_bitmap(w, 128, 128), rops.compress_nm(w)
    q = jnp.asarray(x[:, :64].reshape(1, 16, 64))
    for f in (lambda x: rops.bitmap_spmm(x, comp, bm=16).sum(),
              lambda x: rops.bitmap_spmm(x, comp, bm=16,
                                         pipeline=False).sum(),
              lambda x: rops.nm_spmm(x, nm, bm=16).sum()):
        with pytest.raises((NotImplementedError, AssertionError)):
            jax.grad(f)(jnp.asarray(x))
    with pytest.raises((NotImplementedError, AssertionError)):
        jax.grad(lambda q: rops.flash_attention(q, q, q).sum())(q)


def test_the_kernel_wrappers_refuse_an_input_that_requires_grad():
    w, x = _sparse_inputs()
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    comp, nm = ops.compress_bitmap(wt, 128, 128), ops.compress_nm(wt)
    q = torch.from_numpy(x[:, :64].reshape(1, 16, 64))
    calls = [lambda x: ops.bitmap_spmm(x, comp),
             lambda x: ops.bitmap_spmm(x, comp, pipeline=False),
             lambda x: ops.nm_spmm(x, nm),
             lambda x: ops.flash_attention(q, x[:, :64].reshape(1, 16, 64),
                                           q)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="no backward"):
            call(xt.clone().requires_grad_())
        with torch.no_grad():
            call(xt.clone().requires_grad_())       # inference: allowed
        call(xt)                                    # nothing needs grad
    comp.blocks.requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.bitmap_spmm(xt, comp)


def test_spelled_out_derivatives_are_jaxs():
    x = np.array([0.0, -100.0, -3.0, 2.5, 30.0], np.float32)
    for port, ref in ((L.softplus, jax.nn.softplus),
                      (L.sigmoid, jax.nn.sigmoid), (L.silu, jax.nn.silu)):
        t = torch.from_numpy(x).requires_grad_()
        port(t).sum().backward()
        want = np.asarray(jax.grad(lambda v: ref(v).sum())(jnp.asarray(x)))
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-7)
        with torch.no_grad():
            assert torch.equal(port(t), port(t.detach()))
