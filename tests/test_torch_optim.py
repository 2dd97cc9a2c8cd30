"""The port's optimizer, data pipeline and checkpoints
(``repro_torch.optim.adamw``, ``repro_torch.data.pipeline``,
``repro_torch.checkpoint.ckpt``) held to the reference's
``tests/test_substrate.py`` case for case, and to the reference's own
functions on the same inputs:

* the pipeline's batches equal the reference's exactly (tokens, labels,
  encoder frames; several steps and hosts);
* ``schedule``, ``_global_norm``, ``_quantize_int8`` (ties rounded half to
  even), ``compress_grads`` and AdamW steps, with and without int8
  compression, on the reference's own gradients of reduced chatglm3-6b:
  within 1e-6 · max|leaf| of the reference's (the second moment 2e-6);
* checkpoints: the reference's layout and ``meta.json`` (its ``treedef``
  string too), and a directory written by either package restores in the
  other.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.configs import get_config as rget_config
from repro.data.pipeline import PipelineState as RPipelineState
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro.optim import adamw as radamw
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.optim import adamw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _pipe(**kw) -> TokenPipeline:
    return TokenPipeline(device="cpu", **kw)


# ---------------------------------------------------------------------------
# data pipeline (test_substrate.py:27-57)
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_and_resumable():
    p = _pipe(vocab=101, seq_len=16, global_batch=4)
    b1 = p.batch_at(5)
    b2 = p.batch_at(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    # resuming from a checkpointed state replays the same stream
    it = p.iterate(PipelineState(3))
    st, batch = next(it)
    assert torch.equal(batch["tokens"], p.batch_at(3)["tokens"])
    assert st.step == 4


def test_pipeline_shards_disjoint_and_elastic():
    p = _pipe(vocab=101, seq_len=8, global_batch=8, n_hosts=2, host_id=0)
    q = p.reshard(2, 1)
    b0, b1 = p.batch_at(0), q.batch_at(0)
    assert b0["tokens"].shape == (4, 8)
    assert not torch.equal(b0["tokens"], b1["tokens"])


def test_pipeline_labels_shifted():
    p = _pipe(vocab=101, seq_len=16, global_batch=2)
    b = p.batch_at(0)
    # labels are next tokens — mostly the affine map of tokens
    nxt = (b["tokens"].numpy() * 31 + 7) % 101
    match = np.mean(nxt == b["labels"].numpy())
    assert match > 0.7


@pytest.mark.parametrize("kw", [
    dict(vocab=101, seq_len=16, global_batch=4),
    dict(vocab=512, seq_len=33, global_batch=8, n_hosts=2, host_id=1,
         seed=7),
    dict(vocab=512, seq_len=12, global_batch=2, enc_seq=16, d_model=8)])
def test_pipeline_batches_equal_the_references(kw):
    for step in (0, 1, 9):
        want = RPipeline(**kw).batch_at(step)
        got = _pipe(**kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device.type == "cpu"
            assert v.dtype == (torch.float32 if k == "enc_frames"
                               else torch.int32)
            assert np.array_equal(v.numpy(), np.asarray(want[k]))
    assert PipelineState.from_dict(RPipelineState(4).to_dict()) == \
        PipelineState(4)


# ---------------------------------------------------------------------------
# optimizer (test_substrate.py:63-111)
# ---------------------------------------------------------------------------

def _toy_params():
    return {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}


def _grad(loss, params):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    g = torch.autograd.grad(loss(live), list(live.values()),
                            allow_unused=True, materialize_grads=True)
    return dict(zip(live, g))


def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                            weight_decay=0.0)
    params = _toy_params()
    state = adamw.init(params, cfg)

    def loss(p):
        return torch.sum(torch.square(p["w"] - 2.0)) + \
            torch.sum(torch.square(p["b"]))

    l0 = loss(params)
    for _ in range(50):
        params, state = adamw.apply(params, _grad(loss, params), state, cfg)
    assert loss(params) < l0 * 0.1


def test_adamw_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(adamw.schedule(torch.tensor(5), cfg)) == pytest.approx(0.5)
    assert float(adamw.schedule(torch.tensor(10), cfg)) == \
        pytest.approx(1.0)
    assert float(adamw.schedule(torch.tensor(100), cfg)) == pytest.approx(
        cfg.lr * cfg.min_lr_frac)


def test_grad_compression_error_feedback_converges():
    cfg = adamw.AdamWConfig(lr=0.05, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, grad_compress=True)
    params = _toy_params()
    state = adamw.init(params, cfg)

    def loss(p):
        return torch.sum(torch.square(p["w"] - 1.5))

    for _ in range(80):
        params, state = adamw.apply(params, _grad(loss, params), state, cfg)
    assert float(loss(params)) < 0.05
    assert state.err is not None


def test_schedule_equals_the_references():
    for cfg in (adamw.AdamWConfig(), adamw.AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=40),
            adamw.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7)):
        rcfg = radamw.AdamWConfig(**cfg.__dict__)
        for step in range(0, cfg.total_steps + 3, 3):
            got = adamw.schedule(torch.tensor(step, dtype=torch.int32), cfg)
            want = radamw.schedule(jnp.asarray(step, jnp.int32), rcfg)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6,
                                               abs=1e-12)


def test_quantize_int8_rounds_half_to_even_as_the_reference():
    # scale = 127 / 127 = 1: g / scale lands on exact halves
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.49],
                 np.float32)
    q, scale = adamw._quantize_int8(torch.from_numpy(g))
    rq, rscale = radamw._quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and float(scale) == float(rscale) == 1.0
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -126, 3]
    z, zs = adamw._quantize_int8(torch.zeros(3))
    assert float(zs) == pytest.approx(1e-8 / 127) and not z.any()


@pytest.fixture(scope="module")
def reduced_grads():
    """The reference's fp32 params and gradients of reduced chatglm3-6b on
    one batch, as numpy trees."""
    rcfg = rget_config("chatglm3-6b").reduced()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (RL, rattn):
            mp.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
        rparams = RModel(rcfg).init(jax.random.key(0))
        batch = RPipeline(vocab=rcfg.vocab, seq_len=32,
                          global_batch=2).batch_at(0)
        grads = jax.jit(jax.grad(RModel(rcfg).loss))(rparams, batch)
    return jax.tree.map(np.asarray, rparams), jax.tree.map(np.asarray, grads)


def _close(got, want, tol: float = 1e-6) -> None:
    got, want = tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g.astype(np.float64) - w).max() <= \
            tol * max(np.abs(w).max(), 1e-30)


def test_global_norm_and_compress_grads_equal_the_references(reduced_grads):
    _, grads = reduced_grads
    tg = params_from_numpy(grads, "cpu")
    got = adamw._global_norm(tg)
    want = radamw._global_norm(jax.tree.map(jnp.asarray, grads))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    err = jax.tree.map(lambda g: (0.3 * g).astype(np.float32), grads)
    deq, new_err = adamw.compress_grads(tg, params_from_numpy(err, "cpu"))
    rdeq, rerr = radamw.compress_grads(jax.tree.map(jnp.asarray, grads),
                                       jax.tree.map(jnp.asarray, err))
    _close(deq, rdeq)
    _close(new_err, rerr)


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_steps_equal_the_references(reduced_grads, compress):
    """Three steps on the reference's gradients (scaled a step apart, so
    clipping and error feedback both act): params, moments, residuals and
    the step counter."""
    params, grads = reduced_grads
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40,
                            grad_compress=compress)
    rcfg = radamw.AdamWConfig(**cfg.__dict__)
    p, rp = params_from_numpy(params, "cpu"), jax.tree.map(jnp.asarray,
                                                          params)
    st, rst = adamw.init(p, cfg), radamw.init(rp, rcfg)
    before = [t.clone() for t in tree.leaves(p) + tree.leaves(st)]
    for k, scale in enumerate((1.0, 40.0, 0.5)):
        g = jax.tree.map(lambda x: (x * scale).astype(np.float32), grads)
        p1, st1 = adamw.apply(p, params_from_numpy(g, "cpu"), st, cfg)
        if k == 0:                   # apply writes into neither input
            assert all(torch.equal(a, b) for a, b in zip(
                before, tree.leaves(p) + tree.leaves(st)))
        p, st = p1, st1
        rp, rst = radamw.apply(rp, jax.tree.map(jnp.asarray, g), rst, rcfg)
        _close(p, rp)
        _close([st.step, st.mu, st.err], [rst.step, rst.mu, rst.err])
        # the second moment holds the clip scale squared: the reference's
        # fp32 norm (a reduction in XLA's order, ~1e-7 .. 8e-7 off its
        # exact value here) is off twice as far there
        _close(st.nu, rst.nu, 2e-6)
    assert int(st.step) == int(rst.step) == 3
    assert (st.err is None) == (not compress)


def test_adamw_slices_give_the_whole_leaf_pass(reduced_grads, monkeypatch):
    """A leaf walked in slices gives what one pass over it gives."""
    params, grads = reduced_grads
    cfg = adamw.AdamWConfig(grad_compress=True)
    p, g = params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu")
    whole = adamw.apply(p, g, adamw.init(p, cfg), cfg)
    monkeypatch.setattr(adamw, "SLICE", 1000)
    sliced = adamw.apply(p, g, adamw.init(p, cfg), cfg)
    for a, b in zip(tree.leaves(whole), tree.leaves(sliced)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# checkpointing (test_substrate.py:113-130)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_latest(tmp_path):
    t = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    ckpt.save(str(tmp_path), 3, t, extra={"pipeline": {"step": 3}})
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = tree.map_leaves(torch.zeros_like, t)
    restored, extra = ckpt.restore(str(tmp_path), like, step=3)
    assert torch.equal(restored["a"], t["a"])
    assert extra["pipeline"]["step"] == 3


def test_checkpoint_prune_old(tmp_path):
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    ckpt.prune_old(str(tmp_path), keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_shape_and_count_mismatch_raise(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros((2, 2))})
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros((3, 3))})
    with pytest.raises(AssertionError):
        ckpt.restore(str(tmp_path), {"x": torch.zeros((2, 2)),
                                     "y": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"x": torch.zeros((2, 2))})


def _train_trees(compress: bool):
    """The train loop's checkpoint tree, in both packages, with values."""
    rng = np.random.default_rng(3)
    params = {"embed": rng.normal(size=(8, 4)).astype(np.float32),
              "blocks": {"ln1": rng.normal(size=(2, 4)).astype(np.float32),
                         "attn": {"wq": rng.normal(size=(2, 4, 4)).astype(
                             np.float32)}},
              "final_norm": np.zeros(4, np.float32)}
    cfg = adamw.AdamWConfig(grad_compress=compress)
    rcfg = radamw.AdamWConfig(grad_compress=compress)
    p = params_from_numpy(params, "cpu")
    grads = tree.map_leaves(lambda t: t * 0.1 + 0.01, p)
    p, st = adamw.apply(p, grads, adamw.init(p, cfg), cfg)
    rp = jax.tree.map(jnp.asarray, params)
    rp, rst = radamw.apply(rp, jax.tree.map(lambda t: jnp.asarray(_np(t)),
                                            grads), radamw.init(rp, rcfg),
                           rcfg)
    return {"params": p, "opt": st}, {"params": rp, "opt": rst}


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoints_restore_across_the_packages(tmp_path, compress):
    ours, theirs = _train_trees(compress)
    extra = {"pipeline": {"step": 5}}
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(a, 5, ours, extra=extra)
    rckpt.save(b, 5, theirs, extra=extra)
    # the same layout and meta.json, treedef string included
    for d in (a, b):
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000005"]
        assert sorted(os.listdir(os.path.join(d, "step_00000005"))) == \
            ["meta.json", "shard_0.npz"]
    metas = [json.load(open(os.path.join(d, "step_00000005", "meta.json")))
             for d in (a, b)]
    assert metas[0] == metas[1]
    assert tree.describe(ours) == str(jax.tree.structure(theirs))
    # the port's directory in the reference, the reference's in the port
    got, gextra = rckpt.restore(a, jax.tree.map(jnp.zeros_like, theirs))
    assert gextra == extra
    for x, y in zip(jax.tree.leaves(got), tree.leaves(ours)):
        assert np.array_equal(np.asarray(x), _np(y))
    like = tree.map_leaves(torch.zeros_like, ours)
    got, gextra = ckpt.restore(b, like)
    assert gextra == extra and isinstance(got["opt"], adamw.OptState)
    assert (got["opt"].err is None) == (not compress)
    for x, y, z in zip(tree.leaves(got), jax.tree.leaves(theirs),
                       tree.leaves(like)):
        assert x.dtype == z.dtype
        assert np.array_equal(_np(x), np.asarray(y))
