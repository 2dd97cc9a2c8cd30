"""The port's training loop (``repro_torch.launch.train``) against the
reference's:

* the counterpart of ``tests/test_system.py::
  test_train_loop_with_failure_and_resume`` (reduced chatglm3-6b, bf16):
  the loss falls over 20 steps, and a restore from the step-10 checkpoint
  replays steps 10-12 to rtol 1e-5;
* ``train`` (the loop of the CLI's ``main``) from the reference's
  ``Model.init`` weights, with and without ``--grad-compress``, against
  the reference's jitted ``build_train_step`` over the same batches at
  fp32: every step's loss within 1e-4 relative; its printed lines;
* the CLI: checkpoints every ``--ckpt-every`` steps, ``prune_old(keep=3)``
  and a final save, as the reference CLI lays them out; ``--resume``
  prints ``[resume] step K`` and carries on from there;
* what the loop's ``StepGuard`` retries: ``NonFiniteError`` (once, then a
  restore from the latest checkpoint and a replay), while a
  ``RuntimeError`` propagates (deliberate divergence: the reference's
  guard retries it and restores);
* the CLI's weights are the port's own ``Model.init`` (a seeded
  ``torch.Generator``, not JAX's threefry), so its losses from ``--arch``
  alone differ from the reference CLI's (pinned).
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.data.pipeline import TokenPipeline as RPipeline
from repro.launch import train as rtrain
from repro.models import attention as rattn
from repro.models import layers as RL
from repro.models.transformer import Model as RModel
from repro.optim import adamw as radamw
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault import NonFiniteError


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small ops: the suite
    runs several workers on the host's cores, and a thread pool per op
    then costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    rcfg = rget_config("chatglm3-6b").reduced()
    rparams = RModel(rcfg).init(jax.random.key(0))
    return rcfg, get_config("chatglm3-6b").reduced(), rparams


def _params(rparams):
    return params_from_numpy(jax.tree.map(np.asarray, rparams), "cpu")


def test_train_loop_with_failure_and_resume(tmp_path, reduced):
    """Loss decreases over a short run; a mid-run restore replays exactly."""
    _, cfg, rparams = reduced
    model = Model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4,
                         device="cpu")
    params = _params(rparams)
    state = adamw.init(params, opt_cfg)
    step = train.build_train_step(model, opt_cfg)

    losses = []
    for i in range(20):
        loss, params, state = step(params, state, pipe.batch_at(i))
        losses.append(float(loss))
        if i == 9:
            ckpt.save(str(tmp_path), 10, {"p": params, "o": state},
                      extra={"pipeline": PipelineState(10).to_dict()})
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

    # crash after step 14 → restore from step 10 → replay is exact
    restored, extra = ckpt.restore(str(tmp_path), {"p": params, "o": state})
    rp, ro = restored["p"], restored["o"]
    ps = PipelineState.from_dict(extra["pipeline"])
    assert ps.step == 10
    replay = []
    for i in range(ps.step, 13):
        loss, rp, ro = step(rp, ro, pipe.batch_at(i))
        replay.append(float(loss))
    np.testing.assert_allclose(replay, losses[10:13], rtol=1e-5)


def _args(**kw) -> argparse.Namespace:
    return train.parse_args([f"--{k.replace('_', '-')}={v}"
                             for k, v in kw.items()
                             if not isinstance(v, bool)]
                            + [f"--{k.replace('_', '-')}"
                               for k, v in kw.items() if v is True]
                            + ["--arch", "chatglm3-6b", "--device", "cpu"])


def _reference_losses(rcfg, rparams, steps: int, compress: bool):
    """The reference CLI's loop body: its jitted train step over the
    pipeline's batches, with the CLI's optimizer settings."""
    opt_cfg = radamw.AdamWConfig(lr=1e-3, total_steps=steps,
                                 warmup_steps=min(20, steps // 5),
                                 grad_compress=compress)
    pipe = RPipeline(vocab=rcfg.vocab, seq_len=32, global_batch=4)
    step = jax.jit(rtrain.build_train_step(RModel(rcfg), opt_cfg))
    params, state, losses = rparams, radamw.init(rparams, opt_cfg), []
    for i in range(steps):
        loss, params, state = step(params, state, pipe.batch_at(i))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("compress", [False, True])
def test_train_equals_the_references_loop(reduced, compress, monkeypatch,
                                          capsys):
    rcfg, cfg, rparams = reduced
    for mod in (RL, rattn):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    steps = 12
    want = _reference_losses(rcfg, rparams, steps, compress)
    run = train.train(cfg, _params(rparams), _args(
        steps=steps, batch=4, seq=32, lr=1e-3, log_every=5,
        grad_compress=compress), device="cpu")
    np.testing.assert_allclose(run.losses, want, rtol=1e-4)
    assert run.pstate.step == steps and int(run.opt_state.step) == steps
    assert (run.opt_state.err is not None) == compress
    if compress:
        assert all(bool(torch.isfinite(e).all())
                   for e in tree.leaves(run.opt_state.err))
    assert not run.events
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" loss ")[0] for ln in lines[:-1]] == \
        ["step     1", "step     5", "step    10"]
    n = max(steps // 10, 1)
    assert lines[-1] == (f"[done] first-10 mean loss "
                         f"{sum(run.losses[:n]) / n:.4f} → last-10 mean "
                         f"{sum(run.losses[-n:]) / n:.4f}")


def _cli(argv, tmp, resume=False):
    return ["--arch", "chatglm3-6b", "--reduced", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp), "--ckpt-every", "2",
            "--log-every", "1"] + argv + (["--resume"] if resume else [])


def test_the_cli_checkpoints_and_resumes_as_the_references(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """Both CLIs on the same arguments: the same checkpoint directories
    (every 2 steps, pruned to the newest 3, then the final save) and the
    same resume line; the port's restored state is its own last one."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    run = train.main(_cli(["--steps", "7", "--device", "cpu"], port))
    monkeypatch.setattr(sys, "argv", ["train"] + _cli(["--steps", "7"], ref))
    rtrain.main()
    capsys.readouterr()
    listing = [sorted(os.listdir(d)) for d in (port, ref)]
    # pruned to the newest 3 at each periodic save; the final save after
    assert listing[0] == listing[1] == [
        "LATEST", "step_00000002", "step_00000004", "step_00000006",
        "step_00000007"]
    assert ckpt.latest_step(str(port)) == 7

    resumed = train.main(_cli(["--steps", "9", "--device", "cpu"], port,
                              resume=True))
    monkeypatch.setattr(sys, "argv", ["train"] + _cli(["--steps", "9"], ref,
                                                      resume=True))
    rtrain.main()
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("[resume]")] == \
        ["[resume] step 7", "[resume] step 7"]
    assert len(resumed.losses) == 2 and resumed.pstate.step == 9
    # the resumed run started from the first run's final params
    params = run.params
    restored, _ = ckpt.restore(str(port), {"params": params,
                                           "opt": run.opt_state}, step=7)
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves(restored["params"]), tree.leaves(params)))


def test_the_clis_weights_are_the_ports_own_init(reduced):
    """``--arch`` alone initialises with the port's seeded generator: the
    same tree and shapes as the reference's ``Model.init``, other values
    (so the two CLIs' losses differ; tests pass the reference's weights
    to ``train`` instead)."""
    rcfg, cfg, rparams = reduced
    got = Model(cfg).init(seed=0, device="cpu")
    want = jax.tree.leaves(rparams)
    assert [tuple(t.shape) for t in tree.leaves(got)] == \
        [tuple(w.shape) for w in want]
    assert not np.allclose(got["embed"].numpy(),
                           np.asarray(rparams["embed"]))


class _Failing:
    """A train step that raises ``error`` at pipeline step ``at`` the
    first ``times`` times it is called there."""

    def __init__(self, step_fn, pipe_steps: list, at: int, times: int,
                 error):
        self.step_fn, self.at, self.left, self.error = \
            step_fn, at, times, error
        self.steps = pipe_steps

    def __call__(self, params, opt_state, batch):
        if self.steps[-1] == self.at and self.left:
            self.left -= 1
            raise self.error
        return self.step_fn(params, opt_state, batch)


def _guarded_run(tmp_path, reduced, monkeypatch, at, times, error):
    _, cfg, rparams = reduced
    seen = []
    orig_batch = TokenPipeline.batch_at

    def batch_at(self, step):
        seen.append(step)
        return orig_batch(self, step)

    monkeypatch.setattr(TokenPipeline, "batch_at", batch_at)
    build = train.build_train_step
    monkeypatch.setattr(train, "build_train_step", lambda m, c: _Failing(
        build(m, c), seen, at, times, error))
    run = train.train(cfg, _params(rparams), _args(
        steps=6, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=2),
        device="cpu")
    return run, seen


def test_the_loop_retries_a_non_finite_step_then_restores(tmp_path, reduced,
                                                          monkeypatch):
    """Twice non-finite at step 5: one retry, then the step-4 checkpoint
    and a replay of step 4; the losses are an undisturbed run's."""
    clean, _ = _guarded_run(tmp_path / "clean", reduced, monkeypatch, 5, 0,
                            None)
    run, seen = _guarded_run(tmp_path / "faulty", reduced, monkeypatch, 5, 2,
                             NonFiniteError("nan loss"))
    assert [e.action for e in run.events] == ["retry", "restore"]
    assert [e.step for e in run.events] == [5, 5]
    assert seen == [0, 1, 2, 3, 4, 5, 4, 5]
    assert run.losses[:5] == clean.losses[:5]
    assert run.losses[5:] == clean.losses[4:]


def test_the_loop_lets_a_runtime_error_propagate(tmp_path, reduced,
                                                 monkeypatch):
    """Deliberate divergence: the reference's guard retries a
    RuntimeError (and OSError) once, then restores; the port's raises it
    at once (on the card: out of memory, a sticky launch error)."""
    with pytest.raises(RuntimeError, match="launch failure"):
        _guarded_run(tmp_path, reduced, monkeypatch, 3, 1,
                     RuntimeError("launch failure"))
    assert ckpt.latest_step(str(tmp_path)) == 2
