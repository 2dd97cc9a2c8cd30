"""End-to-end training driver: the port of the reference's
``repro.launch.train`` on one device.

The loop is the reference's: a deterministic resumable data pipeline
(:mod:`repro_torch.data.pipeline`), a train step of ``Model.loss`` with
remat and its gradients followed by AdamW (optionally with int8 gradient
compression, :mod:`repro_torch.optim.adamw`), periodic atomic checkpoints
carrying the pipeline's state (:mod:`repro_torch.checkpoint.ckpt`),
bounded retry through ``StepGuard`` and straggler monitoring.  The step
runs eagerly; ``torch.cuda.synchronize()`` stands where the reference
blocks on the loss, so a step's time is the device's.  The reference's
mesh branch is the port's too: with more than one device to train on
(``--device cuda`` on a host of several cards) :func:`main` trains on the
reference's (data 2, model 1) mesh, data-parallel in one process
(:func:`build_data_parallel_step`); ``--device cuda:N`` trains on card N
alone.

What the guard retries is the port's ``StepGuard``'s:
``NonFiniteError`` and ``KernelFault``, neither of which the dense eager
step raises.  Any other error (a ``RuntimeError`` or ``OSError`` among
them, which the reference retries once and then answers by restoring the
latest checkpoint) propagates: on the card those are out-of-memory and
sticky launch errors, which a replay of the same step meets again.

Usage (on the card; ``--device cpu`` runs on the host)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      [--reduced] --steps 50 --batch 8 --seq 128 [--lr 3e-4] \\
      [--ckpt-dir D --ckpt-every 50 [--resume]] [--grad-compress] \\
      [--log-every 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PipelineState, TokenPipeline
from repro_torch.device import resolve, synchronize
from repro_torch.launch import data_parallel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.runtime.fault import StepGuard, StragglerMonitor

PyTree = Any


def value_and_grad(fn: Callable, params: PyTree, *args
                   ) -> tuple[torch.Tensor, PyTree]:
    """``fn(params, *args)`` (a scalar) and its gradient with respect to
    every leaf of ``params``, as ``jax.value_and_grad``: a leaf the value
    does not read gets zeros.  ``params`` itself is not marked for grad."""
    live = [p.detach().requires_grad_() for p in tree.leaves(params)]
    value = fn(tree.unflatten(params, live), *args)
    grads = torch.autograd.grad(value, live, allow_unused=True,
                                materialize_grads=True)
    return value.detach(), tree.unflatten(params, list(grads))


def build_train_step(model: Model, opt_cfg: adamw.AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model.loss, params, batch)
        params, opt_state = adamw.apply(params, grads, opt_state, opt_cfg)
        return loss, params, opt_state
    return train_step


def build_data_parallel_step(model: Model, opt_cfg: adamw.AdamWConfig,
                             devices: list):
    """The train step over replicas, one per device: each replica's loss
    and gradients on its rows of the global batch, the gradients summed in
    replica order on the first replica's device and scaled to the global
    batch's mean (what the reference's step under GSPMD differentiates:
    the rows split evenly, so the global mean is the mean of the replicas'
    means), then the same AdamW update on every replica.  ``params`` and
    ``opt_state`` are lists, one per replica; the new params are asserted
    bit for bit equal across replicas.  ``grad_compress`` acts on the
    summed gradient, where the reference's ``adamw.apply`` meets it."""
    n = len(devices)

    def train_step(params, opt_state, batch):
        rows = {k: data_parallel.split_rows(v, n) for k, v in batch.items()}
        losses, grads = [], []
        for i, (p, dev) in enumerate(zip(params, devices)):
            with data_parallel.device_ctx(dev):
                loss, g = value_and_grad(
                    model.loss, p, {k: v[i].to(dev) for k, v in rows.items()})
            losses.append(loss)
            grads.append(g)
        first = devices[0]
        total = grads[0]
        for g in grads[1:]:
            total = tree.map_leaves(lambda a, b: a + b.to(a.device), total, g)
        # tensor divisors: CUDA multiplies by a Python scalar's reciprocal
        scale = torch.tensor(float(n), device=first)
        total = tree.map_leaves(lambda a: a / scale.to(a.dtype), total)
        loss = sum(x.to(first) for x in losses) / scale
        new = []
        for p, o, dev in zip(params, opt_state, devices):
            with data_parallel.device_ctx(dev):
                new.append(adamw.apply(
                    p, tree.map_leaves(lambda a: a.to(dev), total), o,
                    opt_cfg))
        params = [p for p, _ in new]
        if not data_parallel.params_equal(params):
            raise AssertionError("the replicas' params differ after an "
                                 "update")
        return loss, params, [o for _, o in new]
    return train_step


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: every step's loss (replays included),
    the final params and optimizer state (replica 0's over a mesh), the
    pipeline state, the guard's events, the straggler monitor and every
    replica's params (one entry without a mesh)."""
    losses: list
    params: PyTree
    opt_state: adamw.OptState
    pstate: PipelineState
    events: list
    monitor: StragglerMonitor
    replicas: list = dataclasses.field(default_factory=list)


def train(cfg: ModelConfig, params: PyTree, args: argparse.Namespace,
          device="cuda", mesh: Optional[mesh_mod.Mesh] = None) -> TrainRun:
    """The reference's training loop from ``params`` (``args`` as
    :func:`main` parses them), printing its lines.  A ``mesh`` of more
    than one device trains data-parallel
    (:func:`build_data_parallel_step`): params and AdamW state per
    replica, the global batch split by rows; the checkpoint is replica
    0's, restored onto every replica.  A mesh whose ``model`` axis is
    larger than 1 raises ``NotImplementedError``; one of one device
    trains as ``None`` does."""
    dev = resolve(device)
    devs = [dev]
    if mesh is not None and mesh.size > 1:
        devs = data_parallel.data_devices(mesh, "train")
        if devs[0].type != dev.type:
            raise ValueError(f"train: device {dev} is not of the mesh's "
                             f"type ({devs[0].type})")
    model = Model(cfg)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=min(20, args.steps // 5),
                                grad_compress=args.grad_compress)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch,
                         enc_seq=cfg.enc_seq if cfg.family == "encdec" else 0,
                         d_model=cfg.d_model, device=devs[0])
    # one entry per replica (one without a mesh)
    params = data_parallel.replicate(params, devs)
    opt_state = [adamw.init(p, opt_cfg) for p in params]
    pstate = PipelineState()

    def do_restore():
        nonlocal params, opt_state, pstate
        if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
            restored, extra = ckpt.restore(
                args.ckpt_dir, {"params": params[0], "opt": opt_state[0]})
            params = data_parallel.replicate(restored["params"], devs)
            opt_state = data_parallel.replicate(restored["opt"], devs)
            pstate = PipelineState.from_dict(extra["pipeline"])

    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        do_restore()
        print(f"[resume] step {pstate.step}")

    if len(devs) > 1:
        step_fn = build_data_parallel_step(model, opt_cfg, devs)
    else:
        one = build_train_step(model, opt_cfg)

        def step_fn(ps, os_, batch):
            loss, p, o = one(ps[0], os_[0], batch)
            return loss, [p], [o]
    monitor = StragglerMonitor()
    guard = StepGuard(max_retries=1, on_restore=do_restore)
    losses = []
    while pstate.step < args.steps:
        batch = pipe.batch_at(pstate.step)
        t0 = time.perf_counter()

        def one_step():
            out = step_fn(params, opt_state, batch)
            for d in dict.fromkeys(devs):
                synchronize(d)              # honest step timing
            return out

        out = guard.run(pstate.step, one_step)
        if out is None:
            continue                        # restored; replay from ckpt step
        loss, params, opt_state = out
        dt = time.perf_counter() - t0
        slow = monitor.observe(pstate.step, dt)
        pstate = PipelineState(pstate.step + 1)
        losses.append(float(loss))
        if pstate.step % args.log_every == 0 or pstate.step == 1:
            print(f"step {pstate.step:5d} loss {float(loss):.4f} "
                  f"({dt*1e3:.0f} ms{' STRAGGLER' if slow else ''})",
                  flush=True)
        if args.ckpt_dir and pstate.step % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, pstate.step,
                      {"params": params[0], "opt": opt_state[0]},
                      extra={"pipeline": pstate.to_dict()})
            ckpt.prune_old(args.ckpt_dir, keep=3)

    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, pstate.step,
                  {"params": params[0], "opt": opt_state[0]},
                  extra={"pipeline": pstate.to_dict()})
    n = max(len(losses) // 10, 1)
    print(f"[done] first-10 mean loss {sum(losses[:n])/n:.4f} → "
          f"last-10 mean {sum(losses[-n:])/n:.4f}")
    return TrainRun(losses, params[0], opt_state[0], pstate, guard.events,
                    monitor, params)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_dev = len(mesh_mod.devices(args.device))
    mesh = mesh_mod.make_small_mesh(data=min(2, n_dev), model=1,
                                    device=args.device) if n_dev > 1 \
        else None
    params = Model(cfg).init(seed=0, device=args.device)
    return train(cfg, params, args, device=args.device, mesh=mesh)


if __name__ == "__main__":
    main()
