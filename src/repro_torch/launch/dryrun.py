"""Dry run: trace every (architecture x input shape x mesh) cell at full
width on the meta device and record its roofline terms, with no real
allocation: the counterpart of the reference's ``repro.launch.dryrun``.

The reference lowers and compiles each cell under ``jax.jit`` with
``NamedSharding``s over 512 forced host devices and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and its own HLO cost reader.
The port has no compiler and no SPMD partitioner; a step is eager
PyTorch.  Per cell it

  * builds the cell's params (``Model.init(device="meta")``), optimizer
    state, decode cache and inputs (:func:`input_specs`) as meta tensors,
    and their partition specs (:mod:`repro_torch.models.partition`) on
    the production mesh (:func:`repro_torch.launch.mesh.make_production_mesh`,
    sizes only);
  * runs the step (train: ``Model.loss``, its gradients, ``adamw.apply``;
    prefill: ``hidden_states(remat=False)``; decode: ``decode_step`` over
    an ``init_cache``) under :class:`repro_torch.launch.op_cost.OpCost`,
    which counts FLOPs, perfect-fusion bytes and live bytes from the
    dispatched aten ops;
  * stands in for the reference's ``known_trip_count``: on a production
    mesh the model is traced cut to one and to two repeating units (a
    layer of a uniform stack, a gemma3 or hybrid super-block, one layer of
    each of whisper's stacks) and its FLOPs and bytes extrapolated to its
    depth, which is exact, since every unit dispatches the same ops at the
    same shapes (a full-width ``prefill_32k`` cell costs the traces of
    three units, not of 28-62).  The optimizer's update is traced whole
    (its slices do not scale with depth).  On a mesh of one device the
    step is traced at its full depth: the peak of live bytes is not
    linear in depth (where it falls in a train step moves).

The record has the reference's keys.  ``lower_s`` holds the trace
seconds; ``compile_s``, ``xla_flops_raw`` and ``xla_bytes_raw`` are
``null`` (no compiler).  ``memory_analysis`` holds the per-device
``argument_size_in_bytes`` and ``output_size_in_bytes`` (each leaf's
bytes over the mesh axes its spec names) and ``peak_memory_in_bytes``.
The reference's ``flops``, ``hlo_bytes``, ``collectives`` and
``coll_bytes`` are per device, read from post-partitioning HLO; the port
has no partitioner, so on a mesh of more than one device they and the
peak are ``null`` with ``"partitioned": false``, and the whole step's
counts stand under ``step_flops`` and ``step_bytes`` (a deliberate
divergence).  On a mesh of one device the per-device fields are the
step's.  The reference's lines that force 512 host devices have no
counterpart: the mesh is sizes only.

Artifacts land in artifacts/dryrun/<arch>__<shape>__<mesh>[__opt-...].json.

Usage (the meta device needs no card; ``--device`` is not taken):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--skip-existing]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.convert import bf16_params
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import (Mesh, data_axes_of, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.train import build_train_step, value_and_grad
from repro_torch.models import layers as L
from repro_torch.models import optflags
from repro_torch.models.partition import batch_specs, cache_specs, param_specs
from repro_torch.models.transformer import Model, input_specs
from repro_torch.optim import adamw

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun")
META = torch.device("meta")
ONE_DEVICE = Mesh(("data", "model"), (1, 1))


# long_500k is skipped for pure full-attention architectures (DESIGN.md §5).
def cell_applicable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: no sub-quadratic mechanism"
    return True, ""


@dataclasses.dataclass
class Cell:
    """One cell's step, its meta arguments and their specs (the
    reference's ``(fn, abstract_args, in_shardings)``, with specs in
    place of shardings), and what the trace splits it by."""

    fn: Callable
    args: tuple
    specs: tuple
    model: Model
    opt_cfg: Optional[adamw.AdamWConfig] = None


def build_cell(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh) -> Cell:
    """The step of one cell over meta arguments sized for ``cfg``."""
    model = Model(cfg)
    axes = mesh_axis_sizes(mesh)
    data_axes = data_axes_of(mesh)
    params = model.init(device=META)
    p_specs = param_specs(params, axes, data_axes,
                          kv_heads=cfg.n_kv_heads or None)
    inputs = input_specs(cfg, shape, device=META)
    b_specs = batch_specs(inputs, axes, data_axes)

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        opt = adamw.init(params, opt_cfg)
        # ZeRO-style: optimizer moments shard exactly like their params
        o_specs = adamw.OptState((), p_specs, p_specs, None)
        return Cell(build_train_step(model, opt_cfg), (params, opt, inputs),
                    (p_specs, o_specs, b_specs), model, opt_cfg)

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return model.hidden_states(params, batch["tokens"],
                                       batch.get("enc_frames"), remat=False)
        return Cell(prefill_step, (params, inputs), (p_specs, b_specs), model)

    # decode
    if optflags.enabled("bf16params"):
        params = bf16_params(params)
    cache = model.init_cache(shape.global_batch, shape.seq_len, device=META)
    c_specs = cache_specs(cache, axes, data_axes)

    def serve_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"], batch["pos"])

    return Cell(serve_step, (params, cache, inputs),
                (p_specs, c_specs, b_specs), model)


# ---------------------------------------------------------------------------
# Trip counts: repeating units
# ---------------------------------------------------------------------------

def repeat_units(cfg: ModelConfig) -> tuple[int, Callable[[int], ModelConfig]]:
    """The number of repeating units of ``cfg`` and ``cut(k)``, ``cfg``
    with ``k`` of them: a layer of a uniform or SSM stack, a super-block
    of a ``hybrid`` pattern (gemma3's 5 local + 1 global, recurrentgemma's
    rec, rec, attn) with its tail kept, one layer of each of an
    encoder-decoder's stacks."""
    if cfg.hybrid is not None:
        per, tail = len(cfg.hybrid.block), len(cfg.hybrid.tail)
        n, rest = divmod(cfg.n_layers - tail, per)
        if rest:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are no "
                             f"whole number of {per}-layer blocks and a "
                             f"{tail}-layer tail")
        return n, lambda k: dataclasses.replace(cfg, n_layers=k * per + tail)
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.enc_layers} encoder and "
                             f"{cfg.n_layers} decoder layers make no "
                             f"common unit")
        return cfg.n_layers, lambda k: dataclasses.replace(
            cfg, n_layers=k, enc_layers=k)
    return cfg.n_layers, lambda k: dataclasses.replace(cfg, n_layers=k)


def _traced(cfg: ModelConfig, shape: ShapeCfg
            ) -> tuple[Any, op_cost.Counted]:
    """The step of ``cfg``, traced: (its output, :class:`op_cost.Counted`).
    A train cell's stops at the gradients.  The mesh only specs the
    arguments, so the trace takes none."""
    cell = build_cell(cfg, shape, ONE_DEVICE)
    if shape.kind == "train":      # the optimizer state is live throughout
        def fn(params, opt, batch):
            return value_and_grad(cell.model.loss, params, batch)
    else:
        fn = cell.fn
    return op_cost.count(fn, *cell.args)


def _extrapolated(cfg: ModelConfig, shape: ShapeCfg
                  ) -> tuple[Any, op_cost.Counted]:
    """The step of ``cfg`` at its depth from traces of one and two units
    (the output is the one-unit trace's)."""
    n, cut = repeat_units(cfg)
    out, one = _traced(cut(1), shape)
    if n == 1:
        return out, one
    _, two = _traced(cut(2), shape)
    return out, one.extrapolate(two, n)


def _step(cfg: ModelConfig, shape: ShapeCfg, extrapolate: bool,
          traces: Optional[dict]) -> tuple[Any, op_cost.Counted]:
    """The traced step, from ``traces`` (a cache keyed by config, shape,
    flags, compute dtype and ``extrapolate``) where it holds it."""
    trace = _extrapolated if extrapolate else _traced
    if traces is None:
        return trace(cfg, shape)
    key = (cfg, shape, optflags.active(), L.COMPUTE_DTYPE, extrapolate)
    if key not in traces:
        traces[key] = trace(cfg, shape)
    return traces[key]


@dataclasses.dataclass
class StepCost:
    """One cell's step at full depth: its terms, peak live bytes, the
    per-device argument and output bytes, and the trace seconds."""

    cost: op_cost.Cost
    peak: Optional[int]
    argument_bytes: int
    output_bytes: int
    ops: int
    seconds: float


def per_device_bytes(leaves_specs, axes: dict[str, int]) -> int:
    """Σ each leaf's bytes over the mesh axes its spec names."""
    total = 0
    for leaf, spec in leaves_specs:
        shards = 1
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            shards *= math.prod(axes[a] for a in names if a is not None)
        total += op_cost.nbytes(leaf) // shards
    return total


def _pairs(trees, specs) -> list:
    """(leaf, spec) over parallel trees of tensors and specs (a spec is
    a tuple, so the spec tree is walked to the tensor tree's leaves)."""
    out = []
    if isinstance(trees, torch.Tensor):
        return [(trees, specs)]
    if isinstance(trees, dict):
        for k in trees:
            out += _pairs(trees[k], specs[k])
        return out
    if isinstance(trees, (tuple, list)):
        for t, s in zip(trees, specs):
            out += _pairs(t, s)
    return out


def step_cost(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh,
              extrapolate: bool = True,
              traces: Optional[dict] = None) -> StepCost:
    """Trace one cell (see the module docstring) under the active
    optflags: the model at its full depth, or (``extrapolate``) cut to
    one and two units, which gives the same FLOPs and bytes but not the
    peak of live bytes (where the peak falls in a train step moves with
    depth).  A step ``traces`` holds (the sweep's other mesh traced it)
    is not traced again: ``seconds`` are this call's own."""
    t0 = time.perf_counter()
    axes = mesh_axis_sizes(mesh)
    full = build_cell(cfg, shape, mesh)
    args_bytes = per_device_bytes(_pairs(full.args, full.specs), axes)
    out, counted = _step(cfg, shape, extrapolate, traces)
    cost, peak, ops = op_cost.Cost(), counted.peak, counted.ops
    cost.add(counted.cost)
    if shape.kind == "train":
        params, opt, batch = full.args
        loss = torch.empty((), device=META)
        grads = tree.map_leaves(torch.empty_like, params)
        (new_p, new_o), upd = op_cost.count(
            lambda p, g, o, b, l: adamw.apply(p, g, o, full.opt_cfg),
            params, grads, opt, batch, loss)
        cost.add(upd.cost)
        peak = None if peak is None else max(peak, upd.peak)
        ops += upd.ops
        outputs = [(loss, ())] + _pairs((new_p, new_o), full.specs[:2])
    elif shape.kind == "prefill":
        outputs = _pairs(out, batch_specs(out, axes, data_axes_of(mesh)))
    else:
        logits, _ = out
        # decode_step returns the cache it was given, updated in place
        outputs = _pairs(logits, batch_specs(logits, axes,
                                             data_axes_of(mesh))) \
            + _pairs(full.args[1], full.specs[1])
    return StepCost(cost, peak, args_bytes, per_device_bytes(outputs, axes),
                    ops, time.perf_counter() - t0)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             artifact_dir: str = ARTIFACT_DIR,
             opts: tuple[str, ...] = (), mesh: Optional[Mesh] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeCfg] = None,
             traces: Optional[dict] = None) -> dict:
    """One cell's record.  ``mesh`` (default: the production mesh),
    ``cfg`` and ``shape`` (default: the registry's) let a caller trace a
    cell of its own, as a one-device run of a cut model.  On a mesh of one
    device the step is traced at its full depth, so that its peak is
    exact; on more, cut and extrapolated.  ``traces`` caches the traced
    steps across calls (:func:`main` shares one between the meshes of a
    cell)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = ("multi" if multi_pod else "single") if mesh is None \
        else "x".join(map(str, mesh.shape))
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "ok": False, "opts": list(opts)}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        record.update(skipped=True, reason=why, ok=True)
        return record
    if "sparseffn" in opts and shape.kind != "decode":
        record.update(skipped=True, ok=True,
                      reason="sparseffn applies to serve cells only")
        return record

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    try:
        one = mesh.size == 1
        with optflags.optimizations(opts):
            sc = step_cost(cfg, shape, mesh, extrapolate=not one,
                           traces=traces)
        record.update(
            ok=True,
            lower_s=round(sc.seconds, 2),
            compile_s=None,
            partitioned=one,
            flops=sc.cost.flops if one else None,
            hlo_bytes=sc.cost.bytes if one else None,
            collectives=dict(sc.cost.coll, count=sc.cost.coll_count)
            if one else None,
            coll_bytes=sc.cost.coll_bytes if one else None,
            step_flops=sc.cost.flops,
            step_bytes=sc.cost.bytes,
            xla_flops_raw=None,
            xla_bytes_raw=None,
            devices=mesh.size,
            memory_analysis={
                "available": True,
                "argument_size_in_bytes": sc.argument_bytes,
                "output_size_in_bytes": sc.output_bytes,
                "peak_memory_in_bytes": sc.peak if one else None},
            traced_ops=sc.ops,
            params_count=cfg.params_count(),
            active_params=cfg.active_params_count(),
        )
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        record.update(error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--opts", default="",
                    help="comma-separated optflags (padheads,replkv,"
                         "saveremat,maskedkv,sparseffn); artifacts get an "
                         "__opt-<flags> suffix")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    opts = tuple(o for o in args.opts.split(",") if o)
    suffix = f"__opt-{'-'.join(opts)}" if opts else ""

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            traces: dict = {}           # the meshes share the traced step
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                path = os.path.join(
                    args.out, f"{arch}__{shape}__{mesh_name}{suffix}.json")
                if args.skip_existing and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("ok"):
                            print(f"[skip] {arch} {shape} {mesh_name}")
                            continue
                print(f"[cell] {arch} {shape} {mesh_name} opts={opts} ...",
                      flush=True)
                rec = run_cell(arch, shape, multi, args.out, opts=opts,
                               traces=traces)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("skipped"):
                    print(f"  skipped: {rec['reason']}")
                elif rec["ok"]:
                    mem = rec["memory_analysis"]
                    print(f"  ok: trace={rec['lower_s']}s "
                          f"step_flops={rec['step_flops']:.3e} "
                          f"step_bytes={rec['step_bytes']:.3e} "
                          f"args/device={mem['argument_size_in_bytes']:.3e}"
                          f" B", flush=True)
                else:
                    n_fail += 1
                    print(f"  FAIL: {rec['error']}", flush=True)
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
