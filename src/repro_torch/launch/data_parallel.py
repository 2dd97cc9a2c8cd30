"""Data-parallel execution over a mesh, one process driving every device.

The reference gets this from GSPMD: under a mesh its serving and training
entry points place the batch on the ``data`` axis (and ``pod``, where there
is one), and one jitted program runs on every device.  The port has no
counterpart module: one process enqueues each replica's work on its own
device, in mesh order, before it reads anything back.

* :func:`data_devices` — a data mesh's replicas: its devices in grid
  order.  Only the ``pod`` and ``data`` axes may be larger than 1 there
  (training); a mesh may repeat a device, as the reference's forced host
  devices stand in for several.
* :func:`replicate` — a copy of a tree (params, a compressed store,
  optimizer state) per replica.  The first replica on a device takes the
  tree moved there (the caller's own tensors where they already lie on
  it); a replica on a device that an earlier one holds gets a clone, so
  every replica's payload, caches and optimizer state are its own.
* :func:`split_rows` / :func:`gather` — the row split of a batch in mesh
  order, replica i taking rows ``[i·B/d, (i+1)·B/d)``, and the rows put
  back in that order on the first replica's device.
* :class:`Replicated` — one model served data-parallel, with the serving
  surface (``prefill`` / ``init_cache`` / ``decode_step``): each replica
  has a model object of its own (so its own CUDA graphs,
  :func:`repro_torch.launch.compiled.graphs`), its params and store on its
  device, and a cache of its own; a batch's rows split over the replicas
  and their outputs come back gathered.  :mod:`repro_torch.launch.serve`
  and :mod:`repro_torch.runtime.guard` serve it as they serve one model.
  Over a mesh whose ``model`` axis is larger than 1 each replica is a
  :class:`~repro_torch.launch.tensor_parallel.TensorParallel` group on
  its row of the grid (:func:`tensor_groups`), which steps eagerly; a
  group without a one-pass prefill (gemma3, a window) ingests its rows'
  prompts through that step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.device import device_ctx
from repro_torch.exec.dispatch import CompressedModel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import tensor_parallel as tp_mod
from repro_torch.launch.tensor_parallel import Shards, TensorParallel, _to


def data_devices(mesh: mesh_mod.Mesh, what: str = "data_devices"
                 ) -> list[torch.device]:
    """The mesh's replicas, one device each, in grid order (``pod`` major,
    then ``data``): the order the reference splits a batch's rows in."""
    mesh_mod.check_data_only(mesh, what)
    return [torch.device(d) for d in mesh.devices.flat]


def replicate(tree: Any, devices: list[torch.device]) -> list:
    """A copy of ``tree`` per device: moved to the first replica on each
    device, cloned for every later replica on the same device."""
    seen: set = set()
    out = []
    for dev in devices:
        out.append(_to(tree, dev, clone=dev in seen))
        seen.add(dev)
    return out


def rows_each(batch: int, n: int) -> int:
    """The rows each of ``n`` replicas takes of a batch of ``batch``."""
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{n} replicas")
    return batch // n


def split_rows(x, n: int) -> list:
    """``x``'s rows in ``n`` equal parts, in order (views)."""
    rows = rows_each(x.shape[0], n)
    return [x[i * rows:(i + 1) * rows] for i in range(n)]


def gather(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The parts' rows, in order, on ``device``."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


@dataclasses.dataclass(eq=False)
class Replicated:
    """``models[i]`` over ``params[i]`` on ``devices[i]`` serves rows
    ``[i·B/d, (i+1)·B/d)`` of a batch of B.  The serving surface takes
    ``params`` (this object's :attr:`params`) and a cache as
    :class:`Shards`; every tensor it returns lies on ``devices[0]``, rows
    in batch order."""

    models: list
    params: Shards
    devices: list

    def each(self, fn: Callable) -> "Replicated":
        """``fn`` of every replica's model, over the same params and
        devices (a demoted store, the inner dense model)."""
        return Replicated([fn(m) for m in self.models], self.params,
                          self.devices)

    def _arg(self, x: Any, i: int, n: int) -> Any:
        if isinstance(x, Shards):
            return x[i]
        if isinstance(x, torch.Tensor):
            x = x if x.ndim == 0 else split_rows(x, n)[i]
            return x.to(self.devices[i], non_blocking=True)
        if isinstance(x, np.ndarray):
            return split_rows(x, n)[i]
        return x

    def _combine(self, parts: list) -> Any:
        first = parts[0]
        if isinstance(first, tuple):
            return tuple(self._combine(list(p)) for p in zip(*parts))
        if isinstance(first, torch.Tensor):
            return gather(parts, self.devices[0])
        if isinstance(first, dict):
            return Shards(enumerate(parts))
        return first if all(p is None for p in parts) else parts

    def map(self, fn: Callable, *args) -> Any:
        """``fn(i, models[i], *args_i)`` for every replica in order, each
        under its device.  A :class:`Shards` argument gives replica i its
        entry, a tensor its rows (a 0-d one itself) on its device, an
        array its rows; anything else passes as it is.  The results come
        back combined: tensors gathered by rows on ``devices[0]``, dicts
        (caches) as :class:`Shards`, tuples item by item.  Nothing is
        read back to the host in between."""
        n = len(self.models)
        parts = []
        for i, m in enumerate(self.models):
            with device_ctx(self.devices[i]):
                parts.append(fn(i, m, *(self._arg(a, i, n) for a in args)))
        return self._combine(parts)

    def prefill(self, params: Shards, tokens: torch.Tensor, max_len: int):
        return self.map(lambda i, m, p, x: m.prefill(p, x, max_len),
                        params, tokens)

    def init_cache(self, batch: int, max_len: int, device=None) -> Shards:
        """Each replica's cache of ``batch / d`` rows on its device
        (``device`` is the replicas' own)."""
        rows = rows_each(batch, len(self.models))
        return Shards((i, m.init_cache(rows, max_len, device=d))
                      for i, (m, d) in enumerate(zip(self.models,
                                                     self.devices)))

    def decode_step(self, params: Shards, cache: Shards,
                    tokens: torch.Tensor, pos):
        """Every replica's eager ``decode_step`` on its rows."""
        return self.map(lambda i, m, p, c, t, q: m.decode_step(p, c, t, q),
                        params, cache, tokens, pos)

    def step(self, cls: Callable) -> "ReplicatedStep":
        """A step of ``cls(model)`` per replica (a
        :class:`~repro_torch.launch.compiled.CompiledStep`; a
        tensor-parallel group's eager ``decode_step``)."""
        return ReplicatedStep(self, Shards(
            (i, step_of(m, cls)) for i, m in enumerate(self.models)))


@dataclasses.dataclass(eq=False)
class ReplicatedStep:
    """Called as ``decode_step``: each replica's own step on its rows."""

    replicated: Replicated
    steps: Shards

    def __call__(self, params: Shards, cache: Shards, tokens: torch.Tensor,
                 pos):
        return self.replicated.map(
            lambda i, m, p, c, t, q, s: s(p, c, t, q), params, cache,
            tokens, pos, self.steps)


def replica_models(model) -> list:
    """Every replica's model (``[model]`` for one not replicated)."""
    return model.models if isinstance(model, Replicated) else [model]


def each(model, fn: Callable):
    """``fn(model)``, or ``fn`` of every replica's model."""
    return model.each(fn) if isinstance(model, Replicated) else fn(model)


def shard_models(model) -> list:
    """Every shard's model of every replica, in order (each replica's
    model itself where it is not a tensor-parallel group)."""
    return [s for m in replica_models(model)
            for s in (m.shards if isinstance(m, TensorParallel) else [m])]


def stores(model) -> list:
    """The compressed store of every shard of every replica, in order."""
    return [m.store for m in shard_models(model)
            if isinstance(m, CompressedModel)]


def compressed(model) -> bool:
    """Whether ``model`` serves compressed stores."""
    return isinstance(shard_models(model)[0], CompressedModel)


def step_of(model, cls: Callable):
    """``cls(model)``, or a step of ``cls`` per replica; a
    tensor-parallel group steps eagerly (its ``decode_step``: no CUDA
    graph is captured)."""
    if isinstance(model, Replicated):
        return model.step(cls)
    if isinstance(model, TensorParallel):
        return model.decode_step
    return cls(model)


def _own_model(model, store=None):
    """A model object of the replica's own (a graph is kept per model
    object), over ``store`` for a compressed model."""
    if isinstance(model, CompressedModel):
        return dataclasses.replace(model, model=dataclasses.replace(
            model.model), store=store)
    return dataclasses.replace(model)


def replicate_model(model, params, mesh: mesh_mod.Mesh,
                    what: str = "replicate_model") -> Replicated:
    """``model`` over ``params`` replicated on the mesh's data devices:
    params and (for a :class:`CompressedModel`) the store copied per
    replica (:func:`replicate`), a model object per replica."""
    devs = data_devices(mesh, what)
    stores = replicate(model.store, devs) \
        if isinstance(model, CompressedModel) else [None] * len(devs)
    return Replicated([_own_model(model, s) for s in stores],
                      Shards(enumerate(replicate(params, devs))), devs)


def tensor_groups(model, params, groups: list, what: str = "tensor_groups"
                  ) -> Replicated:
    """``model`` over ``params`` as one
    :class:`~repro_torch.launch.tensor_parallel.TensorParallel` group per
    list of ``groups`` (:func:`repro_torch.launch.mesh.model_groups`), the
    groups replicas of one another: the first group is split from
    ``model`` and ``params``, every later one gets a copy of its shards'
    params and stores (the same bytes and checksums, not cut again), so
    each group's tensors are its own.  A replica's rows go to its group's
    first device."""
    first, ps = tp_mod.build(model, params, groups[0], what)
    models, params_ = [first], Shards({0: ps})
    for i, g in enumerate(groups[1:], 1):
        stores = [_to(m.store, d, clone=True)
                  if isinstance(m, CompressedModel) else None
                  for m, d in zip(first.shards, g)]
        models.append(TensorParallel(
            [_own_model(m, st) for m, st in zip(first.shards, stores)],
            first.layout, list(g), first.plain))
        params_[i] = Shards((s, _to(ps[s], d, clone=True))
                            for s, d in enumerate(g))
    return Replicated(models, params_, [g[0] for g in groups])


def serving_replicas(model, params, mesh: mesh_mod.Mesh,
                     device: torch.device, what: str) -> Replicated:
    """What serves over ``mesh``: ``model`` itself where it is a
    :class:`Replicated` on the mesh's devices, else ``model`` over
    ``params`` replicated there, as tensor-parallel groups where the
    mesh's ``model`` axis is larger than 1 (:func:`tensor_groups`).
    Raises ``ValueError`` where ``device`` (the caller's) is not of the
    mesh's device type, or a given :class:`Replicated` lies on other
    devices than the mesh's."""
    mesh_mod.check_servable(mesh, what)
    groups = mesh_mod.model_groups(mesh)
    devs = [g[0] for g in groups]
    if device.type != devs[0].type:
        raise ValueError(f"{what}: device {device} is not of the mesh's "
                         f"type ({devs[0].type})")
    if isinstance(model, Replicated):
        if model.devices != devs:
            raise ValueError(f"{what}: replicas on {model.devices}, not on "
                             f"the mesh's {devs}")
        return model
    if len(groups[0]) > 1:
        return tensor_groups(model, params, groups, what)
    return replicate_model(model, params, mesh, what)


def with_model(replicated: Replicated, model) -> Replicated:
    """``model`` (a dense model) over ``replicated``'s params: the guard's
    degradation target for a replicated compressed model (split as each
    tensor-parallel group is)."""
    return replicated.each(lambda m: m.with_model(model)
                           if isinstance(m, TensorParallel)
                           else _own_model(model))


def params_equal(replicas: list) -> bool:
    """Whether every replica's tree is bit for bit the first's."""
    first = tree_mod.leaves(replicas[0])
    return all(
        all(torch.equal(a, b.to(a.device)) for a, b in
            zip(first, tree_mod.leaves(r)))
        for r in replicas[1:])
