"""Data-parallel execution over a mesh, one process driving every device.

The reference gets this from GSPMD: under a mesh its serving and training
entry points place the batch on the ``data`` axis (and ``pod``, where there
is one), and one jitted program runs on every device.  The port has no
counterpart module: one process enqueues each replica's work on its own
device, in mesh order, before it reads anything back.

* :func:`data_devices` — a mesh's replicas: its devices in grid order.
  Only the ``pod`` and ``data`` axes may be larger than 1 (a ``model``
  axis larger than 1 is tensor parallelism, not ported); a mesh may
  repeat a device, as the reference's forced host devices stand in for
  several.
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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.exec.dispatch import CompressedModel
from repro_torch.launch import mesh as mesh_mod


def data_devices(mesh: mesh_mod.Mesh, what: str = "data_devices"
                 ) -> list[torch.device]:
    """The mesh's replicas, one device each, in grid order (``pod`` major,
    then ``data``): the order the reference splits a batch's rows in."""
    mesh_mod.check_data_only(mesh, what)
    return [torch.device(d) for d in mesh.devices.flat]


def device_ctx(dev: torch.device):
    """``dev`` made the current CUDA device (nothing for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _to(x: Any, dev: torch.device, clone: bool) -> Any:
    """``x`` with every tensor on ``dev`` (a copy of its own with
    ``clone``), through dicts, lists, tuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True) if clone else x.to(dev)
    if isinstance(x, dict):
        return type(x)((k, _to(v, dev, clone)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev, clone) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev, clone) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev, clone)
            for f in dataclasses.fields(x) if f.init})
    return x


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


class Shards(dict):
    """One value per replica, by replica index: a cache, params, steps.
    A dict, so the cache helpers that walk a cache tree
    (:func:`repro_torch.models.transformer.step_writes`,
    :func:`repro_torch.launch.compiled.leaves`) walk every replica's."""


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
        :class:`~repro_torch.launch.compiled.CompiledStep`)."""
        return ReplicatedStep(self, Shards(
            (i, cls(m)) for i, m in enumerate(self.models)))


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


def step_of(model, cls: Callable):
    """``cls(model)``, or a step of ``cls`` per replica."""
    return model.step(cls) if isinstance(model, Replicated) else cls(model)


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


def serving_replicas(model, params, mesh: mesh_mod.Mesh,
                     device: torch.device, what: str) -> Replicated:
    """What serves over ``mesh``: ``model`` itself where it is a
    :class:`Replicated` on the mesh's devices, else ``model`` over
    ``params`` replicated there.  Raises ``ValueError`` where ``device``
    (the caller's) is not of the mesh's device type, or a given
    :class:`Replicated` lies on other devices than the mesh's."""
    devs = data_devices(mesh, what)
    if device.type != devs[0].type:
        raise ValueError(f"{what}: device {device} is not of the mesh's "
                         f"type ({devs[0].type})")
    if isinstance(model, Replicated):
        if model.devices != devs:
            raise ValueError(f"{what}: replicas on {model.devices}, not on "
                             f"the mesh's {devs}")
        return model
    return replicate_model(model, params, mesh, what)


def with_model(replicated: Replicated, model) -> Replicated:
    """``model`` (a dense model) over ``replicated``'s params: the guard's
    degradation target for a replicated compressed model."""
    return replicated.each(lambda _: _own_model(model))


def params_equal(replicas: list) -> bool:
    """Whether every replica's tree is bit for bit the first's."""
    first = tree_mod.leaves(replicas[0])
    return all(
        all(torch.equal(a, b.to(a.device)) for a, b in
            zip(first, tree_mod.leaves(r)))
        for r in replicas[1:])
