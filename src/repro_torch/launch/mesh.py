"""Device meshes, as data: the counterpart of the reference's
``repro.launch.mesh``.

A :class:`Mesh` is the port's own small object: axis names, axis sizes
and, where devices back it, the grid of ``torch.device`` it spans.  The
functions return ``None`` wherever the reference's return ``None`` for the
same device count, so on one card every serving mesh is ``None`` and
serving runs unsharded, as the reference's does on one device.  A mesh
whose axes other than ``pod`` / ``data`` have size 1 is served and
trained data-parallel by one process
(:mod:`repro_torch.launch.data_parallel`).  A ``model`` axis larger than
1 is served tensor-parallel (:func:`check_servable`, :func:`model_groups`,
:mod:`repro_torch.launch.tensor_parallel`: each of the grid's rows one
group of shards); training and the dry run take data axes only
(:func:`check_data_only`).  A grid may repeat a device (:func:`grid`):
four replicas on one CPU or one card stand in for four devices, as the
reference's forced host devices do.
:meth:`Mesh.device_mesh` builds a ``torch.distributed`` ``DeviceMesh``
only where a process group exists.

``devices(device)`` are the devices a mesh may span: every card when
``device`` names CUDA without an index, the one named device otherwise
(``cuda:0``, ``cpu``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve

_state = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes of ``shape`` over ``devices`` (an object array of
    ``torch.device`` of that shape), or over no devices at all (the
    production meshes: sizes only).  ``with mesh:`` makes it the current
    mesh (:func:`current`), as entering a JAX mesh does."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: Optional[np.ndarray] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def device_mesh(self):
        """A ``torch.distributed`` ``DeviceMesh`` over this mesh's ranks
        (rank i on device i of the flattened grid), or ``None`` without a
        process group or without devices."""
        import torch.distributed as dist
        if self.devices is None or not dist.is_available() \
                or not dist.is_initialized():
            return None
        from torch.distributed.device_mesh import DeviceMesh
        ranks = torch.arange(self.size).reshape(self.shape)
        return DeviceMesh(self.devices.flat[0].type, ranks,
                          mesh_dim_names=self.axis_names)

    def __enter__(self) -> "Mesh":
        stack = getattr(_state, "stack", [])
        _state.stack = stack + [self]
        return self

    def __exit__(self, *exc) -> None:
        _state.stack = _state.stack[:-1]


def current() -> Optional[Mesh]:
    """The innermost mesh entered on this thread, or ``None``."""
    stack = getattr(_state, "stack", [])
    return stack[-1] if stack else None


def devices(device="cuda") -> list[torch.device]:
    """The devices a mesh may span: every card for ``"cuda"``, the one
    named device for ``"cuda:N"`` or ``"cpu"``."""
    named = torch.device(device)
    dev = resolve(device)
    if dev.type == "cuda" and named.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def grid(devs: list, shape: tuple[int, ...]) -> np.ndarray:
    """The first ``prod(shape)`` of ``devs`` as an object array of
    ``shape`` (a device may repeat)."""
    grid = np.empty(math.prod(shape), dtype=object)
    grid[:] = devs[:math.prod(shape)]
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production axes, (data 16, model 16) or (pod 2,
    data 16, model 16), as sizes without devices: what the partition
    specs read."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def data_axes_of(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_map_for(mesh: Mesh) -> dict:
    """Logical → mesh axis binding of the reference's annotations."""
    data = data_axes_of(mesh)
    return {
        "batch": data if len(data) > 1 else data[0],
        "model": "model",
        "vocab": "model",
        "expert": "model",
    }


def make_small_mesh(data: int = 1, model: int = 1, device="cuda"
                    ) -> Optional[Mesh]:
    """A (data, model) mesh over the first ``data · model`` devices, or
    ``None`` when there are fewer (one device still makes a (1, 1)
    mesh, as the reference's does)."""
    devs = devices(device)
    if len(devs) < data * model:
        return None
    return Mesh(("data", "model"), (data, model),
                grid(devs, (data, model)))


def make_serve_mesh(batch: int, model: int = 1, device="cuda"
                    ) -> Optional[Mesh]:
    """The reference's serving mesh: the data axis takes the largest
    divisor of ``batch`` that fits the devices left after TP; ``None``
    when that is a single device (always, on one card)."""
    devs = devices(device)
    avail = len(devs)
    if model < 1 or avail < model:
        return None
    data = math.gcd(max(batch, 1), avail // model)
    if data * model <= 1:
        return None
    return Mesh(("data", "model"), (data, model),
                grid(devs, (data, model)))


def degraded_serve_mesh(batch: int, lost: int, model: int = 1,
                        device="cuda") -> Optional[Mesh]:
    """The serving mesh after losing ``lost`` devices: the largest (data,
    model) shape :func:`repro_torch.runtime.fault.elastic_remesh` gives
    the survivors (the first ``avail`` devices), TP pinned.  Raises
    ``ValueError`` when nothing is left or the survivors cannot sustain
    the TP degree; ``None`` when the proposal is one device."""
    from repro_torch.runtime.fault import elastic_remesh

    devs = devices(device)
    avail = len(devs) - lost
    if avail < 1:
        raise ValueError(f"lost {lost} of {len(devs)} devices: "
                         "nothing left to serve on")
    data, model = elastic_remesh(avail, model)
    data = math.gcd(max(batch, 1), data)
    if data * model <= 1:
        return None
    return Mesh(("data", "model"), (data, model),
                grid(devs, (data, model)))


def check_data_only(mesh: Optional[Mesh], what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh with an axis other than
    ``pod`` / ``data`` larger than 1 (tensor parallelism, which only
    serving takes: :func:`check_servable`), and ``ValueError`` for one
    without devices (a production mesh's sizes): neither is trained,
    unsharded or otherwise."""
    if mesh is None:
        return
    sizes = mesh_axis_sizes(mesh)
    wide = {a: n for a, n in sizes.items()
            if a not in ("pod", "data") and n > 1}
    if wide:
        raise NotImplementedError(
            f"{what}: a mesh of {mesh.size} devices ({sizes}) with "
            f"{wide}: it takes data parallelism only (a 'model' axis "
            f"larger than 1 is tensor parallelism, which serving takes)")
    if mesh.devices is None:
        raise ValueError(f"{what}: the mesh {sizes} has no devices")


def check_servable(mesh: Optional[Mesh], what: str) -> None:
    """Raise ``ValueError`` for a mesh without devices (a production
    mesh's sizes), and ``NotImplementedError`` for an axis other than
    ``pod`` / ``data`` / ``model`` larger than 1: what serving takes is
    data replicas (``pod`` / ``data``) of tensor-parallel groups
    (``model``)."""
    if mesh is None:
        return
    sizes = mesh_axis_sizes(mesh)
    other = {a: n for a, n in sizes.items()
             if a not in ("pod", "data", "model") and n > 1}
    if other:
        raise NotImplementedError(
            f"{what}: a mesh of {mesh.size} devices ({sizes}) with "
            f"{other}: serving takes 'pod' / 'data' replicas of 'model' "
            f"groups only")
    if mesh.devices is None:
        raise ValueError(f"{what}: the mesh {sizes} has no devices")


def model_groups(mesh: Mesh) -> list[list[torch.device]]:
    """The grid's rows in mesh order (``pod`` major, then ``data``), each
    the list of its ``model`` axis's t devices: one tensor-parallel group
    a row.  Devices may repeat."""
    check_servable(mesh, "model_groups")
    t = mesh_axis_sizes(mesh).get("model", 1)
    flat = [torch.device(d) for d in mesh.devices.flat]
    if "model" in mesh.axis_names and \
            mesh.axis_names.index("model") != len(mesh.axis_names) - 1:
        raise ValueError(f"model_groups: the 'model' axis of "
                         f"{mesh.axis_names} is not the last")
    return [flat[i:i + t] for i in range(0, len(flat), t)]
