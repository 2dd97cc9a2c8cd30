"""Logical axis names, bound to mesh axes: the counterpart of the
reference's ``repro.models.sharding``, as data.

The reference's models annotate activations with logical names that the
launch layer binds to mesh axes.  The port computes the same bindings
(:func:`logical_axis_rules`, :func:`spec`, :func:`named_sharding`); a spec
is the tuple that ``tuple(PartitionSpec)`` gives in the reference.
:func:`shard` is the identity where the reference's changes no value:
without rules (the reference's no-op), and in a mesh whose axes bound to
the names are of size 1 or are the data axes (``pod`` / ``data``): the
port runs a data mesh as replicas in one process
(:mod:`repro_torch.launch.data_parallel`), so a replica's tensor is
already its shard.  Inside the tensor-parallel driver
(:mod:`repro_torch.launch.tensor_parallel`) each shard's tensors are its
slice too, and :func:`local_view` binds the names bound to ``model`` to
``None`` there.  Elsewhere, where a bound ``model`` / ``vocab`` /
``expert`` axis is larger than 1 it raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

from repro_torch.launch import mesh as mesh_mod

_state = threading.local()


def _axis_map() -> Optional[dict]:
    return getattr(_state, "axis_map", None)


@contextlib.contextmanager
def logical_axis_rules(axis_map: dict):
    """Bind logical axis names → mesh axis names (or None) for the
    scope."""
    prev = _axis_map()
    _state.axis_map = axis_map
    try:
        yield
    finally:
        _state.axis_map = prev


@contextlib.contextmanager
def local_view():
    """A shard's local view for the scope: every logical name bound to
    the ``model`` axis bound to ``None`` (nothing, without rules)."""
    amap = _axis_map()
    if amap is None:
        yield
        return
    with logical_axis_rules({k: None if v == "model" else v
                             for k, v in amap.items()}):
        yield


def spec(*logical_axes: Optional[str]) -> tuple:
    """The spec of ``logical_axes`` under the current rules; without
    rules, fully replicated (every entry ``None``)."""
    amap = _axis_map() or {}
    return tuple(amap.get(a) if a is not None else None
                 for a in logical_axes)


def shard(x, *logical_axes: Optional[str]):
    """``x`` itself, except where the current rules bind one of
    ``logical_axes`` to a mesh axis other than ``pod`` / ``data`` that is
    larger than 1 in the current mesh: then ``NotImplementedError``."""
    m = mesh_mod.current()
    if m is None or _axis_map() is None:
        return x
    sizes = mesh_mod.mesh_axis_sizes(m)
    for entry in spec(*logical_axes):
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if axis not in (None, "pod", "data") and sizes.get(axis, 1) > 1:
                raise NotImplementedError(
                    f"shard{spec(*logical_axes)}: mesh axis {axis!r} of "
                    f"{sizes[axis]} devices outside the tensor-parallel "
                    f"driver")
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: mesh_mod.Mesh
    spec: tuple


def named_sharding(mesh: mesh_mod.Mesh, *logical_axes: Optional[str]
                   ) -> NamedSharding:
    return NamedSharding(mesh, spec(*logical_axes))
