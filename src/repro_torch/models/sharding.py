"""Logical axis names, bound to mesh axes: the counterpart of the
reference's ``repro.models.sharding``, as data.

The reference's models annotate activations with logical names that the
launch layer binds to mesh axes.  The port computes the same bindings
(:func:`logical_axis_rules`, :func:`spec`, :func:`named_sharding`); a spec
is the tuple that ``tuple(PartitionSpec)`` gives in the reference.
:func:`shard` is the identity where the reference's changes no value:
without rules (the reference's no-op) and in a mesh of one device.  Where
the reference would constrain a mesh of more than one device it raises
``NotImplementedError``: the port runs one process on one card.
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


def spec(*logical_axes: Optional[str]) -> tuple:
    """The spec of ``logical_axes`` under the current rules; without
    rules, fully replicated (every entry ``None``)."""
    amap = _axis_map() or {}
    return tuple(amap.get(a) if a is not None else None
                 for a in logical_axes)


def shard(x, *logical_axes: Optional[str]):
    """``x`` itself, except inside a mesh of more than one device with
    rules bound, where it raises ``NotImplementedError``."""
    m = mesh_mod.current()
    if m is not None and m.size > 1 and _axis_map() is not None:
        raise NotImplementedError(
            f"shard{spec(*logical_axes)}: the port runs one process on one "
            f"device, not a mesh of {m.size}")
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: mesh_mod.Mesh
    spec: tuple


def named_sharding(mesh: mesh_mod.Mesh, *logical_axes: Optional[str]
                   ) -> NamedSharding:
    return NamedSharding(mesh, spec(*logical_axes))
