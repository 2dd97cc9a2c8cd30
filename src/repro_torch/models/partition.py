"""Parameter, cache and batch partition specs: the counterpart of the
reference's ``repro.models.partition`` (Megatron-style TP on the
``model`` axis, DP over ``data`` and ``pod``, EP for MoE experts), as
data.

A spec is a tuple of mesh axis names (or ``None``, or a tuple of names)
with one entry a dimension: what ``tuple(PartitionSpec)`` gives in the
reference.  Rules go by a leaf's last dict key, rank and shape, with the
leading stack axes replicated; a dimension is sharded only when the mesh
axis divides it.  The trees are nested dicts, as the port's params,
caches and batches are; any leaf with ``ndim`` and ``shape`` does
(meta-device tensors give the specs of a full-width model without
allocating it).  With optflag ``replkv`` K / V
projections whose head count does not divide the model axis are
replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.models import optflags

PyTree = Any

# trailing-dims rules: leaf-name → (spec for last N dims)
_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_x", "w_y",
        "w_a", "w_i")                       # (d_model, wide): shard wide
_ROW = ("wo", "w_down", "w_out")            # (wide, d_model): shard wide
_REPL = ("ln1", "ln2", "ln3", "final_norm", "enc_norm", "norm", "conv",
         "lam", "A_log", "D", "dt_bias", "router")


def _map_with_path(fn: Callable, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over the leaves of nested dicts; ``path`` holds
    the keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _last_name(path: tuple) -> str:
    return str(path[-1]) if path else ""


def _keystr(path: tuple) -> str:
    """The path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{e!r}]" for e in path)


def _divisible(extent: int, axis_size: Optional[int]) -> bool:
    return axis_size is not None and axis_size > 0 and extent % axis_size == 0


def _repl(nd: int) -> tuple:
    return (None,) * nd


def param_specs(params: PyTree, mesh_axes: dict[str, int],
                data_axes: tuple[str, ...] = ("data",),
                model_axis: str = "model",
                kv_heads: Optional[int] = None) -> PyTree:
    """The spec tree of ``params``; ``mesh_axes`` maps axis name → size.
    Optimizer states shard as their parameters do."""
    msize = mesh_axes.get(model_axis, 1)
    repl_kv = (optflags.enabled("replkv") and
               (kv_heads is None or kv_heads % msize != 0))

    def rule(path, leaf) -> tuple:
        name = _last_name(path)
        nd = leaf.ndim
        shape = tuple(leaf.shape)
        if name == "embed":
            if _divisible(shape[0], msize):
                return (model_axis, None)
            return (None, None)
        if name in ("payload_gate", "payload_up") and nd >= 4:
            # block-sparse FFN payload (…, gk, T, bn, bk): block-column EP
            if _divisible(shape[-4], msize):
                return _repl(nd - 4) + (model_axis, None, None, None)
            return _repl(nd)
        if name in ("rows_gate", "rows_up") and nd >= 2:
            if _divisible(shape[-2], msize):
                return _repl(nd - 2) + (model_axis, None)
            return _repl(nd)
        if name in ("wk", "wv") and repl_kv:
            return _repl(nd)
        if name in _REPL or name == "_meta":
            return _repl(nd)
        if name in ("w_gate", "w_up", "w_down") and "ffn" in _keystr(path) \
                and nd >= 3:
            # MoE expert stacks (…, E, d, f): shard the expert axis (EP)
            if _divisible(shape[-3], msize):
                return _repl(nd - 3) + (model_axis, None, None)
            return _repl(nd)
        if name in _COL and nd >= 2:
            if _divisible(shape[-1], msize):
                return _repl(nd - 1) + (model_axis,)
            return _repl(nd)
        if name in _ROW and nd >= 2:
            if _divisible(shape[-2], msize):
                return _repl(nd - 2) + (model_axis, None)
            return _repl(nd)
        return _repl(nd)

    return _map_with_path(rule, params)


def _data(mesh_axes: dict[str, int], data_axes: tuple[str, ...]):
    """The batch dimension's spec entry and the data axes' total size."""
    dsize = 1
    for a in data_axes:
        dsize *= mesh_axes.get(a, 1)
    return (data_axes if len(data_axes) > 1 else data_axes[0]), dsize


def cache_specs(cache: PyTree, mesh_axes: dict[str, int],
                data_axes: tuple[str, ...] = ("data",),
                model_axis: str = "model") -> PyTree:
    """Decode-cache specs.  K / V leaves (L, B, S, H, D): batch over the
    data axes, heads over the model axis where it divides them, else the
    sequence (KV sequence parallelism).  Other states (L, B, …): batch,
    and the last divisible axis past it over the model axis."""
    msize = mesh_axes.get(model_axis, 1)
    batch_spec, dsize = _data(mesh_axes, data_axes)

    def rule(path, leaf) -> tuple:
        nd = leaf.ndim
        if nd == 0:
            return ()
        shape = tuple(leaf.shape)
        if _last_name(path) in ("k", "v") and nd == 5:
            _, b, s, h, _ = shape
            bspec = batch_spec if b % dsize == 0 else None
            if h % msize == 0:
                return (None, bspec, None, model_axis, None)
            if s % msize == 0:
                return (None, bspec, model_axis, None, None)
            return (None, bspec, None, None, None)
        spec: list = [None] * nd
        if nd >= 2 and shape[1] % dsize == 0:
            spec[1] = batch_spec
        for ax in range(nd - 1, 1, -1):
            if shape[ax] % msize == 0 and shape[ax] >= msize:
                spec[ax] = model_axis
                break
        return tuple(spec)

    return _map_with_path(rule, cache)


def batch_specs(batch: PyTree, mesh_axes: dict[str, int],
                data_axes: tuple[str, ...] = ("data",)) -> PyTree:
    """Input batches shard the leading (batch) axis over the data axes;
    replicated where the batch does not divide."""
    bspec, dsize = _data(mesh_axes, data_axes)

    def rule(path, leaf) -> tuple:
        nd = getattr(leaf, "ndim", 0)
        if nd == 0:
            return ()
        if leaf.shape[0] % dsize != 0:
            return _repl(nd)
        return (bspec,) + _repl(nd - 1)

    return _map_with_path(rule, batch)
