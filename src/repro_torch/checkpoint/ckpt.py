"""Sharded numpy checkpointing: atomic, step-tagged, resumable, elastic —
the port of the reference's ``repro.checkpoint.ckpt``, on the same disk
layout:

    <dir>/step_<N>/
        meta.json            — step, leaf count, tree structure, extra
        shard_<host>.npz     — this host's leaves, ``leaf_i``
    <dir>/LATEST             — atomic pointer (tmp + rename)

Leaves are written in ``jax.tree``'s flatten order (:mod:`repro_torch.tree`:
dict keys sorted, ``NamedTuple`` fields in order, ``None`` no leaf), so a
directory written by either package restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

PyTree = Any


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, state: PyTree, host_id: int = 0,
         extra: Optional[dict] = None) -> str:
    """Write a checkpoint; returns its directory.  Atomic via
    tmp + rename."""
    leaves = [_host(x) for x in tree.leaves(state)]
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, f"shard_{host_id}.npz"),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        meta = {"step": step, "n_leaves": len(leaves),
                "treedef": tree.describe(state), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp, step_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(step_dir))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _like(arr: np.ndarray, ref):
    """``arr`` in the type of the leaf ``ref``: a tensor on its device in
    its dtype, or a numpy array of its dtype."""
    if isinstance(ref, torch.Tensor):
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    return arr.astype(np.asarray(ref).dtype)


def restore(ckpt_dir: str, like: PyTree, step: Optional[int] = None,
            host_id: int = 0) -> tuple[PyTree, dict]:
    """Restore into the structure of ``like`` (shapes must match; a
    mismatch raises ``AssertionError``, as the reference's).  Returns
    (tree, extra).  ``step=None`` → latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "meta.json")) as f:
        meta = json.load(f)
    refs = tree.leaves(like)
    assert meta["n_leaves"] == len(refs), \
        f"checkpoint has {meta['n_leaves']} leaves, expected {len(refs)}"
    restored = []
    with np.load(os.path.join(step_dir, f"shard_{host_id}.npz")) as data:
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            assert arr.shape == tuple(ref.shape), \
                f"leaf {i}: ckpt {arr.shape} != model {tuple(ref.shape)}"
            restored.append(_like(arr, ref))
    return tree.unflatten(like, restored), meta.get("extra", {})


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Garbage-collect old checkpoints, keeping the newest ``keep``."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
