"""Parameter pytrees between numpy and the port's tensors.

The port's params are plain dicts in the reference's layout (``embed``,
``final_norm``, ``blocks`` with a leading layer axis; weights
``(d_in, d_out)``; a MoE layer's ``ffn`` holds the router ``(L, d, E)``
and the experts ``(L, E, d, f)`` / ``(L, E, f, d)``), so the reference's
``Model.init`` tree, passed as numpy arrays, converts leaf by leaf, the
int32 leaves of block-stored FFN params (optflag ``sparseffn``) as int32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays → the same dict of tensors on ``device``
    (values copied; dtypes kept)."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy` (copies to host numpy)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def bf16_params(tree):
    """Every floating leaf of a param tree cast to bf16, every other leaf
    (the int32 ``rows_*`` / ``_meta`` of block-stored FFN params) as it
    is: the reference dry run's cast of its decode cell's params under
    optflag ``bf16params``."""
    if isinstance(tree, dict):
        return {k: bf16_params(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.is_floating_point() else tree
