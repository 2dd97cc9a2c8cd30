"""Parameter pytrees between numpy and the port's tensors.

The port's params are plain dicts in the reference's layout (``embed``,
``final_norm``, ``blocks`` with a leading layer axis; weights
``(d_in, d_out)``; a MoE layer's ``ffn`` holds the router ``(L, d, E)``
and the experts ``(L, E, d, f)`` / ``(L, E, f, d)``), so the reference's
``Model.init`` tree, passed as numpy arrays, converts leaf by leaf.
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
