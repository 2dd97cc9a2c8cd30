"""Weight pruning to the structures the compressed kernels execute.

Same selection rules as the reference (``repro.sparse.masks``): block
pruning keeps every block whose Frobenius norm is ``>=`` the threshold of
the top-|density| fraction; N:M pruning keeps the ``n_sel`` largest
magnitudes per group with ties to the first (a stable argsort, as jnp's).
"""

from __future__ import annotations

import torch


def nm_prune(w: torch.Tensor, n_sel: int = 2, m_group: int = 4
             ) -> torch.Tensor:
    """N:M structured pruning along axis 0 (the contraction dim)."""
    n, k = w.shape
    if n % m_group:
        raise ValueError(f"m_group {m_group} does not divide N={n}")
    wg = w.reshape(n // m_group, m_group, k)
    order = torch.argsort(-wg.abs(), dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    return torch.where(ranks < n_sel, wg, torch.zeros_like(wg)).reshape(n, k)


def block_prune(w: torch.Tensor, bn: int, bk: int, density: float
                ) -> torch.Tensor:
    """Keep the top-|density| fraction of (bn × bk) blocks by norm."""
    n, k = w.shape
    if n % bn or k % bk:
        raise ValueError(f"block ({bn}, {bk}) does not tile {tuple(w.shape)}")
    gn, gk = n // bn, k // bk
    wb = w.reshape(gn, bn, gk, bk)
    norms = wb.square().sum(dim=(1, 3)).sqrt()               # (gn, gk)
    nkeep = max(int(gn * gk * density), 1)
    thresh = torch.sort(norms.reshape(-1)).values[-nkeep]
    mask = (norms >= thresh)[:, None, :, None]
    return (wb * mask).reshape(n, k)
