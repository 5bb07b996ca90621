"""Truncation task types: removal of small matrix elements with error control.

The paper ships several error-control variants; implemented here:

* :func:`truncate` — block-level truncation with a *global* Frobenius-norm
  guarantee: the blocks with smallest norms are removed greedily such that
  ``||A - truncate(A, tau)||_F <= tau`` (tight by construction).
* :func:`truncate_hierarchical` — the same global guarantee, decided on the
  quadtree: whole subtrees with small subtree norms are dropped first during
  a top-down descent, so a dropped subtree's leaves are never visited.
* :func:`truncate_elementwise` — zero every element with ``|a_ij| <= eps``
  and drop blocks that become empty (the classic drop-tolerance variant).
"""

from __future__ import annotations

import numpy as np
import torch

from .matrix import BSMatrix, _to_numpy
from .quadtree import hierarchical_drop_mask

__all__ = ["truncate", "truncate_hierarchical", "truncate_elementwise"]


def _keep_blocks(a: BSMatrix, idx: np.ndarray, data: torch.Tensor | None = None) -> BSMatrix:
    data = a.data if data is None else data
    return BSMatrix(
        shape=a.shape,
        bs=a.bs,
        coords=a.coords[idx],
        data=data[torch.from_numpy(idx).to(data.device)],
    )


def truncate(a: BSMatrix, tau: float) -> BSMatrix:
    """Remove smallest-norm blocks while sqrt(sum of removed norms^2) <= tau."""
    if a.nnzb == 0 or tau <= 0:
        return a
    norms = a.block_norms().astype(np.float64)
    order = np.argsort(norms)
    csum = np.sqrt(np.cumsum(norms[order] ** 2))
    ndrop = int(np.searchsorted(csum, tau, side="right"))
    if ndrop == 0:
        return a
    keep = np.ones(a.nnzb, dtype=bool)
    keep[order[:ndrop]] = False
    return _keep_blocks(a, np.nonzero(keep)[0])


def truncate_hierarchical(a: BSMatrix, tau: float) -> BSMatrix:
    """Truncate by dropping whole quadtree subtrees first, then leaves.

    Top-down greedy over the cached
    :class:`~repro_torch.core.quadtree.QuadtreeIndex` subtree norms via
    :func:`repro_torch.core.quadtree.hierarchical_drop_mask`.  The global
    guarantee ``||A - truncate_hierarchical(A, tau)||_F <= tau`` is
    preserved; the dropped set may differ from :func:`truncate`'s leaf-greedy
    optimum, but a subtree dropped at level L is removed without its leaves
    ever being enumerated — the paper's hierarchical error-control task.
    """
    if a.nnzb == 0 or tau <= 0:
        return a
    keep, _ = hierarchical_drop_mask(a.quadtree_index(), tau)
    if keep.all():
        return a
    return _keep_blocks(a, np.nonzero(keep)[0])


def truncate_elementwise(a: BSMatrix, eps: float) -> BSMatrix:
    """Zero elements with |a_ij| <= eps; drop blocks that become all-zero."""
    if a.nnzb == 0:
        return a
    data = torch.where(a.data.abs() > eps, a.data, torch.zeros_like(a.data))
    alive = _to_numpy((data != 0).flatten(1).any(dim=1))
    return _keep_blocks(a, np.nonzero(alive)[0], data)
