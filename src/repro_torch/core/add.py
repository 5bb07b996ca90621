"""Addition task types: C = alpha*A + beta*B, and A + alpha*I."""

from __future__ import annotations

import numpy as np
import torch

from .matrix import BSMatrix, resolve_device

__all__ = ["add", "add_scaled_identity", "identity"]


def add(a: BSMatrix, b: BSMatrix, alpha=1.0, beta=1.0) -> BSMatrix:
    """C = alpha*A + beta*B.  Structure union; overlapping blocks summed.

    Scaled in fp32 (alpha and beta rounded to fp32 first, as the JAX
    package does), then summed A-first by the ordered duplicate sum of
    :meth:`BSMatrix.from_blocks`.
    """
    assert a.shape == b.shape and a.bs == b.bs, (a.shape, b.shape, a.bs, b.bs)
    if a.nnzb == 0 and b.nnzb == 0:
        return BSMatrix.zeros(a.shape, a.bs, a.dtype, device=a.device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    data = torch.cat(
        [a.data.float() * f32(alpha), b.data.float() * f32(beta)]
    ).to(torch.promote_types(a.dtype, b.dtype))
    coords = np.concatenate([a.coords, b.coords])
    return BSMatrix.from_blocks(a.shape, a.bs, coords, data, device=a.device)


def identity(n: int, bs: int, dtype=torch.float32, *, device="cuda") -> BSMatrix:
    """Block-sparse identity, partial trailing block handled."""
    dev = resolve_device(device)
    nb = -(-n // bs)
    coords = np.stack([np.arange(nb), np.arange(nb)], axis=1).astype(np.int64)
    data = torch.eye(bs, dtype=dtype, device=dev).repeat(nb, 1, 1)
    tail = n - (nb - 1) * bs
    if tail < bs:
        data[-1] = torch.diag((torch.arange(bs, device=dev) < tail).to(dtype))
    return BSMatrix.from_blocks((n, n), bs, coords, data, device=dev)


def add_scaled_identity(a: BSMatrix, alpha) -> BSMatrix:
    """A + alpha*I (paper: addition of a matrix with a scaled identity)."""
    assert a.shape[0] == a.shape[1]
    return add(a, identity(a.shape[0], a.bs, a.dtype, device=a.device), 1.0, alpha)
