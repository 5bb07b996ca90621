"""Carry matrix state between the JAX package and the port.

A matrix library has no weights: its state is the block stack and its
structure.  These two functions move a ``BSMatrix`` across as plain numpy
arrays — the JAX package's fields (``shape``, ``bs``, ``coords`` and
``np.asarray(m.data)``) in, the same fields out — so neither package imports
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.matrix import BSMatrix, _to_numpy, resolve_device

__all__ = ["bsmatrix_from_arrays", "bsmatrix_to_arrays"]


def bsmatrix_from_arrays(shape, bs: int, coords, data, *, device) -> BSMatrix:
    """The port's ``BSMatrix`` from host arrays (coords Morton-sorted, unique).

    ``data`` may be bf16 as numpy's ``ml_dtypes`` extension type; it arrives
    as a torch bf16 tensor (the conversion through fp32 is exact).
    """
    data = np.asarray(data)
    if data.dtype.name == "bfloat16":
        tensor = torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
    else:
        tensor = torch.from_numpy(np.array(data))  # a writable copy
    return BSMatrix(
        shape=tuple(int(s) for s in shape),
        bs=int(bs),
        coords=np.asarray(coords, dtype=np.int64).reshape(-1, 2),
        data=tensor.to(resolve_device(device)),
    )


def bsmatrix_to_arrays(m: BSMatrix) -> tuple[tuple[int, int], int, np.ndarray, np.ndarray]:
    """``(shape, bs, coords, data)`` on the host; bf16 data comes back as fp32."""
    return tuple(m.shape), m.bs, m.coords.copy(), _to_numpy(m.data)
