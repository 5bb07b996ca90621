"""Carry matrix state between the JAX package and the port.

A matrix library has no weights: its state is the block stack and its
structure.  These functions move a ``BSMatrix`` — or a resident
``DistBSMatrix`` with its placement — across as plain numpy arrays: the JAX
package's fields (``shape``, ``bs``, ``coords``, ``owner``, ``slot``,
``cap`` and ``np.asarray(m.data)`` / ``np.asarray(x.store)``) in, the same
fields out — so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.matrix import BSMatrix, _to_numpy, resolve_device
from .dist.matrix import DistBSMatrix

__all__ = [
    "bsmatrix_from_arrays",
    "bsmatrix_to_arrays",
    "distmatrix_from_arrays",
    "distmatrix_to_arrays",
]


def _tensor(data) -> torch.Tensor:
    """A writable torch copy of a host array; numpy's bf16 extension type arrives as torch bf16."""
    data = np.asarray(data)
    if data.dtype.name == "bfloat16":
        return torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(data))


def bsmatrix_from_arrays(shape, bs: int, coords, data, *, device) -> BSMatrix:
    """The port's ``BSMatrix`` from host arrays (coords Morton-sorted, unique).

    ``data`` may be bf16 as numpy's ``ml_dtypes`` extension type; it arrives
    as a torch bf16 tensor (the conversion through fp32 is exact).
    """
    return BSMatrix(
        shape=tuple(int(s) for s in shape),
        bs=int(bs),
        coords=np.asarray(coords, dtype=np.int64).reshape(-1, 2),
        data=_tensor(data).to(resolve_device(device)),
    )


def bsmatrix_to_arrays(m: BSMatrix) -> tuple[tuple[int, int], int, np.ndarray, np.ndarray]:
    """``(shape, bs, coords, data)`` on the host; bf16 data comes back as fp32."""
    return tuple(m.shape), m.bs, m.coords.copy(), _to_numpy(m.data)


def distmatrix_from_arrays(shape, bs: int, coords, owner, slot, cap: int, store, *, mesh):
    """The port's ``DistBSMatrix`` on ``mesh`` from host arrays.

    ``store`` is the ``[P, cap, bs, bs]`` stack with one row per worker (the
    JAX package's sharded store gathered to the host, ``np.asarray(x.store)``);
    ``mesh`` is a :class:`repro_torch.core.distributed.WorkerMesh` of P
    workers.
    """
    return DistBSMatrix(
        shape=tuple(int(s) for s in shape),
        bs=int(bs),
        coords=np.asarray(coords, dtype=np.int64).reshape(-1, 2),
        owner=np.asarray(owner, dtype=np.int32),
        slot=np.asarray(slot, dtype=np.int32),
        cap=int(cap),
        store=_tensor(store).to(mesh.device),
        mesh=mesh,
    )


def distmatrix_to_arrays(x) -> dict:
    """``shape, bs, coords, owner, slot, cap, store`` of a ``DistBSMatrix`` on the
    host; a bf16 store comes back as fp32."""
    return dict(shape=tuple(x.shape), bs=x.bs, coords=x.coords.copy(), owner=x.owner.copy(),
                slot=x.slot.copy(), cap=x.cap, store=_to_numpy(x.store))
