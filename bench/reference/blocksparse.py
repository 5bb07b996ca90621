"""Block-sparse matrix product, plainly: the task list by a join on the inner index, then bmm.

A task is one block product ``A[i, k] @ B[k, j]`` into ``C[i, j]``; the
product's structure is every ``(i, j)`` some task reaches.  Nothing here is
taken from the program: the tasks come from the operands' coordinates alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the precisions :func:`product` computes in besides the name of a
#: floating ``torch`` dtype: float64 is the reference; ``tf32`` the control
#: for float32 with TF32 off: each operand element rounded to TF32's 10
#: explicit mantissa bits (to nearest, ties to even), the products and their
#: sum in float32, as a TF32 tensor core computes.  A dtype's name
#: (``bfloat16``, ``float8_e4m3fn``) rounds each operand element to that
#: type, the products and their sum in float32.
PRECISIONS = ("float64", "tf32")


def _rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(x.float())
    dt = getattr(torch, precision, None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"precision {precision!r} is neither in {PRECISIONS} nor a floating torch dtype")
    return x.to(dt).float()


@dataclasses.dataclass(frozen=True)
class Tasks:
    """``C[c_idx[t]] += A[a_idx[t]] @ B[b_idx[t]]`` for every task ``t``.

    ``c_coords`` is the product's block structure, sorted by row, then
    column; the tasks are sorted by their output block.
    """

    a_idx: np.ndarray
    b_idx: np.ndarray
    c_idx: np.ndarray
    c_coords: np.ndarray

    @property
    def num_tasks(self) -> int:
        return int(self.a_idx.shape[0])

    @property
    def num_out(self) -> int:
        return int(self.c_coords.shape[0])


def product_tasks(a_coords: np.ndarray, b_coords: np.ndarray) -> Tasks:
    """Every block product of ``A @ B`` from the block coordinates ``[n, 2]`` of each."""
    order = np.argsort(b_coords[:, 0], kind="stable")
    b_rows = b_coords[order, 0]
    first = np.searchsorted(b_rows, a_coords[:, 1], side="left")
    counts = np.searchsorted(b_rows, a_coords[:, 1], side="right") - first
    total = int(counts.sum())
    a_idx = np.repeat(np.arange(a_coords.shape[0], dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = order[np.repeat(first, counts) + within].astype(np.int64)
    width = int(b_coords[:, 1].max()) + 1 if b_coords.shape[0] else 1
    keys = a_coords[a_idx, 0] * width + b_coords[b_idx, 1]
    c_keys, c_idx = np.unique(keys, return_inverse=True)
    by_c = np.argsort(c_idx, kind="stable")
    c_coords = np.stack([c_keys // width, c_keys % width], 1).astype(np.int64)
    return Tasks(a_idx[by_c], b_idx[by_c], c_idx[by_c].astype(np.int64), c_coords)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def product(a_values: torch.Tensor, b_values: torch.Tensor, tasks: Tasks, *,
            precision: str = "float64", chunk: int = 8192) -> torch.Tensor:
    """The output blocks ``[num_out, bm, bn]`` of ``A @ B``, in ``precision``, on the values' device.

    The tasks are taken ``chunk`` at a time: both operands gathered, one
    ``torch.bmm``, the products added into their output blocks.
    """
    dev = a_values.device
    if precision == "float64":
        a, b, dtype = a_values.double(), b_values.double(), torch.float64
    else:
        a, b, dtype = _rounded(a_values, precision), _rounded(b_values, precision), torch.float32
    if b_values is a_values:
        b = a
    out = torch.zeros((tasks.num_out, a.shape[1], b.shape[2]), dtype=dtype, device=dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the emulated TF32 is the only rounding
    try:
        for k in range(0, tasks.num_tasks, chunk):
            a_i = torch.from_numpy(tasks.a_idx[k:k + chunk]).to(dev)
            b_i = torch.from_numpy(tasks.b_idx[k:k + chunk]).to(dev)
            c_i = torch.from_numpy(tasks.c_idx[k:k + chunk]).to(dev)
            out.index_add_(0, c_i, torch.bmm(a[a_i], b[b_i]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out
