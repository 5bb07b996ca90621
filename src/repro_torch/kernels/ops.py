"""Public kernel entry points: dispatch by the operands' device.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on a
CUDA card launches the hand-written kernel or raises.  Nothing falls back
from the card to the plain version, and no shape escapes the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import block_spmm as _bsp

__all__ = ["block_spmm", "task_arrays"]

IMPLS = ("auto", "kernel", "ref")


def task_arrays(
    a_idx, b_idx, c_idx, num_out: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host task list -> int64 ``(a_idx, b_idx, run_ptr)`` on ``device``."""
    run_ptr = _bsp.task_runs(c_idx, num_out)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(device)

    return up(a_idx), up(b_idx), up(run_ptr)


def block_spmm(
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    a_idx,
    b_idx,
    c_idx,
    num_out: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Grouped block matmul: C[c[t]] += A[a[t]] @ B[b[t]], c sorted ascending.

    ``a_idx``/``b_idx``/``c_idx`` are the host task list (numpy).  Output
    rows no task writes are zeros (a trailing padded-task trash row
    included).  ``impl``: ``"auto"`` takes the kernel on a CUDA tensor and the
    plain version on a CPU tensor; ``"kernel"`` launches the kernel and raises
    off the card; ``"ref"`` runs the plain version on any device.

    Returns fp32 ``[num_out, bm, bn]``.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    dev = a_data.device
    if len(a_idx) == 0:
        return torch.zeros((num_out, a_data.shape[1], b_data.shape[2]), dtype=torch.float32, device=dev)
    if impl == "auto":
        if dev.type == "cuda":
            impl = "kernel"
        elif dev.type == "cpu":
            impl = "ref"
        else:
            raise ValueError(f"block_spmm runs on a CUDA card or the CPU, not on {dev}")
    args = (a_data.contiguous(), b_data.contiguous(), *task_arrays(a_idx, b_idx, c_idx, num_out, dev), num_out)
    if impl == "kernel":
        return _bsp.block_spmm_cuda(*args)
    return _bsp.block_spmm_ref(*args)
