"""Public kernel entry points: dispatch by the operands' device.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on a
CUDA card launches the hand-written kernel or raises.  Nothing falls back
from the card to the plain version, and no shape escapes the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import block_spmm as _bsp
from . import flash_attention as _fa
from . import fused_leaf as _fl

__all__ = ["block_spmm", "block_spmm_tensors", "flash_attention", "fused_block_spmm", "task_arrays"]

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
    return block_spmm_tensors(a_data.contiguous(), b_data.contiguous(),
                              *task_arrays(a_idx, b_idx, c_idx, num_out, dev), num_out, impl=impl)


def _route(dev: torch.device, impl: str, what: str) -> str:
    """``"kernel"`` or ``"ref"`` for ``impl`` on a tensor of device ``dev``."""
    if impl != "auto":
        return impl
    if dev.type == "cuda":
        return "kernel"
    if dev.type == "cpu":
        return "ref"
    raise ValueError(f"{what} runs on a CUDA card or the CPU, not on {dev}")


def block_spmm_tensors(
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    run_ptr: torch.Tensor,
    num_out: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """:func:`block_spmm` on a task list already on the device (see :func:`task_arrays`)."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    args = (a_data, b_data, a_idx, b_idx, run_ptr, num_out)
    if _route(a_data.device, impl, "block_spmm") == "kernel":
        return _bsp.block_spmm_cuda(*args)
    return _bsp.block_spmm_ref(*args)


def fused_block_spmm(
    a_store: torch.Tensor,
    a_recv: torch.Tensor,
    b_store: torch.Tensor,
    b_recv: torch.Tensor,
    a_src: torch.Tensor,
    a_off: torch.Tensor,
    b_src: torch.Tensor,
    b_off: torch.Tensor,
    run_ptr: torch.Tensor,
    num_out: int,
    *,
    on: torch.Tensor | None = None,
    low: torch.Tensor | None = None,
    adaptive: bool = False,
) -> torch.Tensor:
    """The fused leaf engine for every worker of a mesh in one call.

    Operands are addressed as ``(src, off)`` over each worker's own store and
    stacked receive buffers; ``run_ptr`` holds each worker's CSR runs of its
    sorted output slots (:func:`repro_torch.kernels.fused_leaf.fused_task_runs`);
    ``on`` skips tasks, ``low`` rounds a task's operands to bf16 when
    ``adaptive``.  See :mod:`repro_torch.kernels.fused_leaf`.

    A CUDA tensor launches the hand-written kernel (any block size, no
    fallback); a CPU tensor takes the plain version.  Returns fp32
    ``[P, num_out, bm, bn]``.
    """
    args = (a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off, run_ptr, num_out)
    kw = dict(on=on, low=low, adaptive=adaptive)
    if _route(a_store.device, "auto", "fused_block_spmm") == "kernel":
        return _fl.fused_block_spmm_cuda(*args, **kw)
    return _fl.fused_block_spmm_ref(*args, **kw)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Online-softmax attention; ``q [B, H, Sq, D]``, ``k, v [B, HK, Sk, D]``.

    Queries are aligned to the end of the kv axis; a row with no live key
    gives zeros.  ``impl``: ``"auto"`` launches the kernel on a CUDA tensor
    and takes the plain version on a CPU tensor; ``"kernel"`` launches the
    kernel and raises off the card; ``"ref"`` runs the plain version on any
    device.  See :mod:`repro_torch.kernels.flash_attention`.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if _route(q.device, impl, "flash_attention") == "kernel":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_ref(q, k, v, causal=causal, window=window)
