"""Grouped block-sparse matmul ``C[c[t]] += A[a[t]] @ B[b[t]]``: CUDA kernel and plain version.

The numeric phase of every multiplication task type.  On an NVIDIA Hopper
card :func:`block_spmm_cuda` launches the hand-written kernel of
``csrc/block_spmm.cu`` (the port of the Pallas TPU kernel in the JAX package's
``repro/kernels/block_spmm.py``); :func:`block_spmm_ref` is its plain PyTorch
version, which the CPU takes and against which the kernel is checked on the
card.  Both take the task list as device tensors: operand block indices
``a_idx``/``b_idx`` and the CSR runs ``run_ptr`` of the ascending output
indices (:func:`task_runs`), and both sum each output block's products in
ascending task order, so neither uses atomics or a scatter-add.

``launches`` counts the kernel launches of this process: it is raised by one
where :func:`block_spmm_cuda` launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load_library

__all__ = [
    "block_spmm_cuda",
    "block_spmm_ref",
    "launches",
    "segment_sum_sorted",
    "task_runs",
    "tile_engine",
]

#: kernel launches so far (see the module docstring)
launches = 0

_C_FUNCTIONS = {torch.float32: "block_spmm_f32", torch.bfloat16: "block_spmm_bf16"}


def tile_engine(bm: int, bk: int, bn: int, tensors=()) -> str:
    """The tile engine the GEMM kernels launch for a block shape: ``"tile128"`` or ``"tile64"``.

    The host mirror of ``tile_gemm::use_tile128`` (``csrc/tile_gemm.cuh``),
    which ``block_spmm.cu`` and ``fused_block_spmm.cu`` both apply: the 128 x
    128 engine needs ``bm`` and ``bn`` multiples of 128, ``bk`` a multiple of
    8 and every operand stack (``tensors``, the kernel's operand tensors)
    16-byte aligned; anything else takes the 64 x 64 engine.
    """
    if bm <= 0 or bn <= 0 or bk <= 0 or bm % 128 or bn % 128 or bk % 8:
        return "tile64"
    if any(t.data_ptr() % 16 for t in tensors):
        return "tile64"
    return "tile128"


def task_runs(c_idx: np.ndarray, num_out: int) -> np.ndarray:
    """CSR run offsets ``run_ptr[num_out + 1]`` of an ascending output index list.

    Tasks ``run_ptr[c] : run_ptr[c + 1]`` all write output block ``c``; a
    block no task writes has an empty run.
    """
    c = np.asarray(c_idx, dtype=np.int64)
    if c.size and (c[0] < 0 or c[-1] >= num_out or np.any(c[1:] < c[:-1])):
        raise ValueError("c_idx must be sorted ascending and lie in [0, num_out)")
    return np.searchsorted(c, np.arange(num_out + 1, dtype=np.int64), side="left")


def segment_sum_sorted(x: torch.Tensor, run_ptr: torch.Tensor) -> torch.Tensor:
    """``out[s] = x[run_ptr[s]] + x[run_ptr[s] + 1] + ...``, summed in that order.

    Deterministic on every device: the r-th element of every run is added in
    one pass over distinct output rows, never with a scatter-add.  Empty runs
    give zeros.
    """
    starts = run_ptr[:-1]
    lens = run_ptr[1:] - starts
    out = torch.zeros((starts.numel(), *x.shape[1:]), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return out
    for r in range(int(lens.max())):
        rows = torch.nonzero(lens > r).squeeze(1)
        out[rows] += x[starts[rows] + r]
    return out


def block_spmm_ref(
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    run_ptr: torch.Tensor,
    num_out: int,
) -> torch.Tensor:
    """Plain version: gather, ``torch.bmm`` in fp32, ordered sum per output block.

    fp32 accumulation whatever the input dtype, as the kernel.  Returns fp32
    ``[num_out, bm, bn]``.  It materialises the ``[T, bm, bn]`` products, so
    it is for checks and the CPU, not for the card's large task lists.
    """
    assert run_ptr.numel() == num_out + 1, (run_ptr.numel(), num_out)
    prods = torch.bmm(a_data[a_idx].float(), b_data[b_idx].float())
    return segment_sum_sorted(prods, run_ptr)


def _kernel_function(dtype: torch.dtype):
    fn = getattr(load_library("block_spmm"), _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = load_library("block_spmm").block_spmm_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def block_spmm_cuda(
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    run_ptr: torch.Tensor,
    num_out: int,
) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as :func:`block_spmm_ref`.

    Runs on PyTorch's current stream and does not synchronise.  Raises on
    what the kernel does not take: a tensor off the card, another dtype, a
    non-contiguous stack, a mismatched shape, or a launch the driver refuses.
    """
    global launches
    dev = a_data.device
    tensors = (a_data, b_data, a_idx, b_idx, run_ptr)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"block_spmm_cuda needs every tensor on one CUDA device, got {dev}")
    if a_data.dtype not in _C_FUNCTIONS or b_data.dtype != a_data.dtype:
        raise TypeError(f"block_spmm_cuda takes fp32 or bf16 blocks, got {a_data.dtype}/{b_data.dtype}")
    if any(t.dtype != torch.int64 for t in tensors[2:]):
        raise TypeError("block_spmm_cuda takes int64 task indices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("block_spmm_cuda takes contiguous tensors")
    if a_data.ndim != 3 or b_data.ndim != 3 or a_data.shape[2] != b_data.shape[1]:
        raise ValueError(f"block shapes do not chain: {tuple(a_data.shape)} @ {tuple(b_data.shape)}")
    if a_idx.shape != b_idx.shape or run_ptr.numel() != num_out + 1 or num_out >= 2**31:
        raise ValueError("task arrays do not match num_out")
    bm, bk, bn = a_data.shape[1], a_data.shape[2], b_data.shape[2]
    out = torch.empty((num_out, bm, bn), dtype=torch.float32, device=dev)
    if num_out == 0:
        return out
    fn = _kernel_function(a_data.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            a_data.data_ptr(), b_data.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), num_out, bm, bk, bn, stream,
        )
    if rc != 0:
        raise RuntimeError(f"block_spmm kernel launch failed: {_error_string(rc)} ({rc})")
    launches += 1
    return out
