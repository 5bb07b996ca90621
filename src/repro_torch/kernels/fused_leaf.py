"""Fused leaf engine: unpack + grouped block GEMM + C-accumulate for every worker.

The numeric phase of every resident multiply (:mod:`repro_torch.dist`).  The
staged path builds, per worker, the concatenated operand buffer ``[own store
| recv_0 | recv_1 | ...]`` after the exchange and runs the grouped GEMM over
it; the fused engine never builds it.  The plan's task operand indices are
decomposed host-side into ``(src, off)`` pairs
(:func:`repro_torch.core.schedule.split_local_indices`): ``src == 0`` reads
the worker's own store at row ``off``; ``src == r + 1`` reads its receive
buffer ``r`` at row ``off``.

All P workers of the mesh run in one call: stores ``[P, cap, bm, bk]``,
stacked receive buffers ``[P, R, capU, bm, bk]``, task arrays ``[P, t_cap]``
and per-worker CSR runs ``run_ptr[P, num_out + 1]`` of the sorted output
slots (:func:`fused_task_runs`); the result is fp32 ``[P, num_out, bm, bn]``.
Each output block sums its run's products in ascending task order.  A
per-task ``on`` flag (the delta-plan SpAMM mask) skips a task in place — the
JAX package redirects masked tasks to a trash row instead, which leaves the
output index list unsorted — and in ``adaptive`` mode a per-task ``low`` flag
rounds that task's fp32 operands to bf16 (round to nearest even) before its
products (:mod:`repro_torch.kernels.precision`).  Stores may be bf16 (the
``bf16`` policy casts before the exchange); accumulation is always fp32.

On an NVIDIA Hopper card :func:`fused_block_spmm_cuda` launches the
hand-written kernel of ``csrc/fused_block_spmm.cu``, the port of the Pallas
TPU kernel in the JAX package's ``repro/kernels/fused_leaf.py``;
:func:`fused_block_spmm_ref` is its plain PyTorch version, which the CPU
takes and against which the kernel is checked on the card.

``launches`` counts the kernel launches of this process: it is raised by one
where :func:`fused_block_spmm_cuda` launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .block_spmm import engine_id, segment_sum_sorted
from .build import load_library

__all__ = [
    "first_accumulation_hazard",
    "fused_block_spmm_cuda",
    "fused_block_spmm_ref",
    "fused_task_runs",
    "launches",
]

#: kernel launches so far (see the module docstring)
launches = 0

_LIBRARY = "fused_block_spmm"
_C_FUNCTIONS = {torch.float32: "fused_block_spmm_f32", torch.bfloat16: "fused_block_spmm_bf16"}


def first_accumulation_hazard(c_idx) -> int | None:
    """First task index violating the run-per-output contract, else ``None``.

    Each output row must be visited by one contiguous ascending run of tasks:
    a ``c_idx`` that revisits an earlier row would split that row's sum
    between two runs (the TPU kernel re-zeroes the row and drops the first
    run; the runs of :func:`fused_task_runs` cannot be built at all).
    Host-side (numpy), as in the JAX package, which shares it with its
    static verifier.
    """
    c = np.asarray(c_idx).reshape(-1)
    if c.size < 2:
        return None
    dec = np.nonzero(np.diff(c) < 0)[0]
    return int(dec[0]) + 1 if dec.size else None


def fused_task_runs(task_c: np.ndarray, num_out: int) -> np.ndarray:
    """Per-worker CSR runs ``run_ptr[P, num_out + 1]`` of sorted output slots.

    ``task_c[p]`` must be ascending.  Tasks ``run_ptr[p, c] : run_ptr[p, c +
    1]`` of worker ``p`` write its output block ``c``; tasks whose slot is
    ``>= num_out`` (a plan's padding, aimed at the trash row ``c_cap``) lie
    past ``run_ptr[p, num_out]`` and are never visited.
    """
    c = np.asarray(task_c, dtype=np.int64)
    if c.ndim != 2:
        raise ValueError(f"task_c must be [P, t_cap], got shape {c.shape}")
    for p in range(c.shape[0]):
        bad = first_accumulation_hazard(c[p])
        if bad is not None:
            raise ValueError(f"worker {p}: task_c is not ascending at task {bad}")
        if c.shape[1] and c[p, 0] < 0:
            raise ValueError(f"worker {p}: negative output slot")
    rows = np.arange(num_out + 1, dtype=np.int64)
    return np.stack([np.searchsorted(c[p], rows, side="left") for p in range(c.shape[0])]
                    ) if c.shape[0] else np.zeros((0, num_out + 1), np.int64)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _gather(store, recv, p, src, off) -> torch.Tensor:
    """Operand blocks of tasks ``(p, src, off)`` from the stores and receive stacks."""
    P, cap = store.shape[:2]
    R, capu = recv.shape[1:3]
    flat_store = store.reshape(P * cap, *store.shape[2:])
    flat_recv = recv.reshape(P * R * capu, *recv.shape[3:])
    local = src == 0
    out = torch.empty((src.numel(), *store.shape[2:]), dtype=store.dtype, device=store.device)
    out[local] = flat_store[p[local] * cap + off[local]]
    far = ~local
    out[far] = flat_recv[(p[far] * R + src[far] - 1) * capu + off[far]]
    return out


def fused_block_spmm_ref(
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
    """Plain version: gather the tasks that are on, ``torch.bmm`` in fp32, ordered sum.

    The tasks of all workers are taken worker by worker, each worker's in
    ascending order, which is the order in which the staged plain path
    (:class:`repro_torch.core.distributed.SpgemmExecutable`, ``impl="ref"``)
    lists them: in fp32 the two are bit-identical.  Materialises the
    ``[T, bm, bn]`` products, so it is for checks and the CPU.  Returns fp32
    ``[P, num_out, bm, bn]``.
    """
    P, T = a_src.shape
    bm, bn = a_store.shape[2], b_store.shape[3]
    dev = a_store.device
    assert run_ptr.shape == (P, num_out + 1), (tuple(run_ptr.shape), P, num_out)
    slots = torch.arange(T, device=dev).expand(P, T).contiguous()
    keep = slots < run_ptr[:, num_out:]  # past the last run: padding
    if on is not None:
        keep &= on.bool()
    p, t = torch.nonzero(keep, as_tuple=True)
    c = torch.searchsorted(run_ptr, slots, right=True)[p, t] - 1
    lhs = _gather(a_store, a_recv, p, a_src[p, t], a_off[p, t]).float()
    rhs = _gather(b_store, b_recv, p, b_src[p, t], b_off[p, t]).float()
    if adaptive:
        if low is None:
            raise ValueError("adaptive mode needs the per-task low flags")
        lo = low[p, t].bool()[:, None, None]
        lhs = torch.where(lo, _round_bf16(lhs), lhs)
        rhs = torch.where(lo, _round_bf16(rhs), rhs)
    prods = torch.bmm(lhs, rhs)
    rows = p * num_out + c  # ascending: worker-major, runs ascending
    runs = torch.searchsorted(rows, torch.arange(P * num_out + 1, device=dev))
    return segment_sum_sorted(prods, runs).reshape(P, num_out, bm, bn)


def _kernel_function(dtype: torch.dtype):
    fn = getattr(load_library(_LIBRARY), _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int])
        fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = load_library(_LIBRARY).fused_block_spmm_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def fused_block_spmm_cuda(
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
    engine: str | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as :func:`fused_block_spmm_ref`.

    Runs on PyTorch's current stream and does not synchronise.  Raises on
    what the kernel does not take: a tensor off the card, another dtype, a
    non-contiguous tensor, mismatched shapes, or a launch the driver refuses.
    ``engine`` (internal, for tests and benchmarks) forces a tile engine as
    in :func:`repro_torch.kernels.block_spmm.block_spmm_cuda`.
    """
    global launches
    dev = a_store.device
    blocks = (a_store, a_recv, b_store, b_recv)
    index = (a_src, a_off, b_src, b_off, run_ptr)
    flags = tuple(f for f in (on, low if adaptive else None) if f is not None)
    tensors = blocks + index + flags
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_block_spmm_cuda needs every tensor on one CUDA device, got {dev}")
    if a_store.dtype not in _C_FUNCTIONS or any(t.dtype != a_store.dtype for t in blocks):
        raise TypeError(f"fused_block_spmm_cuda takes fp32 or bf16 blocks of one dtype, "
                        f"got {[str(t.dtype) for t in blocks]}")
    if any(t.dtype != torch.int64 for t in index):
        raise TypeError("fused_block_spmm_cuda takes int64 task arrays and runs")
    if any(t.dtype != torch.bool for t in flags):
        raise TypeError("fused_block_spmm_cuda takes bool on/low flags")
    if adaptive and low is None:
        raise ValueError("adaptive mode needs the per-task low flags")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_block_spmm_cuda takes contiguous tensors")
    P, capa, bm, bk = a_store.shape
    capb, bn = b_store.shape[1], b_store.shape[3]
    T = a_src.shape[1] if a_src.ndim == 2 else -1
    if (a_recv.ndim != 5 or b_recv.ndim != 5 or b_store.ndim != 4
            or a_recv.shape[0] != P or b_store.shape[0] != P or b_recv.shape[0] != P
            or a_recv.shape[3:] != (bm, bk) or b_store.shape[2] != bk
            or b_recv.shape[3:] != (bk, bn)):
        raise ValueError(f"store shapes do not chain: {[tuple(t.shape) for t in blocks]}")
    if (any(t.shape != (P, T) for t in (a_src, a_off, b_src, b_off) + flags)
            or run_ptr.shape != (P, num_out + 1)):
        raise ValueError("task arrays do not match the stores, each other or num_out")
    eid = engine_id(engine, bm, bk, bn, blocks)
    out = torch.empty((P, num_out, bm, bn), dtype=torch.float32, device=dev)
    if P == 0 or num_out == 0:
        return out
    fn = _kernel_function(a_store.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = fn(
            a_store.data_ptr(), a_recv.data_ptr(), b_store.data_ptr(), b_recv.data_ptr(),
            a_src.data_ptr(), a_off.data_ptr(), b_src.data_ptr(), b_off.data_ptr(),
            run_ptr.data_ptr(), ptr(on), ptr(low if adaptive else None), out.data_ptr(),
            P, num_out, T, capa, a_recv.shape[1], a_recv.shape[2],
            capb, b_recv.shape[1], b_recv.shape[2], bm, bk, bn, stream, eid,
        )
    if rc != 0:
        raise RuntimeError(f"fused_block_spmm kernel launch failed: {_error_string(rc)} ({rc})")
    launches += 1
    return out
