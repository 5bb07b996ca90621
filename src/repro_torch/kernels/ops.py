"""Public kernel entry points: dispatch by the operands' device.

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on a
CUDA card launches the hand-written kernel or raises.  Nothing falls back
from the card to the plain version, and no shape escapes the kernel.

The kernels have no gradient rule, as the JAX package's Pallas calls have
none: with grad mode on, an operand that requires grad makes every entry
point raise ``TypeError``, on the card and on the CPU alike (whatever
``impl``), so a gradient never silently leaves a kernel's inputs out on one
device and reaches them through the plain version on the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import block_spmm as _bsp
from . import flash_attention as _fa
from . import fused_leaf as _fl

__all__ = [
    "block_spmm",
    "block_spmm_tensors",
    "flash_attention",
    "fused_block_spmm",
    "grouped_gemm_tasks",
    "grouped_gemm_varsize",
    "task_arrays",
]

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
    _no_grad("block_spmm", a_data, b_data)
    dev = a_data.device
    if len(a_idx) == 0:
        return torch.zeros((num_out, a_data.shape[1], b_data.shape[2]), dtype=torch.float32, device=dev)
    return block_spmm_tensors(a_data.contiguous(), b_data.contiguous(),
                              *task_arrays(a_idx, b_idx, c_idx, num_out, dev), num_out, impl=impl)


def _no_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a call through the kernel (see the module docstring)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise TypeError(f"{what} has no gradient rule: call it under torch.no_grad(), or take "
                        "a differentiable path (the LM's attn_impl='chunked', gemm_impl='einsum')")


def _route(dev: torch.device, impl: str, what: str, *tensors) -> str:
    """``"kernel"`` or ``"ref"`` for ``impl`` on a tensor of device ``dev``;
    raises under autograd for any of ``tensors`` (:func:`_no_grad`)."""
    _no_grad(what, *tensors)
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
    if _route(a_data.device, impl, "block_spmm", a_data, b_data) == "kernel":
        return _bsp.block_spmm_cuda(*args)
    return _bsp.block_spmm_ref(*args)


def grouped_gemm_tasks(group_sizes, tile_m: int):
    """Host symbolic phase of :func:`grouped_gemm_varsize`: one task per (row tile, group) pair.

    Rows ``[0, T)`` are sorted by group (``group_sizes`` rows each, empty
    groups allowed) and padded to a multiple of ``tile_m``; the padded rows
    belong to the last group.  Returns int64 ``(a_idx, b_idx, c_idx,
    mask_lo, mask_hi)``: task ``i`` multiplies rows ``[mask_lo, mask_hi)`` of
    tile ``a_idx[i]`` by group ``b_idx[i]``'s weight into output tile
    ``c_idx[i] = a_idx[i]``; a tile that spans several groups has one task
    per group, in ascending group order.
    """
    sizes = np.asarray(group_sizes, dtype=np.int64)
    G, T = sizes.size, int(sizes.sum())
    pad = (-T) % tile_m
    starts = np.concatenate([[0], np.cumsum(sizes)])
    row_group = np.concatenate([np.repeat(np.arange(G), sizes), np.full(pad, G - 1)])
    pairs = np.unique(np.arange(T + pad) // tile_m * G + row_group)  # tile-major, then group
    tile, group = pairs // G, pairs % G
    lo = tile * tile_m
    g_hi = np.where(group < G - 1, starts[group + 1], T + pad)
    mask_lo = np.maximum(starts[group] - lo, 0)
    mask_hi = np.minimum(g_hi - lo, tile_m)
    return tile, group, tile.copy(), mask_lo, mask_hi


def grouped_gemm_varsize(x: torch.Tensor, group_sizes, w: torch.Tensor, *,
                         tile_m: int = 8) -> torch.Tensor:
    """Dropless grouped GEMM (MegaBlocks) through :func:`block_spmm`: ``[T, N]``.

    x ``[T, K]`` rows sorted by group (tokens sorted by expert);
    ``group_sizes`` host sizes summing to T; w ``[G, K, N]``.  Row t is
    multiplied by its group's weight.  x is cut into ``tile_m``-row tiles,
    and each task's tile is masked to the rows of its group
    (:func:`grouped_gemm_tasks`), so a boundary tile appears once per group
    it spans and no row is dropped or padded to a capacity.  A CUDA tensor
    launches the ``block_spmm`` kernel, a CPU tensor takes its plain version.
    """
    _no_grad("grouped_gemm_varsize", x, w)
    T, K = x.shape
    if int(np.sum(group_sizes)) != T:
        raise ValueError(f"group sizes sum to {int(np.sum(group_sizes))}, x has {T} rows")
    a_idx, b_idx, c_idx, mask_lo, mask_hi = grouped_gemm_tasks(group_sizes, tile_m)
    nt = -(-T // tile_m)
    xt = torch.nn.functional.pad(x, (0, 0, 0, nt * tile_m - T)).reshape(nt, tile_m, K)
    dev = x.device
    rows = torch.arange(tile_m, device=dev)
    lo, hi = (torch.from_numpy(m).to(dev) for m in (mask_lo, mask_hi))
    sel = (rows[None, :] >= lo[:, None]) & (rows[None, :] < hi[:, None])
    a_data = xt[torch.from_numpy(a_idx).to(dev)] * sel[:, :, None].to(x.dtype)
    out = block_spmm(a_data, w.to(x.dtype), np.arange(a_idx.size), b_idx, c_idx, nt)
    return out.reshape(nt * tile_m, -1)[:T].to(x.dtype)


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
    if _route(a_store.device, "auto", "fused_block_spmm", a_store, a_recv, b_store,
              b_recv) == "kernel":
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
    if _route(q.device, impl, "flash_attention", q, k, v) == "kernel":
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_ref(q, k, v, causal=causal, window=window)
