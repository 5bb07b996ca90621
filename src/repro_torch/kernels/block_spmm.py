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
where :func:`block_spmm_cuda` launches the kernel, and nowhere else;
``launches_by_tiles`` counts the same launches by the ``(engine, pack)`` they
ran (:func:`launch_tiles`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import load_library

__all__ = [
    "ENGINES",
    "block_spmm_cuda",
    "block_spmm_ref",
    "engine_id",
    "engine_takes",
    "full_pack",
    "launch_tiles",
    "launches",
    "launches_by_tiles",
    "pack_id",
    "packed_steps",
    "rows_pack",
    "segment_sum_sorted",
    "task_runs",
    "tile_engine",
]

#: kernel launches so far (see the module docstring)
launches = 0
#: the same launches by ``(engine, pack)``
launches_by_tiles: dict[tuple[str, int], int] = {}

_C_FUNCTIONS = {torch.float32: "block_spmm_f32", torch.bfloat16: "block_spmm_bf16"}


#: the GEMM kernels' tile engines (``csrc/tile_gemm.cuh``), by their ids there
ENGINES = {"tile64": 1, "tilerows": 2, "tile128": 3, "tiletc": 4}
#: TileRows takes blocks of at most this many rows (``tile_gemm::TILEROWS_MAX_BM``)
TILEROWS_MAX_BM = 64
#: the row step a TileRows block's rows round up to
TILEROWS_RSTEP = 8
#: TileTC takes blocks of at least this many rows (``tile_gemm::TILETC_MIN_BM``)
TILETC_MIN_BM = 64


def engine_takes(engine: str, bm: int, bk: int, bn: int, tensors=()) -> bool:
    """Whether ``engine`` takes the block shape: the host mirror of
    ``tile_gemm::engine_takes``.  Tile64 takes any shape, TileRows ``bm <=
    64``, Tile128 ``bm`` and ``bn`` multiples of 128, ``bk`` a multiple of 8
    and every operand stack (``tensors``) 16-byte aligned; TileTC (the
    tensor cores) bf16 stacks only, ``bm >= 64``, ``bk`` and ``bn``
    multiples of 8 and every stack 16-byte aligned.  The store type comes in
    through ``tensors``, as the alignment does: no stacks, no TileTC."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {tuple(ENGINES)}")
    if bm <= 0 or bn <= 0 or bk <= 0:
        return False
    if engine == "tile64":
        return True
    if engine == "tilerows":
        return bm <= TILEROWS_MAX_BM
    aligned = not any(t.data_ptr() % 16 for t in tensors)
    if engine == "tiletc":
        return (bool(tensors) and all(t.dtype == torch.bfloat16 for t in tensors)
                and bm >= TILETC_MIN_BM and bk % 8 == 0 and bn % 8 == 0 and aligned)
    return not (bm % 128 or bn % 128 or bk % 8) and aligned


def tile_engine(bm: int, bk: int, bn: int, tensors=()) -> str:
    """The tile engine the GEMM kernels launch for a block shape:
    ``"tiletc"``, ``"tile128"``, ``"tilerows"`` or ``"tile64"``.

    The host mirror of ``tile_gemm::pick_engine`` (``csrc/tile_gemm.cuh``),
    which ``block_spmm.cu`` and ``fused_block_spmm.cu`` both apply: TileTC
    where it takes the shape and the stores (:func:`engine_takes`;
    ``tensors`` are the kernel's operand stacks, bf16 for TileTC), else
    Tile128, else TileRows for blocks of at most 64 rows, else Tile64.
    """
    for engine in ("tiletc", "tile128", "tilerows"):
        if engine_takes(engine, bm, bk, bn, tensors):
            return engine
    return "tile64"


def engine_id(engine: str | None, bm: int, bk: int, bn: int, tensors=()) -> int:
    """The C entry points' engine argument: 0 (the rule) for ``None``, else
    the id of ``engine``, which must take the shape (``ValueError``)."""
    if engine is None:
        return 0
    if not engine_takes(engine, bm, bk, bn, tensors):
        raise ValueError(f"engine {engine!r} does not take blocks {bm} x {bk} @ {bk} x {bn}"
                         + (" at these alignments" if engine == "tile128" else
                            " of these stores (bf16, 16-byte aligned)" if engine == "tiletc" else ""))
    return ENGINES[engine]


def pack_id(engine: str, pack: int | None, bm: int, bn: int) -> int:
    """The C entry points' pack argument: 0 (the engine's rule) for ``None``,
    else ``pack``, which ``engine`` must take (``ValueError``): TileRows any
    pack from 1 to :func:`rows_pack`, the other engines 1.  The host mirror
    of ``tile_gemm::pick_pack``."""
    if pack is None:
        return 0
    full = full_pack(engine, bm, bn)
    if type(pack) is not int or not 1 <= pack <= full:
        raise ValueError(f"engine {engine!r} takes a pack from 1 to {full} at blocks {bm} x {bn}, "
                         f"got {pack!r}")
    return pack


def launch_tiles(engine: str | None, pack: int | None, bm: int, bk: int, bn: int, dtype,
                 tensors, device) -> tuple[str, int]:
    """The ``(engine, pack)`` a GEMM kernel launches.

    With ``engine=None`` (and no ``pack``): the tile autotuner's pick for the
    block shape, the dtype and the operand stacks ``tensors``
    (:func:`repro_torch.kernels.autotune.pick_tiles`: a tuned winner from the
    on-disk cache, else the rule; a memo lookup, the file ``stat``-ed at most
    once a second).  A forced
    ``engine`` must take the shape (:func:`engine_id`) and ``pack`` must be
    one it takes (:func:`pack_id`; ``None``: its full pack), else
    ``ValueError`` before any launch.
    """
    if engine is None:
        if pack is not None:
            raise ValueError("pack= needs engine=: it is the pack of one engine")
        from .autotune import device_platform, pick_tiles  # autotune imports this module

        return pick_tiles(bm, bk, bn, dtype, platform=device_platform(device), tensors=tensors)
    engine_id(engine, bm, bk, bn, tensors)
    return engine, full_pack(engine, bm, bn) if pack is None else pack_id(engine, pack, bm, bn)


def rows_pack(bm: int, bn: int) -> int:
    """Output blocks one TileRows tile packs: its rows (64, or 128 with the
    8 x 8 register tile it takes for ``bn`` above 64) over ``bm`` rounded up
    to a multiple of 8."""
    return (128 if bn > 64 else 64) // (-(-bm // TILEROWS_RSTEP) * TILEROWS_RSTEP)


def full_pack(engine: str, bm: int, bn: int) -> int:
    """The most output blocks a tile of ``engine`` packs: :func:`rows_pack`
    for TileRows, 1 for the others (the rule's pack)."""
    return rows_pack(bm, bn) if engine == "tilerows" else 1


def packed_steps(run_ptr, key, pack: int, on=None) -> list[tuple[int, list[tuple[int, int]]]]:
    """TileRows' walk of packed runs, in host numpy: the kernel's step rule.

    ``run_ptr`` holds the CSR runs of ``num_out`` output blocks (one
    worker's), ``key[t]`` names task t's B operand (rows of a 2-D ``key``
    compare whole; the fused kernel's key is ``(src, off, low)``), ``on[t]``
    whether task t runs.  Output blocks ``g * pack .. g * pack + pack - 1``
    share a tile.  Each step of a tile takes the head task of its
    lowest-numbered block with tasks left, and the head of every other block
    whose key equals that one's.  Returns ``(group, [(block, task), ...])``
    per step, tile by tile, in the kernel's order.
    """
    rp = np.asarray(run_ptr, dtype=np.int64)
    key = np.asarray(key)
    key = key.reshape(key.shape[0], -1)
    live = np.ones(key.shape[0], bool) if on is None else np.asarray(on, bool)
    num_out = rp.size - 1
    steps = []
    for g in range(-(-num_out // pack)):
        blocks = range(g * pack, min(g * pack + pack, num_out))
        runs = {c: np.arange(rp[c], rp[c + 1])[live[rp[c]:rp[c + 1]]] for c in blocks}
        pos = dict.fromkeys(blocks, 0)
        while True:
            heads = [(c, int(runs[c][pos[c]])) for c in blocks if pos[c] < runs[c].size]
            if not heads:
                break
            lead = key[heads[0][1]]
            step = [(c, t) for c, t in heads if np.array_equal(key[t], lead)]
            for c, _ in step:
                pos[c] += 1
            steps.append((g, step))
    return steps


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
            ctypes.c_int, ctypes.c_int,
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
    *,
    engine: str | None = None,
    pack: int | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel; same arguments and result as :func:`block_spmm_ref`.

    Runs on PyTorch's current stream and does not synchronise.  Raises on
    what the kernel does not take: a tensor off the card, another dtype, a
    non-contiguous stack, a mismatched shape, or a launch the driver refuses.
    ``engine=None`` launches the tile autotuner's ``(engine, pack)`` for the
    block shape (:func:`launch_tiles`: the kernels' rule unless the on-disk
    cache holds a tuned winner).  ``engine`` (tests, benchmarks and the tuner
    hold the engines against each other with it) forces a tile engine of
    :data:`ENGINES` and ``pack`` the output blocks a TileRows tile packs;
    either raises ``ValueError`` where the kernel does not take it.  The
    FFMA engines (Tile64, TileRows, Tile128) give the same bits at every
    pack; TileTC (bf16 stores on the tensor cores) gives its own.
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
    tiles = launch_tiles(engine, pack, bm, bk, bn, a_data.dtype, (a_data, b_data), dev)
    out = torch.empty((num_out, bm, bn), dtype=torch.float32, device=dev)
    if num_out == 0:
        return out
    fn = _kernel_function(a_data.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            a_data.data_ptr(), b_data.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
            run_ptr.data_ptr(), out.data_ptr(), num_out, bm, bk, bn, stream, ENGINES[tiles[0]],
            tiles[1],
        )
    if rc != 0:
        raise RuntimeError(f"block_spmm kernel launch failed: {_error_string(rc)} ({rc})")
    launches += 1
    launches_by_tiles[tiles] = launches_by_tiles.get(tiles, 0) + 1
    return out
