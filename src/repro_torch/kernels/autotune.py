"""On-disk tile autotuner for the GEMM kernels: the port of ``repro/kernels/autotune.py``.

The JAX package tunes the ``(tm, tn, tk)`` output tile of its Pallas
programs.  The port's GEMM kernels (``csrc/block_spmm.cu`` and
``csrc/fused_block_spmm.cu``) run one of four tile engines
(:data:`~repro_torch.kernels.block_spmm.ENGINES`), and TileRows packs up to
:func:`~repro_torch.kernels.block_spmm.rows_pack` output blocks into one tile
of rows: its rows are that pack times the block's rows rounded up to 8.  So
the port's tiling is the pair ``(engine, pack)``, the pack 1 for the engines
other than TileRows.  The three FFMA engines give the same bits at every
pack (one ``fmaf`` chain per output element, in task order); TileTC, which
the rule takes for bf16 stores wherever it can, sums in the tensor cores'
order.  So where TileTC takes a shape its own pair is the only candidate
and an FFMA pair in the cache is stale, and elsewhere TileTC is none: the
choice moves time only, never the bits.

Winners measured per ``(platform, bm, bk, bn, dtype)`` are kept in a small
JSON cache and looked up by :func:`pick_tiles` before every launch of
``block_spmm_cuda`` and ``fused_block_spmm_cuda`` that names no engine; the
resident executables (``repro_torch.core.distributed``) take the pick once
per dtype and stack alignment and name it in their launches, as the JAX
package fixes its tiles when it traces an executable.  An
untuned shape, and any unreadable or corrupt cache file, takes the kernels'
fixed rule (:func:`heuristic_tiles`), so the tuner is opt-in: correctness
never depends on the cache.  A lookup is a dict lookup in the in-process
memo; the cache file is ``stat``-ed at most once every
:data:`STAT_INTERVAL_S` seconds (a ``stat`` can cost tens of us where the
file system is virtualised, against some 40 us of host time a launch on an
H100's host, ``chip_smoke.py``'s ``autotune`` phase) and parsed again
only when its mtime moves.  This process's own writes
(:func:`save_tile_entry`) and :func:`clear_memo` take effect at once.

The key holds the block shape only, not the task list, as the JAX package's
does, and which pair is fastest depends on the task list: packed output
blocks that share B operands (the band's, the dropless grouped GEMM's tiles
of one expert) favour a full pack, blocks that share none (a random list)
favour Tile64 or a small pack.  So a winner is saved only from a ``bench``
over the task lists that you run: the default bench times a random list
that no path of the package runs, and :func:`autotune_tiles` reports its
winner without saving it unless asked to (``persist=True``).

The cache is ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``~/.cache/repro_torch/autotune.json``: not the JAX package's file, whose
loader keeps only entries of three ints.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from ..obs.timing import Stopwatch
from .block_spmm import ENGINES, engine_id, engine_takes, full_pack, pack_id, tile_engine

__all__ = [
    "time_call",
    "heuristic_tiles",
    "tile_key",
    "default_cache_path",
    "default_platform",
    "device_platform",
    "load_tile_cache",
    "save_tile_entry",
    "pick_tiles",
    "candidate_tiles",
    "autotune_tiles",
    "clear_memo",
]

CACHE_VERSION = 1
_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"

#: a cache file is stat-ed at most once this many seconds (see the module docstring)
STAT_INTERVAL_S = 1.0

# in-process memo of cache files: path -> (mtime or None when missing, entries
# dict, time.monotonic() of the last stat)
_memo: dict[str, tuple[float | None, dict, float]] = {}
# card names by device index (the cache's platform)
_platforms: dict[int, str] = {}

# the default bench's random task list: 2,048 tasks over 128 operand blocks
# into 256 output blocks, enough tiles to fill the card; launched this many
# times a timed call, queued behind a spin of this many clock cycles (some
# 3 ms on an H100) so that the card runs them back to back whatever the host
# takes to launch them (some 30-45 us each, as long as the shortest launches)
BENCH_TASKS, BENCH_BLOCKS, BENCH_OUTPUTS = 2048, 128, 256
BENCH_LAUNCHES = 10
BENCH_SPIN_CYCLES = 5_000_000


def time_call(fn, reps: int = 5) -> float:
    """Mean seconds per call after one warm-up call.

    ``fn`` must finish its work before it returns (synchronise the card):
    the card runs asynchronously, so otherwise this times the launch only.
    The wall clock times the calls, unless ``fn`` returns a number: the
    seconds it timed itself (the device time between CUDA events, as the
    default bench does), whose mean is returned instead.
    """
    fn()
    sw = Stopwatch()
    own = [fn() for _ in range(reps)]
    wall = sw.elapsed()
    if own and all(isinstance(t, (int, float)) for t in own):
        return sum(own) / len(own)
    return wall / max(reps, 1)


def heuristic_tiles(bm: int, bk: int, bn: int, tensors=()) -> tuple[str, int]:
    """The kernels' fixed rule as ``(engine, pack)``, the fallback for untuned
    shapes: :func:`~repro_torch.kernels.block_spmm.tile_engine` with its full
    pack (``tensors``: the operand stacks, whose alignment Tile128 needs)."""
    engine = tile_engine(bm, bk, bn, tensors)
    return engine, full_pack(engine, bm, bn)


def tiles_take(tiles, bm: int, bk: int, bn: int, tensors=()) -> bool:
    """Whether ``(engine, pack)`` may stand for the rule at this block shape
    (the stores' type and alignment, from ``tensors``, included): the
    wrappers' own checks, :func:`~repro_torch.kernels.block_spmm.engine_id`
    and ``pack_id``, and the rule's bits: where TileTC takes the shape it
    alone gives them, so an FFMA pair there is refused (a forced ``engine=``
    may still run one)."""
    engine, pack = tiles
    try:
        engine_id(engine, bm, bk, bn, tensors)
        pack_id(engine, pack, bm, bn)
    except ValueError:
        return False
    return (engine == "tiletc") == engine_takes("tiletc", bm, bk, bn, tensors)


def dtype_name(dtype) -> str:
    """``float32`` / ``bfloat16`` for a torch or numpy dtype or a name."""
    return str(dtype).removeprefix("torch.")


def default_platform() -> str:
    """The current card's name, or ``cpu`` without one."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def device_platform(device: torch.device) -> str:
    """The cache's platform for a tensor's device: the card's name (memoised
    per device index), ``cpu`` off the card."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = _platforms.get(index)
    if name is None:
        name = _platforms[index] = torch.cuda.get_device_name(index)
    return name


def tile_key(platform: str, bm: int, bk: int, bn: int, dtype) -> str:
    """The cache key, the JAX package's string: ``platform|bmxbkxbn|dtype``."""
    return f"{platform}|{int(bm)}x{int(bk)}x{int(bn)}|{dtype_name(dtype)}"


def default_cache_path() -> str:
    path = os.environ.get(_ENV_VAR)
    if path:
        return path
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


def _is_tiles(value) -> bool:
    """An ``[engine name, int pack]`` pair (a JSON entry)."""
    return (isinstance(value, (list, tuple)) and len(value) == 2 and isinstance(value[0], str)
            and value[0] in ENGINES and type(value[1]) is int)


def load_tile_cache(path: str | None = None) -> dict:
    """Entries ``key -> (engine, pack)`` from the on-disk cache; ``{}`` when
    the file is missing, unreadable, not JSON or of another version.

    A malformed file must never break a kernel launch: it reads as empty and
    the rule takes over.  Entries that are not an ``[engine, int pack]`` pair
    are dropped.  The file is stat-ed at most once every
    :data:`STAT_INTERVAL_S` seconds and parsed again only when its mtime moves.
    """
    path = path or default_cache_path()
    now = time.monotonic()
    memo = _memo.get(path)
    if memo is not None and now - memo[2] < STAT_INTERVAL_S:
        return memo[1]
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        _memo[path] = (None, {}, now)
        return {}
    if memo is not None and memo[0] == mtime:
        _memo[path] = (mtime, memo[1], now)
        return memo[1]
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except (OSError, ValueError):  # unreadable, or not JSON (UnicodeDecodeError included)
        raw = None
    entries = {}
    if (isinstance(raw, dict) and raw.get("version") == CACHE_VERSION
            and isinstance(raw.get("entries"), dict)):
        entries = {k: (v[0], v[1]) for k, v in raw["entries"].items() if _is_tiles(v)}
    _memo[path] = (mtime, entries, now)
    return entries


def save_tile_entry(key: str, tiles: tuple[str, int], path: str | None = None) -> None:
    """Merge one winner into the cache file (atomic replace)."""
    if not _is_tiles(tiles):
        raise ValueError(f"tiles must be (engine in {tuple(ENGINES)}, int pack), got {tiles!r}")
    path = path or default_cache_path()
    _memo.pop(path, None)  # merge into the file as it is now, not as last read
    entries = dict(load_tile_cache(path))
    entries[key] = (tiles[0], tiles[1])
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump({"version": CACHE_VERSION, "entries": entries}, fh, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _memo.pop(path, None)


def clear_memo() -> None:
    """Drop the in-process cache-file memo (tests poking at the file)."""
    _memo.clear()


def pick_tiles(
    bm: int,
    bk: int,
    bn: int,
    dtype="float32",
    *,
    platform: str | None = None,
    path: str | None = None,
    tensors=(),
) -> tuple[str, int]:
    """``(engine, pack)`` for a block shape: the tuned winner if cached, else
    the rule (:func:`heuristic_tiles`).

    A cached entry that the kernels do not take at this shape (a stale file,
    a hand edit: an engine that does not take the shape or the alignment of
    ``tensors``, a pack below 1 or above the engine's full pack), or an FFMA
    pair where TileTC takes the bf16 stores (:func:`tiles_take`), is ignored,
    not trusted, so it never reaches the kernel as a refused launch or moves
    the bits.
    """
    platform = platform or default_platform()
    entry = load_tile_cache(path).get(tile_key(platform, bm, bk, bn, dtype))
    if entry is not None and tiles_take(entry, bm, bk, bn, tensors):
        return entry
    return heuristic_tiles(bm, bk, bn, tensors)


def candidate_tiles(bm: int, bk: int, bn: int, tensors=()) -> list[tuple[str, int]]:
    """Every ``(engine, pack)`` with the rule's bits at this shape: TileTC's
    own pair where it takes the shape and the stores (``tensors``); else
    every FFMA engine that takes it, TileRows at each power of two below its
    full pack and at the full pack (the rule's), the others at pack 1."""
    if engine_takes("tiletc", bm, bk, bn, tensors):
        return [("tiletc", 1)]
    out = []
    for engine in ENGINES:
        if not engine_takes(engine, bm, bk, bn, tensors):
            continue
        full = full_pack(engine, bm, bn)
        packs = [1 << i for i in range(full.bit_length()) if 1 << i < full] + [full]
        out += [(engine, p) for p in packs]
    return out


def autotune_tiles(
    bm: int,
    bk: int,
    bn: int,
    dtype="float32",
    *,
    bench=None,
    candidates=None,
    reps: int = 3,
    platform: str | None = None,
    path: str | None = None,
    persist: bool | None = None,
) -> tuple[tuple[str, int], list[dict]]:
    """Time candidate ``(engine, pack)`` pairs for one block shape and persist the winner.

    ``bench(engine, pack)`` must return a zero-argument callable that runs
    the kernel with that pair and synchronises the card before it returns
    (:func:`time_call`).  The default bench launches ``block_spmm_cuda``
    :data:`BENCH_LAUNCHES` times a call on a random task list
    (:data:`BENCH_TASKS` tasks into :data:`BENCH_OUTPUTS` outputs), timed on
    the card, and needs a card: timing the plain version would tune nothing.
    A candidate that raises is recorded with ``us=None`` and skipped.  The
    winner is saved when ``persist`` is true; ``None`` saves it from a
    caller's ``bench`` only, since the default bench's random list is no
    path's traffic and its winner can slow the lists that run (see the
    module docstring).  With no candidate left the result is the rule's
    pair and nothing is saved.  Returns the winner and the per-candidate rows.
    """
    platform = platform or default_platform()
    if persist is None:
        persist = bench is not None
    if bench is None:
        bench = _default_bench(bm, bk, bn, dtype)
    candidates = candidates or candidate_tiles(bm, bk, bn)
    rows = []
    best, best_t = None, float("inf")
    for engine, pack in candidates:
        try:
            fn = bench(engine, pack)
            t = time_call(fn, reps=reps)
        except Exception as e:  # noqa: BLE001 - a refused candidate is a result, recorded
            rows.append(dict(tiles=(engine, pack), us=None, error=str(e)))
            continue
        rows.append(dict(tiles=(engine, pack), us=t * 1e6))
        if t < best_t:
            best, best_t = (engine, pack), t
    if best is None:
        best = heuristic_tiles(bm, bk, bn)
    elif persist:
        save_tile_entry(tile_key(platform, bm, bk, bn, dtype), best, path)
    return best, rows


def _default_bench(bm: int, bk: int, bn: int, dtype):
    """The JAX package's random task list, sized to fill the card, through
    ``block_spmm_cuda``, timed on the card: each call returns the seconds
    between CUDA events around its launches, queued behind a spin
    (``torch.cuda._sleep``); raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("autotune_tiles times the CUDA kernels and needs a card "
                           "(or pass bench=): timing the plain version would tune nothing")
    from .block_spmm import block_spmm_cuda, task_runs

    dev = torch.device("cuda")
    dt = getattr(torch, dtype_name(dtype))
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((BENCH_BLOCKS, bm, bk), generator=gen, device=dev).to(dt)
    b = torch.randn((BENCH_BLOCKS, bk, bn), generator=gen, device=dev).to(dt)
    ai = torch.from_numpy(rng.integers(0, BENCH_BLOCKS, BENCH_TASKS)).to(dev)
    bi = torch.from_numpy(rng.integers(0, BENCH_BLOCKS, BENCH_TASKS)).to(dev)
    ci = np.sort(rng.integers(0, BENCH_OUTPUTS, BENCH_TASKS))
    run_ptr = torch.from_numpy(task_runs(ci, BENCH_OUTPUTS)).to(dev)

    def bench(engine, pack):
        def run():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(BENCH_SPIN_CYCLES)
            start.record()
            for _ in range(BENCH_LAUNCHES):
                block_spmm_cuda(a, b, ai, bi, run_ptr, BENCH_OUTPUTS, engine=engine, pack=pack)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3

        return run

    return bench
