"""Fault-tolerant checkpointing: atomic commits, async save, restore into a state's shape.

Port of the JAX package's ``repro/checkpoint/manager.py``, with its layout
and protocol::

    <dir>/step_00000123/arrays.npz      flat {path: array} of the state tree
    <dir>/step_00000123/MANIFEST.json   committed LAST -> crash-safe marker

A checkpoint exists iff its manifest exists; a directory written partly
(a crash mid-save) is ignored by restore and removed by the manager's
clean-up.  Paths are the port's tree paths (``params/layers/3/q/w``,
:func:`repro_torch.tree.tree_paths`).  bf16 leaves are stored as fp32 (an
exact conversion: ``np.savez`` has no bf16) and come back in the type of the
state they are restored into.  Arrays are stored whole; a restored state
goes onto a mesh of ranks with :func:`repro_torch.runtime.elastic.reshard_state`.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil

import numpy as np
import torch

from ..obs.timing import Stopwatch
from ..tree import tree_paths, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]

_MANIFEST = "MANIFEST.json"


def _host(leaf) -> np.ndarray:
    """A tensor's host copy, sharing no memory with it (bf16 as fp32); a host array as it is."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in tree_paths(state)}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, state, *, extra: dict | None = None) -> str:
    """Atomic save: arrays first, manifest last (commit point).

    ``state`` is a tree of tensors or of host arrays (what
    :meth:`CheckpointManager.save` snapshots).
    """
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays.keys()), "extra": extra or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    """Largest step with a committed manifest; ignores torn writes."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_like, step: int | None = None):
    """Restore into the structure of ``state_like``: ``(state, step)``.

    ``state_like`` holds tensors (on any device, ``"meta"`` too) that give
    each leaf's shape and type; the restored leaves are CPU tensors of those
    types.  A shape that differs from the file's raises.
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    with np.load(os.path.join(_step_dir(directory, step), "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}
    leaves = []
    for path, like in tree_paths(state_like):
        arr = data[path]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, state shape {tuple(like.shape)}")
        leaves.append(torch.from_numpy(arr).to(like.dtype))
    return tree_unflatten(state_like, leaves), step


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async (background) save.

    ``snapshot_seconds`` and ``write_seconds`` keep, for each save in order,
    the time its host snapshot held the caller and the time its write (and
    the clean-up after it) took, in the background when async.
    """

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1) if async_save else None
        )
        self._pending: concurrent.futures.Future | None = None
        self.snapshot_seconds: list[float] = []
        self.write_seconds: list[float] = []

    def save(self, step: int, state, extra: dict | None = None):
        """Snapshot ``state`` to host memory now, write it (in the background when async).

        The snapshot is a copy, so a later in-place change to the state's
        tensors does not reach the file.
        """
        self.wait()
        sw = Stopwatch()
        arrays = _flatten(state)  # snapshot off-device, before the caller moves on
        self.snapshot_seconds.append(sw.elapsed())

        def work():
            sw = Stopwatch()
            save_checkpoint(self.directory, step, arrays, extra=extra)
            self._gc()
            self.write_seconds.append(sw.elapsed())

        if self._pool is not None:
            self._pending = self._pool.submit(work)
        else:
            work()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def restore_latest(self, state_like):
        return restore_checkpoint(self.directory, state_like)
