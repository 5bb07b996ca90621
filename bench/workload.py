"""What the drivers share: the result as the judge reads it, a held sample of it, the inputs' checksum.

A traffic mix (``bench/traffic/<mix>.json``) is data: the parameters of its
load and the name of its ``driver``.  A driver (``bench/drivers/<name>.py``)
is the one piece of code a mix needs of its own.  It exports ``Driver``::

    Driver(config, traffic, structure, seed, device, cache=None)
    .setup() -> dict          # seconds of each set-up step, warm calls included
    .call()                   # one operation, not waited for; returns its result
    .answer(result) -> Answer # the result as the judge reads it
    .counters() -> dict       # the program's counters, read before and after the window
    .release()                # frees the program's state
    .judge(answers, control=False) -> (work, results)

``judge`` draws the inputs again from the seed and holds each answer against
the plain reference (``bench/reference/``); with ``control`` it also judges
the reference computed in the configuration's lower precision, under
``"control"``.  ``work`` is what the roofline readers count (``tasks``,
``bs``, ``a_blocks``, ``c_blocks``, ``dtype``).  The closed loop, the
window, the trace and the metrics are ``bench/run.py``'s, for every driver.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def dtype_of(config: dict) -> torch.dtype:
    """The configuration's ``dtype`` as a ``torch.dtype``, found by its name in ``torch``."""
    dt = getattr(torch, config["dtype"], None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"dtype {config['dtype']!r} is not a torch dtype")
    return dt


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Answer:
    """A block-sparse result as the program returned it: its block
    coordinates, and its blocks at given positions, ``blocks(idx)`` ->
    ``[len(idx), bm, bn]``.  ``held`` lists the positions whose blocks can be
    read, where only a sample was kept; ``None`` where all can."""

    coords: np.ndarray
    blocks: object
    held: np.ndarray | None = None


def hold(answer: Answer, count: int, rng: np.random.Generator) -> Answer:
    """A copy of ``answer``'s coordinates and of ``count`` of its blocks drawn
    with ``rng``, so that the result itself can be freed: what the judge
    needs of an answer kept through the window, and little memory."""
    coords = np.array(answer.coords, copy=True)
    idx = np.sort(rng.choice(len(coords), size=min(int(count), len(coords)), replace=False))
    kept = answer.blocks(idx).clone()

    def blocks(want: np.ndarray) -> torch.Tensor:
        at = np.searchsorted(idx, want)
        if not np.array_equal(idx[np.minimum(at, len(idx) - 1)], want):
            raise KeyError("a block that was not held")
        return kept[torch.from_numpy(at).to(kept.device)]

    return Answer(coords, blocks, idx)


def checksum(values: torch.Tensor, slab: int = 4096) -> tuple:
    """Two float64 sums that a second draw of the same inputs has to repeat
    exactly, taken slab by slab so that no float64 copy of the whole is made."""
    total = values.new_zeros((), dtype=torch.float64)
    absolute = values.new_zeros((), dtype=torch.float64)
    for k in range(0, values.shape[0], slab):
        v = values[k:k + slab].double()
        total += v.sum()
        absolute += v.abs().sum()
    return float(total), float(absolute)
