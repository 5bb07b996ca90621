"""Block structures of the paper's matrix families, and their element masks.

Frozen copies of the port's generators (``chip_smoke.py``'s ``band_coords``,
``banded_matrix`` and ``random_blocks_coords``, and the Morton sort of
``repro_torch.core.quadtree``), so that the benchmark makes its own inputs
and no later change to the program can move them.  Each family is a module
``bench/families/<family>.py`` whose ``structure(config)`` builds a
:class:`Structure` from these pieces; :func:`structure_of` finds it by the
configuration's ``family``.  Pure numpy; the values are drawn by
:func:`draw_values` with a ``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

_B = (0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F,
      0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF)


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of ``x`` with a zero bit between each."""
    x = x.astype(np.uint64)
    for shift, mask in zip((16, 8, 4, 2, 1), reversed(_B)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def morton_sort(coords: np.ndarray) -> np.ndarray:
    """The permutation that sorts ``(row, col)`` block coordinates in Z-order (row in the odd bits)."""
    if coords.size == 0:
        return np.zeros((0,), dtype=np.int64)
    codes = (_part1by1(coords[:, 0]) << np.uint64(1)) | _part1by1(coords[:, 1])
    return np.argsort(codes, kind="stable")


def band_coords(nb: int, hw_blocks: int) -> np.ndarray:
    """Morton-sorted block coordinates of the block band ``|I - J| <= hw_blocks`` of ``nb`` block rows."""
    i = np.arange(nb)
    parts = [np.stack([i[(i + d >= 0) & (i + d < nb)], (i + d)[(i + d >= 0) & (i + d < nb)]], 1)
             for d in range(-hw_blocks, hw_blocks + 1)]
    coords = np.concatenate(parts).astype(np.int64)
    return coords[morton_sort(coords)]


def square_start(n: int, block: int, seed: int = 0) -> int:
    """First row of the random-blocks family's one dense ``block x block`` square,
    placed as the paper's generator places one block (``_random_block_starts``)."""
    gaps = np.random.default_rng(seed).multinomial(n - block, np.ones(2) / 2)
    return int(gaps[0])


@dataclasses.dataclass(frozen=True)
class Structure:
    """A matrix of a family: its block coordinates and its element pattern.

    ``keep(rows, cols)`` takes int64 tensors of global element indices and
    says which elements may be nonzero; elements past ``n`` are zero
    whatever it says.  ``params`` holds the family's own numbers, for the
    record and for tests.
    """

    n: int
    bs: int
    coords: np.ndarray
    keep: Callable
    params: dict = dataclasses.field(default_factory=dict)

    @property
    def nnzb(self) -> int:
        return int(self.coords.shape[0])


def structure_of(config: dict, root=None) -> Structure:
    """The structure a configuration names, made by ``bench/families/<family>.py``
    of the checkout at ``root`` (this one where it is not given)."""
    from bench import manifest

    family = manifest.load_module("families", config["family"], root or manifest.ROOT)
    return family.structure(config)


def draw_values(s: Structure, seed: int, device, dtype, slab: int = 4096):
    """Standard normal block values from ``seed`` on ``device``, masked to the
    element pattern: one draw for all blocks, then the mask slab by slab.

    The same seed, structure, device and dtype give the same values, so the
    reference can draw them again after the program's state is freed.
    """
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    bs = s.bs
    data = torch.randn((s.nnzb, bs, bs), generator=gen, device=device, dtype=dtype)
    r = torch.arange(bs, device=device)
    c_t = torch.from_numpy(s.coords).to(device)
    for k in range(0, s.nnzb, slab):
        rows = c_t[k:k + slab, 0, None, None] * bs + r[None, :, None]
        cols = c_t[k:k + slab, 1, None, None] * bs + r[None, None, :]
        keep = s.keep(rows, cols) & (rows < s.n) & (cols < s.n)
        data[k:k + slab].mul_(keep)
    return data
