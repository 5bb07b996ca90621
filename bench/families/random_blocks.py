"""The paper's random-blocks family: the band plus one dense square.

Element ``(i, j)`` may be nonzero where ``|i - j| <= half_bandwidth`` or where
both lie in ``[start, start + square)``; ``start`` is placed as the paper's
generator places one block, from ``square_seed``
(:func:`bench.structure.square_start`).  Configuration keys: ``n``, ``leaf``,
``half_bandwidth``, ``square``, ``square_seed``.
"""

import numpy as np

from bench.structure import Structure, band_coords, morton_sort, square_start


def structure(config: dict) -> Structure:
    n, bs, hw = int(config["n"]), int(config["leaf"]), int(config["half_bandwidth"])
    side = int(config["square"])
    nb = -(-n // bs)
    band = band_coords(nb, -(-hw // bs))
    start = square_start(n, side, int(config.get("square_seed", 0)))
    b0, sb = start // bs, -(-side // bs)
    r = np.arange(b0, min(b0 + sb + 1, nb))
    sq = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    codes = np.unique(np.concatenate([band[:, 0] * nb + band[:, 1], sq[:, 0] * nb + sq[:, 1]]))
    coords = np.stack([codes // nb, codes % nb], 1).astype(np.int64)
    lo, hi = start, start + side

    def keep(rows, cols):
        return ((rows - cols).abs() <= hw) | ((rows >= lo) & (rows < hi) & (cols >= lo) & (cols < hi))

    return Structure(n, bs, coords[morton_sort(coords)], keep,
                     dict(half_bandwidth=hw, square_start=start, square=side))
