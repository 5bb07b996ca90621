"""The paper's banded family: element ``(i, j)`` may be nonzero where ``|i - j| <= half_bandwidth``.

Configuration keys: ``n``, ``leaf`` (the block size), ``half_bandwidth``.
"""

from bench.structure import Structure, band_coords


def structure(config: dict) -> Structure:
    n, bs, hw = int(config["n"]), int(config["leaf"]), int(config["half_bandwidth"])
    coords = band_coords(-(-n // bs), -(-hw // bs))
    return Structure(n, bs, coords, lambda rows, cols: (rows - cols).abs() <= hw,
                     dict(half_bandwidth=hw))
