"""The frozen structure generators give the paper's counts, and the port's Morton order."""

import numpy as np
import pytest
import torch

from bench.reference.blocksparse import product_tasks
from bench.structure import draw_values, morton_sort, structure_of
from bench.tests.tiny import ROOT, TINY

# Table 1 row 1 at leaf 128: A blocks, C blocks, block tasks
COUNTS = {"band_t1r1": (37_718, 73_502, 1_828_582), "random_t1r1": (47_618, 87_602, 3_596_082)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_table1_row1_counts(name):
    import json

    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    s = structure_of(cfg)
    tasks = product_tasks(s.coords, s.coords)
    assert (s.nnzb, tasks.num_out, tasks.num_tasks) == COUNTS[name]
    assert tuple(cfg["counts"].values()) == COUNTS[name]


def test_random_square_is_124_blocks_a_side():
    s = structure_of(dict(family="random_blocks", n=100_000, leaf=128, half_bandwidth=3000,
                          square=15_716, square_seed=0))
    start = s.params["square_start"]
    assert start == 42_324
    b0 = start // 128
    inside = (s.coords >= b0) & (s.coords < b0 + 124)
    assert int(inside.all(1).sum()) == 124 * 124
    assert start + 15_716 <= 124 * 128 + b0 * 128


def test_morton_sort_is_the_ports():
    from repro_torch.core.quadtree import morton_sort as ports

    coords = np.random.default_rng(1).integers(0, 5000, size=(4000, 2))
    assert np.array_equal(morton_sort(coords), ports(coords))


@pytest.mark.parametrize("name", sorted(TINY))
def test_values_masked_and_repeatable(name):
    cfg = TINY[name]
    s = structure_of(cfg)
    a = draw_values(s, 2**31 + 7, "cpu", torch.float32)
    assert torch.equal(a, draw_values(s, 2**31 + 7, "cpu", torch.float32))
    assert not torch.equal(a, draw_values(s, 2**31 + 8, "cpu", torch.float32))
    dense = torch.zeros(s.n + s.bs, s.n + s.bs)
    for (i, j), blk in zip(s.coords, a):
        dense[i * s.bs:(i + 1) * s.bs, j * s.bs:(j + 1) * s.bs] = blk
    i, j = torch.nonzero(dense, as_tuple=True)
    hw = cfg["half_bandwidth"]
    ok = (i - j).abs() <= hw
    if "square" in cfg:
        lo, hi = s.params["square_start"], s.params["square_start"] + cfg["square"]
        ok |= (i >= lo) & (i < hi) & (j >= lo) & (j < hi)
    assert bool(ok.all()) and bool((i < s.n).all() and (j < s.n).all())
    # every element the pattern allows is drawn (none is zero by chance in a normal draw)
    allowed = (torch.arange(s.n)[:, None] - torch.arange(s.n)[None]).abs() <= hw
    if "square" in cfg:
        allowed[lo:hi, lo:hi] = True
    assert len(i) == int(allowed.sum())
