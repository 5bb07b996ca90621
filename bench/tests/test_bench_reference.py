"""The plain reference against a dense float64 product, the TF32 rounding, and the comparison."""

import math

import numpy as np
import pytest
import torch

from bench.reference.blocksparse import product, product_tasks, round_tf32
from bench.reference.compare import compare
from bench.structure import draw_values, structure_of
from bench.tests.tiny import TINY


def _dense(coords, blocks, n, bs):
    out = torch.zeros(n, n, dtype=torch.float64)
    for (i, j), blk in zip(coords, blocks):
        out[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blk.double()
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_is_the_dense_product(name):
    s = structure_of(TINY[name])
    a = draw_values(s, 3, "cpu", torch.float32)
    tasks = product_tasks(s.coords, s.coords)
    c = product(a, a, tasks)
    n = -(-s.n // s.bs) * s.bs
    dense_a = _dense(s.coords, a, n, s.bs)
    want = dense_a @ dense_a
    got = _dense(tasks.c_coords, c, n, s.bs)
    assert torch.allclose(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))
    # the structure is exactly where the dense product's blocks can be nonzero
    nb = n // s.bs
    reach = torch.from_numpy(np.zeros((nb, nb), bool))
    occ = torch.zeros(nb, nb, dtype=torch.float64)
    occ[s.coords[:, 0], s.coords[:, 1]] = 1
    reach = (occ @ occ) > 0
    assert int(reach.sum()) == tasks.num_out
    assert bool(reach[tasks.c_coords[:, 0], tasks.c_coords[:, 1]].all())


def test_tasks_of_a_rectangular_pair():
    a = np.array([[0, 0], [0, 2], [1, 1]])
    b = np.array([[0, 1], [2, 0], [2, 1], [1, 3]])
    t = product_tasks(a, b)
    got = sorted((int(t.c_coords[c][0]), int(t.c_coords[c][1]), int(i), int(j))
                 for i, j, c in zip(t.a_idx, t.b_idx, t.c_idx))
    assert got == [(0, 0, 1, 1), (0, 1, 0, 0), (0, 1, 1, 2), (1, 3, 2, 3)]
    assert np.all(np.diff(t.c_idx) >= 0)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -1.0 - 2.0**-12, 3.0e-30])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10
    assert r[2] == 1.0  # a tie goes to the even mantissa
    assert r[3] == 1.0 + 2.0**-9  # a tie goes to the even mantissa
    assert r[4] == -1.0
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    rel = ((round_tf32(y) - y).abs() / y.abs()).max()
    assert 2.0**-13 < float(rel) <= 2.0**-11


def _case():
    want_coords = np.array([[0, 0], [0, 1], [1, 1]])
    want = torch.randn(3, 4, 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    return want_coords, want


def test_compare_equal_and_reordered():
    wc, w = _case()
    perm = np.array([2, 0, 1])
    r = compare(wc, w, wc[perm], lambda idx: w[perm][torch.from_numpy(idx)])
    assert r == dict(structure_mismatch=0, value_gap=0.0)


def test_compare_counts_missing_extra_and_duplicate_blocks():
    wc, w = _case()
    got = np.array([[0, 0], [0, 0], [2, 2]])
    blocks = torch.stack([w[0], w[0], w[0]])
    r = compare(wc, w, got, lambda idx: blocks[torch.from_numpy(idx)])
    assert r["structure_mismatch"] == 1 + 2 + 1  # a duplicate, two missing, one extra


def test_compare_value_gap_against_the_larger_of_block_and_median_norm():
    wc, w = _case()
    got = w.clone()
    got[1, 0, 0] += 1e-3 * float(torch.linalg.matrix_norm(w).median())
    r = compare(wc, w, wc, lambda idx: got[torch.from_numpy(idx)])
    norms = torch.linalg.matrix_norm(w)
    want_gap = 1e-3 * float(norms.median()) / max(float(norms[1]), float(norms.median()))
    assert r["structure_mismatch"] == 0 and math.isclose(r["value_gap"], want_gap, rel_tol=1e-9)
    got[2, 1, 1] = float("nan")
    assert compare(wc, w, wc, lambda idx: got[torch.from_numpy(idx)])["value_gap"] == math.inf


def test_compare_held_judges_the_structure_whole_and_the_values_held():
    from bench.workload import Answer, hold

    wc, w = _case()
    got = w.clone()
    held = hold(Answer(wc, lambda idx: got[torch.from_numpy(idx)]), 2, np.random.default_rng(0))
    assert len(held.held) == 2 and held.coords is not wc
    (out,) = sorted({0, 1, 2} - set(held.held.tolist()))
    got[held.held] += 1.0  # the result changes after it was held: the held copy does not
    assert compare(wc, w, held.coords, held.blocks, held=held.held) == dict(structure_mismatch=0,
                                                                             value_gap=0.0)
    wrong = w.clone()
    wrong[out] += 1.0  # a block that was not held is not read
    r = compare(wc, wrong, held.coords, held.blocks, held=held.held)
    assert r["value_gap"] == 0.0
    wrong[held.held[0]] += 1.0
    assert compare(wc, wrong, held.coords, held.blocks, held=held.held)["value_gap"] > 0
    assert compare(wc, w, wc[:2], held.blocks, held=held.held)["structure_mismatch"] == 1
    with pytest.raises(KeyError):
        held.blocks(np.array([out]))


@pytest.mark.parametrize("precision", ["tf32", "bfloat16", "float16"])
def test_lower_precisions_by_name(precision):
    s = structure_of(TINY["tiny_band"])
    a = draw_values(s, 5, "cpu", torch.float32)
    tasks = product_tasks(s.coords, s.coords)
    want = product(a, a, tasks)
    low = product(a, a, tasks, precision=precision)
    gap = compare(tasks.c_coords, want, tasks.c_coords, lambda idx: low[torch.from_numpy(idx)])["value_gap"]
    assert 0 < gap < {"tf32": 3e-3, "bfloat16": 2e-2, "float16": 3e-3}[precision]
    with pytest.raises(ValueError):
        product(a, a, tasks, precision="int8")
