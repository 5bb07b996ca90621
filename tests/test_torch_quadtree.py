"""Parity of the port's quadtree module with the JAX package's: equal arrays."""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import quadtree as jq  # noqa: E402
from repro_torch.core import quadtree as tq  # noqa: E402
from torch_parity import structures, to_port  # noqa: E402

STRUCTURES = structures()


def _assert_index_equal(a, b, norms_exact=True):
    assert a.depth == b.depth and a.fingerprint == b.fingerprint
    for field in ("prefixes", "child_start", "leaf_start"):
        for x, y in zip(getattr(a, field), getattr(b, field), strict=True):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    assert (a.norms is None) == (b.norms is None)
    if a.norms is not None:
        for x, y in zip(a.norms, b.norms, strict=True):
            if norms_exact:
                assert np.array_equal(x, y)
            else:  # each package's own fp32 block norms: summation order differs
                np.testing.assert_allclose(x, y, rtol=1e-6)


def test_morton_codes_equal():
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 1 << 20, (2, 500))
    codes = tq.morton_encode(rows, cols)
    assert np.array_equal(codes, jq.morton_encode(rows, cols))
    for x, y in zip(tq.morton_decode(codes), jq.morton_decode(codes)):
        assert np.array_equal(x, y)
    coords = np.stack([rows % 37, cols % 41], axis=1)
    assert np.array_equal(tq.morton_sort(coords), jq.morton_sort(coords))
    assert tq.expand_prefix(13, 2, 5) == jq.expand_prefix(13, 2, 5)
    assert tq.quadtree_depth(33, 7) == jq.quadtree_depth(33, 7)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_quadtree_index_equal(name):
    m = STRUCTURES[name]
    norms = m.block_norms()
    depth = tq.quadtree_depth(*m.nblocks) + 1  # a raised common root too
    for d in (None, depth):
        _assert_index_equal(
            tq.build_quadtree_index(m.coords, norms, depth=d),
            jq.build_quadtree_index(m.coords, norms, depth=d),
        )
    assert tq.quadtree_node_counts(m.coords) == jq.quadtree_node_counts(m.coords)
    # through each package's BSMatrix: structure equal, norms from each side's
    # own fp32 block-norm reduction
    p = to_port(m)
    _assert_index_equal(p.quadtree_index(), m.quadtree_index(), norms_exact=False)
    bare_t = tq.build_quadtree_index(p.coords)
    _assert_index_equal(bare_t, jq.build_quadtree_index(m.coords))
    assert p.structure_key == m.structure_key


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_fingerprint_and_drop_mask_equal(name):
    m = STRUCTURES[name]
    assert tq.structure_fingerprint(m.codes(), m.nblocks, 3, "x") == jq.structure_fingerprint(
        m.codes(), m.nblocks, 3, "x"
    )
    qt_t = tq.build_quadtree_index(m.coords, m.block_norms())
    qt_j = jq.build_quadtree_index(m.coords, m.block_norms())
    total = float(np.sqrt((m.block_norms() ** 2).sum()))
    for tau in (0.0, 1e-3 * total, 0.05 * total, 0.5 * total, 2 * total):
        kt, vt = tq.hierarchical_drop_mask(qt_t, tau)
        kj, vj = jq.hierarchical_drop_mask(qt_j, tau)
        assert vt == vj and np.array_equal(kt, kj)


def test_empty_index_equal():
    z = np.zeros((0, 2), np.int64)
    _assert_index_equal(
        tq.build_quadtree_index(z, np.zeros(0), depth=3),
        jq.build_quadtree_index(z, np.zeros(0), depth=3),
    )
