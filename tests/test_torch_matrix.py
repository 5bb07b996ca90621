"""The port's BSMatrix, add and truncations against the JAX package's.

Structures and kept sets must be equal; values agree within fp32 rounding.
"""

import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import BSMatrix as JBSMatrix  # noqa: E402
from repro.core.matrix import block_frobenius_norms as jnorms  # noqa: E402
from repro_torch.core import BSMatrix, add, add_scaled_identity, identity  # noqa: E402
from repro_torch.core.leaf import LeafSpec, exact_spgemm_flops, inner_masks, nnz_elements  # noqa: E402
from repro_torch.core.matrix import block_frobenius_norms  # noqa: E402
from repro_torch.core.spgemm import spgemm_symbolic  # noqa: E402
from torch_parity import structures, to_port  # noqa: E402

STRUCTURES = structures()
# the packages export functions named like these modules, so import by path
jadd = importlib.import_module("repro.core.add")
jtrunc = importlib.import_module("repro.core.truncate")
ttrunc = importlib.import_module("repro_torch.core.truncate")


def _same(p, j, atol=0.0):
    """Equal structure; values equal (atol=0) or within atol."""
    assert p.shape == j.shape and p.bs == j.bs
    assert np.array_equal(p.coords, j.coords)
    got, want = p.to_dense(), np.asarray(j.to_dense(), dtype=np.float32)
    if atol == 0.0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_dense_roundtrip_transpose_elements(name):
    j = STRUCTURES[name]
    dense = np.asarray(j.to_dense())
    p = BSMatrix.from_dense(dense, j.bs, device="cpu")
    _same(p, j)
    _same(BSMatrix.from_dense(dense, j.bs, prune_tol=1.0, device="cpu"),
          JBSMatrix.from_dense(dense, j.bs, prune_tol=1.0))
    _same(p.transpose(), j.transpose())
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, j.shape[0], (2, 300))
    assert np.array_equal(p.get_elements(rows, cols), j.get_elements(rows, cols))
    assert p.nnzb == j.nnzb and p.nblocks == j.nblocks and p.density() == j.density()
    assert p.structure_key == j.structure_key


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_norms_and_trace(name):
    j = STRUCTURES[name]
    p = to_port(j)
    np.testing.assert_allclose(p.block_norms(), j.block_norms(), rtol=1e-6)
    np.testing.assert_allclose(p.frobenius_norm(), j.frobenius_norm(), rtol=1e-6)
    np.testing.assert_allclose(p.trace(), j.trace(), rtol=1e-5, atol=1e-5)
    for inner in (4, 8):
        np.testing.assert_allclose(
            block_frobenius_norms(p.data, inner=inner).numpy(),
            np.asarray(jnorms(j.data, inner=inner)),
            rtol=1e-6,
        )


def test_from_coo_from_blocks_zeros():
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 70, (2, 200))
    vals = rng.standard_normal(200).astype(np.float32)
    _same(BSMatrix.from_coo((70, 70), 8, rows, cols, vals, device="cpu"),
          JBSMatrix.from_coo((70, 70), 8, rows, cols, vals))
    # duplicate block coordinates are summed (three copies of one block)
    coords = np.array([[1, 2], [0, 0], [1, 2], [3, 1], [1, 2]])
    data = rng.standard_normal((5, 8, 8)).astype(np.float32)
    _same(BSMatrix.from_blocks((32, 32), 8, coords, data, device="cpu"),
          JBSMatrix.from_blocks((32, 32), 8, coords, jnp.asarray(data)), atol=1e-6)
    z = BSMatrix.zeros((16, 24), 8, device="cpu")
    assert z.nnzb == 0 and z.to_dense().shape == (16, 24) and not z.to_dense().any()


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (2.0, -1.0), (0.3, 1.7)])
def test_add(alpha, beta):
    a, b = STRUCTURES["banded"], STRUCTURES["random"]
    _same(add(to_port(a), to_port(b), alpha, beta), jadd.add(a, b, alpha, beta))
    n = a.shape[0] - 7  # a partial trailing block
    _same(identity(n, 16, device="cpu"), jadd.identity(n, 16))
    s = STRUCTURES["spd_banded"]
    _same(add_scaled_identity(to_port(s), 0.7), jadd.add_scaled_identity(s, 0.7))


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_truncations_keep_the_same_blocks(name):
    j = STRUCTURES[name]
    p = to_port(j)
    total = j.frobenius_norm()
    for tau in (0.0, 1e-4 * total, 1e-2 * total, 0.3 * total):
        _same(ttrunc.truncate(p, tau), jtrunc.truncate(j, tau))
        _same(ttrunc.truncate_hierarchical(p, tau), jtrunc.truncate_hierarchical(j, tau))
    for eps in (0.0, 0.5, 2.0):
        _same(ttrunc.truncate_elementwise(p, eps), jtrunc.truncate_elementwise(j, eps))


def test_leaf_policies():
    from repro.core import leaf as jleaf
    from repro.core.spgemm import spgemm_symbolic as jsym

    j = STRUCTURES["seq_random_offdiag"]
    p = to_port(j)
    tasks = spgemm_symbolic(p.coords, p.coords)
    for kind, ibs in (("dense", 64), ("block_sparse", 4), ("hierarchical", 8)):
        ps, js = LeafSpec(kind, ibs), jleaf.LeafSpec(kind, ibs)
        assert np.array_equal(inner_masks(p, ps), jleaf.inner_masks(j, js))
        assert nnz_elements(p, ps) == jleaf.nnz_elements(j, js)
        assert exact_spgemm_flops(p, p, tasks, ps) == jleaf.exact_spgemm_flops(
            j, j, jsym(j.coords, j.coords), js)


def test_convert_round_trip_keeps_bf16_values():
    from repro_torch.convert import bsmatrix_from_arrays, bsmatrix_to_arrays

    j = STRUCTURES["banded"].astype(jnp.bfloat16)
    p = bsmatrix_from_arrays(j.shape, j.bs, j.coords, np.asarray(j.data), device="cpu")
    assert p.dtype == torch.bfloat16
    shape, bs, coords, data = bsmatrix_to_arrays(p)
    assert (shape, bs) == (j.shape, j.bs) and np.array_equal(coords, j.coords)
    assert np.array_equal(data, np.asarray(j.data, dtype=np.float32))


def test_constructors_follow_device_argument():
    m = BSMatrix.from_dense(np.eye(20, dtype=np.float32), 8, device="cpu")
    assert m.device.type == "cpu" and m.dtype == torch.float32
    assert add(m, m).device.type == "cpu"
    assert m.astype(torch.bfloat16).dtype == torch.bfloat16
