"""The port's symbolic and numeric multiply phases against the JAX package's.

Task lists must be equal array for array; multiplied values agree within
1e-5 * sum_t ||A_t||_F ||B_t||_F per output block (the summation order
differs, see torch_parity.gemm_tolerance).  SpAMM error bounds agree to 1e-12
relative when both descents get the same subtree norms.  Through ``spamm``
itself each package takes its own fp32 block norms, whose summation orders
differ by an ulp (about 1e-7 relative), so there the bounds agree to 1e-6 and
the kept task sets are equal.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.spgemm as js  # noqa: E402
from repro.core.leaf import LeafSpec as JLeafSpec  # noqa: E402
from repro_torch.core import SymbolicCache  # noqa: E402
import repro_torch.core.quadtree as tq  # noqa: E402
import repro_torch.core.spgemm as ts  # noqa: E402
from repro_torch.core.leaf import LeafSpec  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance, structures, to_port  # noqa: E402

STRUCTURES = structures()
PAIRS = [("banded", "banded"), ("random", "banded"), ("seq_exp_decay", "seq_exp_decay"),
         ("seq_random_offdiag", "seq_banded")]


def _tasks_equal(t, j):
    for f in ("a_idx", "b_idx", "c_idx", "c_coords"):
        x, y = getattr(t, f), getattr(j, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _close(p, j, a, b, tasks):
    """p (port) and j (JAX) products of a @ b: equal structure, values within
    the per-block tolerance over ``tasks``."""
    assert p.shape == j.shape and np.array_equal(p.coords, j.coords)
    tol = gemm_tolerance(np.asarray(a.data), np.asarray(b.data), tasks.a_idx, tasks.b_idx,
                         tasks.c_idx, tasks.num_out)
    assert_blocks_within(p.data.numpy(), np.asarray(j.data), tol)


@pytest.mark.parametrize("na,nb", PAIRS)
def test_symbolic_task_lists_equal(na, nb):
    a, b = STRUCTURES[na], STRUCTURES[nb]
    _tasks_equal(ts.spgemm_symbolic(a.coords, b.coords), js.spgemm_symbolic(a.coords, b.coords))
    _tasks_equal(ts.spgemm_symbolic_recursive(a.coords, b.coords),
                 js.spgemm_symbolic_recursive(a.coords, b.coords))
    # one set of subtree norms (the JAX package's fp32 block norms) for both
    depth = js._common_depth(a, b)
    ja, jb = a.quadtree_index(depth), b.quadtree_index(depth)
    ia = tq.build_quadtree_index(a.coords, a.block_norms(), depth=depth)
    ib = tq.build_quadtree_index(b.coords, b.block_norms(), depth=depth)
    for upper in (False, True):
        _tasks_equal(ts.spgemm_symbolic_tree(ia, ib, upper_only=upper),
                     js.spgemm_symbolic_tree(ja, jb, upper_only=upper))
    total = a.frobenius_norm() * b.frobenius_norm()
    for tau in (0.0, 1e-4 * total, 1e-2 * total):
        tt, et, vt = ts.spamm_symbolic(ia, ib, tau)
        tj, ej, vj = js.spamm_symbolic(ja, jb, tau)
        _tasks_equal(tt, tj)
        assert vt == vj
        np.testing.assert_allclose(et, ej, rtol=1e-12)
    full = ts.spgemm_symbolic(a.coords, b.coords)
    keep = np.arange(full.num_tasks) % 3 != 0
    _tasks_equal(ts._prune_tasks(full, keep), js._prune_tasks(js.spgemm_symbolic(a.coords, b.coords), keep))
    assert ts.task_flops(full, 16) == js.task_flops(full, 16)


@pytest.mark.parametrize("na,nb", PAIRS)
def test_multiply_values(na, nb):
    a, b = STRUCTURES[na], STRUCTURES[nb]
    if a.shape[1] != b.shape[0]:
        pytest.skip("shapes do not chain")
    pa, pb = to_port(a), to_port(b)
    cache = SymbolicCache()
    p = ts.multiply(pa, pb, cache=cache)
    assert ts.multiply(pa, pb, cache=cache).structure_key == p.structure_key
    assert cache.hits == 1 and cache.misses == 1
    _close(p, js.multiply(a, b, impl="ref"), a, b, ts.spgemm_symbolic(a.coords, b.coords))


@pytest.mark.parametrize("name", ["banded", "seq_exp_decay", "spd_banded"])
def test_syrk_values(name):
    a = STRUCTURES[name]
    p = ts.syrk(to_port(a))
    j = js.syrk(a, impl="ref")
    at = a.transpose()
    _close(p, j, a, at, js.spgemm_symbolic(a.coords, at.coords))
    assert np.array_equal(ts.symm_square(to_port(a)).coords, j.coords)


@pytest.mark.parametrize("method", ["hierarchical", "leaf"])
@pytest.mark.parametrize("leaf", [None, "dense", "block_sparse"])
@pytest.mark.parametrize("name", ["seq_exp_decay", "seq_random_offdiag"])
def test_spamm_values_and_bound(method, leaf, name):
    a = STRUCTURES[name]
    pa = to_port(a)
    total = a.frobenius_norm() ** 2
    for tau in (1e-4 * total, 1e-2 * total):
        pspec = None if leaf is None else LeafSpec(leaf, 4)
        jspec = None if leaf is None else JLeafSpec(leaf, 4)
        p, ep = ts.spamm(pa, pa, tau, method=method, leaf_spec=pspec)
        j, ej = js.spamm(a, a, tau, method=method, leaf_spec=jspec, impl="ref")
        np.testing.assert_allclose(ep, ej, rtol=1e-6)
        _close(p, j, a, a, _tasks_for(a, p))


def _tasks_for(a, c):
    """Full task list of a @ a restricted to c's output blocks (for bounds)."""
    t = js.spgemm_symbolic(a.coords, a.coords)
    codes = {tuple(x) for x in c.coords.tolist()}
    keep = np.array([tuple(x) in codes for x in t.c_coords[t.c_idx].tolist()], bool)
    return js._prune_tasks(t, keep)


def test_numeric_impls_agree_and_empty():
    a = to_port(STRUCTURES["banded"])
    tasks = ts.spgemm_symbolic(a.coords, a.coords)
    auto = ts.spgemm_numeric(a.data, a.data, tasks)
    assert np.array_equal(auto.numpy(), ts.spgemm_numeric(a.data, a.data, tasks, impl="ref").numpy())
    with pytest.raises(ValueError):
        ts.spgemm_numeric(a.data, a.data, tasks, impl="kernel")
    empty = ts.spgemm_numeric(a.data, a.data, ts._empty_tasks())
    assert empty.shape == (0, 16, 16)


def test_symbolic_cache_mirrors_reference():
    from repro.core.cache import SymbolicCache as JSymbolicCache

    a = to_port(STRUCTURES["banded"])
    cache = SymbolicCache(verify="always")
    for _ in range(3):
        ts.multiply(a, a, cache=cache)
    stats = cache.stats()
    assert set(stats) == set(JSymbolicCache().stats())
    assert (stats["hits"], stats["misses"], stats["plans_verified"]) == (2, 1, 0)
    assert stats["by_kind"] == {"spgemm/hit": 2, "spgemm/miss": 1}
    with pytest.raises(ValueError):
        SymbolicCache(verify="sometimes")
