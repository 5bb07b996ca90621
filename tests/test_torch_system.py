"""The paper's whole-stack checks (``tests/test_system.py``) on the port, held
against the JAX package.

Each test runs the same inputs, made from the same numpy seeds, through both
packages: the three weak-scaling families end to end, the electronic-structure
pipeline, a truncated multiply chain, sparsity surviving squaring, and SP2's
symbolic-cache hits.  Structure is exact (block coords, plan statistics, cache
hit histories, SP2 iteration counts); values pass the reference's own limits,
and every product of the same inputs agrees per output block within
``1e-5 * sum_t ||A_t||_F ||B_t||_F`` (:func:`torch_parity.gemm_tolerance`).
The JAX side runs its plain numeric phase (``impl="ref"``), as its own tests
run it on the CPU.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from helpers import banded_matrix  # noqa: E402
from repro.core.schedule import make_spgemm_plan as j_plan  # noqa: E402
from repro.core.schedule import plan_stats as j_plan_stats  # noqa: E402
from repro_torch.core.schedule import make_spgemm_plan as t_plan  # noqa: E402
from repro_torch.core.schedule import plan_stats as t_plan_stats  # noqa: E402
from torch_parity import assert_blocks_within, gemm_tolerance, to_port  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Small blocks: one intra-op thread, so the test workers' torch pools do
    not spin on the cores the other workers' XLA device threads need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_product(ja, jb):
    """``multiply(a, b)`` in both packages on the same inputs: the same
    coords, every block within the GEMM tolerance.  Returns both results."""
    jcm = jc.multiply(ja, jb, impl="ref")
    tcm = tc.multiply(to_port(ja), to_port(jb))
    assert np.array_equal(tcm.coords, jcm.coords)
    tasks = tc.spgemm_symbolic(ja.coords, jb.coords)
    tol = gemm_tolerance(np.asarray(ja.data), np.asarray(jb.data), tasks.a_idx, tasks.b_idx,
                         tasks.c_idx, tasks.num_out)
    assert_blocks_within(tcm.data.numpy(), np.asarray(jcm.data), tol)
    return jcm, tcm


def _hamiltonian(seed, n, width=3):
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - width), min(n, i + width + 1)
        h[i, lo:hi] = 0.2 * rng.standard_normal(hi - lo)
    return (h + h.T) / 2 + np.diag(np.linspace(-1, 1, n))


def test_weak_scaling_families_end_to_end():
    """The paper's three test families through the multiply and the planner."""
    rng = np.random.default_rng(0)
    n, bs, hw = 512, 32, 48

    def banded():
        a = np.zeros((n, n), dtype=np.float32)
        for i in range(n):
            lo, hi = max(0, i - hw), min(n, i + hw + 1)
            a[i, lo:hi] = rng.standard_normal(hi - lo)
        return a

    fams = {"banded": banded()}
    g = banded()
    g[: n // 4, : n // 4] = rng.standard_normal((n // 4, n // 4))
    fams["growing"] = g
    r = banded()
    s = n // 8
    for st in (0, n // 2):
        r[st : st + s, st : st + s] = rng.standard_normal((s, s))
    fams["random"] = r

    for name, dense in fams.items():
        ja, ta = jc.BSMatrix.from_dense(dense, bs), tc.BSMatrix.from_dense(dense, bs, device="cpu")
        assert np.array_equal(ta.coords, ja.coords), name
        _, c = _same_product(ja, ja)
        assert np.allclose(c.to_dense(), dense @ dense, atol=1e-2), name
        st = t_plan_stats(t_plan(ta.coords, ta.coords, 4, bs))
        assert st == j_plan_stats(j_plan(ja.coords, ja.coords, 4, bs)), name
        assert st["task_balance"] < 2.0, (name, st)


def test_electronic_structure_pipeline():
    """inv-factorize the overlap, transform, purify: the paper's application."""
    n, bs, nocc = 128, 16, 40
    h = _hamiltonian(3, n)
    s_dense = np.eye(n, dtype=np.float32) + 0.01 * np.abs(h)

    def pipeline(core, impl, device=None):
        kw = {} if device is None else dict(device=device)
        f = core.BSMatrix.from_dense(h, bs, **kw)
        s = core.BSMatrix.from_dense(s_dense, bs, **kw)
        z = core.inv_chol(s, impl=impl)
        resid = core.factorization_residual(s, z, impl=impl)
        f_o = core.multiply(core.multiply(z.transpose(), f, impl=impl), z, impl=impl)
        w = np.linalg.eigvalsh(np.asarray(f_o.to_dense(), np.float64))
        d, stats = core.sp2_purify(f_o, nocc, float(w.min()) - 0.05, float(w.max()) + 0.05,
                                   idem_tol=1e-5, trunc_tau=1e-5, impl=impl)
        return z, resid, f_o, d, stats

    jz, j_resid, j_fo, jd, jst = pipeline(jc, "ref")
    tz, t_resid, t_fo, td, tst = pipeline(tc, "auto", device="cpu")
    assert np.array_equal(tz.coords, jz.coords) and np.array_equal(t_fo.coords, j_fo.coords)
    assert max(t_resid, j_resid) < 1e-4
    assert tst.iterations == jst.iterations
    assert tst.nnzb_history == jst.nnzb_history
    assert np.array_equal(td.coords, jd.coords)
    assert abs(td.trace() - nocc) < 0.05
    x2 = tc.multiply(td, td)
    assert np.abs(x2.to_dense() - td.to_dense()).max() < 1e-2  # idempotent
    assert np.abs(td.to_dense() - np.asarray(jd.to_dense())).max() <= 1e-4
    # the purified D's square, from the same D in both packages
    _same_product(jd, jd)


def test_truncated_multiply_chain_error_accumulation():
    """Chained multiply + truncate keeps the total error controlled; each link
    is held against the JAX package's on the same input."""
    a = banded_matrix(256, 8, 16, seed=9)
    a = a.scale(1.0 / np.linalg.norm(a.to_dense(), 2))
    exact = a.to_dense().astype(np.float64)
    tau = 1e-4
    japprox, tapprox = a, to_port(a)
    for _ in range(3):
        exact = exact @ exact
        _same_product(japprox, japprox)
        japprox = jc.truncate(jc.multiply(japprox, japprox, impl="ref"), tau)
        tapprox = tc.truncate(tc.multiply(tapprox, tapprox), tau)
        assert np.array_equal(tapprox.coords, japprox.coords)
    err = np.linalg.norm(tapprox.to_dense() - exact)
    assert err < 50 * tau
    assert np.linalg.norm(np.asarray(japprox.to_dense()) - exact) < 50 * tau


def test_quadtree_sparsity_survives_squaring():
    a = banded_matrix(512, 4, 16)
    _, c = _same_product(a, a)
    nb = a.nblocks[0]
    assert c.nnzb < 0.2 * nb * nb  # banded^2 is still banded (width doubles)


def test_purify_symbolic_cache_hits_and_bit_identical():
    """Stable-pattern SP2 iterations skip the symbolic phase through the
    structure-keyed SymbolicCache: the same hit history as the JAX package's,
    results bit-identical to an uncached run, and a second solve all hits."""
    n, bs, nocc = 128, 16, 40
    h = _hamiltonian(3, n)
    w = np.linalg.eigvalsh(h.astype(np.float64))
    lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
    kw = dict(idem_tol=1e-5, trunc_tau=1e-5)

    jd, jst = jc.sp2_purify(jc.BSMatrix.from_dense(h, bs), nocc, lmin, lmax, impl="ref",
                            cache=jc.SymbolicCache(), **kw)
    f = tc.BSMatrix.from_dense(h, bs, device="cpu")
    cache = tc.SymbolicCache()
    d1, st1 = tc.sp2_purify(f, nocc, lmin, lmax, cache=cache, **kw)
    assert st1.iterations == jst.iterations
    assert st1.cache_hits_history == jst.cache_hits_history
    counts = lambda c: {k: v for k, v in c.items() if not k.endswith("_s")}  # noqa: E731
    assert counts(st1.symbolic_cache) == counts(jst.symbolic_cache)
    assert st1.symbolic_cache["hits"] > 0
    assert st1.symbolic_cache["hits"] + st1.symbolic_cache["misses"] == st1.iterations
    hits = np.asarray(st1.cache_hits_history)
    assert ((hits == 0) | (hits == 1)).all()
    assert hits[-3:].tolist() == [1, 1, 1]

    # bit-identical to the uncached (fresh-cache) run
    d2, _ = tc.sp2_purify(f, nocc, lmin, lmax, **kw)
    assert np.array_equal(d1.coords, d2.coords)
    assert np.array_equal(d1.data.numpy(), d2.data.numpy())

    # a second solve sharing the cache starts hot: zero misses
    m0 = cache.misses
    d3, _ = tc.sp2_purify(f, nocc, lmin, lmax, cache=cache, **kw)
    assert cache.misses == m0
    assert np.array_equal(d1.data.numpy(), d3.data.numpy())
    # and the port's D is the JAX package's within the pipeline's limit
    assert np.array_equal(d1.coords, jd.coords)
    assert np.abs(d1.to_dense() - np.asarray(jd.to_dense())).max() <= 1e-4
