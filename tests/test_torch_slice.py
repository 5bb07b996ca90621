"""The whole slice against the JAX package: S -> inv_chol -> Z^T F Z -> SP2 -> D.

The ``examples/purification.py`` pipeline at n=256, bs=16, run by both
packages from the same numpy inputs (the JAX side through its plain numeric
phase, ``impl="ref"``; the kernels themselves are compared in
``test_torch_block_spmm.py``).  SP2 must take the same branches for the same
number of iterations, the density matrices agree to 1e-4 in max norm, and
the inverse-factorization residuals lie within 2x of each other.

SP2 stops at ``IDEM_TOL``, above the fp32 idempotency floor of this problem
(about 8e-6 with ``trunc_tau=1e-5``).  Below that floor trace(X) sits within
an ulp of n_occ, so the branch ``trace > n_occ`` is decided by rounding, in
either package, and the iterations until the divergence stop are noise.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from torch_parity import to_port  # noqa: E402

N, BS, NOCC = 256, 16, 80
IDEM_TOL = 1e-4


def _problem():
    """Banded Hamiltonian with decaying off-diagonals, and its overlap S."""
    rng = np.random.default_rng(7)
    i, j = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    band = np.abs(i - j) <= 8
    h = np.where(band, 0.3 * np.exp(-0.5 * np.abs(i - j)) * rng.standard_normal((N, N)), 0.0)
    h = ((h + h.T) / 2 + np.diag(np.linspace(-2.0, 2.0, N))).astype(np.float32)
    s = (np.eye(N) + 0.01 * np.abs(h)).astype(np.float32)
    return h, s


def _pipeline(core, f, s, impl):
    z = core.inv_chol(s, impl=impl)
    resid = core.factorization_residual(s, z, impl=impl)
    f_o = core.multiply(core.multiply(z.transpose(), f, impl=impl), z, impl=impl)
    w = np.linalg.eigvalsh(np.asarray(f_o.to_dense(), dtype=np.float64))
    d, stats = core.sp2_purify(f_o, NOCC, float(w.min()) - 0.05, float(w.max()) + 0.05,
                               idem_tol=IDEM_TOL, trunc_tau=1e-5, impl=impl)
    return resid, f_o, d, stats


def test_purification_pipeline_matches_reference():
    h, s_dense = _problem()
    jf, js = jc.BSMatrix.from_dense(h, BS), jc.BSMatrix.from_dense(s_dense, BS)
    j_resid, j_fo, j_d, j_stats = _pipeline(jc, jf, js, "ref")
    t_resid, t_fo, t_d, t_stats = _pipeline(tc, to_port(jf), to_port(js), "auto")

    assert t_stats.iterations == j_stats.iterations
    assert t_stats.idempotency_history[-1] <= IDEM_TOL  # converged, not diverged
    n = NOCC
    # every iteration but the last chose a branch (the last one stopped)
    branches = lambda st: [tr > n for tr in st.trace_history[:-1]]
    assert branches(t_stats) == branches(j_stats)
    assert t_stats.nnzb_history == j_stats.nnzb_history
    assert np.abs(t_d.to_dense() - np.asarray(j_d.to_dense())).max() <= 1e-4
    assert 0.5 <= t_resid / j_resid <= 2.0, (t_resid, j_resid)
    # and the port's density matrix is the projector it should be
    ev = np.linalg.eigh(np.asarray(t_fo.to_dense(), dtype=np.float64))
    d_ref = ev.eigenvectors[:, :n] @ ev.eigenvectors[:, :n].T
    assert np.abs(t_d.to_dense() - d_ref).max() <= 1e-3
    assert abs(t_d.trace() - n) <= 1e-2


def test_localized_inverse_factorization_matches_reference():
    _, s_dense = _problem()
    js = jc.BSMatrix.from_dense(s_dense, BS)
    jz, jst = jc.localized_inverse_factorization(js, tol=1e-5, trunc_tau=1e-6, impl="ref")
    tz, tst = tc.localized_inverse_factorization(to_port(js), tol=1e-5, trunc_tau=1e-6)
    assert tst.iterations == jst.iterations
    assert tst.nnzb_history == jst.nnzb_history
    assert 0.5 <= tst.factorization_residual / jst.factorization_residual <= 2.0
    np.testing.assert_allclose(tz.to_dense(), np.asarray(jz.to_dense()), atol=1e-4)
