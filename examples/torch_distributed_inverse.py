"""Distributed inverse factorization pipeline on a worker mesh, on the PyTorch port.

The port's copy of ``examples/distributed_inverse.py``: the paper's full
electronic-structure workflow on the resident runtime
(``repro_torch.dist``).  The overlap matrix S enters the mesh once, the
localized inverse factorization (Z^T S Z = I) refines through delta-plan
SpAMM + hierarchical truncation, then the congruence transform Z^T H Z and
the SP2 purification chain run on resident matrices, and the density matrix
leaves at the single boundary gather: S -> Z -> Z^T H Z -> SP2 -> Z D Z^T.
The 8 workers share one device.  D is checked against the host pipeline; a
failed check exits non-zero.

Run:  PYTHONPATH=src python examples/torch_distributed_inverse.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import BSMatrix, localized_inverse_factorization, multiply, sp2_purify
from repro_torch.core.distributed import make_worker_mesh
from repro_torch.dist import PlanCache, dist_sqrt_inv_pipeline

P = 8
N, BS, NOCC = 128, 16, 40
TOL, IDEM_TOL, TRUNC_TAU, SPAMM_TAU = 1e-6, 1e-5, 1e-6, 1e-7


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device

    # banded SPD overlap matrix + symmetric Hamiltonian with a spectral gap
    rng = np.random.default_rng(7)
    b = np.zeros((N, N), dtype=np.float32)
    for i in range(N):
        lo, hi = max(0, i - 3), min(N, i + 4)
        b[i, lo:hi] = rng.standard_normal(hi - lo)
    s_dense = b @ b.T + N * np.eye(N, dtype=np.float32)
    S = BSMatrix.from_dense(s_dense, BS, device=dev)
    hm = np.zeros((N, N), dtype=np.float32)
    for i in range(N):
        lo, hi = max(0, i - 4), min(N, i + 5)
        hm[i, lo:hi] = 0.2 * rng.standard_normal(hi - lo)
    H = BSMatrix.from_dense((hm + hm.T) / 2 + np.diag(np.linspace(-1, 1, N)).astype(np.float32),
                            BS, device=dev)
    print(f"S: n={N} bs={BS} nnzb={S.nnzb}  H: nnzb={H.nnzb}  mesh={P} on {S.device}")

    mesh = make_worker_mesh(P, dev)
    # verify="always" re-proves every plan on hits too: the example doubles
    # as the static verifier's end-to-end exercise on real plans
    cache = PlanCache(verify="always")
    D, stats = dist_sqrt_inv_pipeline(
        S, H, NOCC, mesh, tol=TOL, idem_tol=IDEM_TOL,
        trunc_tau=TRUNC_TAU, spamm_tau=SPAMM_TAU, cache=cache,
    )

    inv = stats.inverse
    print(f"\ninverse factor:  {inv.iterations} refinement iterations, "
          f"residual {inv.factorization_residual:.2e}")
    print(f"SP2 bounds from resident norm table: [{stats.bounds[0]:.3f}, {stats.bounds[1]:.3f}]")
    print(f"purification:    {stats.purify.iterations} iterations")
    print(f"congruence:      {stats.congruence['cache_hits']}h/"
          f"{stats.congruence['cache_misses']}m in {stats.congruence['wall_s']*1e3:.1f} ms")
    tail = inv.per_iter[-3:]
    print("refinement tail: "
          + ", ".join(f"{pi['cache_hits']}h/{pi['cache_misses']}m" for pi in tail))

    c = stats.cache
    print(f"plan cache:      {c['hits']} hits / {c['misses']} misses "
          f"(hit rate {c['hit_rate']:.2f})")
    print(f"static verifier: {c['plans_verified']} plans proved, "
          f"{c['verify_violations']} violations in {c['verify_s']*1e3:.1f} ms")
    check(c["plans_verified"] > 0 and c["verify_violations"] == 0, "plan verification")

    # cross-check against the host pipeline
    z, _ = localized_inverse_factorization(S, tol=TOL, trunc_tau=TRUNC_TAU)
    f_o = multiply(multiply(z.transpose(), H), z)
    w = np.linalg.eigvalsh(np.asarray(f_o.to_dense(), np.float64))
    d_o, _ = sp2_purify(f_o, NOCC, float(w.min()) - 0.05, float(w.max()) + 0.05,
                        idem_tol=IDEM_TOL, trunc_tau=TRUNC_TAU)
    d_host = multiply(multiply(z, d_o), z.transpose())
    err = np.abs(D.to_dense() - d_host.to_dense()).max()
    tr = multiply(D, S).trace()
    print(f"\nmax |D_dist - D_host| = {err:.2e}")
    print(f"trace(D S) = {tr:.3f}  (n_occ = {NOCC})")
    check(err < 1e-3, f"max |D_dist - D_host| = {err:.2e}")
    check(abs(tr - NOCC) < 0.05, f"trace(D S) = {tr}")
    print("OK")


if __name__ == "__main__":
    main()
