"""Density-matrix purification on the PyTorch port, end to end.

The port's copy of ``examples/purification.py``, the paper's driving
application:
  1. build a sparse "Fock" matrix F with banded structure + decay,
  2. inverse-factorize the overlap S (congruence to orthogonal basis),
  3. SP2 purification: D = theta(mu I - F) via repeated sparse A@A,
  4. truncation keeps every iterate sparse with controlled error.
D is checked against a float64 eigendecomposition; a failed check exits
non-zero.

Run:  PYTHONPATH=src python examples/torch_purification.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (
    BSMatrix,
    factorization_residual,
    inv_chol,
    multiply,
    sp2_purify,
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device

    rng = np.random.default_rng(7)
    n, bs, nocc = 512, 32, 160

    # 1) banded Hamiltonian with decaying off-diagonals + spectral gap
    h = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j in range(max(0, i - 8), min(n, i + 9)):
            h[i, j] = 0.3 * np.exp(-0.5 * abs(i - j)) * rng.standard_normal()
    # fp32, as the reference's jax arrays are (the kernels take fp32 or bf16 blocks)
    h = ((h + h.T) / 2 + np.diag(np.linspace(-2.0, 2.0, n))).astype(np.float32)
    f = BSMatrix.from_dense(h, bs, device=dev)
    print(f"F: {f.shape}, {f.nnzb}/{f.nblocks[0]**2} blocks on {f.device}")

    # 2) overlap-like SPD matrix and its inverse Cholesky (Z^T S Z = I)
    s_dense = np.eye(n, dtype=np.float32) + 0.01 * np.abs(h)
    s = BSMatrix.from_dense(s_dense, bs, device=dev)
    z = inv_chol(s)
    resid = factorization_residual(s, z)
    print(f"inv_chol(S): residual = {resid:.2e}")
    check(resid < 1e-4, f"inv_chol residual {resid:.2e}")

    # 3) transform F to orthogonal basis: F_o = Z^T F Z (two sparse multiplies)
    f_o = multiply(multiply(z.transpose(), f), z)

    # 4) SP2 purification with truncation
    w = np.linalg.eigvalsh(np.asarray(f_o.to_dense(), dtype=np.float64))
    d, stats = sp2_purify(
        f_o, nocc, float(w.min()) - 0.05, float(w.max()) + 0.05,
        idem_tol=1e-6, trunc_tau=1e-5,
    )
    ev = np.linalg.eigh(np.asarray(f_o.to_dense(), dtype=np.float64))
    d_ref = ev.eigenvectors[:, :nocc] @ ev.eigenvectors[:, :nocc].T
    err = np.abs(d.to_dense() - d_ref).max()
    print(f"SP2: {stats.iterations} iterations")
    print(f"     trace(D) = {d.trace():.3f} (target {nocc})")
    print(f"     max |D - D_ref| = {err:.2e}")
    print(f"     density-matrix sparsity: {d.nnzb}/{d.nblocks[0]**2} blocks")
    print("     idempotency history: "
          + " ".join(f"{x:.1e}" for x in stats.idempotency_history[:8]) + " ...")
    check(abs(d.trace() - nocc) < 1e-2, f"trace(D) = {d.trace()}")
    check(err < 1e-3, f"max |D - D_ref| = {err:.2e}")


if __name__ == "__main__":
    main()
