"""Quickstart on the PyTorch port: the Chunks-and-Tasks matrix library's public API.

The port's copy of ``examples/quickstart.py``: builds a block-sparse banded
matrix, multiplies, runs SpAMM, truncates, factorizes, then plans the
distributed multiply and prints the locality win.  Each step is checked
against its dense oracle or its error bound, and a failed check exits
non-zero.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (
    BSMatrix,
    add_scaled_identity,
    factorization_residual,
    inv_chol,
    multiply,
    spamm,
    truncate,
)
from repro_torch.core.schedule import make_spgemm_plan, plan_stats


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device

    # 1) construct a block-sparse matrix (banded + random values)
    rng = np.random.default_rng(0)
    n, bs, halfwidth = 1024, 64, 96
    dense = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - halfwidth), min(n, i + halfwidth + 1)
        decay = np.exp(-0.05 * np.abs(np.arange(lo, hi) - i))  # magnitude decay
        dense[i, lo:hi] = rng.standard_normal(hi - lo) * decay / np.sqrt(halfwidth)
    a = BSMatrix.from_dense(dense, bs, device=dev)
    print(f"A: {a.shape} blocks={a.nnzb}/{a.nblocks[0]**2} (zero branches pruned) on {a.device}")

    # 2) multiply (symbolic quadtree join on the host + grouped GEMM on the device)
    exact = dense.astype(np.float64) @ dense
    c = multiply(a, a)
    err = np.abs(c.to_dense() - exact).max()
    print(f"A@A: blocks={c.nnzb}, max err vs dense = {err:.2e}")
    check(err <= 1e-5 * np.abs(exact).max(), f"multiply error {err:.2e}")

    # 3) sparse approximate multiply with error bound (SpAMM)
    tau = 0.05 * np.linalg.norm(exact)
    c_approx, bound = spamm(a, a, tau=tau)
    true_err = np.linalg.norm(c_approx.to_dense() - exact)
    print(f"SpAMM(tau={tau:.2f}): {c.nnzb - c_approx.nnzb} output blocks pruned, "
          f"||err||_F = {true_err:.2e} <= bound {bound:.2e} <= tau")
    check(true_err <= bound <= tau, "SpAMM error above its bound")

    # 4) truncation with global error control
    t = truncate(c, tau=0.5)
    trunc_err = np.linalg.norm(c.to_dense() - t.to_dense())
    print(f"truncate(C, 0.5): {c.nnzb} -> {t.nnzb} blocks, ||C - T||_F = {trunc_err:.2e} <= 0.5")
    check(trunc_err <= 0.5, f"truncation error {trunc_err:.2e}")

    # 5) inverse Cholesky of an SPD shift (Z^T A Z = I)
    spd = add_scaled_identity(multiply(a, a.transpose()), 4.0)
    z = inv_chol(spd)
    resid = factorization_residual(spd, z)
    print(f"inv_chol residual ||I - Z^T A Z||_F = {resid:.2e}")
    check(resid < 1e-3, f"inv_chol residual {resid:.2e}")

    # 6) distributed schedule: locality-aware vs allgather baseline (8 workers)
    for placement, exchange in [("morton", "p2p"), ("random", "p2p")]:
        plan = make_spgemm_plan(a.coords, a.coords, 8, bs, placement=placement, exchange=exchange)
        st = plan_stats(plan)
        print(f"schedule {placement:6s}/{exchange}: balance={st['task_balance']:.2f} "
              f"recv/worker={st['recv_bytes_mean']/2**20:.2f} MiB")
    plan = make_spgemm_plan(a.coords, a.coords, 8, bs, exchange="allgather")
    print(f"schedule allgather baseline: recv/worker="
          f"{plan_stats(plan)['recv_bytes_mean']/2**20:.2f} MiB")


if __name__ == "__main__":
    main()
