"""Distributed density-matrix purification on a worker mesh, on the PyTorch port.

The port's copy of ``examples/distributed_purification.py``: the full
iterative SP2 loop on device-resident matrices (``repro_torch.dist``).  The
Hamiltonian is scattered to the mesh once, every iterate (multiply, add,
trace, Frobenius norm, truncate) stays in the workers' stores, and the
structure-keyed PlanCache makes iterations on a stationary sparsity pattern
pure device work.  The 8 workers share one device.  D is checked against
the single-host driver; a failed check exits non-zero.

Run:  PYTHONPATH=src python examples/torch_distributed_purification.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import BSMatrix, multiply, sp2_purify
from repro_torch.core.distributed import make_worker_mesh
from repro_torch.dist import PlanCache, dist_sp2_purify

P = 8
N, BS, NOCC = 512, 32, 160


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = ap.parse_args(argv).device

    # banded Hamiltonian with decaying off-diagonals + spectral gap
    rng = np.random.default_rng(7)
    h = np.zeros((N, N), dtype=np.float32)
    for i in range(N):
        lo, hi = max(0, i - 6), min(N, i + 7)
        h[i, lo:hi] = 0.2 * rng.standard_normal(hi - lo)
    # fp32, as the reference's jax arrays are (the kernels take fp32 or bf16 blocks)
    h = ((h + h.T) / 2 + np.diag(np.linspace(-2.0, 2.0, N))).astype(np.float32)
    f = BSMatrix.from_dense(h, BS, device=dev)
    w = np.linalg.eigvalsh(h.astype(np.float64))
    lmin, lmax = float(w.min()) - 0.05, float(w.max()) + 0.05
    print(f"F: n={N} bs={BS} nnzb={f.nnzb}  spec=[{lmin:.2f}, {lmax:.2f}]  mesh={P} on {f.device}")

    mesh = make_worker_mesh(P, dev)
    cache = PlanCache()
    d, stats = dist_sp2_purify(
        f, NOCC, lmin, lmax, mesh, idem_tol=1e-5, trunc_tau=1e-5, cache=cache
    )

    print(f"\nconverged in {stats.iterations} iterations")
    print(f"trace(D) = {d.trace():.3f}  (n_occ = {NOCC})")
    idem = np.abs(multiply(d, d).to_dense() - d.to_dense()).max()
    print(f"max |D^2 - D| = {idem:.2e}  (idempotency)")

    c = stats.cache
    print(f"\nplan cache: {c['hits']} hits / {c['misses']} misses over "
          f"{stats.iterations} iterations")
    all_hit = sum(1 for pi in stats.per_iter if pi["cache_misses"] == 0)
    warm = [pi["wall_s"] for pi in stats.per_iter if pi["cache_misses"] == 0]
    cold = [pi["wall_s"] for pi in stats.per_iter if pi["cache_misses"] > 0]
    if warm and cold:
        print(f"{all_hit} iterations ran with zero planning: "
              f"{np.mean(warm)*1e3:.1f} ms vs {np.mean(cold)*1e3:.1f} ms "
              f"({np.mean(cold)/np.mean(warm):.0f}x)")
    print("\nper-iteration (last 5):")
    for pi in stats.per_iter[-5:]:
        print(f"  it={pi['iteration']:3d} nnzb={pi['nnzb']:4d} idem={pi['idem']:.2e} "
              f"hits={pi['cache_hits']} misses={pi['cache_misses']} "
              f"wall={pi['wall_s']*1e3:6.1f} ms")

    # cross-check against the single-host driver
    d_ref, _ = sp2_purify(f, NOCC, lmin, lmax, idem_tol=1e-5, trunc_tau=1e-5)
    err = np.abs(d.to_dense() - d_ref.to_dense()).max()
    print(f"\nmax |D_dist - D_host| = {err:.2e}")
    check(err < 1e-4, f"max |D_dist - D_host| = {err:.2e}")


if __name__ == "__main__":
    main()
