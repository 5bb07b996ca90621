"""Inverse factorization task types (paper §2.2).

Finds Z with Z^T A Z = I for symmetric positive definite A.

* :func:`inv_chol` — recursive inverse Cholesky over the quadtree split
  (Schur-complement recursion; every step is library multiply/add/transpose,
  i.e. multiplication-heavy exactly as the paper emphasises).
* :func:`localized_inverse_factorization` — divide-and-conquer: factorize the
  two diagonal quadrants independently, then correct the coupling by
  iterative refinement Z <- Z(I + delta/2), delta = I - Z^T A Z  [paper refs
  4, 19].  Truncation keeps the iterates sparse.

The refinement *policy* (convergence / divergence tests, best-iterate
tracking) lives in :class:`RefineMonitor`, the same split as
:class:`repro_torch.core.purify.Sp2Monitor` for SP2.  The drivers thread a
structure-keyed :class:`~repro_torch.core.cache.SymbolicCache` through every
multiply, so refinement iterations on a stabilized sparsity pattern skip the
symbolic phase entirely.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .add import add, identity
from .cache import SymbolicCache
from .matrix import BSMatrix
from .spgemm import multiply
from .truncate import truncate

__all__ = [
    "submatrix",
    "assemble2x2",
    "inv_chol",
    "localized_inverse_factorization",
    "factorization_residual",
    "RefineMonitor",
    "InverseStats",
]


def submatrix(a: BSMatrix, r0: int, r1: int, c0: int, c1: int) -> BSMatrix:
    """Block-range slice a[r0:r1, c0:c1] (block coordinates)."""
    m = (
        (a.coords[:, 0] >= r0)
        & (a.coords[:, 0] < r1)
        & (a.coords[:, 1] >= c0)
        & (a.coords[:, 1] < c1)
    )
    idx = np.nonzero(m)[0]
    coords = a.coords[idx] - np.array([[r0, c0]])
    rows = min((r1 - r0) * a.bs, max(a.shape[0] - r0 * a.bs, 0))
    cols = min((c1 - c0) * a.bs, max(a.shape[1] - c0 * a.bs, 0))
    return BSMatrix(
        shape=(rows, cols),
        bs=a.bs,
        coords=coords,
        data=a.data[torch.from_numpy(idx).to(a.device)] if idx.size else a.data[:0],
    )


def assemble2x2(
    a00: BSMatrix, a01: BSMatrix, a10: BSMatrix, a11: BSMatrix, split: int
) -> BSMatrix:
    """Inverse of the quadtree split: glue four quadrants at block offset."""
    bs = a00.bs
    shape = (a00.shape[0] + a11.shape[0], a00.shape[1] + a11.shape[1])
    coords, datas = [], []
    for q, (dr, dc) in (
        (a00, (0, 0)),
        (a01, (0, split)),
        (a10, (split, 0)),
        (a11, (split, split)),
    ):
        if q.nnzb:
            coords.append(q.coords + np.array([[dr, dc]]))
            datas.append(q.data)
    if not coords:
        return BSMatrix.zeros(shape, bs, a00.dtype, device=a00.device)
    return BSMatrix.from_blocks(
        shape, bs, np.concatenate(coords), torch.cat(datas), device=a00.device
    )


def _dense_inv_chol(a: BSMatrix) -> BSMatrix:
    """Leaf: Z = L^{-T} where A = L L^T (dense LAPACK path, float64 on the host).

    As in the JAX package, the leaf factorization runs in numpy; the result
    goes back to the operand's device in the operand's dtype.
    """
    d = a.to_dense()
    L = np.linalg.cholesky(d.astype(np.float64))
    z = np.linalg.solve(L.T, np.eye(d.shape[0]))  # L^{-T}
    return BSMatrix.from_dense(z.astype(d.dtype), a.bs, device=a.device).astype(a.dtype)


@dataclasses.dataclass
class RefineMonitor:
    """Convergence / divergence policy of the iterative refinement
    Z <- Z(I + delta/2), shared by the host and resident drivers.

    Tracks the most accurate iterate seen; ``update`` flags a stop on
    convergence (residual ||I - Z^T A Z||_F below tolerance), divergence
    (the residual grows 4x past the best seen), or stagnation (no new best
    for ``max_stall`` consecutive iterations — truncation / SpAMM error
    floors the residual above ``tol``, and iterating past the floor is pure
    waste).  On a non-convergence stop the caller returns the best iterate.
    """

    tol: float
    max_stall: int = 3
    best_r: float = float("inf")
    best_iter: int = -1
    stall: int = 0
    improved: bool = False  # whether the last update() set a new best
    # why the last update() returned True: "converged" / "diverged" /
    # "stalled"; None while the loop should continue.  The divergence trip
    # is the one the flight recorder dumps a postmortem on.
    stop_reason: str | None = None

    def update(self, it: int, r: float) -> bool:
        """Record iteration ``it``; return True when refinement should stop."""
        self.improved = r < self.best_r
        if self.improved:
            self.best_r, self.best_iter = r, it
            self.stall = 0
        else:
            self.stall += 1
        if r <= self.tol:
            self.stop_reason = "converged"
            return True
        if r > 4.0 * self.best_r:
            self.stop_reason = "diverged"
            return True
        if self.stall >= self.max_stall:
            self.stop_reason = "stalled"
            return True
        self.stop_reason = None
        return False


@dataclasses.dataclass
class InverseStats:
    """Metrics of one inverse-factorization run (mirrors PurifyStats).

    ``residual_history[i]`` is ``||I - Z_i^T A Z_i||_F`` before update ``i``;
    ``factorization_residual`` is the residual of the returned Z.  The
    symbolic-cache fields report the hit/miss behaviour of the refinement
    loop: once the iterate's sparsity pattern stabilizes under truncation,
    iterations are all hits (the symbolic phase is skipped entirely).
    """

    iterations: int
    residual_history: list
    factorization_residual: float
    nnzb_history: list
    symbolic_cache: dict | None = None
    cache_hits_history: list | None = None
    cache_misses_history: list | None = None


def inv_chol(
    a: BSMatrix,
    leaf_blocks: int = 1,
    *,
    impl: str = "auto",
    cache: SymbolicCache | None = None,
) -> BSMatrix:
    """Recursive inverse Cholesky.  Z upper triangular, Z^T A Z = I.

    Recursion: split A at the quadtree midpoint,
      Z00 = invchol(A00);  W = A01^T Z00;  S = A11 - W W^T;
      Z11 = invchol(S);    Z01 = -Z00 W^T Z11.

    ``cache`` memoizes every multiply's symbolic phase by structure —
    recursions over repeated quadrant structures (banded matrices, SCF-style
    repeated factorizations) skip the descent on the second encounter.
    """
    nbr = a.nblocks[0]
    if nbr <= leaf_blocks:
        return _dense_inv_chol(a)
    depth = int(np.ceil(np.log2(nbr)))
    split = 1 << (depth - 1)
    a00 = submatrix(a, 0, split, 0, split)
    a01 = submatrix(a, 0, split, split, nbr)
    a11 = submatrix(a, split, nbr, split, nbr)
    z00 = inv_chol(a00, leaf_blocks, impl=impl, cache=cache)
    w = multiply(a01.transpose(), z00, impl=impl, cache=cache)  # [n1, n0]
    s = add(a11, multiply(w, w.transpose(), impl=impl, cache=cache), 1.0, -1.0)
    z11 = inv_chol(s, leaf_blocks, impl=impl, cache=cache)
    z01 = multiply(
        multiply(z00, w.transpose(), impl=impl, cache=cache),
        z11,
        impl=impl,
        cache=cache,
    ).scale(-1.0)
    zero = BSMatrix.zeros((a11.shape[0], a00.shape[1]), a.bs, a.dtype, device=a.device)
    return assemble2x2(z00, z01, zero, z11, split)


def factorization_residual(
    a: BSMatrix,
    z: BSMatrix,
    *,
    impl: str = "auto",
    cache: SymbolicCache | None = None,
) -> float:
    """||I - Z^T A Z||_F."""
    zaz = multiply(
        multiply(z.transpose(), a, impl=impl, cache=cache), z, impl=impl, cache=cache
    )
    delta = add(identity(a.shape[0], a.bs, a.dtype, device=a.device), zaz, 1.0, -1.0)
    return delta.frobenius_norm()


def localized_inverse_factorization(
    a: BSMatrix,
    *,
    tol: float = 1e-10,
    max_iter: int = 100,
    trunc_tau: float = 0.0,
    leaf_blocks: int = 1,
    impl: str = "auto",
    cache: SymbolicCache | None = None,
) -> tuple[BSMatrix, InverseStats]:
    """Divide-and-conquer inverse factorization with iterative refinement.

    Factorize the two diagonal quadrants independently, then correct the
    coupling by Z <- Z(I + delta/2), delta = I - Z^T A Z, until
    :class:`RefineMonitor` stops the loop.  Every multiply's symbolic phase
    goes through ``cache`` (a :class:`~repro_torch.core.cache.SymbolicCache`;
    created here when omitted), so iterations whose sparsity pattern is
    stable skip the symbolic phase entirely — hit/miss counts are reported
    per iteration in the returned :class:`InverseStats`.
    """
    cache = cache if cache is not None else SymbolicCache()
    nbr = a.nblocks[0]
    if nbr <= leaf_blocks:
        z = _dense_inv_chol(a)
        return z, InverseStats(
            0, [], factorization_residual(a, z, impl=impl, cache=cache), [z.nnzb],
            cache.stats(), [], [],
        )
    depth = int(np.ceil(np.log2(nbr)))
    split = 1 << (depth - 1)
    a00 = submatrix(a, 0, split, 0, split)
    a11 = submatrix(a, split, nbr, split, nbr)
    z00 = inv_chol(a00, leaf_blocks, impl=impl, cache=cache)
    z11 = inv_chol(a11, leaf_blocks, impl=impl, cache=cache)
    zero01 = BSMatrix.zeros((z00.shape[0], z11.shape[1]), a.bs, a.dtype, device=a.device)
    zero10 = BSMatrix.zeros((z11.shape[0], z00.shape[1]), a.bs, a.dtype, device=a.device)
    z = assemble2x2(z00, zero01, zero10, z11, split)

    eye = identity(a.shape[0], a.bs, a.dtype, device=a.device)
    monitor = RefineMonitor(tol)
    best = z
    history: list[float] = []
    nnzbs, hits_hist, miss_hist = [], [], []
    for it in range(max_iter):
        h0, m0 = cache.hits, cache.misses
        zaz = multiply(
            multiply(z.transpose(), a, impl=impl, cache=cache),
            z,
            impl=impl,
            cache=cache,
        )
        delta = add(eye, zaz, 1.0, -1.0)
        r = delta.frobenius_norm()
        history.append(r)
        nnzbs.append(z.nnzb)
        stop = monitor.update(it, r)
        if monitor.improved:
            best = z
        if not stop:
            step = add(eye, delta, 1.0, 0.5)  # I + delta/2
            z = multiply(z, step, impl=impl, cache=cache)
            if trunc_tau > 0:
                z = truncate(z, trunc_tau)
        hits_hist.append(cache.hits - h0)
        miss_hist.append(cache.misses - m0)
        if stop:
            break
    return best, InverseStats(
        len(history),
        history,
        monitor.best_r,
        nnzbs,
        cache.stats(),
        hits_hist,
        miss_hist,
    )
