"""Density matrix purification (SP2) — the paper's driving application.

Given a symmetric "Hamiltonian" F, eigenvalue bounds, and an occupation count
n_occ, compute the density matrix D = theta(mu*I - F) (projector onto the
n_occ lowest eigenstates) using only the library's multiply / add / trace /
truncate task types — the multiplication-heavy workload the library was built
for (paper refs 15, 3).

The SP2 *policy* (initial congruence coefficients, branch selection,
convergence / divergence tests) is factored out as in the JAX package, so a
device-resident distributed driver can run the identical iteration on
another matrix backend.
"""

from __future__ import annotations

import dataclasses

from .add import add, add_scaled_identity, identity
from .cache import SymbolicCache
from .matrix import BSMatrix
from .spgemm import multiply
from .truncate import truncate

__all__ = [
    "sp2_purify",
    "PurifyStats",
    "sp2_init_coeffs",
    "sp2_should_square",
    "Sp2Monitor",
]


def sp2_init_coeffs(lmin: float, lmax: float) -> tuple[float, float]:
    """(scale, shift) with X0 = scale*F + shift*I = (lmax*I - F)/(lmax - lmin),
    mapping spec(F) in [lmin, lmax] onto [0, 1] reversed."""
    span = lmax - lmin
    return -1.0 / span, lmax / span


def sp2_should_square(trace: float, n_occ: float) -> bool:
    """Trace-correcting branch: X <- X^2 when trace(X) > n_occ, else 2X - X^2."""
    return trace > n_occ


@dataclasses.dataclass
class Sp2Monitor:
    """Convergence / divergence bookkeeping shared by both SP2 drivers.

    Tracks the most idempotent iterate seen; ``done`` flags convergence
    (idempotency below tolerance) or divergence (in finite precision
    eigenvalues drift outside [0, 1] and repeated squaring blows up — stop
    once idempotency regresses 4x past the best seen, and report the best
    iterate instead of iterating past the noise floor).
    """

    idem_tol: float
    best_idem: float = float("inf")
    best_iter: int = -1
    improved: bool = False  # whether the last update() set a new best
    # why the last update() returned True: "converged" / "diverged"; None
    # while the loop should continue (mirrors RefineMonitor.stop_reason)
    stop_reason: str | None = None

    def update(self, it: int, idem: float) -> bool:
        """Record iteration ``it``; return True when the loop should stop.

        ``improved`` afterwards tells the caller whether this iterate is the
        new most-idempotent one (so it can retain it as the result).
        """
        self.improved = idem < self.best_idem
        if self.improved:
            self.best_idem, self.best_iter = idem, it
        if idem <= self.idem_tol:
            self.stop_reason = "converged"
            return True
        if idem > 4.0 * self.best_idem:
            self.stop_reason = "diverged"
            return True
        self.stop_reason = None
        return False


@dataclasses.dataclass
class PurifyStats:
    iterations: int
    trace_history: list
    idempotency_history: list
    nnzb_history: list
    # symbolic-phase cache metrics: SymbolicCache.stats() at exit, plus the
    # per-iteration hit counts (an iteration on a stable sparsity pattern is
    # all hits — the symbolic phase is skipped entirely)
    symbolic_cache: dict | None = None
    cache_hits_history: list | None = None


def sp2_purify(
    f: BSMatrix,
    n_occ: float,
    lmin: float,
    lmax: float,
    *,
    max_iter: int = 100,
    idem_tol: float = 1e-8,
    trunc_tau: float = 0.0,
    impl: str = "auto",
    cache: SymbolicCache | None = None,
) -> tuple[BSMatrix, PurifyStats]:
    """SP2 (trace-correcting) purification.

    X0 = (lmax*I - F) / (lmax - lmin); then X <- X^2 when trace(X) > n_occ
    else X <- 2X - X^2, until idempotency ||X^2 - X|| is below tolerance.

    The multiply symbolic phase goes through a structure-keyed
    :class:`~repro_torch.core.cache.SymbolicCache` (pass one to share across
    calls): iterations whose sparsity pattern is stable skip the symbolic
    phase entirely.
    """
    cache = cache if cache is not None else SymbolicCache()
    scale, shift = sp2_init_coeffs(lmin, lmax)
    x = add_scaled_identity(f.scale(scale), shift)
    traces, idems, nnzbs, cache_hits = [], [], [], []
    monitor = Sp2Monitor(idem_tol)
    best = x
    for it in range(max_iter):
        h0 = cache.hits
        x2 = multiply(x, x, impl=impl, cache=cache)
        idem = add(x2, x, 1.0, -1.0).frobenius_norm()
        tr = x.trace()
        traces.append(tr)
        idems.append(idem)
        nnzbs.append(x.nnzb)
        cache_hits.append(cache.hits - h0)
        stop = monitor.update(it, idem)
        if monitor.improved:
            best = x
        if stop:
            break
        if sp2_should_square(tr, n_occ):
            x = x2
        else:
            x = add(x, x2, 2.0, -1.0)
        if trunc_tau > 0:
            x = truncate(x, trunc_tau)
    return best, PurifyStats(
        len(traces), traces, idems, nnzbs, cache.stats(), cache_hits
    )
