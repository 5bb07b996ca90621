"""Device-resident inverse factorization (paper §2.2).

The multiplication-heavy workload that motivates the whole quadtree design,
run end to end on the resident runtime: find Z with Z^T A Z = I for SPD A
without the iterates ever leaving the worker mesh.

* :func:`dist_inv_chol` — recursive inverse Cholesky over the quadtree
  split.  Quadrants are carved out of the resident store with
  :func:`~repro_torch.dist.collectives.dist_submatrix` (owner-local masks, no
  motion between workers), every Schur step is a resident
  transpose/multiply/add, and the recursion bottoms out in a dense lapack
  factorization of the tiny leaf on the host (the one boundary crossing,
  exactly like the single-device path's leaf).
* :func:`dist_localized_inverse_factorization` — divide-and-conquer:
  factorize the two diagonal quadrants independently, glue them with
  :func:`~repro_torch.dist.collectives.dist_assemble2x2`, then correct the
  coupling by iterative refinement Z <- Z(I + delta/2), delta = I - Z^T A Z.
  The refinement loop is the hot path and runs entirely through the cached
  planners: ``dist_spamm(method="delta")`` multiplies and
  ``dist_truncate_hierarchical`` error control share one norm-table fetch
  per iteration (the transposed iterate's norms are a host-side permutation
  of the same table — block norms are transpose-invariant), and once the
  sparsity pattern stabilizes an iteration incurs *zero* plan-cache misses —
  the same discipline as ``dist_sp2_purify``.

Convergence policy (:class:`repro_torch.core.inverse.RefineMonitor`) is
shared with the single-device driver, so both stop on the identical
criterion.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.add import identity
from ..core.inverse import (
    RefineMonitor,
    _dense_inv_chol,
    assemble2x2,
    factorization_residual,
    submatrix,
)
from ..core.matrix import BSMatrix
from ..core.schedule import plan_stats
from ..kernels.precision import Precision
from ..obs.health import HealthMonitor, HealthPolicy
from ..obs.locality import locality_iteration, locality_snapshot
from ..obs.log import log_of
from ..obs.timing import IterationScope
from ..obs.tracer import run_metrics, tracer_of
from .balance import (
    LoadMonitor,
    RebalancePolicy,
    block_reference_weights,
    map_block_weights,
    measure_iteration_load,
    peek_last_plan,
)
from .cache import PlanCache
from .collectives import (
    dist_add,
    dist_assemble2x2,
    dist_frobenius_norm,
    dist_submatrix,
    dist_transpose,
    dist_truncate_hierarchical,
    transpose_permutation,
)
from .matrix import DistBSMatrix, dist_zeros, resident_block_norms, scatter
from .multiply import dist_multiply, dist_spamm

__all__ = [
    "dist_inv_chol",
    "dist_localized_inverse_factorization",
    "DistInverseStats",
]


@dataclasses.dataclass
class DistInverseStats:
    """Per-run and per-iteration metrics of the resident refinement loop.

    Mirrors :class:`~repro_torch.dist.purify.DistPurifyStats`: ``per_iter``
    rows carry the plan-cache hit/miss deltas, planning/symbolic seconds,
    the executed multiply plan's mean received bytes per worker, the bytes
    of the shared norm-table fetch, and the SpAMM error bound of that
    iteration's multiplies.  ``factorization_residual`` is the residual of
    the returned (best) iterate; ``stop_reason`` is the
    :class:`~repro_torch.core.inverse.RefineMonitor`'s (``"converged"`` at
    ``tol``, ``"stalled"`` at the floor that truncation, SpAMM or fp32
    rounding set, ``"diverged"``; ``None`` when ``max_iter`` ran out).
    """

    iterations: int
    residual_history: list
    factorization_residual: float
    nnzb_history: list
    cache: dict  # run_metrics(cache) at exit
    per_iter: list  # shared-schema rows (repro_torch.obs.timing.SHARED_ITER_KEYS
    # plus the refinement residual)
    rebalances: int = 0  # re-layouts performed by the rebalance= policy
    # wall-clock calibration of the rebalance policy's cost coefficients
    # (repro_torch.dist.balance.calibrate_policy report); None without rebalance=
    calibration: dict | None = None
    # HealthMonitor.summary() when health monitoring was on; None otherwise
    health: dict | None = None
    stop_reason: str | None = None


def _leaf_ranges(nbr: int, leaf_blocks: int, base: int = 0) -> list[tuple[int, int]]:
    """Block-row ranges the inv_chol recursion's leaves cover, in descent
    order (power-of-2 split, same as the recursion itself)."""
    if nbr <= leaf_blocks:
        return [(base, base + nbr)]
    split = 1 << (int(np.ceil(np.log2(nbr))) - 1)
    return _leaf_ranges(split, leaf_blocks, base) + _leaf_ranges(
        nbr - split, leaf_blocks, base + split
    )


def _leaf_block_diagonal(coords: np.ndarray, ranges: list[tuple[int, int]]) -> bool:
    """True when every nonzero block lies inside some diagonal leaf square —
    then all inv_chol leaves are independent and can factorize as one batch."""
    if coords.shape[0] == 0:
        return True
    starts = np.array([lo for lo, _ in ranges] + [ranges[-1][1]], dtype=np.int64)
    leaf = np.searchsorted(starts, coords[:, 0], side="right") - 1
    return bool(np.all((coords[:, 1] >= starts[leaf]) & (coords[:, 1] < starts[leaf + 1])))


def _batched_leaf_inv_chol(
    a: DistBSMatrix, ranges: list[tuple[int, int]], leaf_blocks: int
) -> DistBSMatrix:
    """All leaves independent: ONE gather to the host, size-grouped batched
    dense factorizations, ONE scatter back — instead of the recursion's
    per-leaf gather/factorize/scatter loop.

    numpy's stacked ``cholesky`` / ``solve`` run the same lapack routine per
    matrix in the batch, in float64, so each leaf's factor is bit-identical
    to what the per-leaf :func:`~repro_torch.core.inverse._dense_inv_chol`
    produces — and to the JAX package's, which runs the same numpy code.
    """
    dev = a.gather()
    host = BSMatrix(shape=dev.shape, bs=dev.bs, coords=dev.coords, data=dev.data.cpu())
    leaves = [submatrix(host, lo, hi, lo, hi) for lo, hi in ranges]
    denses = [lf.to_dense() for lf in leaves]
    np_dtype = denses[0].dtype
    z_dense: list[np.ndarray | None] = [None] * len(leaves)
    by_shape: dict[tuple, list[int]] = {}
    for i, d in enumerate(denses):
        by_shape.setdefault(d.shape, []).append(i)
    for shape, idxs in by_shape.items():
        stack = np.stack([denses[i].astype(np.float64) for i in idxs])
        L = np.linalg.cholesky(stack)
        eye = np.broadcast_to(np.eye(shape[0]), stack.shape)
        z = np.linalg.solve(np.swapaxes(L, -1, -2), eye)  # L^{-T}, batched
        for j, i in enumerate(idxs):
            z_dense[i] = z[j]
    leaf_z = [BSMatrix.from_dense(z.astype(np_dtype), a.bs, device="cpu").astype(host.dtype)
              for z in z_dense]
    # rebuild the recursion's assemble2x2 nesting over the precomputed
    # leaves so the result's block structure matches the unbatched path
    ptr = [0]

    def nest(lo: int, hi: int) -> BSMatrix:
        nbr = hi - lo
        if nbr <= leaf_blocks:
            z = leaf_z[ptr[0]]
            ptr[0] += 1
            return z
        split = 1 << (int(np.ceil(np.log2(nbr))) - 1)
        z00 = nest(lo, lo + split)
        z11 = nest(lo + split, hi)
        zero01 = BSMatrix.zeros((z00.shape[0], z11.shape[1]), a.bs, host.dtype, device="cpu")
        zero10 = BSMatrix.zeros((z11.shape[0], z00.shape[1]), a.bs, host.dtype, device="cpu")
        return assemble2x2(z00, zero01, zero10, z11, split)

    return scatter(nest(0, -(-a.shape[0] // a.bs)), a.mesh)


def dist_inv_chol(
    a: DistBSMatrix,
    cache: PlanCache | None = None,
    *,
    leaf_blocks: int = 1,
    exchange: str = "p2p",
    impl: str = "fused",
    precision: Precision | None = None,
    batch_leaves: bool = True,
) -> DistBSMatrix:
    """Recursive inverse Cholesky on the resident store.  Z^T A Z = I.

    Identical recursion (and identical block structure) to
    :func:`repro_torch.core.inverse.inv_chol`:
      Z00 = invchol(A00);  W = A01^T Z00;  S = A11 - W W^T;
      Z11 = invchol(S);    Z01 = -Z00 W^T Z11,
    with every step a resident collective.  Leaves (<= ``leaf_blocks`` block
    rows) gather to the host for the dense lapack factorization and scatter
    straight back — the only boundary crossings, same as the single-device
    path.

    Two structural fast paths (both value-preserving):

    * an empty coupling quadrant A01 skips the W / Schur multiplies outright
      (S = A11, Z01 = 0) instead of multiplying empty structures;
    * ``batch_leaves`` (default on): when every nonzero block of the current
      submatrix lies inside a diagonal leaf square, the remaining descent
      is pure bookkeeping — the leaves gather in ONE boundary crossing,
      factorize as size-grouped *batched* dense cholesky/solve calls, and
      scatter back in one crossing.
    """
    nbr = -(-a.shape[0] // a.bs)
    if nbr <= leaf_blocks:
        return scatter(_dense_inv_chol(a.gather()), a.mesh)
    if batch_leaves:
        ranges = _leaf_ranges(nbr, leaf_blocks)
        if len(ranges) > 1 and _leaf_block_diagonal(a.coords, ranges):
            with tracer_of(cache).span("inv_chol_batched_leaves", cat="collective",
                                       nbr=int(nbr), leaves=len(ranges)):
                return _batched_leaf_inv_chol(a, ranges, leaf_blocks)
    kw = dict(leaf_blocks=leaf_blocks, exchange=exchange, impl=impl,
              precision=precision, batch_leaves=batch_leaves)
    mkw = dict(exchange=exchange, impl=impl, precision=precision)
    with tracer_of(cache).span("inv_chol", cat="collective", nbr=int(nbr)):
        depth = int(np.ceil(np.log2(nbr)))
        split = 1 << (depth - 1)
        a00 = dist_submatrix(a, 0, split, 0, split, cache)
        a01 = dist_submatrix(a, 0, split, split, nbr, cache)
        a11 = dist_submatrix(a, split, nbr, split, nbr, cache)
        z00 = dist_inv_chol(a00, cache, **kw)
        if a01.nnzb == 0:
            # no coupling between the quadrants: S = A11 and Z01 = 0 exactly
            z11 = dist_inv_chol(a11, cache, **kw)
            zero01 = dist_zeros((a00.shape[0], a11.shape[1]), a.bs, a.mesh, a.dtype)
            zero10 = dist_zeros((a11.shape[0], a00.shape[1]), a.bs, a.mesh, a.dtype)
            return dist_assemble2x2(z00, zero01, zero10, z11, split, cache)
        w = dist_multiply(dist_transpose(a01, cache), z00, cache, **mkw)  # [n1, n0]
        wt = dist_transpose(w, cache)  # shared by Schur and coupling steps
        s = dist_add(a11, dist_multiply(w, wt, cache, **mkw), 1.0, -1.0, cache)
        z11 = dist_inv_chol(s, cache, **kw)
        z01 = dist_multiply(dist_multiply(z00, wt, cache, **mkw), z11, cache, **mkw).scale(-1.0)
        zero = dist_zeros((a11.shape[0], a00.shape[1]), a.bs, a.mesh, a.dtype)
        return dist_assemble2x2(z00, z01, zero, z11, split, cache)


def dist_localized_inverse_factorization(
    a: DistBSMatrix,
    cache: PlanCache | None = None,
    *,
    tol: float = 1e-8,
    max_iter: int = 100,
    trunc_tau: float = 0.0,
    spamm_tau: float = 0.0,
    spamm_method: str = "delta",
    leaf_blocks: int = 1,
    exchange: str = "p2p",
    impl: str = "fused",
    precision: Precision | None = None,
    batch_leaves: bool = True,
    rebalance: RebalancePolicy | None = None,
    tracer=None,
    log=None,
    health: HealthPolicy | None = None,
) -> tuple[DistBSMatrix, DistInverseStats]:
    """Divide-and-conquer inverse factorization, resident end to end.

    The two diagonal quadrants factorize independently
    (:func:`dist_inv_chol`), the block-diagonal Z is glued resident, and the
    refinement Z <- Z(I + delta/2) runs through the cached planners:

    * ``spamm_tau > 0`` routes every refinement multiply through
      ``dist_spamm(method="delta")`` — the prune pattern is a task mask over
      the structure-keyed full plan, so a fluctuating ``tau``-prune never
      misses the plan cache;
    * ``trunc_tau > 0`` truncates the iterate with the hierarchical
      subtree-drop descent, and its norm table is carried into the next
      iteration's SpAMM (the transposed operand reuses the same table via
      :func:`~repro_torch.dist.collectives.transpose_permutation` — block
      norms are transpose-invariant), so one fetch serves the whole
      iteration.

    Convergence/divergence policy is the shared
    :class:`~repro_torch.core.inverse.RefineMonitor`; the best iterate is
    returned resident with :class:`DistInverseStats`.  Everything runs on
    the mesh's device; the kernels' failures propagate.

    ``rebalance`` (a :class:`~repro_torch.dist.balance.RebalancePolicy`)
    turns on dynamic load balancing.  The pinned SPD operand ``a`` is the
    classic skew trap — its layout never changes, so a skewed scatter makes
    one worker ship its blocks every refinement multiply forever; when its
    ownership imbalance exceeds the threshold it is re-laid out once,
    up-front, on the device.  The iterate Z is then measured and re-laid out
    between iterations exactly like the SP2 driver, with ``imbalance`` /
    ``imbalance_after`` / ``migrated_bytes`` per-iteration rows.  Values are
    bit-identical to the static run.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) turns on span tracing for
    the whole run: it is attached to the plan cache, so every collective,
    kernel dispatch and plan build records nested spans under one phase
    span.  ``log`` (a :class:`repro_torch.obs.EventLog`) attaches the
    structured event log to the cache the same way: run start/end,
    per-iteration debug events, plan builds, rebalances and health alerts
    all land in it.  ``health`` (a :class:`repro_torch.obs.HealthPolicy`)
    turns on the online :class:`~repro_torch.obs.health.HealthMonitor` —
    straggler / miss-storm / blowup / stall alerts, plus live calibration of
    the rebalance policy when ``rebalance`` is also on; its summary lands in
    the stats' ``health``.  All three are schedule- and report-only: results
    stay bit-identical with them on or off.
    """
    cache = cache if cache is not None else PlanCache()
    if tracer is not None:
        cache.tracer = tracer
    if log is not None:
        cache.event_log = log
    trc = tracer_of(cache)
    lg = log_of(cache)
    hm = HealthMonitor(health, cache=cache) if health is not None else None
    rec = getattr(cache, "flight_recorder", None)
    if lg.enabled:
        lg.info("run_start", driver="inverse_factorization", n=int(a.shape[0]),
                max_iter=int(max_iter), tol=float(tol),
                trunc_tau=float(trunc_tau), spamm_tau=float(spamm_tau))
    with trc.span("inverse_factorization", cat="phase", n=int(a.shape[0])):
        lb = LoadMonitor(a.nparts, rebalance) if rebalance is not None else None
        upfront_migrated = 0
        if lb is not None:
            # the pinned operand's layout is never revisited by the
            # iteration: a skewed scatter would make one worker ship its
            # store every refinement multiply forever — fix it once,
            # up-front, on the device (its bytes land in iteration 0's row)
            a, upfront_migrated = lb.relayout_if_skewed(a, cache)
        nbr = -(-a.shape[0] // a.bs)
        if nbr <= leaf_blocks:
            host_a = a.gather()
            z_host = _dense_inv_chol(host_a)
            return scatter(z_host, a.mesh), DistInverseStats(
                0, [], factorization_residual(host_a, z_host),
                [z_host.nnzb], run_metrics(cache), [],
            )
        depth = int(np.ceil(np.log2(nbr)))
        split = 1 << (depth - 1)
        a00 = dist_submatrix(a, 0, split, 0, split, cache)
        a11 = dist_submatrix(a, split, nbr, split, nbr, cache)
        kw = dict(leaf_blocks=leaf_blocks, exchange=exchange, impl=impl,
                  precision=precision, batch_leaves=batch_leaves)
        z00 = dist_inv_chol(a00, cache, **kw)
        z11 = dist_inv_chol(a11, cache, **kw)
        zero01 = dist_zeros((z00.shape[0], z11.shape[1]), a.bs, a.mesh, a.dtype)
        zero10 = dist_zeros((z11.shape[0], z00.shape[1]), a.bs, a.mesh, a.dtype)
        z = dist_assemble2x2(z00, zero01, zero10, z11, split, cache)

        eye = scatter(identity(a.shape[0], a.bs, a.dtype, device=a.device), a.mesh)
        # the SPD operand's norms never change: one fetch serves all
        # iterations
        a_norms = resident_block_norms(a, cache) if spamm_tau > 0 else None
        monitor = RefineMonitor(tol)
        best = z
        history: list[float] = []
        nnzbs: list[int] = []
        per_iter: list[dict] = []
        z_norms = None  # stack-order norm table of z, carried from truncation
        mkw = dict(exchange=exchange, impl=impl, precision=precision)
        skw = dict(mkw, method=spamm_method)
        for it in range(max_iter):
            if rec is not None:
                rec.mark(cache)
            with IterationScope(cache, it, trc, name="inv_iteration") as scope:
                lsnap = locality_snapshot(cache)
                z_op = z  # the iterate the refinement multiplies read
                mult_err = 0.0
                norm_fetch_bytes = 0
                # measured per-worker cost accumulates over BOTH residual
                # multiplies — the (zt)a plan is where a pinned skewed
                # operand shows up
                leaf_w = (z_norms != 0.0).astype(np.float64) if z_norms is not None else None
                a_leaf_w = (a_norms != 0.0).astype(np.float64) if a_norms is not None else None
                zt = dist_transpose(z, cache)
                if spamm_tau > 0:
                    zt_norms = (z_norms[transpose_permutation(z.coords)]
                                if z_norms is not None else None)
                    za, e1 = dist_spamm(zt, a, spamm_tau, cache, a_norms=zt_norms,
                                        b_norms=a_norms, **skw)
                    load_zta = measure_iteration_load(cache, peek_last_plan(cache), None, a_leaf_w)
                    zaz, e2 = dist_spamm(za, z, spamm_tau, cache, b_norms=z_norms, **skw)
                    mult_err = max(e1, e2)
                else:
                    za = dist_multiply(zt, a, cache, **mkw)
                    load_zta = measure_iteration_load(cache, peek_last_plan(cache), None, a_leaf_w)
                    zaz = dist_multiply(za, z, cache, **mkw)
                plan = peek_last_plan(cache)  # (za)z plan: recv stats + z weights
                load = measure_iteration_load(cache, plan, None, leaf_w)
                if load is None:
                    # the (za)z multiply built no plan (its full task list is
                    # empty): the (zt)a measurement still counts
                    load = load_zta
                elif load_zta is not None:
                    load = load + load_zta
                imb = None
                if load is not None:
                    imb = lb.observe(load) if lb is not None else load.imbalance()
                delta = dist_add(eye, zaz, 1.0, -1.0, cache)
                r = dist_frobenius_norm(delta, cache)
                history.append(r)
                nnzbs.append(z.nnzb)
                nnzb_it = z.nnzb
                stop = monitor.update(it, r)
                if stop and monitor.stop_reason == "diverged":
                    if lg.enabled:
                        lg.warn("refine_divergence", iteration=it, residual=float(r),
                                best_r=float(monitor.best_r), best_iter=int(monitor.best_iter))
                    if trc.enabled:
                        trc.instant("refine_divergence", cat="health", iteration=it,
                                    residual=float(r), best_r=float(monitor.best_r))
                    if rec is not None:
                        rec.dump("refine_divergence", cache, iteration=it, residual=float(r),
                                 best_r=float(monitor.best_r), best_iter=int(monitor.best_iter))
                if monitor.improved:
                    best = z
                if not stop:
                    step = dist_add(eye, delta, 1.0, 0.5, cache)  # I + delta/2
                    if spamm_tau > 0:
                        z, e3 = dist_spamm(z, step, spamm_tau, cache, a_norms=z_norms, **skw)
                        mult_err = max(mult_err, e3)
                    else:
                        z = dist_multiply(z, step, cache, **mkw)
                    z_norms = None
                    if trunc_tau > 0:
                        # one norm-table fetch serves the truncation descent
                        # and the next iteration's SpAMM (both orientations
                        # of Z)
                        pre_norms = resident_block_norms(z, cache)
                        norm_fetch_bytes = pre_norms.shape[0] * 4
                        info: dict = {}
                        z = dist_truncate_hierarchical(z, trunc_tau, cache, norms=pre_norms,
                                                       stats=info)
                        z_norms = pre_norms[info["kept"]]
                imb_after, migrated = None, upfront_migrated
                upfront_migrated = 0
                if (lb is not None and not stop and load is not None
                        and lb.should_rebalance(load) and plan is not None):
                    # measured per-block weights for the iterate: its
                    # reference counts as the b operand of the executed (za)z
                    # plan plus one unit of ownership, mapped onto the
                    # updated structure
                    _, wb = block_reference_weights(plan.tasks, plan.a_owner.shape[0], z_op.nnzb)
                    w = map_block_weights(z_op.coords, wb + 1.0, z.coords, default=1.0)
                    # z_norms is stack-ordered, so it survives the re-layout
                    z, moved, imb_after = lb.migrate(z, w, cache)
                    migrated += moved
                row = scope.row(
                    nnzb=nnzb_it,
                    residual=r,
                    spamm_err=mult_err,
                    recv_bytes_mean=plan_stats(plan)["recv_bytes_mean"] if plan is not None else 0.0,
                    norm_fetch_bytes=norm_fetch_bytes,
                    imbalance=imb,
                    imbalance_after=imb_after,
                    migrated_bytes=migrated,
                    **locality_iteration(cache, scope, lsnap, iteration=it, driver="inverse"),
                )
                per_iter.append(row)
                if lb is not None and load is not None:
                    # wall-clock feedback: the measured iteration time
                    # calibrates the policy's cost coefficients
                    lb.note_wall(row["wall_s"])
                if lg.debug_enabled:
                    lg.debug("iteration", driver="inverse", **{k: row[k] for k in (
                        "iteration", "nnzb", "residual", "wall_s", "cache_hits",
                        "cache_misses", "recv_bytes_mean")})
                if hm is not None:
                    hm.observe(row, load)
                    hm.maybe_refit(lb)
            if stop:
                break
    if lg.enabled:
        lg.info("run_end", driver="inverse_factorization", iterations=len(history),
                stop_reason=monitor.stop_reason, best_r=float(monitor.best_r),
                nnzb=int(best.nnzb))
    return best, DistInverseStats(
        len(history), history, monitor.best_r, nnzbs, run_metrics(cache), per_iter,
        rebalances=lb.rebalances if lb is not None else 0,
        calibration=lb.calibration()[1] if lb is not None else None,
        health=hm.summary() if hm is not None else None,
        stop_reason=monitor.stop_reason,
    )
