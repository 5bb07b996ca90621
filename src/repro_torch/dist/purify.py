"""End-to-end distributed SP2 purification on resident matrices.

The full iterative loop — multiply via a cached plan, add / trace /
Frobenius norm / truncate via the resident collectives — runs on
:class:`~repro_torch.dist.matrix.DistBSMatrix` stores that never leave the
worker mesh.  The host only sees scalars (trace, idempotency) and small
index tables each iteration; after the sparsity pattern stabilizes under
truncation every planning step is a :class:`~repro_torch.dist.cache.PlanCache`
hit, so an iteration is pure device work: the CHT chunk-cache behaviour
the paper measures, on P workers of one card.

Shares the SP2 *policy* (initial congruence, trace-correcting branch,
convergence / divergence monitor) with the single-device driver via
:mod:`repro_torch.core.purify`, so both produce the same iterates.

Every driver here runs on the device of the mesh it is given (or of the
resident operand it is handed); a host ``BSMatrix`` with no mesh raises
``ValueError`` — one card has no "all devices" to default to, so the caller
builds the mesh, ``make_worker_mesh(P, device="cpu")`` in CPU code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.add import add_scaled_identity, identity
from ..core.distributed import WorkerMesh
from ..core.matrix import BSMatrix
from ..core.purify import PurifyStats, Sp2Monitor, sp2_init_coeffs, sp2_should_square
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
    dist_frobenius_norm,
    dist_trace,
    dist_transpose,
    dist_truncate,
    dist_truncate_hierarchical,
)
from .inverse import dist_localized_inverse_factorization
from .matrix import DistBSMatrix, resident_block_norms, scatter
from .multiply import dist_multiply, dist_spamm

__all__ = [
    "dist_sp2_purify",
    "DistPurifyStats",
    "dist_lanczos_bounds",
    "LanczosDivergence",
    "dist_sqrt_inv_pipeline",
    "SqrtInvPipelineStats",
]


def _resident(x: BSMatrix | DistBSMatrix, mesh: WorkerMesh | None, what: str) -> DistBSMatrix:
    """``x`` on the mesh: a resident operand as it is (on its own mesh, which
    ``mesh`` must name if given), a host one scattered onto ``mesh``."""
    if isinstance(x, DistBSMatrix):
        if mesh is not None and mesh != x.mesh:
            raise ValueError(f"resident {what} lives on {x.mesh}, not on the given {mesh}")
        return x
    if mesh is None:
        raise ValueError(f"a host {what} needs a mesh: pass make_worker_mesh(P, device=...)")
    return scatter(x, mesh)


@dataclasses.dataclass
class DistPurifyStats:
    """Per-run and per-iteration metrics of the distributed SP2 loop."""

    iterations: int
    trace_history: list
    idempotency_history: list
    nnzb_history: list
    cache: dict  # run_metrics(cache) at exit
    per_iter: list  # shared-schema rows (repro_torch.obs.timing.SHARED_ITER_KEYS
    # plus SP2 extras): plan-cache hits/misses, recv bytes, nnzb, measured
    # worker-load imbalance (always) and imbalance_after / migrated_bytes
    # when a rebalance= policy re-laid the iterate out
    rebalances: int = 0  # re-layouts performed by the rebalance= policy
    # wall-clock calibration of the rebalance policy's cost coefficients
    # (repro_torch.dist.balance.calibrate_policy report); None without rebalance=
    calibration: dict | None = None
    # HealthMonitor.summary() (alerts, live-policy refits); None without
    # health= monitoring
    health: dict | None = None

    def as_purify_stats(self) -> PurifyStats:
        return PurifyStats(self.iterations, self.trace_history,
                           self.idempotency_history, self.nnzb_history)


def dist_sp2_purify(
    f: BSMatrix | DistBSMatrix,
    n_occ: float,
    lmin: float,
    lmax: float,
    mesh: WorkerMesh | None = None,
    *,
    max_iter: int = 100,
    idem_tol: float = 1e-8,
    trunc_tau: float = 0.0,
    spamm_tau: float = 0.0,
    trunc_method: str = "hierarchical",
    spamm_method: str = "delta",
    impl: str = "fused",
    exchange: str = "p2p",
    precision: Precision | None = None,
    cache: PlanCache | None = None,
    return_resident: bool = False,
    rebalance: RebalancePolicy | None = None,
    tracer=None,
    log=None,
    health: HealthPolicy | None = None,
) -> tuple[BSMatrix | DistBSMatrix, DistPurifyStats]:
    """SP2 purification with every iterate resident on the worker mesh.

    Accepts a host ``BSMatrix`` (scattered once onto ``mesh``, which is then
    required) or an already-resident ``DistBSMatrix``.  Returns the gathered
    density matrix and stats; pass a ``cache`` to share plans across calls.
    ``spamm_tau > 0`` replaces the exact multiply with hierarchical SpAMM
    (:func:`repro_torch.dist.multiply.dist_spamm`): each square carries an
    error bound <= spamm_tau.

    Error control is hierarchical end to end by default:
    ``trunc_method="hierarchical"`` truncates via the quadtree subtree-drop
    descent on the resident norm table
    (:func:`repro_torch.dist.collectives.dist_truncate_hierarchical`;
    ``"leaf"`` selects the flat greedy
    :func:`~repro_torch.dist.collectives.dist_truncate`), and
    ``spamm_method="delta"`` applies the per-iteration prune pattern as a
    task mask against the cached full-multiply plan.  With the defaults, one
    norm-table fetch per iteration is shared between truncation and the next
    SpAMM, and once the sparsity pattern stabilizes an iteration incurs
    *zero* plan-cache misses even while the ``tau``-prune pattern fluctuates.

    ``return_resident=True`` skips the boundary gather and returns the best
    iterate as a :class:`~repro_torch.dist.matrix.DistBSMatrix` — pipeline
    callers (:func:`dist_sqrt_inv_pipeline`) keep chaining resident
    operations on it.

    ``rebalance`` (a :class:`~repro_torch.dist.balance.RebalancePolicy`) turns
    on dynamic load balancing: each iteration's multiply is measured into a
    per-worker cost model (:func:`repro_torch.dist.balance.worker_load`);
    when the combined max/mean imbalance exceeds the policy threshold the
    iterate is re-laid out on the device
    (:func:`~repro_torch.dist.collectives.dist_repartition`) along a weighted,
    subtree-aligned Morton cut before the next iteration.  Every
    per-iteration row carries the measured ``imbalance`` (also with
    ``rebalance=None``), plus ``imbalance_after`` and ``migrated_bytes``
    when a re-layout happened.  Values are bit-identical to the static run
    — only the schedule changes — because the trace and the idempotency
    norm are reduced in an order fixed by the structure
    (:func:`~repro_torch.dist.collectives.dist_trace`).

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
    if trunc_method not in ("hierarchical", "leaf"):
        raise ValueError(f"trunc_method={trunc_method!r} not in ('hierarchical', 'leaf')")
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
        lg.info("run_start", driver="sp2_purify", n=int(f.shape[0]),
                n_occ=float(n_occ), max_iter=max_iter, idem_tol=idem_tol,
                trunc_tau=trunc_tau, spamm_tau=spamm_tau)
    with trc.span("sp2_purify", cat="phase", n=int(f.shape[0])):
        scale, shift = sp2_init_coeffs(lmin, lmax)
        if isinstance(f, DistBSMatrix):
            f = _resident(f, mesh, "F")
            # X0 = scale*F + shift*I, built resident: only the diagonal
            # identity enters through scatter; F's store never leaves the mesh
            eye = scatter(identity(f.shape[0], f.bs, f.dtype, device=f.device), f.mesh)
            x = dist_add(f, eye, scale, shift, cache)
        else:
            x = _resident(add_scaled_identity(f.scale(scale), shift), mesh, "F")

        traces, idems, nnzbs, per_iter = [], [], [], []
        monitor = Sp2Monitor(idem_tol)
        lb = LoadMonitor(x.nparts, rebalance) if rebalance is not None else None
        upfront_migrated = 0
        if lb is not None:
            # a skewed X0 (inherited from F's scatter) would pay one fully
            # imbalanced iteration before the first measured re-layout; fix
            # the ownership skew up-front (its bytes land in iteration 0's row)
            x, upfront_migrated = lb.relayout_if_skewed(x, cache)
        best = x
        x_norms = None  # stack-order norm table of x, carried from truncation
        for it in range(max_iter):
            if rec is not None:
                rec.mark(cache)  # postmortem deltas cover the last iteration
            with IterationScope(cache, it, trc, name="sp2_iteration") as scope:
                lsnap = locality_snapshot(cache)
                x_op = x  # multiply operand: measured weights refer to it
                if spamm_tau > 0:
                    x2, mult_err = dist_spamm(
                        x, x, spamm_tau, cache, exchange=exchange, impl=impl,
                        method=spamm_method, precision=precision, a_norms=x_norms)
                else:
                    x2 = dist_multiply(x, x, cache, exchange=exchange, impl=impl,
                                       precision=precision)
                    mult_err = 0.0
                # the plan the multiply actually used (exact, SpAMM-replan or
                # SpAMM-delta — last_plan_key tracks all three), so recv-bytes
                # stats stay truthful for every mode
                plan = peek_last_plan(cache)
                # measured per-worker cost of the multiply just executed
                # (reported in static runs too, so rebalanced and static
                # trajectories compare)
                leaf_w = (x_norms != 0.0).astype(np.float64) if x_norms is not None else None
                load = measure_iteration_load(cache, plan, leaf_w, leaf_w)
                imb = None
                if load is not None:
                    imb = lb.observe(load) if lb is not None else load.imbalance()
                idem = dist_frobenius_norm(dist_add(x2, x, 1.0, -1.0, cache), cache)
                tr = dist_trace(x, cache)
                traces.append(tr)
                idems.append(idem)
                nnzbs.append(x.nnzb)
                nnzb_it = x.nnzb
                stop = monitor.update(it, idem)
                if stop and monitor.stop_reason == "diverged":
                    if lg.enabled:
                        lg.warn("sp2_divergence", iteration=it, idem=idem,
                                best_idem=monitor.best_idem, best_iter=monitor.best_iter)
                    if trc.enabled:
                        trc.instant("sp2_divergence", cat="health", iteration=it, idem=idem)
                    if rec is not None:
                        rec.dump("sp2_divergence", cache, iteration=it, idem=float(idem),
                                 best_idem=float(monitor.best_idem),
                                 best_iter=monitor.best_iter)
                if monitor.improved:
                    best = x
                nfb = 0
                if not stop:
                    if sp2_should_square(tr, n_occ):
                        x = x2
                    else:
                        x = dist_add(x, x2, 2.0, -1.0, cache)
                    x_norms = None
                    if trunc_tau > 0:
                        if trunc_method == "hierarchical":
                            # one norm-table fetch serves both the truncation
                            # descent and the next iteration's SpAMM:
                            # compaction keeps block values, so the kept
                            # subset of the table is the truncated matrix's
                            pre_norms = resident_block_norms(x, cache)
                            nfb = pre_norms.shape[0] * 4
                            info: dict = {}
                            x = dist_truncate_hierarchical(x, trunc_tau, cache,
                                                           norms=pre_norms, stats=info)
                            x_norms = pre_norms[info["kept"]]
                        else:
                            x = dist_truncate(x, trunc_tau, cache)
                imb_after, migrated = None, upfront_migrated
                upfront_migrated = 0
                if (lb is not None and not stop and load is not None
                        and lb.should_rebalance(load) and plan is not None):
                    # measured per-block weights: reads of each operand block
                    # in the executed task list plus one unit of ownership,
                    # mapped onto the updated iterate's structure by Morton
                    # code
                    wa, wb = block_reference_weights(plan.tasks, x_op.nnzb, x_op.nnzb)
                    w = map_block_weights(x_op.coords, wa + wb + 1.0, x.coords, default=1.0)
                    # x_norms is stack-ordered, so it survives the re-layout
                    x, moved, imb_after = lb.migrate(x, w, cache)
                    migrated += moved
                # built after the update + truncation so each row carries its
                # own iteration's full cache/timing deltas (truncation
                # included)
                row = scope.row(
                    nnzb=nnzb_it,
                    idem=idem,
                    trace=tr,
                    spamm_err=mult_err,
                    recv_bytes_mean=plan_stats(plan)["recv_bytes_mean"] if plan is not None else 0.0,
                    norm_fetch_bytes=nfb,
                    imbalance=imb,
                    imbalance_after=imb_after,
                    migrated_bytes=migrated,
                    **locality_iteration(cache, scope, lsnap, iteration=it, driver="sp2"),
                )
                per_iter.append(row)
                if lb is not None and load is not None:
                    # wall-clock feedback: the measured iteration time
                    # calibrates the policy's cost coefficients
                    lb.note_wall(row["wall_s"])
                if lg.debug_enabled:
                    lg.debug("iteration", driver="sp2", **{k: row[k] for k in (
                        "iteration", "nnzb", "idem", "wall_s", "cache_hits",
                        "cache_misses", "recv_bytes_mean")})
                if hm is not None:
                    hm.observe(row, load)
                    hm.maybe_refit(lb)
            if stop:
                break
    if lg.enabled:
        lg.info("run_end", driver="sp2_purify", iterations=len(traces),
                stop_reason=monitor.stop_reason, best_idem=monitor.best_idem,
                nnzb=best.nnzb)
    return (best if return_resident else best.gather()), DistPurifyStats(
        len(traces), traces, idems, nnzbs, run_metrics(cache), per_iter,
        rebalances=lb.rebalances if lb is not None else 0,
        calibration=lb.calibration()[1] if lb is not None else None,
        health=hm.summary() if hm is not None else None,
    )


# --------------------------------------------------------------------------
# end-to-end SPD pipeline: S -> Z -> Z^T H Z -> SP2 (-> Z D Z^T)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SqrtInvPipelineStats:
    """Per-stage metrics of :func:`dist_sqrt_inv_pipeline`.

    ``inverse`` / ``purify`` are the stage drivers' own stats objects
    (refinement iterations, per-iteration plan hit/miss rows, bytes moved);
    ``congruence`` and ``back_transform`` carry the cache deltas and wall
    time of the two multiply pairs; ``bounds`` records the (lmin, lmax) the
    SP2 stage ran with (estimated from the resident norm table when the
    caller supplied none); ``cache`` is the shared PlanCache at exit.
    """

    inverse: object  # DistInverseStats
    purify: DistPurifyStats
    congruence: dict
    back_transform: dict | None
    bounds: tuple
    cache: dict


def _spectral_bounds_from_norms(coords, norms) -> tuple[float, float]:
    """Symmetric spectral enclosure from the resident block-norm table.

    ``||F||_2 <= max_i sum_j ||F_ij||_2 <= max_i sum_j ||F_ij||_F`` — a
    block row-sum (Gershgorin-style) bound computed from the norm table, so
    estimating SP2's eigenvalue interval costs no extra block data transfer.
    Loose bounds cost SP2 iterations, never correctness.
    """
    rows = np.asarray(coords)[:, 0]
    sums = np.zeros(int(rows.max()) + 1 if rows.size else 1, dtype=np.float64)
    np.add.at(sums, rows, np.asarray(norms, dtype=np.float64))
    b = float(sums.max()) if rows.size else 0.0
    if b == 0.0:
        return -1.0, 1.0  # F == 0: any nondegenerate enclosure of {0} works
    return -b, b


class LanczosDivergence(RuntimeError):
    """The Lanczos recurrence left the finite regime (non-finite alpha /
    beta, or the tridiagonal eigensolve failed) — the caller falls back to
    the block-Gershgorin enclosure."""


def _lanczos_ritz(f: DistBSMatrix, cache, steps: int, seed: int) -> tuple[float, float]:
    """The raw Lanczos sweep; raises :class:`LanczosDivergence` on any
    non-finite recurrence coefficient or eigensolve failure."""
    n, bs = f.shape[0], f.bs
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    col = np.zeros((n, bs), dtype=np.float32)
    col[:, 0] = v0
    vcur = scatter(BSMatrix.from_dense(col, bs, device=f.device).astype(f.dtype), f.mesh)
    vprev = None
    beta = 0.0
    alphas: list[float] = []
    betas: list[float] = []
    for _ in range(max(int(steps), 1)):
        w = dist_multiply(f, vcur, cache)
        vt = dist_transpose(vcur, cache)
        alpha = dist_trace(dist_multiply(vt, w, cache), cache)
        if not np.isfinite(alpha):
            raise LanczosDivergence(f"non-finite alpha {alpha!r}")
        w = dist_add(w, vcur, 1.0, -alpha, cache)
        if vprev is not None:
            w = dist_add(w, vprev, 1.0, -beta, cache)
        alphas.append(alpha)
        beta = dist_frobenius_norm(w, cache)
        if not np.isfinite(beta):
            raise LanczosDivergence(f"non-finite beta {beta!r}")
        betas.append(beta)
        if beta <= 1e-12 * max(abs(alpha), 1.0):
            break  # invariant subspace: Ritz values are exact eigenvalues
        vprev, vcur = vcur, w.scale(1.0 / beta)
    k = len(alphas)
    t = np.diag(np.asarray(alphas, dtype=np.float64))
    for i in range(k - 1):
        t[i, i + 1] = t[i + 1, i] = betas[i]
    try:
        theta, s = np.linalg.eigh(t)
    except np.linalg.LinAlgError as e:
        raise LanczosDivergence(f"tridiagonal eigensolve failed: {e}") from e
    eta = abs(betas[k - 1]) * np.abs(s[k - 1, :])
    lo, hi = float((theta - eta).min()), float((theta + eta).max())
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise LanczosDivergence(f"non-finite Ritz bounds ({lo}, {hi})")
    return lo, hi


def dist_lanczos_bounds(
    f: DistBSMatrix,
    cache: PlanCache | None = None,
    *,
    steps: int = 10,
    seed: int = 0,
) -> tuple[float, float]:
    """Ritz-value estimate of spec(F) from a few resident Lanczos steps.

    Tightens the block-Gershgorin enclosure
    (:func:`_spectral_bounds_from_norms`) without gathering F: the Lanczos
    vector lives on the mesh as an ``(n, bs)`` block-column matrix whose
    first column carries the vector, so every step is existing resident
    collectives — ``dist_multiply`` for F@v, transpose + multiply +
    ``dist_trace`` for the dot products, ``dist_add`` for the three-term
    recurrence and ``dist_frobenius_norm`` for the normalization.  All
    structures repeat across steps, so after the first step the plan cache
    is all-hit.

    Returns ``(lo, hi)`` — the extreme Ritz values widened by each pair's
    residual bound ``beta_k * |s_k|``.  This is a sharp *estimate*, not a
    rigorous enclosure of the full spectrum; callers intersect it with the
    Gershgorin interval (so bounds never widen) and rely on SP2's divergence
    monitor as the backstop for a rare under-estimate.

    A divergence inside the sweep — a non-finite recurrence coefficient or a
    failed tridiagonal eigensolve — falls back to the block-Gershgorin
    enclosure from the resident norm table instead of propagating NaNs into
    SP2's interval (logged as ``lanczos_fallback`` when an event log rides on
    the cache).
    """
    if f.shape[0] != f.shape[1]:
        raise ValueError(f"spectral bounds need a square operand, got {f.shape}")
    try:
        return _lanczos_ritz(f, cache, steps, seed)
    except LanczosDivergence as e:
        lo, hi = _spectral_bounds_from_norms(f.coords, resident_block_norms(f, cache))
        lg = log_of(cache)
        if lg.enabled:
            lg.warn("lanczos_fallback", reason=str(e), steps=int(steps),
                    gershgorin_lo=lo, gershgorin_hi=hi)
        tr = tracer_of(cache)
        if tr.enabled:
            tr.instant("lanczos_fallback", cat="health", reason=str(e))
        return lo, hi


def dist_sqrt_inv_pipeline(
    s: BSMatrix | DistBSMatrix,
    h: BSMatrix | DistBSMatrix,
    n_occ: float,
    mesh: WorkerMesh | None = None,
    *,
    lmin: float | None = None,
    lmax: float | None = None,
    tol: float = 1e-8,
    max_iter: int = 100,
    idem_tol: float = 1e-8,
    trunc_tau: float = 0.0,
    spamm_tau: float = 0.0,
    leaf_blocks: int = 1,
    impl: str = "fused",
    exchange: str = "p2p",
    precision: Precision | None = None,
    cache: PlanCache | None = None,
    transform_back: bool = True,
    rebalance: RebalancePolicy | None = None,
    lanczos_steps: int = 8,
    tracer=None,
    log=None,
    health=None,
) -> tuple[BSMatrix, SqrtInvPipelineStats]:
    """The paper's full electronic-structure workflow, resident end to end.

    Overlap matrix S -> inverse factor Z (localized inverse factorization,
    Z^T S Z = I) -> congruence transform F = Z^T H Z into the orthonormal
    basis -> SP2 purification of F -> density matrix back in the original
    basis, D = Z D_ortho Z^T (skipped with ``transform_back=False``).  S and
    H enter the mesh once (or arrive already resident); every intermediate
    stays on the workers; the returned density matrix is the single boundary
    gather.  All stages share one :class:`~repro_torch.dist.cache.PlanCache`,
    so structures recurring across stages (Z, its transpose, the stabilized
    SP2 iterate) are planned exactly once.  Host operands need ``mesh``; the
    whole pipeline runs on the mesh's device.

    When ``lmin`` / ``lmax`` are omitted, the SP2 eigenvalue interval is
    estimated from F's resident norm table (block Gershgorin row sums — no
    block data leaves the mesh for it); ``lanczos_steps > 0`` (the default)
    refines that interval with a few resident Lanczos steps, intersected
    with the Gershgorin enclosure so it can only tighten.  Pass
    ``lanczos_steps=0`` for the pure Gershgorin interval.

    ``rebalance`` (a :class:`~repro_torch.dist.balance.RebalancePolicy`)
    enables dynamic load balancing in both iterative stages — the inverse
    refinement loop and SP2.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records the whole
    workflow as one span timeline: inverse / congruence / spectral-bounds /
    SP2 / back-transform phases with every collective, plan build and kernel
    dispatch nested beneath — export with
    :func:`repro_torch.obs.write_chrome_trace`.  ``log`` rides on the cache
    the same way, and ``health`` monitors both iterative stages (each
    stage's summary is in its stats).  Results are bit-identical with them
    on or off.
    """
    cache = cache if cache is not None else PlanCache()
    if tracer is not None:
        cache.tracer = tracer
    if log is not None:
        cache.event_log = log
    trc = tracer_of(cache)
    ds = _resident(s, mesh, "S")
    dh = _resident(h, ds.mesh, "H")
    if ds.shape != dh.shape or ds.bs != dh.bs:
        raise ValueError(f"S {ds.shape} (bs {ds.bs}) and H {dh.shape} (bs {dh.bs}) differ")
    mkw = dict(exchange=exchange, impl=impl, precision=precision)

    z, inv_stats = dist_localized_inverse_factorization(
        ds, cache, tol=tol, max_iter=max_iter, trunc_tau=trunc_tau,
        spamm_tau=spamm_tau, leaf_blocks=leaf_blocks, rebalance=rebalance, health=health, **mkw)

    with IterationScope(cache, None, trc, name="congruence", cat="phase") as sc:
        zt = dist_transpose(z, cache)
        f_ortho = dist_multiply(dist_multiply(zt, dh, cache, **mkw), z, cache, **mkw)
        congruence = sc.delta()

    if lmin is None or lmax is None:
        with trc.span("spectral_bounds", cat="phase", lanczos=lanczos_steps):
            lo, hi = _spectral_bounds_from_norms(
                f_ortho.coords, resident_block_norms(f_ortho, cache))
            if lanczos_steps > 0:
                llo, lhi = dist_lanczos_bounds(f_ortho, cache, steps=lanczos_steps)
                # intersect with the Gershgorin enclosure: refinement can
                # only tighten the interval, never widen it
                if max(lo, llo) < min(hi, lhi):
                    lo, hi = max(lo, llo), min(hi, lhi)
        lmin = lo if lmin is None else lmin
        lmax = hi if lmax is None else lmax

    d_ortho, purify_stats = dist_sp2_purify(
        f_ortho, n_occ, lmin, lmax, max_iter=max_iter, idem_tol=idem_tol,
        trunc_tau=trunc_tau, spamm_tau=spamm_tau, cache=cache,
        return_resident=True, rebalance=rebalance, health=health, **mkw)

    back = None
    if transform_back:
        with IterationScope(cache, None, trc, name="back_transform", cat="phase") as sb:
            d = dist_multiply(dist_multiply(z, d_ortho, cache, **mkw), zt, cache, **mkw)
            back = sb.delta()
        result = d.gather()
    else:
        result = d_ortho.gather()
    return result, SqrtInvPipelineStats(
        inv_stats, purify_stats, congruence, back, (lmin, lmax), run_metrics(cache))
