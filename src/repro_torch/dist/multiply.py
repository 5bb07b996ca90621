"""Distributed multiply on resident operands, planned through the cache.

``dist_multiply`` is the hot-path operation the runtime exists for: both
operands are :class:`~repro_torch.dist.matrix.DistBSMatrix` stores already
resident on the mesh, the schedule comes from the structure-keyed
:class:`~repro_torch.dist.cache.PlanCache` (symbolic phase + executable with
its index arrays on the device, built once per distinct structure), and the
result store is produced on the device — it never visits the host.

The numeric engine is chosen by ``impl``.  The default, ``"fused"``, is the
fused leaf engine (:mod:`repro_torch.kernels.fused_leaf`): its CUDA kernel on
the card, its plain version on the CPU.  ``"kernel"`` is the staged engine
through the ``block_spmm`` CUDA kernel and ``"ref"`` the staged engine's
plain version on any device.  (The JAX package's drivers default to
``impl="ref"``; here the plain version is never what a call on the card
runs unless asked for.)

``dist_spamm`` adds error-controlled approximate multiply in two modes:

* ``method="delta"`` (default) — the *delta-plan* path: the full-multiply
  plan and a masked executable are cached once per structure; each call runs
  the hierarchical SpAMM descent on the host and ships only a per-task
  on/off mask.  A fluctuating ``tau``-prune pattern therefore never causes a
  plan-cache miss.  On the fused engine the mask also prunes the exchange.
* ``method="replan"`` — the pruned task list is threaded into
  :func:`make_spgemm_plan(tasks=...)` and the plan is keyed by the pruned
  structure: cheaper flops/exchange per call, but any wiggle in the prune
  pattern re-plans.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.errors import PlanError
from ..core.distributed import (
    FusedSpgemmExecutable,
    MaskedFusedSpgemmExecutable,
    MaskedSpgemmExecutable,
    SpgemmExecutable,
)
from ..core.quadtree import build_quadtree_index, quadtree_depth
from ..core.schedule import make_spgemm_plan, structure_fingerprint
from ..core.spgemm import spamm_symbolic, spgemm_symbolic
from ..kernels.precision import FP32, Precision, low_precision_task_mask
from ..obs.memory import matrix_worker_bytes
from ..obs.timing import timed_into
from ..obs.tracer import tracer_of
from .balance import LoadMonitor, block_reference_weights
from .cache import PlanCache
from .matrix import DistBSMatrix, mesh_key, resident_block_norms

__all__ = [
    "dist_multiply",
    "dist_spamm",
    "multiply_plan_key",
    "spamm_delta_plan_key",
]

IMPLS = ("fused", "ref", "kernel")


def _plan_key(kind: str, a: DistBSMatrix, b: DistBSMatrix, exchange: str, impl: str,
              precision: Precision, *extra) -> tuple:
    return (
        kind,
        structure_fingerprint(a.codes(), b.codes(), a.owner, b.owner, a.nparts, a.bs, *extra),
        mesh_key(a.mesh),
        exchange,
        impl,
        str(a.dtype),
        str(b.dtype),
        precision.key(),
    )


def multiply_plan_key(
    a: DistBSMatrix, b: DistBSMatrix, *, exchange: str, impl: str, precision: Precision = FP32
) -> tuple:
    """Cache key: A/B Morton codes + owner maps + mesh + mode knobs.

    Operand dtypes and the precision policy are part of the key — a bf16 or
    adaptive executable differs from the fp32 one.
    """
    return _plan_key("spgemm", a, b, exchange, impl, precision)


def spamm_delta_plan_key(
    a: DistBSMatrix, b: DistBSMatrix, *, exchange: str, impl: str, precision: Precision = FP32
) -> tuple:
    """Delta-plan SpAMM cache key — structure only, independent of the per-call
    prune pattern, so every call on a stable structure is a hit."""
    return _plan_key("spamm-delta", a, b, exchange, impl, precision)


def _plan_obs_static(plan) -> dict:
    """Per-plan static annotation payload, memoized on the plan object.

    Everything here depends only on the plan (exchange bytes, ownership
    terms of the cost model, per-round byte totals), and a warm run replays
    the same plan hundreds of times, so it is computed once per plan.
    """
    st = getattr(plan, "_obs_static", None)
    if st is None:
        from .balance import RebalancePolicy, worker_load

        load = worker_load(plan)
        pol = RebalancePolicy()
        blk = plan.bs * plan.bs * 4
        rounds = []
        if plan.exchange != "allgather":
            for operand, offs, cnts in (
                ("a", plan.a_offsets, plan.a_send_count),
                ("b", plan.b_offsets, plan.b_send_count),
            ):
                for rnd, d in enumerate(offs):
                    rounds.append((operand, rnd, int(d), float(np.asarray(cnts[d]).sum()) * blk))
        base = (pol.recv_cost * load.recv_bytes / blk + pol.send_cost * load.send_bytes / blk
                + pol.block_cost * load.blocks)
        st = dict(
            # the task-independent terms of the rebalancer's combined cost
            base=base,
            # full (unmasked) dispatch cost vector: most warm dispatches run
            # the whole task list
            full_costs=np.asarray(plan.task_count, np.float64) + base,
            full_tasks=int(np.asarray(plan.task_count).sum()),
            recv_sum=float(load.recv_bytes.sum()),
            send_sum=float(load.send_bytes.sum()),
            rounds=rounds,
            rounds_tracer=None,  # exchange_round instants once per tracer
            counters=(None,),  # (tracer, its dispatch counters), see _annotate_spgemm_dispatch
        )
        st["full_costs"].setflags(write=False)  # shared across spans
        object.__setattr__(plan, "_obs_static", st)  # plan is frozen
    return st


def _annotate_spgemm_dispatch(tr, sp, plan, task_count, precision: Precision | None = None,
                              exe=None) -> None:
    """Per-worker attribution + byte/task counters on an executed multiply
    dispatch span.  Callers guard on ``tr.annotates``: this does real work
    (plan byte accounting, cost-model evaluation) that must cost nothing
    with tracing off.

    All workers run in one launch, so the per-worker costs are the load
    balancer's cost model on the executed plan, as the JAX package
    attributes them.  As the JAX package does, the span records the tile
    autotuner's ``tiles``: the ``[engine, pack]`` that the executable handed
    the kernel in this call (``exe.last_tiles``, the pick it keeps per dtype
    and stack alignment), and ``engine``, its first item.
    """
    st = _plan_obs_static(plan)
    counters = st["counters"]
    if counters[0] is not tr:  # the tracer's counters, looked up once per plan and tracer
        counters = st["counters"] = (tr, tr.counter("tasks_executed"), tr.counter("recv_bytes"),
                                     tr.counter("send_bytes"))
    _, c_tasks, c_recv, c_send = counters
    args = sp.args
    if precision is not None:
        args["precision"] = precision.mode
        args["dtype"] = "bfloat16" if precision.mode == "bf16" else "float32"
        tiles = getattr(exe, "last_tiles", None)
        if tiles is not None:
            args["tiles"] = list(tiles)
            args["engine"] = tiles[0]
    ex = getattr(exe, "last_exchange", None)
    if ex is not None:
        args["send_blocks"] = ex["send_blocks"]
        args["kept_send_blocks"] = ex["kept_blocks"]
        args["dropped_rounds"] = ex["dropped_rounds"]
        tr.counter("pruned_send_blocks").add(float(ex["send_blocks"] - ex["kept_blocks"]))
    # the same combined task-equivalent cost the rebalancer weighs
    if task_count is None or task_count is plan.task_count:
        sp.worker_costs = st["full_costs"]
        tasks = st["full_tasks"]
    else:
        tc = np.asarray(task_count)
        sp.worker_costs = tc.astype(np.float64) + st["base"]
        tasks = int(tc.sum())
    args["tasks"] = tasks
    args["recv_bytes"] = st["recv_sum"]
    args["send_bytes"] = st["send_sum"]
    c_tasks.add(float(tasks))
    c_recv.add(st["recv_sum"])
    c_send.add(st["send_sum"])
    # the exchange rounds run inside the dispatch: per-round markers carry
    # planned bytes, not durations.  They are plan-static, so each plan emits
    # them on its first dispatch a given tracer observes.
    if st["rounds_tracer"] is not tr:
        st["rounds_tracer"] = tr
        for operand, rnd, d, nbytes in st["rounds"]:
            tr.instant("exchange_round", cat="exchange", operand=operand, round=rnd, offset=d,
                       bytes=nbytes)


def _note_dispatch_memory(cache, plan, precision, c) -> None:
    """Account an executed multiply against the installed
    :class:`~repro_torch.obs.memory.MemoryMeter` (no-op when none is
    installed): the plan's receive buffers at wire precision plus the result
    store.  A repeat dispatch of the same plan over the same owner layout
    yields the same account, so it is deduplicated by token."""
    mm = getattr(cache, "memory_meter", None) if cache is not None else None
    if mm is None:
        return
    tok = (id(plan), id(c.owner), c.nnzb, c.cap, getattr(precision, "mode", None))
    seen = getattr(mm, "_dispatch_seen", None)
    if seen is None:
        seen = mm._dispatch_seen = set()
    if tok in seen:
        return
    seen.add(tok)
    mm.note_plan(plan, precision, cache=cache)
    # the result's owner map and capacity are the plan's: its store account is
    # memoized on the plan per store type, as plan_memory_bytes is
    memo = getattr(plan, "_obs_mem_result", None)
    if memo is None:
        memo = {}
        object.__setattr__(plan, "_obs_mem_result", memo)
    b = memo.get(c.dtype)
    if b is None:
        b = memo[c.dtype] = matrix_worker_bytes(c)
    mm.note_matrix(c, "store", cache=cache, worker_bytes=b)


def _note_dispatch_locality(cache, tr, plan, precision, a, b, *, task_on=None, exe=None) -> None:
    """Meter an executed multiply against the installed
    :class:`~repro_torch.obs.locality.LocalityLedger` (no-op when none is
    installed): static local/shipped residency split, wire bytes with
    delta-mask pruning (``exe.last_keeps``) and the wire itemsize applied,
    and per-block movement lineage keyed by the operands' Morton codes.
    Independent of the tracer, but feeds the locality counters when an
    annotating one listens."""
    lld = getattr(cache, "locality_ledger", None) if cache is not None else None
    if lld is None:
        return
    wire = 2 if getattr(precision, "mode", "fp32") != "fp32" else 4
    out = lld.note_dispatch(plan, wire_itemsize=wire, task_on=task_on,
                            keeps=getattr(exe, "last_keeps", None),
                            a_codes=a.codes(), b_codes=b.codes())
    if tr.annotates:
        tr.counter("local_bytes").add(out["local_bytes"])
        tr.counter("shipped_bytes").add(out["shipped_bytes"])
        tr.counter("wire_recv_bytes").add(out["wire_recv_bytes"])
        tr.counter("local_flops").add(out["local_flops"])


def _check_operands(a: DistBSMatrix, b: DistBSMatrix, impl: str) -> None:
    if a.mesh != b.mesh:
        raise ValueError("operands must live on the same worker mesh")
    if a.shape[1] != b.shape[0] or a.bs != b.bs:
        raise ValueError(f"operands do not chain: {a.shape} (bs {a.bs}) @ {b.shape} (bs {b.bs})")
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")


def _rebalance_operands(
    a: DistBSMatrix, b: DistBSMatrix, cache: PlanCache | None, policy
) -> tuple[DistBSMatrix, DistBSMatrix]:
    """Opt-in operand re-layout before planning a multiply.

    Weighs each operand's current owner map against its task-reference
    counts in this multiply (plus one unit of ownership weight per block) —
    the :mod:`repro_torch.dist.balance` cost model at single-op granularity —
    and re-slots skewed operands through
    :func:`~repro_torch.dist.collectives.dist_repartition` before the plan is
    built (:meth:`~repro_torch.dist.balance.LoadMonitor.relayout_if_skewed`).
    Everything is structural, so the decision is deterministic per structure
    pair and repeated calls are pure cache hits; iterative callers should
    instead hold the repartitioned handle (the drivers' ``rebalance=`` loop
    does).
    """
    key = ("spgemm-tasks", structure_fingerprint(a.codes(), b.codes(), a.bs))
    build = lambda: spgemm_symbolic(a.coords, b.coords)  # noqa: E731
    tasks = cache.get_or_build(key, build) if cache is not None else build()
    wa, wb = block_reference_weights(tasks, a.nnzb, b.nnzb)
    mon = LoadMonitor(a.nparts, policy)
    a2, _ = mon.relayout_if_skewed(a, cache, wa + 1.0)
    return (a2, a2) if b is a else (a2, mon.relayout_if_skewed(b, cache, wb + 1.0)[0])


def _precision_of(precision, impl: str, exchange: str) -> Precision:
    precision = FP32 if precision is None else precision
    if precision.is_mixed and (impl != "fused" or exchange != "p2p"):
        raise ValueError(
            "mixed precision needs the fused leaf engine (impl='fused') on a p2p plan")
    return precision


def _use_fused(impl: str, exchange: str) -> bool:
    """The fused engine needs the p2p (src, off) decomposition; an allgather
    plan takes the staged engine of the stores' device instead."""
    return impl == "fused" and exchange == "p2p"


def _staged_impl(impl: str) -> str:
    return "auto" if impl == "fused" else impl


def _check_caps(plan, a: DistBSMatrix, b: DistBSMatrix) -> None:
    # the pinned placements must reproduce the operands' resident layout
    if plan.a_cap != a.cap or plan.b_cap != b.cap:
        raise PlanError(f"plan capacities ({plan.a_cap}, {plan.b_cap}) do not match "
                        f"the resident stores ({a.cap}, {b.cap})")


def _valid_task_slots(plan) -> np.ndarray:
    return np.arange(plan.task_gidx.shape[1])[None, :] < plan.task_count[:, None]


def _adaptive_low_table(plan, low_task: np.ndarray) -> np.ndarray:
    """Map a global per-task low-precision mask onto [P, t_cap] int32."""
    if low_task.shape[0] == 0:  # no tasks: gidx pads with 0, don't index
        return np.zeros(plan.task_gidx.shape, np.int32)
    return (low_task[plan.task_gidx] & _valid_task_slots(plan)).astype(np.int32)


def _result(a: DistBSMatrix, b: DistBSMatrix, plan, c_store: torch.Tensor) -> DistBSMatrix:
    return DistBSMatrix(
        shape=(a.shape[0], b.shape[1]),
        bs=a.bs,
        coords=plan.c_coords,
        owner=np.asarray(plan.c_owner, dtype=np.int32),
        slot=np.asarray(plan.c_slot, dtype=np.int32),
        cap=plan.c_cap,
        store=c_store,
        mesh=a.mesh,
    )


def dist_multiply(
    a: DistBSMatrix,
    b: DistBSMatrix,
    cache: PlanCache | None = None,
    *,
    exchange: str = "p2p",
    impl: str = "fused",
    precision: Precision | None = None,
    rebalance=None,
) -> DistBSMatrix:
    """C = A @ B with A, B, C resident on the mesh.  Plan + executable cached.

    ``impl="fused"`` (the default) routes through the fused leaf engine — one
    unpack + GEMM + accumulate launch for all workers, no concatenated
    operand buffer; on an allgather plan it takes the staged engine.
    ``precision`` selects the fused engine's dtype policy (``fp32`` |
    ``bf16`` | ``adaptive``; adaptive spends a rounding-error budget of
    ``precision.tau`` using the resident norm tables).  The staged impls
    (``"ref"`` / ``"kernel"``) are fp32-only.

    ``rebalance`` (a :class:`repro_torch.dist.balance.RebalancePolicy`)
    re-slots skewed operands before planning (:func:`_rebalance_operands`).
    """
    _check_operands(a, b, impl)
    precision = _precision_of(precision, impl, exchange)
    fused = _use_fused(impl, exchange)
    adaptive = precision.mode == "adaptive"
    tr = tracer_of(cache)
    with tr.span("dist_multiply", cat="collective", nnzb_a=a.nnzb, nnzb_b=b.nnzb):
        if rebalance is not None:
            a, b = _rebalance_operands(a, b, cache, rebalance)

        def build():
            plan = make_spgemm_plan(
                a.coords, b.coords, a.nparts, a.bs,
                exchange=exchange, a_owner=a.owner, b_owner=b.owner,
            )
            _check_caps(plan, a, b)
            if fused and adaptive:
                # adaptive needs the per-task low mask -> masked executable;
                # no pruning here (all tasks run), so keep the exchange full
                exe = MaskedFusedSpgemmExecutable(
                    plan, a.mesh, precision=precision, prune_exchange=False)
            elif fused:
                exe = FusedSpgemmExecutable(plan, a.mesh, precision=precision)
            else:
                exe = SpgemmExecutable(plan, a.mesh, impl=_staged_impl(impl))
            return plan, exe

        with tr.span("plan_lookup", cat="plan"):
            key = multiply_plan_key(a, b, exchange=exchange, impl=impl, precision=precision)
            if cache is None:
                plan, exe = build()
            else:
                plan, exe = cache.get_or_build(key, build)
                cache.last_plan_key = key
                cache.last_task_count = plan.task_count
        if adaptive:
            a_norms = resident_block_norms(a, cache)
            b_norms = a_norms if b is a else resident_block_norms(b, cache)
            full = plan.tasks
            low_task, _ = low_precision_task_mask(
                a_norms, b_norms, full.a_idx, full.b_idx, precision.tau)
            task_on = _valid_task_slots(plan)
            task_low = _adaptive_low_table(plan, low_task)
        with tr.span("dispatch", cat="kernel", op="spgemm") as sp:
            if adaptive:
                c_store = tr.sync(exe(a.store, b.store, task_on, task_low, tracer=tr))
            else:
                c_store = tr.sync(exe(a.store, b.store, tracer=tr))
            if tr.annotates:
                _annotate_spgemm_dispatch(tr, sp, plan, plan.task_count, precision, exe)
    c = _result(a, b, plan, c_store)
    _note_dispatch_memory(cache, plan, precision, c)
    _note_dispatch_locality(cache, tr, plan, precision, a, b, exe=exe)
    return c


def _spamm_pruned_tasks(a: DistBSMatrix, b: DistBSMatrix, tau: float,
                        a_norms: np.ndarray, b_norms: np.ndarray):
    """Hierarchical SpAMM descent on the resident structures.

    ``a_norms`` / ``b_norms`` are stack-order per-block norms the caller
    already holds.  Returns ``(tasks, err_bound)``.
    """
    depth = max(
        quadtree_depth(-(-a.shape[0] // a.bs), -(-a.shape[1] // a.bs)),
        quadtree_depth(-(-b.shape[0] // b.bs), -(-b.shape[1] // b.bs)),
    )
    ia = build_quadtree_index(a.coords, a_norms, depth=depth)
    ib = ia if b is a else build_quadtree_index(b.coords, b_norms, depth=depth)
    tasks, err, _ = spamm_symbolic(ia, ib, tau)
    return tasks, err


def _empty_dist_result(a: DistBSMatrix, b: DistBSMatrix) -> DistBSMatrix:
    return DistBSMatrix(
        shape=(a.shape[0], b.shape[1]),
        bs=a.bs,
        coords=np.zeros((0, 2), dtype=np.int64),
        owner=np.zeros((0,), dtype=np.int32),
        slot=np.zeros((0,), dtype=np.int32),
        cap=1,
        store=torch.zeros((a.nparts, 1, a.bs, a.bs), dtype=a.dtype, device=a.device),
        mesh=a.mesh,
    )


def dist_spamm(
    a: DistBSMatrix,
    b: DistBSMatrix,
    tau: float,
    cache: PlanCache | None = None,
    *,
    exchange: str = "p2p",
    impl: str = "fused",
    method: str = "delta",
    precision: Precision | None = None,
    a_norms: np.ndarray | None = None,
    b_norms: np.ndarray | None = None,
    rebalance=None,
) -> tuple[DistBSMatrix, float]:
    """Sparse approximate multiply on resident operands: C ~= A @ B.

    The hierarchical SpAMM symbolic phase
    (:func:`repro_torch.core.spgemm.spamm_symbolic`) runs on the host
    against quadtree indexes carrying subtree norms — norms depend on
    current values, so it runs every call.  ``a_norms`` / ``b_norms``
    (stack-order per-block norms, as returned by
    :func:`resident_block_norms`) let callers share one norm fetch across
    operations.

    ``method="delta"`` applies the prune pattern as a task mask against the
    cached full-multiply plan (see the module docstring); ``"replan"``
    threads the pruned task list into a per-pattern plan.  ``impl`` as in
    :func:`dist_multiply` (default ``"fused"``).

    ``precision`` (fused impl only) selects the leaf engine's dtype policy;
    ``adaptive`` rounds the smallest-bound kept tasks to bf16 under a budget
    of ``precision.budget(tau)`` — the returned bound then includes the
    rounding spend, so ``||A@B - C||_F <= err_bound`` still holds.

    ``rebalance`` (a :class:`repro_torch.dist.balance.RebalancePolicy`)
    re-slots skewed operands before planning (:func:`_rebalance_operands`);
    the stack-order norm tables stay valid across the re-layout.

    Returns ``(C, err_bound)`` with ``||A@B - C||_F <= err_bound``.
    """
    _check_operands(a, b, impl)
    precision = _precision_of(precision, impl, exchange)
    if method not in ("delta", "replan"):
        raise ValueError(f"method={method!r} not in ('delta', 'replan')")
    if precision.mode == "adaptive" and method != "delta":
        raise ValueError("adaptive precision rides the delta plan (method='delta')")
    tr = tracer_of(cache)
    with tr.span("dist_spamm", cat="collective", nnzb_a=a.nnzb, nnzb_b=b.nnzb, tau=float(tau)):
        if rebalance is not None:
            a, b = _rebalance_operands(a, b, cache, rebalance)
        return _dist_spamm_impl(
            a, b, tau, cache, tr, exchange=exchange, impl=impl, method=method,
            precision=precision, a_norms=a_norms, b_norms=b_norms,
        )


def _delta_task_mask(plan, tasks, nb_blocks: int) -> np.ndarray:
    """Relay the kept (a, b) pairs onto the full plan's [P, t_cap] task slots:
    a task is uniquely (a_idx, b_idx) — the output block follows from the pair."""
    full = plan.tasks
    if full.num_tasks == 0:
        # no structural overlap: task_gidx pads with 0, which must not index
        return np.zeros(plan.task_gidx.shape, dtype=bool)
    keep_task = np.zeros(full.num_tasks, dtype=bool)
    if tasks.num_tasks:
        nb = np.int64(max(nb_blocks, 1))
        keep_task = np.isin(full.a_idx * nb + full.b_idx, tasks.a_idx * nb + tasks.b_idx)
    return keep_task[plan.task_gidx] & _valid_task_slots(plan)


def _dist_spamm_impl(a, b, tau, cache, tr, *, exchange, impl, method, precision, a_norms, b_norms):
    fused = _use_fused(impl, exchange)
    # norm fetches stay outside the symbolic timer
    if a_norms is None:
        a_norms = resident_block_norms(a, cache)
    if b_norms is None:
        b_norms = a_norms if b is a else resident_block_norms(b, cache)
    with timed_into(cache, "symbolic_s", tr, "spamm_descent", cat="symbolic", tau=float(tau)):
        tasks, err = _spamm_pruned_tasks(a, b, tau, a_norms, b_norms)

    if method == "delta":
        def build():
            # the delta plan IS the exact-multiply plan; reuse one already
            # cached for dist_multiply on this structure (only the
            # executable differs)
            exact = (cache.peek(multiply_plan_key(a, b, exchange=exchange, impl=impl,
                                                  precision=precision))
                     if cache is not None else None)
            plan = exact[0] if exact is not None else make_spgemm_plan(
                a.coords, b.coords, a.nparts, a.bs,
                exchange=exchange, a_owner=a.owner, b_owner=b.owner,
            )
            _check_caps(plan, a, b)
            if fused:
                exe = MaskedFusedSpgemmExecutable(plan, a.mesh, precision=precision)
            else:
                exe = MaskedSpgemmExecutable(plan, a.mesh, impl=_staged_impl(impl))
            return plan, exe

        with tr.span("plan_lookup", cat="plan"):
            key = spamm_delta_plan_key(a, b, exchange=exchange, impl=impl, precision=precision)
            if cache is None:
                plan, exe = build()
            else:
                plan, exe = cache.get_or_build(key, build)
                cache.last_plan_key = key
        with timed_into(cache, "symbolic_s", tr, "delta_mask", cat="symbolic"):
            task_on = _delta_task_mask(plan, tasks, b.nnzb)
        # adaptive mixed precision: spend the rounding budget on the kept
        # tasks with the smallest ||A_t||·||B_t|| bound (a pruned task
        # contributes no error and must not consume budget)
        task_low = None
        if precision.mode == "adaptive":
            full = plan.tasks
            keep_task_g = np.zeros(max(full.num_tasks, 1), dtype=bool)
            if full.num_tasks:
                keep_task_g[plan.task_gidx[task_on]] = True
            low_task, spent = low_precision_task_mask(
                a_norms, b_norms, full.a_idx, full.b_idx,
                precision.budget(tau), eligible=keep_task_g[: full.num_tasks],
            )
            task_low = _adaptive_low_table(plan, low_task)
            err = float(err) + spent
        # measured per-worker flop load: only unmasked tasks cost work
        masked_count = task_on.sum(axis=1).astype(np.int64)
        if cache is not None:
            cache.last_task_count = masked_count
        with tr.span("dispatch", cat="kernel", op="spamm-delta") as sp:
            if fused:
                c_store = tr.sync(exe(a.store, b.store, task_on, task_low, tracer=tr))
            else:
                c_store = tr.sync(exe(a.store, b.store, task_on, tracer=tr))
            if tr.annotates:
                _annotate_spgemm_dispatch(tr, sp, plan, masked_count, precision, exe)
        c = _result(a, b, plan, c_store)
        _note_dispatch_memory(cache, plan, precision, c)
        _note_dispatch_locality(cache, tr, plan, precision, a, b, task_on=task_on, exe=exe)
        return c, err

    if tasks.num_tasks == 0:
        if cache is not None:
            cache.last_plan_key = None  # no plan ran; nothing to peek
            cache.last_task_count = None
        return _empty_dist_result(a, b), err

    def build():
        plan = make_spgemm_plan(
            a.coords, b.coords, a.nparts, a.bs,
            exchange=exchange, tasks=tasks, a_owner=a.owner, b_owner=b.owner,
        )
        _check_caps(plan, a, b)
        if fused:
            exe = FusedSpgemmExecutable(plan, a.mesh, precision=precision)
        else:
            exe = SpgemmExecutable(plan, a.mesh, impl=_staged_impl(impl))
        return plan, exe

    with tr.span("plan_lookup", cat="plan"):
        key = _plan_key("spamm", a, b, exchange, impl, precision,
                        tasks.a_idx, tasks.b_idx, tasks.c_idx)
        if cache is None:
            plan, exe = build()
        else:
            plan, exe = cache.get_or_build(key, build)
            cache.last_plan_key = key
            cache.last_task_count = plan.task_count
    with tr.span("dispatch", cat="kernel", op="spamm-replan") as sp:
        c_store = tr.sync(exe(a.store, b.store, tracer=tr))
        if tr.annotates:
            _annotate_spgemm_dispatch(tr, sp, plan, plan.task_count, precision, exe)
    c = _result(a, b, plan, c_store)
    _note_dispatch_memory(cache, plan, precision, c)
    _note_dispatch_locality(cache, tr, plan, precision, a, b, exe=exe)
    return c, err
