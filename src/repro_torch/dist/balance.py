"""Dynamic load balancing for the device-resident runtime.

The paper's CHT-MPI runtime "succeeds to dynamically load balance the
calculation regardless of the sparsity structure" via decentralized work
stealing.  A planned resident step cannot steal work mid-step, so the equivalent
feedback loop runs between steps, on the host, from quantities the runtime
already materializes:

* **Measured cost model** (:func:`worker_load` / :class:`WorkerLoad`): per
  worker, the multiply tasks it actually executed (the delta-plan SpAMM mask
  is honoured — masked-off tasks cost nothing), the flops they imply, the
  true operand bytes it received *and shipped* during the planned
  exchange rounds (:func:`repro_torch.core.schedule.plan_worker_bytes`), and
  the resident leaf blocks it owns, optionally weighted by the norm table so
  structurally-present-but-zero leaves count for nothing.
* **Policy** (:class:`RebalancePolicy` / :class:`LoadMonitor`): the combined
  per-worker cost (tasks + comm + ownership, in task-equivalent units) is
  summarized as ``imbalance = max / mean``; when it exceeds the threshold,
  a new owner map is proposed — a weighted, subtree-aligned
  :func:`repro_torch.core.schedule.partition_morton` cut over per-block weights
  measured from the executed task list — and adopted only when it improves
  the predicted imbalance by ``min_gain`` (so a stabilized layout is never
  churned and the plan cache stays all-hit).
* **Re-layout** (:func:`repro_torch.dist.collectives.dist_repartition`): blocks
  migrate to the new owners entirely on the device via planned exchange
  rounds; values, coordinates and Morton stack order are untouched, so the
  algorithm cannot observe the move — only the schedule can.

The iterative drivers (``dist_sp2_purify``, the inverse refinement loop, and
``dist_sqrt_inv_pipeline``) accept ``rebalance=RebalancePolicy(...)`` and run
this loop between iterations, reporting per-iteration imbalance and migrated
bytes in their stats rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.quadtree import morton_encode
from ..core.schedule import (
    SpgemmPlan,
    partition_morton,
    plan_worker_bytes,
    subtree_boundaries,
)
from ..core.spgemm import Tasks
from ..obs.log import log_of
from .collectives import RepartitionExecutable, dist_repartition  # noqa: F401
from .matrix import DistBSMatrix

__all__ = [
    "RebalancePolicy",
    "WorkerLoad",
    "LoadMonitor",
    "worker_load",
    "calibrate_policy",
    "measure_iteration_load",
    "peek_last_plan",
    "block_reference_weights",
    "map_block_weights",
    "owner_imbalance",
    "rebalanced_owner",
    "dist_repartition",
    "RepartitionExecutable",
]


@dataclasses.dataclass(frozen=True)
class RebalancePolicy:
    """Knobs of the rebalancing feedback loop.

    Cost coefficients express everything in task-equivalent units (one unit =
    one leaf multiply task, 2*bs^3 flops): moving one operand block over the
    interconnect is charged ``recv_cost`` (receiver) + ``send_cost``
    (shipper) tasks, and owning one resident leaf block — its share of norm
    reductions, additions, truncation compactions and store memory — is
    charged ``block_cost`` tasks.  ``threshold`` is the combined max/mean
    imbalance above which a re-layout is considered; ``min_gain`` is the
    predicted-improvement factor a proposed owner map must deliver before it
    is adopted (the hysteresis that keeps a stabilized layout, and therefore
    the plan cache, untouched).  ``align_subtrees`` / ``slack`` are forwarded
    to :func:`repro_torch.core.schedule.partition_morton` so the new cuts keep
    snapping to quadtree node boundaries.
    """

    threshold: float = 1.25
    min_gain: float = 1.1
    recv_cost: float = 0.5
    send_cost: float = 0.5
    block_cost: float = 0.25
    align_subtrees: bool = True
    slack: float = 0.15

    def __post_init__(self):
        if self.threshold < 1.0 or self.min_gain < 1.0:
            raise ValueError(f"threshold {self.threshold} and min_gain {self.min_gain} "
                             "must be >= 1")


@dataclasses.dataclass(frozen=True)
class WorkerLoad:
    """Measured per-worker cost of one executed distributed multiply.

    All arrays are ``[nparts]``.  ``tasks`` counts the leaf multiply tasks
    the worker actually ran (under delta-plan SpAMM: after the runtime task
    mask); ``recv_bytes`` / ``send_bytes`` are the true (unpadded) operand
    bytes of the planned exchange rounds; ``blocks`` is the (optionally
    norm-weighted) count of resident operand leaves the worker owns.

    ``wall_s``, when set (the drivers thread the measured iteration span
    duration in via :meth:`LoadMonitor.note_wall`), is the wall-clock
    seconds of the step this load was measured from — the feedback signal
    :func:`calibrate_policy` fits the policy's cost coefficients against.
    """

    nparts: int
    bs: int
    tasks: np.ndarray
    recv_bytes: np.ndarray
    send_bytes: np.ndarray
    blocks: np.ndarray
    wall_s: float | None = None

    def flops(self) -> np.ndarray:
        return 2.0 * self.tasks * float(self.bs) ** 3

    def __add__(self, other: "WorkerLoad") -> "WorkerLoad":
        """Accumulate loads of several multiplies (one driver iteration)."""
        assert self.nparts == other.nparts and self.bs == other.bs
        wall = (
            None
            if self.wall_s is None and other.wall_s is None
            else (self.wall_s or 0.0) + (other.wall_s or 0.0)
        )
        return WorkerLoad(
            nparts=self.nparts,
            bs=self.bs,
            tasks=self.tasks + other.tasks,
            recv_bytes=self.recv_bytes + other.recv_bytes,
            send_bytes=self.send_bytes + other.send_bytes,
            blocks=self.blocks + other.blocks,
            wall_s=wall,
        )

    def combined(self, policy: RebalancePolicy) -> np.ndarray:
        """Per-worker cost in task-equivalent units under the policy."""
        blk = float(self.bs * self.bs * 4)
        return (
            self.tasks
            + policy.recv_cost * self.recv_bytes / blk
            + policy.send_cost * self.send_bytes / blk
            + policy.block_cost * self.blocks
        )

    def imbalance(self, policy: RebalancePolicy | None = None) -> float:
        """max/mean of the combined per-worker cost (1.0 = perfect balance)."""
        c = self.combined(policy if policy is not None else RebalancePolicy())
        mean = c.mean()
        return float(c.max() / mean) if mean > 0 else 1.0


def worker_load(
    plan: SpgemmPlan,
    *,
    task_count: np.ndarray | None = None,
    a_weights: np.ndarray | None = None,
    b_weights: np.ndarray | None = None,
) -> WorkerLoad:
    """Measured :class:`WorkerLoad` of one executed multiply plan.

    ``task_count`` overrides the plan's static per-worker task counts with
    what actually ran (the drivers pass the delta-plan SpAMM masked counts
    surfaced on ``cache.last_task_count``).  ``a_weights`` / ``b_weights``
    are per-block ownership weights in operand stack order — the drivers
    pass ``norms != 0`` from the resident norm table so numerically-zero
    leaves cost nothing (leaf-nnz weighting); default is one per block.
    """
    P = plan.nparts
    tasks = np.asarray(
        plan.task_count if task_count is None else task_count, dtype=np.float64
    )
    assert tasks.shape == (P,)
    recv, send, _ = plan_worker_bytes(plan)
    wa = np.ones(plan.a_owner.shape[0]) if a_weights is None else np.asarray(
        a_weights, dtype=np.float64
    )
    wb = np.ones(plan.b_owner.shape[0]) if b_weights is None else np.asarray(
        b_weights, dtype=np.float64
    )
    blocks = np.bincount(plan.a_owner, weights=wa, minlength=P) + np.bincount(
        plan.b_owner, weights=wb, minlength=P
    )
    return WorkerLoad(
        nparts=P,
        bs=plan.bs,
        tasks=tasks,
        recv_bytes=recv,
        send_bytes=send,
        blocks=blocks.astype(np.float64),
    )


def calibrate_policy(
    loads: list[WorkerLoad], base: RebalancePolicy | None = None
) -> tuple[RebalancePolicy, dict]:
    """Fit the policy's cost coefficients from measured wall-clock feedback.

    A resident step's wall time is set by its slowest worker, so each observed
    load with a :attr:`WorkerLoad.wall_s` contributes one sample of

        wall  ~=  k_t * max(tasks) + k_r * max(recv)/blk
                + k_s * max(send)/blk + k_b * max(blocks)

    solved by least squares (coefficients clipped at zero).  ``k_t`` is the
    seconds-per-task unit; the returned policy carries the measured ratios
    ``recv_cost = k_r / k_t`` etc. in the usual task-equivalent units —
    closing the loop the static defaults (0.5 / 0.5 / 0.25) only guessed at.
    Falls back to ``base`` unchanged (``fitted=False`` in the report) when
    there are fewer samples than coefficients or the fit degenerates.
    """
    base = base if base is not None else RebalancePolicy()
    samples = [ld for ld in loads if ld.wall_s is not None and ld.wall_s > 0]
    report = dict(
        samples=len(samples),
        fitted=False,
        task_s=None,
        recv_cost=base.recv_cost,
        send_cost=base.send_cost,
        block_cost=base.block_cost,
        rms_resid_s=None,
    )
    if len(samples) < 4:
        return base, report
    blk = float(samples[0].bs * samples[0].bs * 4)
    X = np.array(
        [
            [
                ld.tasks.max(),
                ld.recv_bytes.max() / blk,
                ld.send_bytes.max() / blk,
                ld.blocks.max(),
            ]
            for ld in samples
        ],
        dtype=np.float64,
    )
    y = np.array([ld.wall_s for ld in samples], dtype=np.float64)
    k, *_ = np.linalg.lstsq(X, y, rcond=None)
    k = np.clip(k, 0.0, None)
    if k[0] <= 0.0:
        return base, report
    policy = dataclasses.replace(
        base,
        recv_cost=float(k[1] / k[0]),
        send_cost=float(k[2] / k[0]),
        block_cost=float(k[3] / k[0]),
    )
    report.update(
        fitted=True,
        task_s=float(k[0]),
        recv_cost=policy.recv_cost,
        send_cost=policy.send_cost,
        block_cost=policy.block_cost,
        rms_resid_s=float(np.sqrt(np.mean((X @ k - y) ** 2))),
    )
    return policy, report


def peek_last_plan(cache) -> SpgemmPlan | None:
    """The plan behind the most recent multiply-family call, or None.

    Reads ``cache.last_plan_key`` without touching hit/miss counters or LRU
    order — the drivers call this right after each multiply to measure the
    plan that actually executed (exact, SpAMM-replan or SpAMM-delta alike).
    """
    if cache is None or cache.last_plan_key is None:
        return None
    entry = cache.peek(cache.last_plan_key)
    plan = entry[0] if entry is not None else None
    assert plan is None or isinstance(plan, SpgemmPlan)
    return plan


def measure_iteration_load(
    cache,
    plan: SpgemmPlan | None,
    a_leaf_weights: np.ndarray | None = None,
    b_leaf_weights: np.ndarray | None = None,
) -> WorkerLoad | None:
    """Measured :class:`WorkerLoad` of the multiply a driver just executed.

    ``plan`` is the peeked plan behind ``cache.last_plan_key``;
    ``cache.last_task_count`` carries the per-worker tasks that actually ran
    (delta-plan SpAMM masks tasks at runtime, so the plan's static counts
    overstate the work).  The leaf-weight vectors are the operands'
    stack-order leaf-nnz weights (``norms != 0``) when the driver holds a
    norm table; each is ignored when its length no longer matches the
    operand the plan was built for.  Returns ``None`` when no plan ran this
    iteration.
    """
    if plan is None:
        return None
    tcount = getattr(cache, "last_task_count", None)
    if tcount is None or len(tcount) != plan.nparts:
        tcount = plan.task_count
    wa, wb = a_leaf_weights, b_leaf_weights
    if wa is not None and wa.shape[0] != plan.a_owner.shape[0]:
        wa = None  # structure drifted from the table the caller holds
    if wb is not None and wb.shape[0] != plan.b_owner.shape[0]:
        wb = None
    return worker_load(plan, task_count=tcount, a_weights=wa, b_weights=wb)


def block_reference_weights(
    tasks: Tasks, na: int, nb: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-block task-reference counts (wa [na], wb [nb]) of a task list.

    ``wa[i]`` counts the multiply tasks reading A block ``i`` — the measured
    per-block flop weight the re-layout cut optimizes.  Structural (derived
    from the full task list, not the per-call prune mask), so the proposed
    owner map is deterministic per structure and the plan cache converges.
    """
    wa = np.bincount(tasks.a_idx, minlength=na).astype(np.float64)
    wb = np.bincount(tasks.b_idx, minlength=nb).astype(np.float64)
    return wa, wb


def map_block_weights(
    src_coords: np.ndarray,
    src_weights: np.ndarray,
    dst_coords: np.ndarray,
    default: float = 1.0,
) -> np.ndarray:
    """Carry per-block weights from one structure to another by coordinates.

    The cost model measures weights on the structure that was multiplied; by
    re-layout time the iterate has been updated (squaring fill-in,
    truncation), so weights are joined on Morton codes: blocks present in
    both keep their measured weight, new blocks get ``default``.
    """
    dst = np.asarray(dst_coords)
    if dst.shape[0] == 0:
        return np.zeros((0,), dtype=np.float64)
    out = np.full(dst.shape[0], float(default), dtype=np.float64)
    src = np.asarray(src_coords)
    if src.shape[0] == 0:
        return out
    src_codes = morton_encode(src[:, 0], src[:, 1])
    dst_codes = morton_encode(dst[:, 0], dst[:, 1])
    pos = np.searchsorted(src_codes, dst_codes)
    pos_c = np.minimum(pos, src_codes.size - 1)
    hit = src_codes[pos_c] == dst_codes
    out[hit] = np.asarray(src_weights, dtype=np.float64)[pos_c[hit]]
    return out


def owner_imbalance(
    owner: np.ndarray, weights: np.ndarray, nparts: int
) -> float:
    """max/mean weighted load of an owner map (1.0 = perfect balance)."""
    loads = np.bincount(
        np.asarray(owner, dtype=np.int64),
        weights=np.asarray(weights, dtype=np.float64),
        minlength=nparts,
    )
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


def rebalanced_owner(
    coords: np.ndarray,
    weights: np.ndarray,
    nparts: int,
    policy: RebalancePolicy | None = None,
) -> np.ndarray:
    """Weighted, subtree-aligned Morton re-partition for a block structure.

    The proposal side of the feedback loop: the same
    :func:`repro_torch.core.schedule.partition_morton` cut the static scheduler
    uses, but over *measured* per-block weights — contiguous Morton ranges
    (locality preserved), cuts snapped to quadtree node boundaries within the
    policy's balance slack.
    """
    policy = policy if policy is not None else RebalancePolicy()
    coords = np.asarray(coords)
    align = subtree_boundaries(coords) if policy.align_subtrees else None
    return partition_morton(
        coords.shape[0], nparts, weights, align=align, slack=policy.slack
    )


class LoadMonitor:
    """Tracks measured worker loads and decides when a re-layout pays.

    ``observe`` records a :class:`WorkerLoad` and returns its combined
    imbalance; ``should_rebalance`` applies the policy threshold;
    ``propose`` turns measured per-block weights into a candidate owner map
    and vets it — identical maps and maps that do not improve the predicted
    weighted imbalance by ``min_gain`` are rejected (returning ``None``), so
    once the layout has converged the monitor goes quiet and every
    downstream plan stays cached.
    """

    def __init__(self, nparts: int, policy: RebalancePolicy | None = None):
        self.nparts = int(nparts)
        self.policy = policy if policy is not None else RebalancePolicy()
        self.loads: list[WorkerLoad] = []
        self.rebalances = 0

    def observe(self, load: WorkerLoad) -> float:
        self.loads.append(load)
        return load.imbalance(self.policy)

    def note_wall(self, wall_s: float) -> None:
        """Attach a measured step wall time to the latest observed load.

        The drivers call this with the iteration span's duration right after
        :meth:`observe` — the wall-clock feedback :func:`calibrate_policy`
        fits the policy coefficients against.
        """
        if self.loads and wall_s > 0:
            self.loads[-1] = dataclasses.replace(
                self.loads[-1], wall_s=float(wall_s)
            )

    def calibration(self) -> tuple[RebalancePolicy, dict]:
        """Wall-clock-calibrated policy + fit report from the observed loads."""
        return calibrate_policy(self.loads, self.policy)

    def should_rebalance(self, load: WorkerLoad) -> bool:
        return load.imbalance(self.policy) > self.policy.threshold

    def propose(
        self, x: DistBSMatrix, weights: np.ndarray
    ) -> np.ndarray | None:
        """Candidate owner map for ``x`` under measured block weights, or
        ``None`` when a re-layout would not pay."""
        if x.nnzb == 0:
            return None
        new_owner = rebalanced_owner(x.coords, weights, self.nparts, self.policy)
        if np.array_equal(new_owner, x.owner):
            return None
        before = owner_imbalance(x.owner, weights, self.nparts)
        after = owner_imbalance(new_owner, weights, self.nparts)
        if before < after * self.policy.min_gain:
            return None
        return new_owner

    def migrate(
        self, x: DistBSMatrix, weights: np.ndarray, cache=None
    ) -> tuple[DistBSMatrix, int, float | None]:
        """Propose-and-apply a re-layout of ``x`` under measured weights.

        The shared tail of every driver's rebalance step: vet a candidate
        owner map (:meth:`propose`), re-slot on device when it pays, and
        account the move.  Returns ``(x, migrated_bytes,
        predicted_imbalance_after)`` — the last two are ``0`` / ``None``
        when no re-layout happened.
        """
        new_owner = self.propose(x, weights)
        if new_owner is None:
            return x, 0, None
        before = owner_imbalance(x.owner, weights, self.nparts)
        info: dict = {}
        x = dist_repartition(x, new_owner, cache, stats=info)
        self.rebalances += 1
        after = owner_imbalance(new_owner, weights, self.nparts)
        lg = log_of(cache)
        if lg.enabled:
            lg.info(
                "rebalance", migrated_bytes=int(info["migrated_bytes"]),
                imbalance=float(before), imbalance_after=float(after),
                rebalances=self.rebalances, nnzb=int(x.nnzb),
            )
        return x, info["migrated_bytes"], after

    def relayout_if_skewed(
        self, x: DistBSMatrix, cache=None, weights: np.ndarray | None = None
    ) -> tuple[DistBSMatrix, int]:
        """Up-front re-layout of a skewed matrix; returns (x, migrated bytes).

        The entry-point fix for layouts the iteration itself never revisits —
        a skewed initial iterate, or a pinned operand (the SPD matrix of the
        inverse refinement) whose placement would otherwise stay skewed for
        every remaining multiply.  Block-ownership weights only (``weights``
        defaults to one per block); gated by the policy threshold and
        ``propose``'s gain vetting like every other re-layout.
        """
        if x.nnzb == 0:
            return x, 0
        w = np.ones(x.nnzb, dtype=np.float64) if weights is None else weights
        if owner_imbalance(x.owner, w, self.nparts) <= self.policy.threshold:
            return x, 0
        x, migrated, _ = self.migrate(x, w, cache)
        return x, migrated
