"""Executed-task-graph analytics: critical path, slack, what-if projections.

The tracer's span timeline says how long a run took; this module says how
long it *had to* take.  From a :class:`~repro_torch.core.schedule.SpgemmPlan`'s
index arrays (exchange round -> task -> output-slot accumulation chain) it
reconstructs the dependency structure the resident program actually executes —
each planned exchange round is a barrier, then every worker runs its
task list — and computes:

* the **critical path**: the sum over rounds of the most-loaded worker's
  round cost, plus the most-loaded worker's compute — a lower bound on the
  step's wall time under the executed schedule;
* per-worker **busy time** and **slack** (critical path minus busy time;
  non-negative by construction since the critical path takes the per-round
  and compute maxima);
* **what-if projections**: predicted critical path under perfect flop
  balance, under zero exchange, and under the measured rebalanced cut
  (:func:`whatif_rebalanced` re-plans with the weights the dynamic load
  balancer would use and analyzes the resulting plan) — validating
  :class:`~repro_torch.dist.balance.RebalancePolicy` gains analytically before
  paying a migration.

Costs are expressed in **task-equivalent units** using the same per-block
coefficients as the load balancer's cost model
(:meth:`~repro_torch.dist.balance.WorkerLoad.combined`): one unit is one leaf
task's flops, a received or sent block costs ``recv_cost`` / ``send_cost``
units.  :func:`project_seconds` converts units to seconds by calibrating
against a measured wall time.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from .locality import plan_provenance

if typing.TYPE_CHECKING:  # core.cache imports obs.log: keep obs<->core lazy
    from ..core.schedule import SpgemmPlan

__all__ = [
    "TaskGraphAnalysis",
    "analyze_plan",
    "whatif_rebalanced",
    "project_seconds",
]


@dataclasses.dataclass(frozen=True)
class TaskGraphAnalysis:
    """Critical-path decomposition of one executed plan, in task units."""

    nparts: int
    compute: np.ndarray  # [P] task-equivalent compute per worker
    exchange: np.ndarray  # [P] summed per-round exchange cost per worker
    busy: np.ndarray  # [P] = exchange + compute
    slack: np.ndarray  # [P] = critical_path - busy  (>= 0)
    critical_path: float  # cp_exchange + cp_compute
    cp_exchange: float  # sum over rounds of the per-round maximum
    cp_compute: float  # max over workers of compute
    rounds: list  # per-round detail records (operand, offset, max_cost, cap)
    whatif_perfect_balance: float  # cp_exchange + mean compute
    whatif_zero_exchange: float  # compute-only critical path

    def as_dict(self) -> dict:
        """JSON-safe record (benchmarks, reports)."""
        return dict(
            nparts=self.nparts,
            units="task-equivalents",
            critical_path=float(self.critical_path),
            cp_exchange=float(self.cp_exchange),
            cp_compute=float(self.cp_compute),
            compute=self.compute.tolist(),
            exchange=self.exchange.tolist(),
            busy=self.busy.tolist(),
            slack=self.slack.tolist(),
            rounds=[dict(r) for r in self.rounds],
            whatif_perfect_balance=float(self.whatif_perfect_balance),
            whatif_zero_exchange=float(self.whatif_zero_exchange),
        )


def analyze_plan(plan: SpgemmPlan, *, task_count: np.ndarray | None = None,
                 policy=None) -> TaskGraphAnalysis:
    """Analyze the executed dependency DAG of one plan.

    ``task_count`` overrides the plan's static per-worker task counts with
    measured ones (delta-plan SpAMM masks tasks at runtime — pass
    ``cache.last_task_count``); ``policy`` supplies the byte-cost
    coefficients and defaults to :class:`~repro_torch.dist.balance.RebalancePolicy`.
    """
    from ..dist.balance import RebalancePolicy  # lazy: avoids obs<->dist cycle

    policy = policy if policy is not None else RebalancePolicy()
    P = plan.nparts
    prov = plan_provenance(plan)
    compute = np.asarray(
        plan.task_count if task_count is None else task_count,
        dtype=np.float64)
    if compute.shape != (P,):
        raise ValueError(
            f"task_count shape {compute.shape} does not match nparts={P}")

    exchange = np.zeros(P, dtype=np.float64)
    cp_exchange = 0.0
    round_detail = []
    for rec in prov["rounds"]:
        recv = np.asarray(rec["recv_blocks"], dtype=np.float64)
        send = np.asarray(rec["send_blocks"], dtype=np.float64)
        cost = policy.recv_cost * recv + policy.send_cost * send
        exchange += cost
        cp_exchange += float(cost.max()) if cost.size else 0.0
        round_detail.append(dict(
            operand=rec["operand"], offset=rec["offset"], cap=rec["cap"],
            max_cost=float(cost.max()) if cost.size else 0.0,
        ))
    cp_compute = float(compute.max()) if compute.size else 0.0
    busy = exchange + compute
    critical_path = cp_exchange + cp_compute
    slack = critical_path - busy
    return TaskGraphAnalysis(
        nparts=P,
        compute=compute,
        exchange=exchange,
        busy=busy,
        slack=slack,
        critical_path=critical_path,
        cp_exchange=cp_exchange,
        cp_compute=cp_compute,
        rounds=round_detail,
        whatif_perfect_balance=cp_exchange + float(compute.mean()),
        whatif_zero_exchange=cp_compute,
    )


def whatif_rebalanced(plan: SpgemmPlan, a_coords: np.ndarray,
                      b_coords: np.ndarray | None = None, *,
                      policy=None) -> dict:
    """Project the critical path under the measured rebalanced cut.

    Re-plans the same task list with the owner map the dynamic load
    balancer would migrate to (reference-count weights over the executed
    tasks, exactly :meth:`~repro_torch.dist.balance.LoadMonitor.migrate`'s
    weighting) and analyzes the re-plan — the analytic preview of a
    migration's gain, before paying its bytes.  ``b_coords`` defaults to
    ``a_coords`` (the X·X case, where one migration moves both operands).

    Returns ``{"before", "after"}`` analyses plus ``predicted_gain``
    (before/after critical-path ratio) and the proposed owner map.
    """
    from ..core.schedule import make_spgemm_plan
    from ..dist.balance import (RebalancePolicy, block_reference_weights,
                                rebalanced_owner)

    policy = policy if policy is not None else RebalancePolicy()
    same = b_coords is None or b_coords is a_coords
    b_coords = a_coords if b_coords is None else b_coords
    na, nb = a_coords.shape[0], b_coords.shape[0]
    wa, wb = block_reference_weights(plan.tasks, na, nb)
    if same:
        owner = rebalanced_owner(a_coords, wa + wb + 1.0, plan.nparts, policy)
        a_owner = b_owner = owner
    else:
        a_owner = rebalanced_owner(a_coords, wa + 1.0, plan.nparts, policy)
        b_owner = rebalanced_owner(b_coords, wb + 1.0, plan.nparts, policy)
    replanned = make_spgemm_plan(
        a_coords, b_coords, plan.nparts, plan.bs,
        exchange=plan.exchange, tasks=plan.tasks,
        a_owner=a_owner, b_owner=b_owner,
    )
    before = analyze_plan(plan, policy=policy)
    after = analyze_plan(replanned, policy=policy)
    gain = (before.critical_path / after.critical_path
            if after.critical_path > 0 else 1.0)
    return dict(
        before=before,
        after=after,
        predicted_gain=float(gain),
        a_owner=a_owner,
        b_owner=b_owner,
        plan=replanned,
    )


def project_seconds(analysis: TaskGraphAnalysis,
                    measured_wall_s: float) -> dict:
    """Convert a unit-space analysis into seconds against a measured wall.

    One measured step wall time calibrates seconds-per-unit on the critical
    path; the what-if projections then read directly in seconds.
    """
    cp = analysis.critical_path
    spu = measured_wall_s / cp if cp > 0 else 0.0
    return dict(
        measured_s=float(measured_wall_s),
        seconds_per_unit=float(spu),
        critical_path_s=float(cp * spu),
        perfect_balance_s=float(analysis.whatif_perfect_balance * spu),
        zero_exchange_s=float(analysis.whatif_zero_exchange * spu),
    )
