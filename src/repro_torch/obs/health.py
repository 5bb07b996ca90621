"""Online health monitoring over per-iteration driver rows.

The CHT runtime observes its own behavior continuously and feeds the
observations back into scheduling; :class:`HealthMonitor` is that loop's
anomaly detector for the resident runtime of the port.  The iterative drivers feed
it the same :data:`~repro_torch.obs.timing.SHARED_ITER_KEYS` row they already
emit per iteration (plus the measured :class:`~repro_torch.dist.balance.WorkerLoad`
when load balancing is on), and it detects:

* **stragglers** — one worker's combined cost drifting past
  ``straggler_factor`` times the mesh median for ``straggler_patience``
  consecutive iterations (a persistently slow/overloaded worker, not a
  one-iteration blip);
* **plan-cache miss storms** — misses on ``miss_storm_window`` consecutive
  iterations after the warmup, i.e. the sparsity pattern never stabilizes
  and every iteration replans (the zero-miss steady state is the runtime's
  whole performance model);
* **exchange-byte blowups** — mean receive bytes jumping past
  ``exchange_blowup`` times the running median (fill-in explosion or a
  degenerate re-layout);
* **convergence stalls** — the driver's residual/idempotency making no
  progress for ``stall_window`` iterations (beyond the monitors' own
  divergence trips, which fire harder and dump a postmortem).

Alerts append to :attr:`HealthMonitor.alerts`, emit ``health_alert`` warn
events into the :class:`~repro_torch.obs.log.EventLog` and ``health_alert``
tracer instants (category ``"health"``), so they land in postmortems and
Chrome traces alike.

**Live policy refit** (closing the ROADMAP follow-on "apply the fitted
policy live"): every ``refit_every`` iterations :meth:`maybe_refit` runs
the wall-clock calibration already collected by the
:class:`~repro_torch.dist.balance.LoadMonitor` and, when the fit converged,
replaces ``LoadMonitor.policy`` mid-run — subsequent rebalance decisions
use measured cost coefficients instead of the defaults.  This is a
schedule-only change: re-layouts are bit-identical by construction, so
results with health monitoring on equal results with it off.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .log import log_of
from .tracer import tracer_of

__all__ = ["HealthPolicy", "HealthAlert", "HealthMonitor"]


def _median(values: list) -> float:
    """``np.median`` of a short list of floats, by ``sorted`` (the same value:
    the middle element, or the mean of the middle two as ``np.mean`` forms it)."""
    s = sorted(values)
    n = len(s)
    mid = s[n // 2]
    return float(mid) if n % 2 else float((s[n // 2 - 1] + mid) / 2.0)


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Detection thresholds; the defaults are deliberately conservative so
    alerts mean something."""

    straggler_factor: float = 1.5
    straggler_patience: int = 3
    miss_warmup: int = 3
    miss_storm_window: int = 3
    exchange_blowup: float = 4.0
    stall_window: int = 6
    refit_every: int = 8
    live_policy: bool = True


@dataclasses.dataclass(frozen=True)
class HealthAlert:
    kind: str
    iteration: int
    message: str
    data: dict = dataclasses.field(default_factory=dict)


class HealthMonitor:
    """Feed :meth:`observe` one driver row per iteration; read
    :attr:`alerts` / :meth:`summary` at run end."""

    def __init__(self, policy: HealthPolicy | None = None, *, cache=None):
        self.policy = policy if policy is not None else HealthPolicy()
        self.cache = cache
        self.alerts: list[HealthAlert] = []
        self.refits = 0
        self.iterations = 0
        self._straggler_streak: np.ndarray | None = None
        self._miss_streak = 0
        self._cost_policy = None  # cached cost-model coefficients
        self._recv_hist: list[float] = []
        self._best_resid = float("inf")
        self._stall = 0

    # -- emission ------------------------------------------------------------
    def _emit(self, kind: str, iteration: int, message: str,
              **data: Any) -> HealthAlert:
        alert = HealthAlert(kind=kind, iteration=int(iteration),
                            message=message, data=dict(data))
        self.alerts.append(alert)
        lg = log_of(self.cache)
        if lg.enabled:
            lg.warn("health_alert", kind=kind, iteration=int(iteration),
                    message=message, **data)
        tr = tracer_of(self.cache)
        if tr.enabled:
            tr.instant("health_alert", cat="health", kind=kind,
                       iteration=int(iteration), **data)
        return alert

    # -- detectors -----------------------------------------------------------
    def observe(self, row: dict, load=None) -> list[HealthAlert]:
        """Run every detector over one iteration row; returns new alerts."""
        p = self.policy
        self.iterations += 1
        it = int(row.get("iteration") or 0)
        new: list[HealthAlert] = []

        # stragglers: per-worker combined cost vs the mesh median
        if load is not None:
            if self._cost_policy is None:
                from ..dist.balance import RebalancePolicy

                self._cost_policy = RebalancePolicy()
            cost = np.asarray(load.combined(self._cost_policy), np.float64)
            if self._straggler_streak is None or (
                    self._straggler_streak.shape != cost.shape):
                self._straggler_streak = np.zeros(cost.shape, np.int64)
            med = _median(cost.tolist())
            if med > 0.0:
                over = cost > p.straggler_factor * med
                self._straggler_streak = np.where(
                    over, self._straggler_streak + 1, 0)
                tripped = np.nonzero(
                    self._straggler_streak >= p.straggler_patience)[0]
                for w in tripped:
                    new.append(self._emit(
                        "straggler", it,
                        f"worker {int(w)} cost {cost[w]:.0f} > "
                        f"{p.straggler_factor:g}x mesh median {med:.0f} for "
                        f"{p.straggler_patience} consecutive iterations",
                        worker=int(w), cost=float(cost[w]), median=med))
                    self._straggler_streak[w] = 0  # re-arm, don't spam

        # plan-cache miss storm: replanning every iteration past warmup
        if self.iterations > p.miss_warmup:
            if int(row.get("cache_misses") or 0) > 0:
                self._miss_streak += 1
                if self._miss_streak == p.miss_storm_window:
                    new.append(self._emit(
                        "miss_storm", it,
                        f"plan-cache misses on {self._miss_streak} "
                        "consecutive iterations past warmup — the sparsity "
                        "pattern is not stabilizing",
                        streak=self._miss_streak,
                        misses=int(row.get("cache_misses") or 0)))
            else:
                self._miss_streak = 0

        # exchange-byte blowup vs the running median (last 64 iterations,
        # so the scan stays O(1) per iteration on long runs)
        recv = float(row.get("recv_bytes_mean") or 0.0)
        if self._recv_hist:
            med = _median(self._recv_hist)
            if med > 0.0 and recv > p.exchange_blowup * med:
                new.append(self._emit(
                    "exchange_blowup", it,
                    f"mean recv bytes {recv:.3g} > {p.exchange_blowup:g}x "
                    f"running median {med:.3g}",
                    recv_bytes_mean=recv, median=med))
        self._recv_hist.append(recv)
        if len(self._recv_hist) > 64:
            del self._recv_hist[0]

        # convergence stall: the driver's own progress metric going flat
        resid = row.get("residual", row.get("idem"))
        if resid is not None:
            resid = float(resid)
            if resid < self._best_resid:
                self._best_resid = resid
                self._stall = 0
            else:
                self._stall += 1
                if self._stall == p.stall_window:
                    new.append(self._emit(
                        "convergence_stall", it,
                        f"no residual improvement for {self._stall} "
                        f"iterations (best {self._best_resid:.3e})",
                        stall=self._stall, best=self._best_resid,
                        residual=resid))
        return new

    # -- live policy feedback ------------------------------------------------
    def maybe_refit(self, lb) -> Any:
        """Feed the wall-clock-calibrated cost coefficients live into the
        :class:`~repro_torch.dist.balance.LoadMonitor` policy every
        ``refit_every`` iterations; returns the new policy when applied."""
        p = self.policy
        if lb is None or not p.live_policy or p.refit_every <= 0:
            return None
        if self.iterations == 0 or self.iterations % p.refit_every:
            return None
        fitted, report = lb.calibration()
        if not report.get("fitted"):
            return None
        if fitted == lb.policy:
            return None
        lb.policy = fitted
        self.refits += 1
        lg = log_of(self.cache)
        if lg.enabled:
            lg.info("policy_refit", iteration=self.iterations,
                    recv_cost=fitted.recv_cost, send_cost=fitted.send_cost,
                    block_cost=fitted.block_cost,
                    rms_resid_s=report.get("rms_resid_s"))
        tr = tracer_of(self.cache)
        if tr.enabled:
            tr.instant("policy_refit", cat="health",
                       iteration=self.iterations,
                       recv_cost=fitted.recv_cost,
                       send_cost=fitted.send_cost,
                       block_cost=fitted.block_cost)
        return fitted

    def summary(self) -> dict:
        """JSON-safe run summary for driver stats / BENCH files."""
        return dict(
            iterations=int(self.iterations),
            refits=int(self.refits),
            alerts=[dict(kind=a.kind, iteration=a.iteration,
                         message=a.message, **a.data) for a in self.alerts],
            alerts_by_kind={
                k: sum(1 for a in self.alerts if a.kind == k)
                for k in sorted({a.kind for a in self.alerts})},
        )
