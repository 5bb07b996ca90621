"""Structure-keyed host-side caches — the chunk-cache analogue on the host.

CHT workers cache the chunks tasks touch so iterative algorithms stop paying
for re-fetches once their access pattern stabilizes.  On the host side the
analogous repeated cost is the *symbolic phase*: quadtree descent, task-list
construction, truncation selection.  :class:`SymbolicCache` memoizes those
behind keys derived from :func:`repro_torch.core.quadtree.structure_fingerprint`
of the operand structures — every `sp2_purify` iteration after the sparsity
pattern stabilizes under truncation skips the symbolic phase entirely,
mirroring what :class:`repro_torch.dist.PlanCache` (a subclass) does for the
distributed plans and their executables.

Hit/miss counters are surfaced via :meth:`SymbolicCache.stats`.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Hashable

from ..analysis.errors import PlanError
from ..obs.log import NULL_LOG
from ..obs.timing import timed_into
from ..obs.tracer import NULL_TRACER, profiler_recording, profiler_tracer

__all__ = ["SymbolicCache"]


class SymbolicCache:
    """LRU cache from structure keys to built symbolic results.

    Keys are hashable tuples (callers prefix them with a kind tag such as
    ``"spgemm"`` / ``"add"`` / ``"trace"``).  Values are whatever the builder
    returns — a :class:`~repro_torch.core.spgemm.Tasks` list on the
    single-device path, a (plan, executable) pair on the distributed path.
    """

    #: verification policies: "off" never verifies; "cached-once" verifies
    #: each value once at admission (miss path) so the zero-miss steady
    #: state pays nothing; "always" re-verifies on every hit as well
    VERIFY_POLICIES = ("off", "cached-once", "always")

    def __init__(self, max_entries: int = 128, tracer=None,
                 verify: str = "cached-once", event_log=None):
        if verify not in self.VERIFY_POLICIES:
            raise ValueError(
                f"verify={verify!r} not in {self.VERIFY_POLICIES}")
        self.max_entries = max_entries
        self.tracer = tracer
        self.event_log = event_log
        self.verify = verify
        # optional observatory riders (repro_torch.obs): a FlightRecorder
        # dumps a postmortem when plan admission raises PlanError or a
        # driver's divergence trip fires; a MemoryMeter accounts per-worker
        # device bytes at the dispatch sites; a LocalityLedger splits each
        # dispatch's operand reads into locally-owned and shipped bytes.  All
        # default off and are read back with getattr, so paths without them
        # pay nothing.
        self.flight_recorder = None
        self.memory_meter = None
        self.locality_ledger = None
        self._entries: collections.OrderedDict[Hashable, Any] = (
            collections.OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        # key of the plan the most recent resident multiply ran, and its
        # per-worker executed task counts (set by repro_torch.dist.multiply)
        self.last_plan_key: Hashable | None = None
        self.last_task_count = None
        self._by_kind: collections.Counter = collections.Counter()
        # accumulated seconds spent in cache-miss builders (the symbolic
        # phase) and in per-call symbolic work that runs outside the cache
        self.build_s = 0.0
        self.symbolic_s = 0.0
        # static-verification accounting: values verified, violations
        # raised, seconds spent
        self.plans_verified = 0
        self.verify_violations = 0
        self.verify_s = 0.0

    # the tracer rides on the cache; assigning None disables tracing, and a
    # cache with none of its own hands out the profiler tracer while a
    # torch.profiler session records (repro_torch.obs.tracer)
    @property
    def tracer(self):
        tr = self._tracer
        if tr is NULL_TRACER and profiler_recording():
            return profiler_tracer()
        return tr

    @tracer.setter
    def tracer(self, tracer) -> None:
        self._tracer = tracer if tracer is not None else NULL_TRACER

    # the structured event log rides on the cache the same way
    @property
    def event_log(self):
        return self._event_log

    @event_log.setter
    def event_log(self, log) -> None:
        self._event_log = log if log is not None else NULL_LOG

    def get_or_build(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        kind = key[0] if isinstance(key, tuple) else "?"
        tr = self.tracer
        if key in self._entries:
            self.hits += 1
            self._by_kind[(kind, "hit")] += 1
            if tr.enabled:
                tr.counter("plan_hits").add()
            self._entries.move_to_end(key)
            value = self._entries[key]
            if self.verify == "always":
                self._verify_value(key, value)
            return value
        self.misses += 1
        self._by_kind[(kind, "miss")] += 1
        if tr.enabled:
            tr.counter("plan_misses").add()
        with timed_into(self, "build_s", tr, "plan_build", cat="plan",
                        kind=str(kind)) as tm:
            value = builder()
        lg = self._event_log
        if lg.debug_enabled:
            lg.debug("plan_build", kind=str(kind), build_s=tm.elapsed,
                     misses=self.misses)
        if self.verify != "off":
            self._verify_value(key, value)  # raises before a bad plan lands
        self._entries[key] = value
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return value

    def _verify_value(self, key: Hashable, value: Any) -> None:
        """Static-verification hook at cache admission (repro_torch.analysis).

        Unverifiable values (symbolic task lists, reductions) pass through;
        plans and the add / compact / relayout / norm-table executables are
        re-proved, and a non-empty violation report raises
        :class:`PlanError` — surfaced through the tracer as
        ``plan_verify_violation`` instants plus ``plans_verified`` /
        ``verify_violations`` counters, through the event log as a
        ``plan_error`` record, and through the flight recorder as a
        postmortem.
        """
        from ..analysis.verify import verify_value

        tr = self.tracer
        kind = key[0] if isinstance(key, tuple) else "?"
        with timed_into(self, "verify_s", tr, "plan_verify", cat="analysis",
                        kind=str(kind)):
            report = verify_value(key, value)
        if report is None:
            return
        self.plans_verified += 1
        if tr.enabled:
            tr.counter("plans_verified").add()
        if report:
            self.verify_violations += len(report)
            if tr.enabled:
                tr.counter("verify_violations").add(len(report))
                for viol in report[:32]:
                    tr.instant("plan_verify_violation", cat="analysis",
                               check=viol.check, message=viol.message,
                               **viol.provenance)
            message = (
                f"{kind} plan failed static verification with "
                f"{len(report)} violation(s); first: [{report[0].check}] "
                f"{report[0].message}")
            lg = self._event_log
            if lg.enabled:
                lg.error("plan_error", kind=str(kind), message=message,
                         violations=len(report), check=report[0].check)
            rec = self.flight_recorder
            if rec is not None:
                rec.dump("plan_error", self, kind=str(kind), message=message,
                         violations=[dict(check=v.check, message=v.message,
                                          **v.provenance)
                                     for v in report[:16]])
            raise PlanError(message, report)

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Read an entry without touching counters or LRU order."""
        return self._entries.get(key, default)

    def snapshot(self) -> tuple:
        """Counter snapshot for per-stage/per-iteration deltas (see delta)."""
        return (self.hits, self.misses, self.build_s, self.symbolic_s)

    def delta(self, snap: tuple) -> dict:
        """Counters accumulated since ``snap``."""
        h, m, b, s = snap
        return dict(
            cache_hits=self.hits - h,
            cache_misses=self.misses - m,
            plan_build_s=self.build_s - b,
            symbolic_s=self.symbolic_s - s,
        )

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> dict:
        """plan_stats-style cache metrics."""
        total = self.hits + self.misses
        return dict(
            entries=len(self._entries),
            hits=self.hits,
            misses=self.misses,
            hit_rate=self.hits / total if total else 0.0,
            build_s=self.build_s,
            symbolic_s=self.symbolic_s,
            verify=self.verify,
            verify_s=self.verify_s,
            plans_verified=self.plans_verified,
            verify_violations=self.verify_violations,
            by_kind={f"{k}/{o}": v for (k, o), v in sorted(self._by_kind.items())},
        )
