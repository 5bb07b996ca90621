"""Span-based tracer + metrics registry for the resident runtime.

The CHT-MPI paper demonstrates its load-balancing claims with per-process
execution timelines and work/communication statistics gathered by the
runtime itself; the original Chunks-and-Tasks programming-model paper makes
task/chunk accounting a first-class runtime service.  This module is that
service for the resident runtime of the port, whose P workers share one
card:

* :class:`Tracer` records **nested spans** (phase -> iteration -> collective
  -> kernel dispatch / plan build / symbolic descent / rebalance migration)
  on one host timeline, each with a wall-clock interval, a category, free
  args, and — on leaf dispatch spans — a **per-worker cost attribution**
  vector (:attr:`Span.worker_costs`).  All workers of a mesh run in one
  kernel launch, so no span can time a worker apart: the attribution is
  the load balancer's cost model evaluated on the executed plan, and the
  exporters derive one *track per worker* whose busy interval inside each
  step is the worker's share of that modelled cost.
* **Counters and gauges** are registered once on the tracer's metrics
  registry (``plan_hits`` / ``plan_misses`` / ``tasks_executed`` /
  ``recv_bytes`` / ``send_bytes`` / ``migrated_bytes`` /
  ``norm_fetch_bytes``, plus ``plans_verified`` / ``verify_violations``
  from the static verifier at plan-cache admission) and emitted uniformly:
  live as Chrome counter events, and at run end as the flat dict
  (:func:`run_metrics`) the driver stats dataclasses wrap.
* **Structured analysis events**: the plan verifier
  (:mod:`repro.analysis`) reports each violation as a
  ``plan_verify_violation`` instant in category ``"analysis"`` carrying
  the check id and task/round provenance — query them with
  :meth:`Tracer.instants_of`.
* :data:`NULL_TRACER` is the disabled tracer every un-instrumented call
  path sees: all methods are allocation-free no-ops, it is falsy, and it
  records nothing — tracing off costs a few attribute lookups per
  operation and cannot perturb numerics.

The tracer rides on the plan cache (``SymbolicCache.tracer``), which is
already threaded through every resident collective and driver — enable
tracing by constructing ``PlanCache(tracer=Tracer())`` or by passing
``tracer=`` to a driver, and read it back anywhere via :func:`tracer_of`.

**The profiler tracer.**  While a ``torch.profiler`` session records, a
cache with no tracer of its own (and :func:`tracer_of` of no cache) hands
out the process's :func:`profiler_tracer` instead of :data:`NULL_TRACER`:
``Tracer(sync=False, profiler_scopes=True)``, so each span is a
``record_function`` scope in the profiler's own trace, beside the device's
kernels, and the host never waits for the card inside one.  It records the
spans and the cache's counters and no dispatch annotation
(:attr:`Tracer.annotates` is False: no span args, worker costs, byte
counters or instants, which only the exporters read).  Each session starts
a fresh one, which keeps its spans after the session stops, until the next
starts.  Outside a session the switch costs one C call
(``torch._C._autograd._profiler_enabled``).

A copy of the JAX package's ``repro/obs/tracer.py`` with these changes:
:meth:`Tracer.sync` waits for the card with ``torch.cuda.synchronize``,
``profiler_scopes`` (the JAX package's ``jax_scopes``) opens a
``torch.profiler.record_function`` scope per span, and the profiler tracer
above, with :attr:`Tracer.annotates` and :meth:`Tracer.self_seconds`.
"""

from __future__ import annotations

import time
from typing import Any

import torch

__all__ = [
    "Counter",
    "Gauge",
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "tracer_of",
    "profiler_tracer",
    "run_metrics",
]


class Counter:
    """Monotonic counter registered once on a tracer's metrics registry."""

    __slots__ = ("name", "value", "_clock", "_events")

    def __init__(self, name: str, tracer: "Tracer | None" = None):
        self.name = name
        self.value = 0.0
        # a registered metric records each change as a Chrome counter event
        self._clock = tracer._clock if tracer is not None else None
        self._events = tracer._counter_events if tracer is not None else None

    def add(self, v: float = 1.0) -> None:
        self.value += v
        if self._events is not None:
            self._events.append((self._clock(), self.name, self.value))


class Gauge:
    """Last-value gauge registered once on a tracer's metrics registry."""

    __slots__ = ("name", "value", "_clock", "_events")

    __init__ = Counter.__init__

    def set(self, v: float) -> None:
        self.value = float(v)
        if self._events is not None:
            self._events.append((self._clock(), self.name, self.value))


class Span:
    """One recorded interval on the host timeline, and the context manager
    that closes it (``with tracer.span(...) as sp`` yields the span itself).

    ``parent`` is the index of the enclosing span in ``tracer.spans`` (or
    -1); ``worker_costs``, when set by the instrumentation, is a ``[P]``
    non-negative vector of measured per-worker cost shares of this span
    (executed tasks + exchange bytes in task-equivalent units) — the
    exporters turn it into per-worker busy intervals.
    """

    __slots__ = ("name", "cat", "t0", "t1", "parent", "args", "worker_costs", "_tracer",
                 "_scope")

    def __init__(self, name: str, cat: str, t0: float, parent: int, args: dict,
                 tracer: "Tracer | None" = None):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = t0
        self.parent = parent
        self.args = args
        self.worker_costs = None
        self._tracer = tracer  # the open span's tracer; dropped on exit
        self._scope = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        if self._tracer._profiler_scopes:
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._scope is not None:
            self._scope.__exit__(*exc)
            self._scope = None
        tr = self._tracer
        self.t1 = tr._clock()
        tr._stack.pop()
        self._tracer = None
        return None


class Tracer:
    """Records nested spans, instants, and registered counters/gauges.

    ``sync`` makes :meth:`sync` wait for the card inside kernel-dispatch
    spans so span durations measure execution rather than the asynchronous
    launch (numerics are untouched either way).  ``profiler_scopes``
    additionally opens a ``torch.profiler.record_function`` scope named
    after each span, so a concurrent ``torch.profiler`` capture carries the
    same labels.
    """

    enabled = True
    #: dispatch sites annotate their spans (args, worker costs, byte counters,
    #: instants) for the exporters; False on the profiler tracer
    annotates = True

    def __init__(
        self,
        *,
        clock=time.perf_counter,
        sync: bool = True,
        profiler_scopes: bool = False,
    ):
        self._clock = clock
        self._sync = sync
        self._profiler_scopes = profiler_scopes
        self.origin = clock()
        self.spans: list[Span] = []
        self.instants: list[tuple[str, str, float, int, dict]] = []
        self._stack: list[int] = []
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._counter_events: list[tuple[float, str, float]] = []

    def __bool__(self) -> bool:
        return True

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, cat: str = "", **args: Any) -> Span:
        """Open a nested span; use as ``with tracer.span(...) as sp``."""
        stack = self._stack
        sp = Span(name, cat, self._clock(), stack[-1] if stack else -1, args, self)
        stack.append(len(self.spans))
        self.spans.append(sp)
        return sp

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        """Zero-duration marker attached to the current span."""
        parent = self._stack[-1] if self._stack else -1
        self.instants.append((name, cat, self._clock(), parent, args))

    def instants_of(self, name: str, cat: str | None = None) -> list[dict]:
        """The recorded args dicts of matching instants, in record order
        (e.g. the verifier's ``plan_verify_violation`` analysis events)."""
        return [args for (n, c, _, _, args) in self.instants
                if n == name and (cat is None or c == cat)]

    # -- metrics registry ----------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, self)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self)
        return g

    def metrics_flat(self) -> dict:
        """Flat dict of every registered counter/gauge plus span counts."""
        out: dict = {name: c.value for name, c in sorted(self._counters.items())}
        out.update({name: g.value for name, g in sorted(self._gauges.items())})
        out["spans_recorded"] = len(self.spans)
        return out

    def self_seconds(self, name: str) -> float:
        """Seconds in the spans called ``name`` outside their direct children:
        each such span's duration less those of the spans it opened."""
        spans = self.spans
        total = 0.0
        for sp in spans:
            if sp.name == name:
                total += sp.dur
            if sp.parent >= 0 and spans[sp.parent].name == name:
                total -= sp.dur
        return total

    # -- device sync ---------------------------------------------------------
    def sync(self, x: Any) -> Any:
        """Wait for the card that holds ``x`` so the enclosing span measures execution.

        ``x`` is a tensor or a tuple / list / dict of them; each CUDA device
        among them is synchronised once, and a CPU tensor needs nothing.
        No-op when the tracer was built with ``sync=False`` (and always on
        :data:`NULL_TRACER`), so tracing off never forces synchronisation.
        """
        if self._sync:
            for dev in _cuda_devices(x, set()):
                torch.cuda.synchronize(dev)
        return x


def _cuda_devices(x: Any, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


class _NullHandle:
    """Reusable no-op span context; also quacks like a Span for annotation."""

    __slots__ = ()
    worker_costs = None

    @property
    def args(self) -> dict:  # a fresh throwaway dict: mutations vanish
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __setattr__(self, name, value):  # annotations on a null span vanish
        pass


class _NullMetric:
    __slots__ = ()
    value = 0.0

    def add(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass


_NULL_HANDLE = _NullHandle()
_NULL_METRIC = _NullMetric()


class NullTracer:
    """The disabled tracer: falsy, allocation-free, records nothing."""

    enabled = False
    annotates = False
    spans: tuple = ()
    instants: tuple = ()

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, cat: str = "", **args: Any) -> _NullHandle:
        return _NULL_HANDLE

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        pass

    def instants_of(self, name: str, cat: str | None = None) -> list:
        return []

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def metrics_flat(self) -> dict:
        return {}

    def self_seconds(self, name: str) -> float:
        return 0.0

    def sync(self, x: Any) -> Any:
        return x


NULL_TRACER = NullTracer()

#: whether a torch.profiler session records now: one C call
profiler_recording = torch._C._autograd._profiler_enabled


def _new_profiler_tracer() -> Tracer:
    tr = Tracer(sync=False, profiler_scopes=True)
    tr.annotates = False
    return tr


_profiler_tracer = _new_profiler_tracer()


def profiler_tracer() -> Tracer:
    """The process's profiler tracer: the spans and cache counters of the
    latest ``torch.profiler`` session, held until the next one starts."""
    return _profiler_tracer


def _start_profiler_tracer(torch_start):
    """``torch.autograd.profiler``'s hook run as each session starts, wrapped
    so that the session also starts a fresh profiler tracer.  A span still
    open on the previous one closes on it."""

    def run_on_profiler_start():
        global _profiler_tracer
        _profiler_tracer = _new_profiler_tracer()
        torch_start()

    run_on_profiler_start.starts_profiler_tracer = True
    return run_on_profiler_start


_torch_start = getattr(torch.autograd.profiler, "_run_on_profiler_start", None)
if _torch_start is not None and not getattr(_torch_start, "starts_profiler_tracer", False):
    torch.autograd.profiler._run_on_profiler_start = _start_profiler_tracer(_torch_start)


def tracer_of(cache) -> Tracer | NullTracer:
    """The tracer threaded through the runtime rides on the plan cache; a
    call with no cache gets :func:`profiler_tracer` while a profiler session
    records, else :data:`NULL_TRACER`."""
    if cache is None:
        return _profiler_tracer if profiler_recording() else NULL_TRACER
    tr = getattr(cache, "tracer", None)
    return tr if tr is not None else NULL_TRACER


def run_metrics(cache=None, tracer=None) -> dict:
    """The unified flat metrics dict the driver stats dataclasses wrap.

    Cache counters (hits / misses / hit_rate / build_s / symbolic_s /
    by_kind) merged with every counter and gauge registered on the tracer
    (tasks_executed, recv/send bytes, migrated bytes, norm-fetch bytes, span
    counts).  With tracing disabled this is exactly ``cache.stats()`` — the
    pre-tracer behaviour — so existing consumers keep working unchanged.
    """
    tr = tracer if tracer is not None else tracer_of(cache)
    if tracer is None and tr is _profiler_tracer:
        tr = NULL_TRACER  # its counters are the whole session's, not this run's
    out: dict = dict(cache.stats()) if cache is not None else {}
    out.update(tr.metrics_flat())
    return out
