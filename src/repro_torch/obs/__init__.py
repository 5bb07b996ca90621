"""Runtime observability of the resident runtime — span tracing, metrics,
Chrome-trace export, reports, and the health observatory.

* :class:`Tracer` / :data:`NULL_TRACER` (:mod:`repro_torch.obs.tracer`) —
  nested spans with per-worker cost attribution, plus counters / gauges
  registered once; the disabled tracer is an allocation-free no-op.  The
  tracer rides on the plan cache (``PlanCache(tracer=...)``), which is
  already threaded through every resident collective and driver.
* :func:`profiler_tracer` — the port's spans in a ``torch.profiler`` trace:
  run any profiler session, and a cache with no tracer of its own records
  into this one, each span a ``record_function`` scope beside the device's
  kernels.  On the resident multiply: ``dist_multiply`` (the call),
  ``plan_lookup`` (the plan key's structure fingerprint and the cache
  lookup; ``plan_build`` and ``plan_verify`` inside on a miss),
  ``dispatch`` (the executable), and in it ``exchange`` (the receive
  buffers) and ``launch`` (the tile pick, the kernel's checks and the
  launch).  :meth:`Tracer.self_seconds` gives a span's time outside its
  children.  It holds the latest session's spans until the next starts.
* :mod:`repro_torch.obs.timing` — the shared timing idioms (``timed_into``,
  ``IterationScope``) that give both iterative drivers one per-iteration
  row schema.
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON loadable in
  Perfetto: a host track with the full span tree and one utilization track
  per worker; :func:`validate_chrome_trace` is the schema check.
* :mod:`repro_torch.obs.report` — per-worker busy/idle utilization summary
  from a live tracer or a written trace file
  (``python -m repro_torch.obs.report trace.json``).
* :func:`run_metrics` — the flat metrics dict (cache + tracer counters) the
  driver stats dataclasses wrap.
* :mod:`repro_torch.obs.log` — :class:`EventLog` leveled structured JSONL
  log + :data:`NULL_LOG`, riding on the plan cache like the tracer
  (:func:`log_of`), and :class:`FlightRecorder`, which dumps a postmortem
  when plan admission raises ``PlanError`` or a driver divergence trip
  fires.
* :mod:`repro_torch.obs.memory` — :class:`MemoryMeter` per-worker device
  bytes from plan capacities, store shapes and receive buffers, with peak
  watermarks; :func:`cuda_memory_stats` reads the card's allocator beside
  it.
* :mod:`repro_torch.obs.health` — :class:`HealthMonitor` online anomaly
  detection (stragglers, plan-cache miss storms, exchange blowups,
  convergence stalls) + live ``calibrate_policy`` feedback into the load
  balancer.
* :mod:`repro_torch.obs.locality` — :class:`LocalityLedger`, riding on the
  plan cache (:func:`ledger_of`): per-dispatch decomposition of operand
  reads into locally-owned vs shipped bytes, and the per-iteration driver
  emission pair (:func:`locality_snapshot` / :func:`locality_iteration`).
* :mod:`repro_torch.obs.taskgraph` — critical path, per-worker slack and
  what-if projections over a plan's index arrays (:func:`analyze_plan`,
  :func:`whatif_rebalanced`, :func:`project_seconds`).

The JAX package's ``repro.obs`` with the same public names, except that
``jax_memory_stats`` is :func:`cuda_memory_stats` here, and
:func:`profiler_tracer` is the port's own.
"""

from .export import chrome_trace_events, validate_chrome_trace, write_chrome_trace
from .health import HealthAlert, HealthMonitor, HealthPolicy
from .locality import (
    LOCALITY_ITER_KEYS,
    LocalityLedger,
    ledger_of,
    locality_iteration,
    locality_snapshot,
    plan_provenance,
)
from .log import (
    EVENT_KEYS,
    NULL_LOG,
    POSTMORTEM_KEYS,
    EventLog,
    FlightRecorder,
    NullEventLog,
    load_events,
    log_of,
)
from .memory import MemoryMeter, cuda_memory_stats, meter_of, plan_memory_bytes
from .report import (
    locality_from_file,
    locality_table,
    memory_from_file,
    utilization_from_file,
    utilization_table,
    worker_utilization,
)
from .taskgraph import TaskGraphAnalysis, analyze_plan, project_seconds, whatif_rebalanced
from .timing import SHARED_ITER_KEYS, IterationScope, Stopwatch, timed_into, wall_clock
from .tracer import (
    NULL_TRACER,
    Counter,
    Gauge,
    NullTracer,
    Span,
    Tracer,
    profiler_tracer,
    run_metrics,
    tracer_of,
)

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Span",
    "Counter",
    "Gauge",
    "tracer_of",
    "profiler_tracer",
    "run_metrics",
    "timed_into",
    "IterationScope",
    "SHARED_ITER_KEYS",
    "Stopwatch",
    "wall_clock",
    "chrome_trace_events",
    "write_chrome_trace",
    "validate_chrome_trace",
    "worker_utilization",
    "utilization_from_file",
    "memory_from_file",
    "utilization_table",
    "EventLog",
    "NullEventLog",
    "NULL_LOG",
    "log_of",
    "load_events",
    "FlightRecorder",
    "EVENT_KEYS",
    "POSTMORTEM_KEYS",
    "MemoryMeter",
    "meter_of",
    "plan_memory_bytes",
    "cuda_memory_stats",
    "HealthPolicy",
    "HealthAlert",
    "HealthMonitor",
    "LocalityLedger",
    "LOCALITY_ITER_KEYS",
    "ledger_of",
    "plan_provenance",
    "locality_snapshot",
    "locality_iteration",
    "locality_table",
    "locality_from_file",
    "TaskGraphAnalysis",
    "analyze_plan",
    "whatif_rebalanced",
    "project_seconds",
]
