"""The disabled tracer and event log, the runtime's wall clock, and the
per-iteration scaffolding of the iterative drivers.

Only the pieces the caches and the drivers call; the full observatory of
the JAX package (``repro.obs``: tracer, event log, locality ledger, health
monitor) is not ported yet.
"""

from .locality import ledger_of, locality_iteration, locality_snapshot
from .log import NULL_LOG, NullEventLog, log_of
from .timing import SHARED_ITER_KEYS, IterationScope, Stopwatch, timed_into, wall_clock
from .tracer import NULL_TRACER, NullTracer, run_metrics, tracer_of

__all__ = [
    "NULL_LOG",
    "NULL_TRACER",
    "NullEventLog",
    "NullTracer",
    "IterationScope",
    "SHARED_ITER_KEYS",
    "Stopwatch",
    "ledger_of",
    "locality_iteration",
    "locality_snapshot",
    "log_of",
    "run_metrics",
    "timed_into",
    "tracer_of",
    "wall_clock",
]
