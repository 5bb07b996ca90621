"""The disabled tracer, event log and the one wall clock of the runtime.

Only the pieces the symbolic and plan caches need; the full observatory of
the JAX package (``repro.obs``) is not ported yet.
"""

from .log import NULL_LOG, NullEventLog
from .timing import Stopwatch, timed_into, wall_clock
from .tracer import NULL_TRACER, NullTracer, tracer_of

__all__ = [
    "NULL_LOG",
    "NULL_TRACER",
    "NullEventLog",
    "NullTracer",
    "Stopwatch",
    "timed_into",
    "tracer_of",
    "wall_clock",
]
