"""The disabled tracer, event log and the one wall clock of the runtime.

Only the pieces :mod:`repro_torch.core.cache` needs; the full observatory of
the JAX package (``repro.obs``) is not ported yet.
"""

from .log import NULL_LOG, NullEventLog
from .timing import Stopwatch, timed_into, wall_clock
from .tracer import NULL_TRACER, NullTracer

__all__ = [
    "NULL_LOG",
    "NULL_TRACER",
    "NullEventLog",
    "NullTracer",
    "Stopwatch",
    "timed_into",
    "wall_clock",
]
