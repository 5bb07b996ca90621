"""The port's own spans in a traced window, for the per-layer metrics that read them.

While ``torch.profiler`` records, the port records its spans into its profiler
tracer (``repro_torch.obs.profiler_tracer``), each one also a scope in the
profiler's trace.  It holds the spans of the latest session, the traced window's,
after the session stops.  A program without one gives nothing to read.
"""

from __future__ import annotations


def profiler_tracer():
    """The port's profiler tracer, or ``None`` where the program has none."""
    try:
        from repro_torch.obs import profiler_tracer
    except ImportError:
        return None
    return profiler_tracer()


def window_spans(run):
    """The profiler tracer of a traced run whose trace holds device operations
    and whose program recorded spans in it; else ``None``."""
    t = run.trace
    if t is None or not t.device_ops:
        return None
    tr = profiler_tracer()
    return tr if tr is not None and tr.spans else None


def self_ms_per_call(run, name: str):
    """Host milliseconds a call in the spans called ``name`` outside their child
    spans; ``None`` where the program recorded no such span."""
    tr = window_spans(run)
    if tr is None or not any(sp.name == name for sp in tr.spans):
        return None
    return 1e3 * tr.self_seconds(name) / len(run.durations)
