"""program_idle_ms: milliseconds a call in which the card idles while the host is in
one of the port's own spans: the window's idle gaps whose host part (after `` > ``)
names a span that the program recorded in its profiler tracer, the share of
``device_idle_pct`` that the program's host path accounts for.  Nothing where the
trace holds no device operation or the program recorded no span."""

from bench.program_spans import window_spans


def read(run):
    tr = window_spans(run)
    if tr is None:
        return None
    names = {sp.name for sp in tr.spans}
    idle = sum(s for label, s in run.trace.idle_gaps.items()
               if label.partition(" > ")[2] in names)
    return 1e3 * idle / len(run.durations)
