"""multiply_p90_s: the 90th percentile of the wall time of every call in the window
(host clock; each call ends in a synchronise), interpolated between order
statistics as ``statistics.quantiles(..., method="inclusive")`` does."""

import statistics


def read(run):
    d = run.durations
    return statistics.quantiles(d, n=10, method="inclusive")[8] if len(d) > 1 else d[0]
