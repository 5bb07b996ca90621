"""device_idle_pct: the share of the traced window in which no kernel, copy or set ran
on the card: 100 * (1 - union of their intervals / window).  Nothing where the
trace holds no device operation."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
