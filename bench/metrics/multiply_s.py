"""multiply_s: the window's seconds over the calls completed in it (host clock)."""


def read(run):
    return run.window_s / len(run.durations)
