"""plan_misses: ``PlanCache.misses`` during the window (``dist/cache.py``): each is a
plan built and verified inside the timed loop.  Nothing where the driver keeps no plan cache."""


def read(run):
    c = run.counters
    if "misses" not in c["window_end"]:
        return None
    return c["window_end"]["misses"] - c["window_start"]["misses"]
