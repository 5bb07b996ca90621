"""plan_build_s: ``PlanCache.build_s`` at the end of set-up (``core/schedule.py``'s
planner, timed by the program around each cache miss).  Nothing where the driver keeps no
plan cache."""


def read(run):
    return run.counters["setup"].get("build_s")
