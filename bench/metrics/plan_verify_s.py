"""plan_verify_s: ``PlanCache.verify_s`` at the end of set-up (``analysis/verify.py``,
run by the program at cache admission).  Nothing where the driver keeps no plan cache."""


def read(run):
    return run.counters["setup"].get("verify_s")
