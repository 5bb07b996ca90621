"""plan_lookup_host_ms: host milliseconds a call in the port's ``plan_lookup`` span
(``dist/multiply.py``: the plan key, a structure fingerprint of both operands' codes
and owner maps, and the plan cache's lookup), outside the ``plan_build`` and
``plan_verify`` spans it opens on a miss.  Nothing where the trace holds no device
operation or the program recorded no such span."""

from bench.program_spans import self_ms_per_call


def read(run):
    return self_ms_per_call(run, "plan_lookup")
