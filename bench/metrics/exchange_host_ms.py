"""exchange_host_ms: host milliseconds a call in the port's ``exchange`` span
(``core/distributed.py``, the executable's receive buffers: the operand casts, each
round's gather and the contiguous stores), whose device side ``nongemm_device_ms``
counts.  Nothing where the trace holds no device operation or the program recorded no
such span."""

from bench.program_spans import self_ms_per_call


def read(run):
    return self_ms_per_call(run, "exchange")
