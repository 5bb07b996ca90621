"""launch_host_ms: host milliseconds a call in the port's ``launch`` span
(``core/distributed.py`` into ``kernels/fused_leaf.py``: the tile pick, the fused
kernel's checks, its output's allocation and the launch).  Nothing where the trace
holds no device operation or the program recorded no such span."""

from bench.program_spans import self_ms_per_call


def read(run):
    return self_ms_per_call(run, "launch")
