"""nongemm_device_ms: device milliseconds a call of every kernel, copy and set in the
window other than the fused GEMM (the exchange's gathers, the zeroed receive
stacks and result store).  Nothing where the trace holds no device operation."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops:
        return None
    other = sum(t.device_ops.values()) - t.device_seconds("fused_block_spmm")
    return 1e3 * other / len(run.durations)
