"""fused_block_spmm_roofline: the least time of the window's products over the fused
kernel's device time, in %.

The kernel is every launch whose name holds ``fused_block_spmm``
(``kernels/csrc/fused_block_spmm.cu``).  The bound is per call the larger of
2 * T * bs**3 operations at the type's peak and A read once plus C written
once at the HBM rate (``bench.roofline``), with T, A and C counted from the
benchmark's own structure.  Nothing where the trace holds no such launch."""

from bench.roofline import block_product_bound


def read(run):
    t = run.trace
    kernel_s = t.device_seconds("fused_block_spmm") if t is not None else 0.0
    if kernel_s <= 0:
        return None
    w = run.work
    bound = block_product_bound(w["tasks"], w["bs"], w["a_blocks"], w["c_blocks"], dtype=w["dtype"])
    return 100.0 * bound["seconds"] * len(run.durations) / kernel_s
