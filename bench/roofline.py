"""The card's peaks and the least time a block-sparse product can take on it.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W: 67 TFLOP/s in
float32 outside the tensor cores (FFMA), 989 TFLOP/s in bf16 on them, 3.35
TB/s of HBM3.  A share of the bound is stated beside the card's power limit.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def block_product_bound(tasks: int, bs: int, a_blocks: int, c_blocks: int, *,
                        dtype: str = "float32", out_itemsize: int = 4) -> dict:
    """Least seconds for ``C = A @ A`` of ``tasks`` block products of ``bs x bs`` blocks.

    Operations: ``2 * tasks * bs**3`` at the type's peak.  Bytes: each block
    of A read once (A is both operands) and each block of C written once,
    whatever the implementation reads again or keeps beside them.  The
    bound is the larger; ``by`` says which.
    """
    itemsize = 2 if dtype == "bfloat16" else 4
    ops = 2.0 * tasks * bs**3
    nbytes = a_blocks * bs * bs * itemsize + c_blocks * bs * bs * out_itemsize
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return dict(seconds=max(t_ops, t_bytes), by="operations" if t_ops >= t_bytes else "bytes",
                ops=ops, bytes=nbytes)
