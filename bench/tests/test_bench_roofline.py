"""The roofline arithmetic, checked by hand."""

import math

from bench.roofline import block_product_bound


def test_band_row1_is_bound_by_operations():
    b = block_product_bound(1_828_582, 128, 37_718, 73_502)
    ops = 2 * 1_828_582 * 128**3  # 7.6696e12
    assert b["ops"] == ops and b["by"] == "operations"
    assert math.isclose(b["seconds"], ops / 67e12)  # 114.47 ms
    assert math.isclose(b["seconds"], 0.114472, rel_tol=1e-5)
    assert b["bytes"] == (37_718 + 73_502) * 128 * 128 * 4  # 7.29 GB


def test_random_row1_and_a_byte_bound_case():
    b = block_product_bound(3_596_082, 128, 47_618, 87_602)
    assert math.isclose(b["seconds"], 0.2251203, rel_tol=1e-6)
    # one task per output block of bs 8: 1024 flop against 512 bytes
    small = block_product_bound(1000, 8, 1000, 1000)
    assert small["by"] == "bytes"
    assert math.isclose(small["seconds"], 1000 * 64 * 8 / 3.35e12)
    bf16 = block_product_bound(1000, 128, 100, 100, dtype="bfloat16")
    assert math.isclose(bf16["seconds"], max(2 * 1000 * 128**3 / 989e12,
                                             (100 * 2 + 100 * 4) * 128 * 128 / 3.35e12))
