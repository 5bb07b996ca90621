"""The profile reader on a trace made by hand."""

import math

from bench.trace_reader import summarize


def _x(cat, name, ts, dur, tid=1):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid)


def test_union_names_and_idle_gaps():
    events = [
        _x("user_annotation", "bench.window", 100, 1000),
        _x("user_annotation", "bench.call", 100, 300),
        _x("cpu_op", "aten::index", 120, 100),
        _x("user_annotation", "bench.sync", 400, 690),
        _x("kernel", "void fused_block_spmm_kernel<float>", 250, 500, tid=7),
        _x("kernel", "gather", 700, 100, tid=8),  # overlaps: counted once in busy time
        _x("gpu_memset", "Memset", 50, 100, tid=7),  # half before the window
        _x("kernel", "late", 1050, 100, tid=7),  # half after the window
        _x("gpu_user_annotation", "bench.call", 100, 900, tid=7),  # not an operation
        dict(ph="s", cat="ac2g", name="flow", ts=100, pid=1, tid=1),
    ]
    s = summarize(dict(traceEvents=events))
    assert math.isclose(s.window_s, 1000e-6)
    # device busy: [100, 150) + [250, 800) + [1050, 1100)
    assert math.isclose(s.busy_s, (50 + 550 + 50) * 1e-6)
    assert math.isclose(s.device_seconds("fused_block_spmm"), 500e-6)
    assert math.isclose(s.device_ops["Memset"], 50e-6) and math.isclose(s.device_ops["late"], 50e-6)
    # gaps: [150, 250) in bench.call > aten::index? its middle 200 is inside aten::index [120, 220)
    # and [800, 1050) in bench.sync (middle 925)
    assert math.isclose(s.idle_gaps["bench.call > aten::index"], 100e-6)
    assert math.isclose(s.idle_gaps["bench.sync"], 250e-6)
    assert s.top("idle_gaps")[0] == ["bench.sync", s.idle_gaps["bench.sync"]]


def test_no_window_reads_nothing():
    assert summarize(dict(traceEvents=[_x("kernel", "k", 0, 10)])) is None
