"""The readers of the port's own spans: host self time a call in ``plan_lookup``,
``exchange`` and ``launch``, and the card's idle under the program's spans.

On a hand-made trace summary and a profiler tracer whose spans come from a
ticking clock; on a trace with no device operation; on a program without a
profiler tracer, as an older port is; and after a traced
run of a small cell on the CPU.
"""

import io
import json
import time
import types

import pytest

import repro_torch.obs as tobs
from bench import manifest
from bench import run as bench_run
from bench.tests.tiny import ROOT, make_root
from bench.trace_reader import TraceSummary
from repro_torch.obs import tracer as tracer_mod

READERS = ("plan_lookup_host_ms", "exchange_host_ms", "launch_host_ms", "program_idle_ms")


class Tick:
    """Deterministic clock: advances 1.0 s per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _ticked_tracer():
    """Two calls as the resident multiply records them; the first a miss."""
    tr = tobs.Tracer(clock=Tick(), sync=False, profiler_scopes=False)
    for miss in (True, False):
        with tr.span("dist_multiply"):
            with tr.span("plan_lookup"):  # 1 s of its own; the miss adds a build
                if miss:
                    with tr.span("plan_build"):
                        pass
            with tr.span("dispatch"):
                with tr.span("exchange"):
                    pass
                with tr.span("launch"):
                    pass
    return tr


def _summary(device_ops=True):
    return TraceSummary(
        window_s=1.0, busy_s=0.9 if device_ops else 0.0,
        device_ops={"fused_block_spmm_kernel": 0.9} if device_ops else {},
        idle_gaps={"bench.call > plan_lookup": 0.05, "bench.call > exchange": 0.01,
                   "bench.call": 0.02, "bench.call > aten::index": 0.004,
                   "bench.sync > cudaDeviceSynchronize": 0.01})


def _read(name, run):
    return manifest.load_reader(name, ROOT)(run)


@pytest.fixture
def ticked(monkeypatch):
    tr = _ticked_tracer()
    monkeypatch.setattr(tracer_mod, "_profiler_tracer", tr)
    return tr


def test_the_readers_on_a_ticking_clock(ticked):
    run = types.SimpleNamespace(trace=_summary(), durations=[0.5, 0.5])
    assert tobs.profiler_tracer() is ticked
    # plan_lookup: 3 s with a 1 s build inside, then 1 s; the others 1 s a call
    assert _read("plan_lookup_host_ms", run) == pytest.approx(1e3 * (2.0 + 1.0) / 2)
    assert _read("exchange_host_ms", run) == pytest.approx(1e3)
    assert _read("launch_host_ms", run) == pytest.approx(1e3)
    # the idle under plan_lookup and exchange; not bare bench.call, an aten op or the sync
    assert _read("program_idle_ms", run) == pytest.approx(1e3 * 0.06 / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_device_operation(ticked, name):
    for trace in (_summary(device_ops=False), None):
        assert _read(name, types.SimpleNamespace(trace=trace, durations=[0.5])) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_where_the_program_recorded_no_span(monkeypatch, name):
    run = types.SimpleNamespace(trace=_summary(), durations=[0.5])
    monkeypatch.setattr(tracer_mod, "_profiler_tracer", tobs.Tracer(sync=False))
    assert _read(name, run) is None
    # a program without a profiler tracer, as an older port is
    monkeypatch.delattr(tobs, "profiler_tracer")
    assert _read(name, run) is None


def test_a_traced_run_on_the_cpu_records_each_call_once(tmp_path):
    root = make_root(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    rc = bench_run.run("tiny_band.resident", 2**31 + 29, 0.3, True, root=root, device="cpu",
                       t0=time.perf_counter(), out=out, err=err)
    assert rc == 0
    detail, last = (json.loads(x) for x in out.getvalue().strip().splitlines())
    assert last["correct"] is True
    tr = tobs.profiler_tracer()
    names = [sp.name for sp in tr.spans]
    calls = detail["calls"]
    for name in ("dist_multiply", "plan_lookup", "dispatch", "exchange", "launch"):
        assert names.count(name) == calls, name
    assert "plan_build" not in names  # set-up's warm calls built the plan, outside the session
    # no device operation on the CPU: the readers read nothing, and with one they read the spans
    run = types.SimpleNamespace(trace=_summary(), durations=[0.0] * calls)
    for name in READERS[:3]:
        assert _read(name, run) > 0
