"""The port's spans in a ``torch.profiler`` trace.

While a profiler session records, a plan cache with no tracer of its own hands
out the process's profiler tracer, whose spans are ``record_function`` scopes
in the profiler's trace: ``dist_multiply`` (or ``dist_spamm``) around
``plan_lookup`` and ``dispatch``, ``plan_build`` and ``plan_verify`` inside
``plan_lookup`` on a miss, and ``exchange`` and ``launch`` inside
``dispatch``.  With no session the hot path makes no span and opens no scope;
a cache's own tracer is left as it is; the profiler tracer holds the latest
session's spans and annotates no dispatch.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.dist.multiply as mult
import repro_torch.obs as tobs
from repro_torch.core import BSMatrix
from repro_torch.core.distributed import make_worker_mesh
from repro_torch.core.quadtree import morton_encode
from repro_torch.dist import PlanCache, dist_multiply, dist_spamm, scatter
from repro_torch.obs import tracer as tracer_mod

BS = 8
N = 96

CALLS = {
    "multiply_fused": lambda a, cache: dist_multiply(a, a, cache),
    "multiply_staged": lambda a, cache: dist_multiply(a, a, cache, impl="ref"),
    "spamm_delta": lambda a, cache: dist_spamm(a, a, 1e-3, cache)[0],
    "spamm_replan": lambda a, cache: dist_spamm(a, a, 1e-3, cache, method="replan")[0],
}


class Tick:
    """Deterministic clock: advances 1.0 s per call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _operand(seed=0):
    """A band of half-width 2 blocks plus a dense corner, on 2 CPU workers."""
    nb = N // BS
    coords = np.array([(i, j) for i in range(nb) for j in range(nb)
                       if abs(i - j) <= 2 or (i < 3 and j < 3)], np.int64)
    coords = coords[np.argsort(morton_encode(coords[:, 0], coords[:, 1]))]
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((len(coords), BS, BS)).astype(np.float32))
    return scatter(BSMatrix(shape=(N, N), bs=BS, coords=coords, data=data),
                   make_worker_mesh(2, "cpu"))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _scopes(prof, tmp_path):
    """The trace's ``record_function`` scopes as ``(name, start, end)``, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(scopes, i):
    """The name of the innermost scope that holds scope ``i``, or None."""
    _, s, e = scopes[i]
    holders = [j for j, (_, s2, e2) in enumerate(scopes) if j != i and s2 <= s and e <= e2]
    return scopes[min(holders, key=lambda j: scopes[j][2] - scopes[j][1])][0] if holders else None


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_the_spans_nest_in_the_profilers_own_trace(kind, tmp_path):
    a, cache = _operand(), PlanCache()
    outer = "dist_spamm" if kind.startswith("spamm") else "dist_multiply"
    _, prof = _profiled(lambda: [CALLS[kind](a, cache) for _ in range(2)])
    scopes = _scopes(prof, tmp_path)
    calls = [s for s in scopes if s[0] == outer]
    assert len(calls) == 2
    want = {"plan_lookup": outer, "dispatch": outer, "exchange": "dispatch", "launch": "dispatch"}
    for i, (name, _, _) in enumerate(scopes):
        if name in want:
            assert _parent(scopes, i) == want[name], (name, i)
    for (_, s, e), miss in zip(calls, (True, False)):
        inside = [(i, sc) for i, sc in enumerate(scopes) if s <= sc[1] and sc[2] <= e]
        names = [sc[0] for _, sc in inside]
        assert [names.count(n) for n in want] == [1, 1, 1, 1]
        lookup_builds = [sc[0] for i, sc in inside if sc[0] in ("plan_build", "plan_verify")
                         and _parent(scopes, i) == "plan_lookup"]
        if miss:
            assert lookup_builds == ["plan_build", "plan_verify"]
        else:
            assert "plan_build" not in names and "plan_verify" not in names
    # the tracer's own record of the same spans: parents by index
    tr = tobs.profiler_tracer()
    spans = tr.spans
    for sp in spans:
        if sp.name in want:
            assert spans[sp.parent].name == want[sp.name]
    assert sum(sp.name == outer for sp in spans) == 2


@pytest.mark.parametrize("kind", ["multiply_fused", "multiply_staged"])
def test_no_profiler_no_span_and_no_scope(kind, monkeypatch):
    made, opened = [], []
    real_init = tracer_mod.Span.__init__

    def counting_init(self, *args, **kwargs):
        made.append(args[0])
        real_init(self, *args, **kwargs)

    real_scope = torch.profiler.record_function
    monkeypatch.setattr(tracer_mod.Span, "__init__", counting_init)
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real_scope(*a, **k))
    a, cache = _operand(), PlanCache()
    assert cache.tracer is tobs.NULL_TRACER and tobs.tracer_of(cache) is tobs.NULL_TRACER
    assert tobs.tracer_of(None) is tobs.NULL_TRACER
    for _ in range(2):  # a miss, then a hit
        CALLS[kind](a, cache)
    assert cache.misses == 1 and cache.hits == 1
    assert made == [] and opened == []
    # the switch itself: the same cache under a session hands out the profiler tracer
    with profile(activities=[ProfilerActivity.CPU]):
        assert cache.tracer is tobs.profiler_tracer() is tobs.tracer_of(cache)
        assert tobs.tracer_of(None) is tobs.profiler_tracer()
        CALLS[kind](a, cache)
    assert made and opened
    assert cache.tracer is tobs.NULL_TRACER


def test_self_seconds_on_a_ticking_clock():
    tr = tobs.Tracer(clock=Tick(), sync=False)  # the origin reads 1
    with tr.span("a"):  # 2 .. 9
        with tr.span("b"):  # 3 .. 4
            pass
        with tr.span("c"):  # 5 .. 8
            with tr.span("a"):  # 6 .. 7: a span of the same name, nested
                pass
    with tr.span("b"):  # 10 .. 11
        pass
    assert [sp.dur for sp in tr.spans] == [7.0, 1.0, 3.0, 1.0, 1.0]
    assert tr.self_seconds("a") == (7.0 - 1.0 - 3.0) + 1.0
    assert tr.self_seconds("b") == 2.0
    assert tr.self_seconds("c") == 3.0 - 1.0
    assert tr.self_seconds("none") == 0.0 and tobs.NULL_TRACER.self_seconds("a") == 0.0


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_results_are_bit_identical_with_the_profiler_on_and_off(kind):
    a = _operand(seed=3)
    off = [CALLS[kind](a, PlanCache()) for _ in range(2)]
    cache = PlanCache()
    on, _ = _profiled(lambda: [CALLS[kind](a, cache) for _ in range(2)])
    assert tobs.profiler_tracer().spans
    for x, y in zip(on, off):
        assert np.array_equal(x.coords, y.coords) and np.array_equal(x.owner, y.owner)
        assert torch.equal(x.store, y.store)


def test_a_caches_own_tracer_keeps_its_settings_and_gets_the_new_spans():
    tr = tobs.Tracer(sync=True)
    a, cache = _operand(), PlanCache(tracer=tr)
    _profiled(lambda: [dist_multiply(a, a, cache) for _ in range(2)])
    assert cache.tracer is tr and tobs.tracer_of(cache) is tr
    assert tr._sync is True and tr._profiler_scopes is False and tr.annotates
    names = [sp.name for sp in tr.spans]
    for name in ("dist_multiply", "plan_lookup", "dispatch", "exchange", "launch"):
        assert names.count(name) == 2, name
    assert names.count("plan_build") == names.count("plan_verify") == 1
    assert all("tasks" in sp.args for sp in tr.spans if sp.name == "dispatch")
    assert tobs.profiler_tracer().spans == []


def test_a_second_profiler_session_starts_from_an_empty_span_list():
    a, cache = _operand(), PlanCache()
    _profiled(lambda: [dist_multiply(a, a, cache) for _ in range(2)])
    first = tobs.profiler_tracer()
    assert [sp.name for sp in first.spans].count("dist_multiply") == 2  # kept after the stop
    _profiled(lambda: dist_multiply(a, a, cache))
    second = tobs.profiler_tracer()
    assert second is not first
    assert [sp.name for sp in second.spans].count("dist_multiply") == 1
    assert second.metrics_flat() == {"plan_hits": 1.0, "spans_recorded": len(second.spans)}
    _profiled(lambda: None)
    assert tobs.profiler_tracer().spans == []


def test_the_profiler_tracer_annotates_no_dispatch(monkeypatch):
    built = []
    real_static = mult._plan_obs_static
    monkeypatch.setattr(mult, "_plan_obs_static", lambda plan: built.append(plan) or real_static(plan))
    a, cache = _operand(), PlanCache()
    _profiled(lambda: [dist_multiply(a, a, cache), dist_spamm(a, a, 1e-3, cache)])
    tr = tobs.profiler_tracer()
    assert built == [] and tr.instants == []
    plan = cache.peek(cache.last_plan_key)[0]
    assert getattr(plan, "_obs_static", None) is None
    ops = [sp.args for sp in tr.spans if sp.name == "dispatch"]
    assert ops == [{"op": "spgemm"}, {"op": "spamm-delta"}]
    assert set(tr.metrics_flat()) <= {"plan_hits", "plan_misses", "plans_verified", "spans_recorded"}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tobs.run_metrics(cache) == cache.stats()  # a run's metrics are its cache's alone
