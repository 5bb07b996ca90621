"""Trace exporters: Chrome trace-event JSON (Perfetto-loadable) + validation.

The emitted file follows the Chrome trace-event format (``traceEvents`` with
``B``/``E`` duration pairs, ``i`` instants, ``C`` counters and ``M``
metadata), which Perfetto and ``chrome://tracing`` both load directly:

* **host track** (pid 0) — the full nested span tree exactly as recorded:
  phases, iterations, collectives, plan builds, symbolic descents, kernel
  dispatches, rebalance migrations, with per-span args.
* **worker tracks** (pid 1, one tid per worker) — the paper-style
  utilization timeline: every leaf span carrying a measured
  :attr:`~repro_torch.obs.tracer.Span.worker_costs` vector contributes a busy
  interval on worker ``p`` of length ``dur * cost_p / max_q cost_q``
  (a step ends when its slowest worker does, so the heaviest worker
  is busy for the whole span and the rest idle in proportion to their
  measured share).  Gaps between busy intervals read as idle time.
* **counter track** — every registered counter/gauge as Chrome ``C``
  events, so byte/task counters plot over the same timeline.

:func:`validate_chrome_trace` is the schema check shared by the tests and
the CI trace-smoke job: monotonic non-negative timestamps per track,
strictly matched and properly nested ``B``/``E`` pairs, and exactly one
track per worker.
"""

from __future__ import annotations

import json

import numpy as np

from .tracer import Tracer

__all__ = [
    "chrome_trace_events",
    "write_chrome_trace",
    "validate_chrome_trace",
    "HOST_PID",
    "WORKER_PID",
]

HOST_PID = 0
WORKER_PID = 1


def _span_tree(tracer: Tracer):
    kids: list[list[int]] = [[] for _ in tracer.spans]
    roots: list[int] = []
    for i, sp in enumerate(tracer.spans):
        (roots if sp.parent < 0 else kids[sp.parent]).append(i)
    return kids, roots


def _attributed_leaves(tracer: Tracer) -> list[int]:
    """Spans carrying worker_costs with no attributed ancestor (so their
    busy intervals never nest on a worker track)."""
    has = [sp.worker_costs is not None for sp in tracer.spans]
    out = []
    for i, sp in enumerate(tracer.spans):
        if not has[i]:
            continue
        p, shadowed = sp.parent, False
        while p >= 0:
            if has[p]:
                shadowed = True
                break
            p = tracer.spans[p].parent
        if not shadowed:
            out.append(i)
    return out


def _json_safe(args: dict) -> dict:
    out = {}
    for k, v in args.items():
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[k] = v
    return out


def chrome_trace_events(tracer: Tracer) -> list[dict]:
    """Chrome trace-event list: metadata, host B/E tree, worker tracks,
    instants and counter series.  Timestamps are microseconds from the
    tracer's origin."""
    org = tracer.origin
    us = lambda t: (t - org) * 1e6
    ev: list[dict] = [
        dict(ph="M", name="process_name", pid=HOST_PID, tid=0,
             args=dict(name="host runtime")),
        dict(ph="M", name="thread_name", pid=HOST_PID, tid=0,
             args=dict(name="driver")),
    ]

    # worker count from the attributed spans (0 tracks when none recorded)
    leaves = _attributed_leaves(tracer)
    nparts = max((len(tracer.spans[i].worker_costs) for i in leaves), default=0)
    if nparts:
        ev.append(dict(ph="M", name="process_name", pid=WORKER_PID, tid=0,
                       args=dict(name="workers")))
        for p in range(nparts):
            ev.append(dict(ph="M", name="thread_name", pid=WORKER_PID, tid=p,
                           args=dict(name=f"worker {p}")))

    # host track: DFS over the span tree keeps B/E properly nested even for
    # zero-duration spans sharing timestamps
    kids, roots = _span_tree(tracer)

    def emit(i: int) -> None:
        sp = tracer.spans[i]
        ev.append(dict(ph="B", name=sp.name, cat=sp.cat or "span",
                       ts=us(sp.t0), pid=HOST_PID, tid=0,
                       args=_json_safe(sp.args)))
        for c in kids[i]:
            emit(c)
        ev.append(dict(ph="E", name=sp.name, cat=sp.cat or "span",
                       ts=us(sp.t1), pid=HOST_PID, tid=0))

    for r in roots:
        emit(r)

    for name, cat, t, _parent, args in tracer.instants:
        ev.append(dict(ph="i", name=name, cat=cat or "instant", ts=us(t),
                       pid=HOST_PID, tid=0, s="t", args=_json_safe(args)))

    # worker utilization tracks: per attributed leaf span, worker p is busy
    # for its measured cost share of the step
    for i in leaves:
        sp = tracer.spans[i]
        costs = np.asarray(sp.worker_costs, dtype=np.float64)
        cmax = costs.max() if costs.size else 0.0
        if cmax <= 0.0:
            continue
        for p in range(costs.shape[0]):
            frac = costs[p] / cmax
            if frac <= 0.0:
                continue
            ev.append(dict(ph="B", name=sp.name, cat=sp.cat or "span",
                           ts=us(sp.t0), pid=WORKER_PID, tid=p,
                           args=dict(cost_share=float(frac))))
            ev.append(dict(ph="E", name=sp.name, cat=sp.cat or "span",
                           ts=us(sp.t0 + sp.dur * frac), pid=WORKER_PID,
                           tid=p))

    for t, name, value in tracer._counter_events:
        ev.append(dict(ph="C", name=name, ts=us(t), pid=HOST_PID, tid=0,
                       args={name: value}))

    return ev


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    """Write the Perfetto-loadable trace file; returns a small summary."""
    events = chrome_trace_events(tracer)
    with open(path, "w") as fh:
        json.dump(dict(traceEvents=events, displayTimeUnit="ms"), fh)
        fh.write("\n")
    return validate_chrome_trace(events)


def validate_chrome_trace(trace) -> dict:
    """Schema check for an emitted trace (events list, trace dict, or path).

    Raises ``AssertionError`` on: non-monotonic or negative timestamps
    within a track, unmatched or mis-nested ``B``/``E`` pairs, or worker
    thread-name metadata not covering tids 0..P-1 exactly once.  Returns
    summary counts (spans per track, workers, counters).
    """
    if isinstance(trace, str):
        with open(trace) as fh:
            trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace

    per_track: dict[tuple, list] = {}
    worker_names: dict[int, str] = {}
    counters = set()
    for e in events:
        ph = e["ph"]
        if ph == "M":
            if e["name"] == "thread_name" and e["pid"] == WORKER_PID:
                tid = e["tid"]
                assert tid not in worker_names, f"duplicate worker track {tid}"
                worker_names[tid] = e["args"]["name"]
            continue
        if ph == "C":
            counters.add(e["name"])
            continue
        assert e["ts"] >= 0.0, f"negative timestamp: {e}"
        if ph in ("B", "E"):
            per_track.setdefault((e["pid"], e["tid"]), []).append(e)

    span_counts: dict[str, int] = {}
    for (pid, tid), evs in sorted(per_track.items()):
        # emission order is authoritative; timestamps must not go backwards
        last = 0.0
        stack: list[str] = []
        n = 0
        for e in evs:
            assert e["ts"] >= last - 1e-9, (
                f"non-monotonic ts on track {(pid, tid)}: {e['ts']} < {last}")
            last = max(last, e["ts"])
            if e["ph"] == "B":
                stack.append(e["name"])
                n += 1
            else:
                assert stack, f"E without B on track {(pid, tid)}: {e}"
                top = stack.pop()
                assert top == e["name"], (
                    f"mis-nested span on track {(pid, tid)}: "
                    f"E {e['name']!r} closes B {top!r}")
        assert not stack, f"unclosed spans on track {(pid, tid)}: {stack}"
        span_counts[f"{pid}/{tid}"] = n

    nworkers = len(worker_names)
    assert set(worker_names) == set(range(nworkers)), (
        f"worker tracks must be tids 0..{nworkers - 1}: {sorted(worker_names)}")
    for tid, name in worker_names.items():
        assert name == f"worker {tid}", (tid, name)
    # the worker timeline as a whole carries busy intervals (a single fully
    # idle worker is legal — its track just reads as idle)
    if nworkers:
        assert any(span_counts.get(f"{WORKER_PID}/{t}", 0) > 0
                   for t in worker_names), "no busy spans on any worker track"

    return dict(
        events=len(events),
        host_spans=span_counts.get(f"{HOST_PID}/0", 0),
        workers=nworkers,
        worker_spans={t: n for t, n in span_counts.items()
                      if t.startswith(f"{WORKER_PID}/")},
        counters=sorted(counters),
    )
