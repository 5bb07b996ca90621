"""Per-worker utilization report — the measured counterpart of the load
balancer's imbalance numbers.

Derives, from a live :class:`~repro_torch.obs.tracer.Tracer` or from a written
Chrome trace file, each worker's busy seconds (sum of its attributed busy
intervals), busy/idle fractions of the traced window, and the timeline
imbalance ``max busy / mean busy`` — directly comparable to the
``max/mean`` combined-cost imbalance the rebalancing cost model reports
(``BENCH_balance.json``): for a single step both reduce to the same ratio,
and across a run the timeline number is the duration-weighted aggregate.

Render with :func:`utilization_table`, or from a trace file::

    python -m repro_torch.obs.report trace_sqrt_inv.json

The locality/task-graph side (``benchmarks/locality.py`` output)::

    python -m repro_torch.obs.report --locality [BENCH_locality.json]

renders, per structure: static vs rebalanced locality fractions, the
per-worker locality table, the most-moved blocks, and the critical-path
breakdown with its what-if projections.
"""

from __future__ import annotations

import json

import numpy as np

from .export import WORKER_PID, _attributed_leaves
from .tracer import Tracer

__all__ = [
    "worker_utilization",
    "utilization_from_file",
    "memory_from_file",
    "utilization_table",
    "locality_table",
    "locality_from_file",
]


def _summarize(busy: np.ndarray, window: float) -> dict:
    window = max(window, 1e-12)
    frac = busy / window
    mean_busy = busy.mean() if busy.size else 0.0
    return dict(
        nparts=int(busy.size),
        window_s=float(window),
        busy_s=[float(b) for b in busy],
        busy_frac=[float(f) for f in frac],
        idle_frac=[float(1.0 - f) for f in frac],
        mean_busy_frac=float(frac.mean()) if busy.size else 0.0,
        min_busy_frac=float(frac.min()) if busy.size else 0.0,
        max_busy_frac=float(frac.max()) if busy.size else 0.0,
        timeline_imbalance=(
            float(busy.max() / mean_busy) if mean_busy > 0 else 1.0
        ),
    )


def worker_utilization(tracer: Tracer) -> dict:
    """Busy/idle fractions per worker from a live tracer's attributed spans.

    The window is the total duration of attributed steps (a step's
    wall time is its slowest worker's time, so the heaviest worker per step
    is busy for the whole step); worker ``p`` is busy for
    ``dur * cost_p / max_q cost_q`` of each step.
    """
    leaves = _attributed_leaves(tracer)
    nparts = max((len(tracer.spans[i].worker_costs) for i in leaves), default=0)
    busy = np.zeros(nparts, dtype=np.float64)
    window = 0.0
    for i in leaves:
        sp = tracer.spans[i]
        costs = np.asarray(sp.worker_costs, dtype=np.float64)
        cmax = costs.max() if costs.size else 0.0
        if cmax <= 0.0:
            continue
        window += sp.dur
        busy[: costs.shape[0]] += sp.dur * costs / cmax
    return _summarize(busy, window)


def utilization_from_file(path: str) -> dict:
    """Same report computed back from a written Chrome trace file.

    Reads the worker tracks' ``B``/``E`` pairs, so it validates that the
    exported file carries the full utilization picture on its own.
    """
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    tids = set()
    opens: dict[tuple, float] = {}
    busy: dict[int, float] = {}
    intervals: list[tuple[float, float]] = []
    for e in events:
        if e.get("pid") != WORKER_PID:
            continue
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                tids.add(e["tid"])
            continue
        if e["ph"] == "B":
            opens[(e["tid"], e["name"], e["ts"])] = e["ts"]
        elif e["ph"] == "E":
            # match the oldest open B on this tid (pairs are emitted B,E)
            key = next(k for k in opens if k[0] == e["tid"])
            t0 = opens.pop(key)
            busy[e["tid"]] = busy.get(e["tid"], 0.0) + (e["ts"] - t0) * 1e-6
            intervals.append((t0 * 1e-6, e["ts"] * 1e-6))
    nparts = (max(tids) + 1) if tids else 0
    busy_v = np.array([busy.get(p, 0.0) for p in range(nparts)])
    # window: union length of the busiest worker's view is not recoverable
    # exactly; use the per-step convention — the heaviest worker spans the
    # whole step — i.e. the maximum single-track busy time per step summed,
    # which equals the merged interval length of all busy intervals
    window, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo >= end:
            window += hi - lo
            end = hi
        elif hi > end:
            window += hi - end
            end = hi
    return _summarize(busy_v, window)


def memory_from_file(path: str) -> list[float] | None:
    """Per-worker peak device-memory bytes recovered from a written trace.

    :meth:`~repro_torch.obs.memory.MemoryMeter.flush` emits one
    ``mem_peak_w{p}_bytes`` gauge per worker; these land in the Chrome trace
    as ``C`` counter events, so the memory column of the report — like the
    utilization numbers — needs nothing but the trace file.  Returns
    ``None`` when the trace carries no memory gauges.
    """
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    peaks: dict[int, float] = {}
    for e in events:
        if e.get("ph") != "C" or not e["name"].startswith("mem_peak_w"):
            continue
        p = int(e["name"][len("mem_peak_w"):-len("_bytes")])
        # gauges re-emit on every flush: the last value is the run peak
        peaks[p] = float(e["args"][e["name"]])
    if not peaks:
        return None
    return [peaks.get(p, 0.0) for p in range(max(peaks) + 1)]


def utilization_table(util: dict, memory: list[float] | None = None) -> str:
    """Human-readable per-worker utilization summary table.

    ``memory`` (per-worker peak bytes, e.g. from :func:`memory_from_file`
    or ``MemoryMeter.worker_peak()``) adds a peak-MB column.
    """
    mem_col = memory is not None and len(memory) >= util["nparts"]
    header = f"{'worker':>6}  {'busy ms':>10}  {'busy %':>7}  {'idle %':>7}"
    if mem_col:
        header += f"  {'peak MB':>9}"
    lines = [
        f"traced window: {util['window_s'] * 1e3:.1f} ms over "
        f"{util['nparts']} workers   "
        f"timeline imbalance (max/mean busy): "
        f"{util['timeline_imbalance']:.2f}",
        header,
    ]
    for p in range(util["nparts"]):
        row = (
            f"{p:>6}  {util['busy_s'][p] * 1e3:>10.1f}  "
            f"{util['busy_frac'][p] * 100:>6.1f}%  "
            f"{util['idle_frac'][p] * 100:>6.1f}%"
        )
        if mem_col:
            row += f"  {memory[p] / 1e6:>9.2f}"
        lines.append(row)
    tail = (
        f"{'mean':>6}  {np.mean(util['busy_s']) * 1e3:>10.1f}  "
        f"{util['mean_busy_frac'] * 100:>6.1f}%  "
        f"{(1 - util['mean_busy_frac']) * 100:>6.1f}%"
    )
    if mem_col:
        tail += f"  {np.mean(memory[: util['nparts']]) / 1e6:>9.2f}"
    lines.append(tail)
    return "\n".join(lines)


def _locality_mode_line(mode: str, s: dict) -> str:
    return (f"  [{mode:10s}] locality {s['locality_flops'] * 100:5.1f}% of "
            f"flops / {s['locality_bytes'] * 100:5.1f}% of bytes   "
            f"shipped {s['shipped_bytes'] / 1e6:7.2f} MB   "
            f"wire {s['wire_recv_bytes'] / 1e6:7.2f} MB   "
            f"({s['dispatches']} dispatches)")


def locality_table(data: dict) -> str:
    """Human-readable render of one ``BENCH_locality.json`` payload.

    Per structure: static vs rebalanced locality fractions, the rebalanced
    run's per-worker locality split, its most-moved blocks, and the
    task-graph critical-path breakdown with what-if projections.
    """
    meta = data.get("meta", {})
    lines = [
        f"locality report: n={meta.get('n')} bs={meta.get('bs')} "
        f"workers={meta.get('workers')} "
        f"initial layout: {meta.get('initial_layout', '?')}"
    ]
    for name, row in sorted(data["locality"].items()):
        lines.append(f"\n== {name} ==")
        for mode in ("static", "rebalanced"):
            if mode in row:
                lines.append(_locality_mode_line(mode, row[mode]))
        detail = row.get("rebalanced") or row.get("static")
        if detail and detail.get("per_worker"):
            lines.append(
                f"  {'worker':>8}  {'local MB':>9}  {'shipped MB':>10}  "
                f"{'wire MB':>8}  {'loc flops':>9}  {'loc bytes':>9}")
            for w in detail["per_worker"]:
                lines.append(
                    f"  {w['worker']:>8}  {w['local_bytes'] / 1e6:>9.2f}  "
                    f"{w['shipped_bytes'] / 1e6:>10.2f}  "
                    f"{w['wire_recv_bytes'] / 1e6:>8.2f}  "
                    f"{w['locality_flops'] * 100:>8.1f}%  "
                    f"{w['locality_bytes'] * 100:>8.1f}%")
        if detail and detail.get("moved_blocks"):
            lines.append("  most-moved blocks (operand, Morton code, "
                         "fetches, owners -> fetchers):")
            for b in detail["moved_blocks"]:
                lines.append(
                    f"    {b['operand']}  code={b['code']:<8d} "
                    f"fetched {b['fetches']:>4d}x   "
                    f"owners {b['owners']} -> workers {b['fetchers']}")
        tg = row.get("taskgraph")
        if tg:
            before, after = tg["before"], tg.get("after")
            lines.append(
                f"  critical path (task-equivalents): "
                f"{before['critical_path']:.1f} = exchange "
                f"{before['cp_exchange']:.1f} + compute "
                f"{before['cp_compute']:.1f}   max busy "
                f"{max(before['busy']):.1f}   mean slack "
                f"{sum(before['slack']) / max(len(before['slack']), 1):.1f}")
            lines.append(
                f"  what-if: perfect balance "
                f"{before['whatif_perfect_balance']:.1f}   zero exchange "
                f"{before['whatif_zero_exchange']:.1f}"
                + (f"   rebalanced cut {after['critical_path']:.1f} "
                   f"(predicted gain {tg['predicted_gain']:.2f}x)"
                   if after else ""))
            rounds = sorted(before.get("rounds", []),
                            key=lambda r: -r["max_cost"])[:4]
            if rounds:
                lines.append("  heaviest exchange rounds: " + "   ".join(
                    f"{r['operand']}@+{r['offset']} {r['max_cost']:.1f}"
                    for r in rounds))
    return "\n".join(lines)


def locality_from_file(path: str) -> str:
    with open(path) as fh:
        return locality_table(json.load(fh))


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--locality":
        path = argv[1] if len(argv) > 1 else "BENCH_locality.json"
        print(locality_from_file(path))
        return 0
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.report <chrome-trace.json> | "
              "--locality [BENCH_locality.json]")
        return 2
    util = utilization_from_file(argv[0])
    print(utilization_table(util, memory=memory_from_file(argv[0])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
