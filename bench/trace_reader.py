"""Read a ``torch.profiler`` trace (Chrome trace JSON) over the benchmark's window.

* busy time: the union of the device's kernel, copy and set intervals inside
  the window, so that overlapping operations count once;
* device time by operation, under the profiler's names;
* idle gaps: the stretches of the window in which no device operation ran,
  each named by what the host was doing at its middle: the benchmark's
  innermost span (``bench.call``, ``bench.sync``) and the innermost host
  operation inside it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: dict  # name -> device seconds inside the window
    idle_gaps: dict  # host activity -> idle device seconds inside the window

    def device_seconds(self, contains: str) -> float:
        """Device seconds of the operations whose name contains ``contains``."""
        return sum(s for name, s in self.device_ops.items() if contains in name)

    def top(self, which: str, k: int = 10) -> list:
        items = sorted(getattr(self, which).items(), key=lambda kv: -kv[1])
        return [[name, seconds] for name, seconds in items[:k]]


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(trace: dict, window: str = "bench.window") -> TraceSummary | None:
    """The window's summary, or ``None`` where the trace holds no span ``window``."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == window]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    device_ops: dict = {}
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            intervals.append((s, t))
            device_ops[e["name"]] = device_ops.get(e["name"], 0.0) + (t - s) * 1e-6
    busy = _union(intervals)
    gaps, cur = [], w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if cur < w1:
        gaps.append((cur, w1))
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != window]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    idle: dict = {}
    for s, t in gaps:
        mid = 0.5 * (s + t)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        ours = [i for i in inside if host[i]["name"].startswith(SPAN_PREFIX)]
        theirs = [i for i in inside if not host[i]["name"].startswith(SPAN_PREFIX)]
        label = host[min(ours, key=lambda i: ends[i] - starts[i])]["name"] if ours else "outside spans"
        if theirs:
            label += " > " + host[min(theirs, key=lambda i: ends[i] - starts[i])]["name"]
        idle[label] = idle.get(label, 0.0) + (t - s) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=sum(t - s for s, t in busy) * 1e-6,
                        device_ops=device_ops, idle_gaps=idle)
