"""Structured event log + flight recorder — the greppable half of obs.

The tracer (:mod:`repro_torch.obs.tracer`) answers "where did the time go" after a
*successful* run; this module answers "what happened" after a *failed* one:

* :class:`EventLog` — a leveled, schema-stable structured log.  Every event
  is one flat JSON-safe dict carrying the stable envelope
  :data:`EVENT_KEYS` (``ts``/``seq``/``level``/``event``) followed by
  free-form payload fields.  Events stream to a JSONL file when a path is
  given and always land in a bounded in-memory ring buffer (``recent``) —
  the flight recorder's source.  Like the tracer, the log rides on the plan
  cache (``cache.event_log``) so the drivers, collectives and balancer all
  reach it via :func:`log_of` without new plumbing; :data:`NULL_LOG` is the
  disabled log every un-instrumented path sees — falsy, allocation-free,
  records nothing, so logging off cannot perturb numerics.
* :class:`FlightRecorder` — a postmortem dumper.  ``install(cache)`` hooks
  it onto the cache; when a :class:`~repro_torch.analysis.PlanError` is raised at
  plan admission, or a :class:`~repro_torch.core.inverse.RefineMonitor` /
  :class:`~repro_torch.core.purify.Sp2Monitor` divergence trip fires, the
  instrumented site calls :meth:`FlightRecorder.dump` and the recorder
  writes one JSON file with the stable envelope :data:`POSTMORTEM_KEYS`:
  the last N closed spans and instants, counter totals and deltas since the
  last :meth:`mark`, the ring buffer of recent log events, the plan-cache
  stats and the last plan key — everything needed to reconstruct the final
  iterations of a run that died.

Timestamps are epoch seconds (``time.time``), not the tracer's monotonic
clock: log lines are correlated with *external* systems (CI logs, other
processes), where the span timeline is correlated with itself.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, IO

from .export import _json_safe
from .tracer import tracer_of

__all__ = [
    "EVENT_KEYS",
    "POSTMORTEM_KEYS",
    "LEVELS",
    "EventLog",
    "NullEventLog",
    "NULL_LOG",
    "log_of",
    "FlightRecorder",
    "load_events",
]

#: severity vocabulary, in increasing order
LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

#: the stable envelope every event record starts with, in order — schema
#: stability is tested like SHARED_ITER_KEYS
EVENT_KEYS = ("ts", "seq", "level", "event")

#: the stable top-level schema of a flight-recorder postmortem file
POSTMORTEM_KEYS = (
    "reason",
    "ts",
    "detail",
    "spans",
    "instants",
    "counters",
    "counter_deltas",
    "events",
    "cache",
    "last_plan_key",
)


class EventLog:
    """Leveled structured log: JSONL stream + bounded ring buffer.

    ``path`` may be a filesystem path (opened line-buffered in append mode)
    or an open file-like object; ``None`` keeps events in memory only.
    ``level`` filters at emit time — events below it cost one dict lookup
    and nothing else.  ``capacity`` bounds ``recent``, the ring buffer the
    flight recorder snapshots.  ``clock`` is injectable for deterministic
    tests and defaults to epoch seconds.
    """

    enabled = True

    def __init__(self, path: str | IO | None = None, *, level: str = "info",
                 capacity: int = 512, clock=time.time):
        if level not in LEVELS:
            raise ValueError(f"level={level!r} not in {sorted(LEVELS)}")
        self.level = level
        self._threshold = LEVELS[level]
        self._clock = clock
        self.seq = 0
        self.recent: deque = deque(maxlen=int(capacity))
        if isinstance(path, str):
            self._fh: IO | None = open(path, "a", buffering=1)
            self._own_fh = True
        else:
            self._fh = path
            self._own_fh = False
        self.path = path if isinstance(path, str) else None

    def __bool__(self) -> bool:
        return True

    @property
    def debug_enabled(self) -> bool:
        """True when debug-level events survive the filter — per-iteration
        call sites guard on this so building the field dict costs nothing
        at ``info`` and above."""
        return self._threshold <= LEVELS["debug"]

    def emit(self, level: str, event: str, **fields: Any) -> dict | None:
        """Record one event; returns the record, or None when filtered."""
        if LEVELS[level] < self._threshold:
            return None
        rec = dict(ts=float(self._clock()), seq=self.seq, level=level,
                   event=str(event))
        rec.update(_json_safe(fields))
        self.seq += 1
        self.recent.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    # -- convenience levels --------------------------------------------------
    def debug(self, event: str, **fields: Any) -> dict | None:
        return self.emit("debug", event, **fields)

    def info(self, event: str, **fields: Any) -> dict | None:
        return self.emit("info", event, **fields)

    def warn(self, event: str, **fields: Any) -> dict | None:
        return self.emit("warn", event, **fields)

    def error(self, event: str, **fields: Any) -> dict | None:
        return self.emit("error", event, **fields)

    def events_of(self, event: str, level: str | None = None) -> list[dict]:
        """Matching records still in the ring buffer, in emit order."""
        return [r for r in self.recent
                if r["event"] == event and (level is None or r["level"] == level)]

    def close(self) -> None:
        if self._own_fh and self._fh is not None:
            self._fh.close()
            self._fh = None


class NullEventLog:
    """The disabled log: falsy, allocation-free, records nothing."""

    enabled = False
    debug_enabled = False
    level = "off"
    seq = 0
    recent: tuple = ()

    def __bool__(self) -> bool:
        return False

    def emit(self, level: str, event: str, **fields: Any) -> None:
        return None

    def debug(self, event: str, **fields: Any) -> None:
        return None

    def info(self, event: str, **fields: Any) -> None:
        return None

    def warn(self, event: str, **fields: Any) -> None:
        return None

    def error(self, event: str, **fields: Any) -> None:
        return None

    def events_of(self, event: str, level: str | None = None) -> list:
        return []

    def close(self) -> None:
        pass


NULL_LOG = NullEventLog()


def log_of(cache) -> EventLog | NullEventLog:
    """The event log threaded through the runtime rides on the plan cache."""
    if cache is None:
        return NULL_LOG
    lg = getattr(cache, "event_log", None)
    return lg if lg is not None else NULL_LOG


def load_events(path: str) -> list[dict]:
    """Parse a JSONL event-log file back into records (postmortem grepping)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _span_record(sp) -> dict:
    rec = dict(name=sp.name, cat=sp.cat, t0=float(sp.t0), dur=float(sp.dur),
               parent=int(sp.parent), args=_json_safe(sp.args))
    if sp.worker_costs is not None:
        rec["worker_costs"] = _json_safe(dict(c=sp.worker_costs))["c"]
    return rec


class FlightRecorder:
    """Bounded postmortem recorder riding on the plan cache.

    ``install(cache)`` attaches the recorder as ``cache.flight_recorder``;
    the plan-cache admission hook and the drivers' divergence trips then
    find it via ``getattr`` and call :meth:`dump` with a reason.  Drivers
    call :meth:`mark` once per iteration so a dump carries counter *deltas*
    over the final iteration, not just totals since run start.
    """

    def __init__(self, path: str = "postmortem.json", *,
                 last_spans: int = 64, last_events: int = 128,
                 clock=time.time):
        self.path = path
        self.last_spans = int(last_spans)
        self.last_events = int(last_events)
        self._clock = clock
        self._marked: dict = {}
        self.dumps = 0

    def install(self, cache) -> "FlightRecorder":
        cache.flight_recorder = self
        return self

    def mark(self, cache) -> None:
        """Snapshot counter totals; the next dump reports deltas vs here."""
        tr = tracer_of(cache)
        self._marked = dict(tr.metrics_flat()) if tr.enabled else {}

    def snapshot(self, reason: str, cache=None, **detail: Any) -> dict:
        """Assemble (but do not write) a postmortem record."""
        tr = tracer_of(cache)
        lg = log_of(cache)
        spans = [_span_record(sp) for sp in list(tr.spans)[-self.last_spans:]]
        instants = [
            dict(name=n, cat=c, ts=float(t), args=_json_safe(a))
            for (n, c, t, _p, a) in list(tr.instants)[-self.last_spans:]
        ]
        counters = dict(tr.metrics_flat()) if tr.enabled else {}
        deltas = {k: v - self._marked.get(k, 0.0)
                  for k, v in counters.items()
                  if isinstance(v, (int, float))}
        events = list(lg.recent)[-self.last_events:] if lg.enabled else []
        return dict(
            reason=str(reason),
            ts=float(self._clock()),
            detail=_json_safe(detail),
            spans=spans,
            instants=instants,
            counters=counters,
            counter_deltas=deltas,
            events=events,
            cache=cache.stats() if cache is not None else None,
            last_plan_key=(
                str(cache.last_plan_key)
                if cache is not None and getattr(cache, "last_plan_key", None)
                is not None else None),
        )

    def dump(self, reason: str, cache=None, **detail: Any) -> str:
        """Write the postmortem file; returns its path.

        Never raises: the recorder fires on the failure path, and a broken
        postmortem write must not mask the original error.
        """
        post = self.snapshot(reason, cache, **detail)
        self.dumps += 1
        try:
            with open(self.path, "w") as fh:
                json.dump(post, fh, indent=2, default=str)
                fh.write("\n")
        except OSError:
            return self.path
        lg = log_of(cache)
        if lg.enabled:
            lg.error("postmortem", reason=str(reason), path=self.path)
        tr = tracer_of(cache)
        if tr.enabled:
            tr.instant("postmortem", cat="health", reason=str(reason),
                       path=self.path)
        return self.path
