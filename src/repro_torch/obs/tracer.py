"""The disabled tracer: every un-instrumented call site talks to it."""

from __future__ import annotations

from typing import Any

__all__ = ["NULL_TRACER", "NullTracer", "run_metrics", "tracer_of"]


class _NullHandle:
    """Reusable no-op span context."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


class _NullMetric:
    __slots__ = ()
    value = 0.0

    def add(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass


_NULL_HANDLE = _NullHandle()
_NULL_METRIC = _NullMetric()


class NullTracer:
    """The disabled tracer: falsy, allocation-free, records nothing."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, cat: str = "", **args: Any) -> _NullHandle:
        return _NULL_HANDLE

    def instant(self, name: str, cat: str = "", **args: Any) -> None:
        return None

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def metrics_flat(self) -> dict:
        return {}

    def sync(self, x: Any) -> Any:
        return x


NULL_TRACER = NullTracer()


def tracer_of(cache):
    """The tracer threaded through the runtime rides on the plan cache."""
    if cache is None:
        return NULL_TRACER
    tr = getattr(cache, "tracer", None)
    return tr if tr is not None else NULL_TRACER


def run_metrics(cache=None, tracer=None) -> dict:
    """The flat metrics dict the driver stats dataclasses wrap.

    The cache's counters (hits / misses / hit_rate / build_s / symbolic_s /
    by_kind) merged with every counter and gauge of the tracer; with the
    disabled tracer this is exactly ``cache.stats()``.
    """
    tr = tracer if tracer is not None else tracer_of(cache)
    out: dict = dict(cache.stats()) if cache is not None else {}
    out.update(tr.metrics_flat())
    return out
