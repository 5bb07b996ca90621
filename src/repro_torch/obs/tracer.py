"""The disabled tracer: every un-instrumented call site talks to it."""

from __future__ import annotations

from typing import Any

__all__ = ["NULL_TRACER", "NullTracer", "tracer_of"]


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


_NULL_HANDLE = _NullHandle()
_NULL_METRIC = _NullMetric()


class NullTracer:
    """The disabled tracer: falsy, allocation-free, records nothing."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, cat: str = "", **args: Any) -> _NullHandle:
        return _NULL_HANDLE

    def counter(self, name: str) -> _NullMetric:
        return _NULL_METRIC

    def sync(self, x: Any) -> Any:
        return x


NULL_TRACER = NullTracer()


def tracer_of(cache):
    """The tracer threaded through the runtime rides on the plan cache."""
    if cache is None:
        return NULL_TRACER
    tr = getattr(cache, "tracer", None)
    return tr if tr is not None else NULL_TRACER
