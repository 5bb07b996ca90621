"""The runtime's one wall clock and the accumulate-into-attribute timer."""

from __future__ import annotations

from time import perf_counter

from .tracer import NULL_TRACER

__all__ = ["timed_into", "wall_clock", "Stopwatch"]


def wall_clock() -> float:
    """The runtime's one wall clock (monotonic seconds)."""
    return perf_counter()


class Stopwatch:
    """Minimal elapsed-seconds helper over :func:`wall_clock`.

    ``elapsed()`` reads without resetting; ``lap()`` reads and restarts.
    """

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = perf_counter()

    def restart(self) -> None:
        self._t0 = perf_counter()

    def elapsed(self) -> float:
        return perf_counter() - self._t0

    def lap(self) -> float:
        now = perf_counter()
        dt = now - self._t0
        self._t0 = now
        return dt


class timed_into:
    """``with timed_into(cache, "build_s", tracer, "plan_build"): ...``

    Accumulates the body's wall time onto ``obj.attr`` (skipped when ``obj``
    is None) and records a tracer span (skipped when ``name`` is None or the
    tracer is disabled).  ``elapsed`` holds the measured seconds after exit.
    """

    __slots__ = ("_obj", "_attr", "_tracer", "_name", "_cat", "_args",
                 "_handle", "_t0", "elapsed")

    def __init__(self, obj, attr: str, tracer=None, name: str | None = None,
                 cat: str = "symbolic", **args):
        self._obj = obj
        self._attr = attr
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._name = name
        self._cat = cat
        self._args = args
        self._handle = None
        self.elapsed = 0.0

    def __enter__(self):
        if self._name is not None and self._tracer.enabled:
            self._handle = self._tracer.span(self._name, cat=self._cat,
                                             **self._args)
            self._handle.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = perf_counter() - self._t0
        if self._handle is not None:
            self._handle.__exit__(*exc)
        obj = self._obj
        if obj is not None:
            setattr(obj, self._attr, getattr(obj, self._attr) + self.elapsed)
        return None
