"""The runtime's one wall clock and the accumulate-into-attribute timer."""

from __future__ import annotations

from time import perf_counter

from .tracer import NULL_TRACER, tracer_of

__all__ = ["timed_into", "wall_clock", "Stopwatch", "IterationScope", "SHARED_ITER_KEYS"]


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


# the per-iteration row keys both iterative drivers (dist_sp2_purify,
# dist_localized_inverse_factorization) emit
SHARED_ITER_KEYS = (
    "iteration",
    "nnzb",
    "spamm_err",
    "recv_bytes_mean",
    "norm_fetch_bytes",
    "imbalance",
    "imbalance_after",
    "migrated_bytes",
    "wall_s",
    "cache_hits",
    "cache_misses",
    "plan_build_s",
    "symbolic_s",
)

_ROW_DEFAULTS = dict(
    nnzb=0,
    spamm_err=0.0,
    recv_bytes_mean=0.0,
    norm_fetch_bytes=0,
    imbalance=None,
    imbalance_after=None,
    migrated_bytes=0,
)


class IterationScope:
    """One driver iteration (or named stage): span + cache snapshot + clock.

    ``delta()`` returns the wall/cache-counter deltas accumulated so far
    (the stage rows of :func:`~repro_torch.dist.purify.dist_sqrt_inv_pipeline`);
    ``row(**fields)`` additionally fills the shared per-iteration schema
    (:data:`SHARED_ITER_KEYS`) with uniform defaults so every driver's rows
    carry the same keys for the same meanings.  The wall clock is the
    host's: it covers device work only where the body waited for it.
    """

    __slots__ = ("_cache", "_tracer", "_name", "_cat", "_args", "_handle",
                 "_snap", "_t0", "iteration")

    def __init__(self, cache, iteration=None, tracer=None,
                 name: str = "iteration", cat: str = "iteration", **args):
        self._cache = cache
        self._tracer = tracer if tracer is not None else tracer_of(cache)
        self._name = name
        self._cat = cat
        self._args = args
        self._handle = None
        self.iteration = iteration

    def __enter__(self):
        if self._tracer.enabled:
            args = dict(self._args)
            if self.iteration is not None:
                args["i"] = self.iteration
            self._handle = self._tracer.span(self._name, cat=self._cat, **args)
            self._handle.__enter__()
        self._snap = self._cache.snapshot() if self._cache is not None else None
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        if self._handle is not None:
            self._handle.__exit__(*exc)
            self._handle = None
        return None

    def annotate(self, **args) -> None:
        """Attach extra attrs to the iteration span (before scope exit).

        The span handle is released on ``__exit__``, so per-iteration
        annotations (the locality ledger's fraction fields) must land while
        the scope is still open; a no-op when tracing is disabled.
        """
        if self._handle is not None:
            self._handle.args.update(args)

    def delta(self) -> dict:
        """wall seconds + cache counter deltas accumulated in this scope."""
        out = dict(wall_s=perf_counter() - self._t0)
        if self._snap is not None:
            out.update(self._cache.delta(self._snap))
        else:
            out.update(cache_hits=0, cache_misses=0, plan_build_s=0.0, symbolic_s=0.0)
        return out

    def row(self, **fields) -> dict:
        """The shared per-iteration stats row, driver extras appended."""
        out = dict(iteration=self.iteration, **_ROW_DEFAULTS)
        out.update(self.delta())
        out.update(fields)
        missing = set(SHARED_ITER_KEYS) - out.keys()
        assert not missing, f"iteration row missing shared keys: {missing}"
        return out
