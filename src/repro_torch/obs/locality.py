"""Per-iteration locality emission of the iterative drivers.

The JAX package's locality ledger (``repro/obs/locality.py``) accounts the
flops and bytes each iteration ran local versus remote; it rides on the plan
cache as ``cache.locality_ledger``.  The ledger itself is not ported, so
nothing in this package installs one and the drivers take the no-ledger
branch: :func:`locality_snapshot` returns ``None`` and
:func:`locality_iteration` an empty dict, at the cost of one ``getattr``.
"""

from __future__ import annotations

__all__ = ["ledger_of", "locality_snapshot", "locality_iteration"]


def ledger_of(cache):
    """The ledger riding on the plan cache, or None when not installed."""
    if cache is None:
        return None
    return getattr(cache, "locality_ledger", None)


def _no_ledger(cache) -> None:
    if ledger_of(cache) is not None:
        raise NotImplementedError("the locality ledger (obs/locality.py) is not ported yet")


def locality_snapshot(cache) -> tuple | None:
    """Iteration-top ledger snapshot; None when no ledger is installed."""
    _no_ledger(cache)
    return None


def locality_iteration(cache, scope, snap: tuple | None, *, iteration, driver: str) -> dict:
    """Per-iteration locality row fields; empty when no ledger is installed."""
    _no_ledger(cache)
    return {}
