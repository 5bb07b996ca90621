"""The disabled structured event log."""

from __future__ import annotations

from typing import Any

__all__ = ["NULL_LOG", "NullEventLog", "log_of"]


class NullEventLog:
    """The disabled log: falsy, allocation-free, records nothing."""

    enabled = False
    debug_enabled = False

    def __bool__(self) -> bool:
        return False

    def debug(self, event: str, **fields: Any) -> None:
        return None

    def info(self, event: str, **fields: Any) -> None:
        return None

    def warn(self, event: str, **fields: Any) -> None:
        return None


NULL_LOG = NullEventLog()


def log_of(cache):
    """The event log threaded through the runtime rides on the plan cache."""
    if cache is None:
        return NULL_LOG
    lg = getattr(cache, "event_log", None)
    return lg if lg is not None else NULL_LOG
