"""The disabled structured event log."""

from __future__ import annotations

from typing import Any

__all__ = ["NULL_LOG", "NullEventLog"]


class NullEventLog:
    """The disabled log: falsy, allocation-free, records nothing."""

    enabled = False
    debug_enabled = False

    def __bool__(self) -> bool:
        return False

    def debug(self, event: str, **fields: Any) -> None:
        return None


NULL_LOG = NullEventLog()
