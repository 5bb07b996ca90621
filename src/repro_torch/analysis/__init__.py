"""Static analysis for the resident runtime — the plan verifier and its
seeded corruptions.

Only :mod:`repro_torch.analysis.errors` (pure dataclasses) is imported
eagerly so low layers (``repro_torch.core.schedule``) can raise
:class:`PlanError` without a cycle; the verifier and the corruptions load
lazily on first attribute access.
"""

from __future__ import annotations

from .errors import PlanError, Violation

__all__ = [
    "PlanError",
    "Violation",
    "verify_spgemm_plan",
    "verify_task_mask",
    "verify_relayout_plan",
    "verify_norm_table",
    "verify_value",
    "CORRUPTIONS",
]

_LAZY = {
    "verify_spgemm_plan": "verify",
    "verify_task_mask": "verify",
    "verify_relayout_plan": "verify",
    "verify_norm_table": "verify",
    "verify_value": "verify",
    "CORRUPTIONS": "mutate",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
