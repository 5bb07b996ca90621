"""Typed verification errors — shared by the planner and the static verifier.

Pure dataclasses with no torch/numpy imports, so that low layers can raise
:class:`PlanError` without an import cycle with a verifier.  A copy of the
JAX package's ``repro/analysis/errors.py``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Violation", "PlanError"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One verified-false invariant, with enough provenance to debug it.

    ``check`` is a stable kebab-case id (``send-conflict`` /
    ``src-off-oob`` / ``round-permutation`` / ``use-before-receive`` /
    ``c-slot-race`` / ``c-slot-order`` / ``accumulation-order`` /
    ``owner-fingerprint`` / ``owner-map`` / ``mask-redirect`` /
    ``capacity-mismatch`` / ``exchange-starvation`` / ``task-gidx`` /
    ``operand-mismatch`` / ``send-oob`` / ``gather-gap`` / ``norm-scatter``);
    ``provenance`` carries the task/round/device coordinates of the failure.
    """

    check: str
    message: str
    provenance: dict = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        where = ", ".join(f"{k}={v}" for k, v in self.provenance.items())
        return f"[{self.check}] {self.message}" + (f" ({where})" if where else "")


class PlanError(RuntimeError):
    """A plan (or pinned plan input) violates a scheduling invariant.

    Raised by the symbolic-cache admission hook
    (:meth:`repro_torch.core.cache.SymbolicCache.get_or_build`) when the
    verifier reports violations.  Unlike a bare ``assert``, this survives
    ``python -O``.
    """

    def __init__(self, message: str, violations: tuple | list = ()):
        super().__init__(message)
        self.violations = tuple(violations)
