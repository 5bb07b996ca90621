"""Typed verification errors (the verifier itself is not ported yet)."""

from .errors import PlanError, Violation

__all__ = ["PlanError", "Violation"]
