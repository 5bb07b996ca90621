"""The synthetic token pipeline (host numpy; every batch a function of ``(seed, step)``)."""

from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
