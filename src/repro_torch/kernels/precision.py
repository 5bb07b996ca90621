"""Norm-aware mixed-precision policy for the fused leaf engine.

SpAMM's error analysis already ranks every task by ``||A_t||_F ||B_t||_F``
— the same bound that controls what pruning may drop also controls what
*rounding* may perturb: storing a task's operand tiles in bfloat16 changes
the product by at most ``(2u + u^2) ||A_t||_F ||B_t||_F`` with ``u`` the
bf16 unit roundoff, so tasks with small norm products tolerate low
precision *by construction*.  :class:`Precision` names the three modes the
drivers thread through (``precision=`` on ``dist_multiply`` /
``dist_spamm`` / the SP2 and inverse drivers):

* ``fp32``   — everything exact single precision (the default).
* ``bf16``   — operand blocks are cast to bfloat16 *before* the exchange
  (halving exchange payload bytes) and multiplied with fp32 accumulation.
* ``adaptive`` — operands stay fp32 on the wire; per task, the fused kernel
  rounds the operand tiles to bf16 when the task was selected by
  :func:`low_precision_task_mask` under the ``tau`` error budget.

Accumulation is always fp32, matching the paper's dtype discipline of
32-bit defaults with selectively relaxed storage.

This module is numpy only and is the JAX package's
``repro/kernels/precision.py`` as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Precision",
    "FP32",
    "BF16",
    "low_precision_task_mask",
    "EPS_BF16",
    "ROUND2_BOUND",
]

# bfloat16 unit roundoff: 8 significand bits (incl. hidden) -> u = 2^-8.
# Used pessimistically; round-to-nearest actually gives 2^-9.
EPS_BF16 = 2.0**-8
# first-order bound on || fl(A)fl(B) - AB ||_F / (||A||_F ||B||_F) when both
# operands are rounded once: (1+u)^2 - 1 = 2u + u^2
ROUND2_BOUND = 2.0 * EPS_BF16 + EPS_BF16 * EPS_BF16


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy threaded through the distributed drivers.

    ``tau`` is the adaptive mode's Frobenius error budget per multiply; with
    ``tau == 0`` the drivers substitute their SpAMM tau, so one knob bounds
    prune + rounding error together.  ``fp32`` / ``bf16`` ignore ``tau``.
    """

    mode: str = "fp32"  # fp32 | bf16 | adaptive
    tau: float = 0.0

    def __post_init__(self):
        assert self.mode in ("fp32", "bf16", "adaptive"), self.mode
        assert self.tau >= 0.0, self.tau

    def key(self) -> tuple:
        """Plan-cache key component — the compiled program differs per mode."""
        return (self.mode, float(self.tau) if self.mode == "adaptive" else 0.0)

    @property
    def is_mixed(self) -> bool:
        return self.mode != "fp32"

    def budget(self, fallback_tau: float = 0.0) -> float:
        """Adaptive error budget: own tau, else the caller's SpAMM tau."""
        return self.tau if self.tau > 0.0 else float(fallback_tau)


FP32 = Precision("fp32")
BF16 = Precision("bf16")


def low_precision_task_mask(
    a_norms: np.ndarray,
    b_norms: np.ndarray,
    a_idx: np.ndarray,
    b_idx: np.ndarray,
    budget: float,
    *,
    eligible: np.ndarray | None = None,
) -> tuple[np.ndarray, float]:
    """Select the tasks whose bf16 rounding error fits inside ``budget``.

    Per-task bound: ``ROUND2_BOUND * ||A_t||_F * ||B_t||_F``.  Greedy
    smallest-bound-first selection keeps the summed bound <= budget (the
    triangle inequality makes the per-task bounds additive), which is the
    same budget-spending rule hierarchical SpAMM uses for pruning.

    ``eligible`` masks tasks that may be selected (delta-plan callers pass
    the kept-task mask: a pruned task contributes zero error and must not
    consume budget).  Returns ``(mask [T] bool, spent_bound)``.
    """
    a_idx = np.asarray(a_idx)
    b_idx = np.asarray(b_idx)
    T = a_idx.shape[0]
    mask = np.zeros(T, dtype=bool)
    if T == 0 or budget <= 0.0:
        return mask, 0.0
    per = ROUND2_BOUND * np.asarray(a_norms, np.float64)[a_idx] * np.asarray(
        b_norms, np.float64
    )[b_idx]
    if eligible is not None:
        cand = np.nonzero(np.asarray(eligible, dtype=bool))[0]
    else:
        cand = np.arange(T)
    if cand.size == 0:
        return mask, 0.0
    order = cand[np.argsort(per[cand], kind="stable")]
    csum = np.cumsum(per[order])
    k = int(np.searchsorted(csum, budget, side="right"))
    mask[order[:k]] = True
    return mask, float(csum[k - 1]) if k else 0.0
