"""Structure-keyed plan cache — the chunk-cache analogue of the CHT runtime.

CHT workers cache the chunks tasks touch so iterative algorithms stop paying
for re-fetches once their access pattern stabilizes.  The resident runtime's
equivalents of those re-fetches are (a) host-side symbolic planning and (b)
shipping plan index arrays to the device.  :class:`PlanCache` memoizes both
behind a key derived from
:func:`repro_torch.core.quadtree.structure_fingerprint` of the operand
structures (Morton codes + owner maps) plus the schedule knobs (nparts,
exchange mode, impl, dtypes, precision).  Every iteration after the sparsity
pattern stabilizes is a pure cache hit: no planning, no host->device index
transfer.

The generic LRU + hit/miss machinery lives in
:class:`repro_torch.core.cache.SymbolicCache`, which the single-device
symbolic phases share; ``PlanCache`` is its distributed-plan face.
"""

from __future__ import annotations

from ..core.cache import SymbolicCache

__all__ = ["PlanCache"]


class PlanCache(SymbolicCache):
    """LRU cache from structure keys to built plans/executables.

    Keys are hashable tuples prefixed with a kind tag (``"spgemm"`` /
    ``"spamm"`` / ``"spamm-delta"`` / ``"norms"``); per-kind hit/miss counts
    surface in :meth:`stats`.  Values are whatever the builder returns —
    typically a ``(plan, executable)`` pair whose executable holds the plan's
    index arrays on the device.  Every key fingerprints the operand owner
    maps, so a re-layout re-keys downstream plans automatically.

    Admission runs the static verifier (:mod:`repro_torch.analysis`) per
    the ``verify=`` policy inherited from :class:`SymbolicCache`: the
    default ``"cached-once"`` re-proves every plan and every add / compact /
    relayout / norm-table executable once, on the miss path — a zero-miss
    replay (the stabilized steady state) never verifies and pays nothing —
    while ``"always"`` re-verifies on every hit and ``"off"`` disables the
    hook.  Violations raise :class:`repro_torch.analysis.PlanError` before
    the bad plan is cached.
    """
