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

    ``verify=`` is the admission policy inherited from
    :class:`SymbolicCache`.  The port's verifier hook recognises no value
    yet (the JAX package's plan verifier, ``repro/analysis/verify.py``, is
    still to port), so admission proves nothing and costs nothing.
    """
