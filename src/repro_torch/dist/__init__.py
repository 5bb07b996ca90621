"""Device-resident distributed matrix runtime — the CHT worker-storage layer.

The paper's CHT-MPI runtime keeps chunks resident in worker storage and
caches the chunks tasks touch, so iterative algorithms never re-ship
operands between operations.  This package is that layer for P workers
living on one card (the worker axis leads every store, see
:mod:`repro_torch.core.distributed`):

* :class:`DistBSMatrix` (:mod:`repro_torch.dist.matrix`) — a block-sparse
  matrix whose padded per-worker stores ``[P, cap, bs, bs]`` stay on the
  device *across* operations; host-side structure (coords, owner, slot
  maps); enters via :func:`scatter`, leaves via :meth:`DistBSMatrix.gather`.
* :class:`PlanCache` (:mod:`repro_torch.dist.cache`) — structure-keyed cache
  of symbolic plans and executables (index arrays on the device), with
  hit/miss metrics.
* :func:`dist_multiply` / :func:`dist_spamm` (:mod:`repro_torch.dist.multiply`)
  — C = A @ B on resident operands through the cached schedule and, by
  default, the fused leaf engine's CUDA kernel; SpAMM prunes hierarchically
  with an error bound <= tau, by default as a *delta plan* whose task mask
  also prunes the exchange.

The resident collectives, the SP2 / inverse drivers and the load balancer
of the JAX package's ``repro.dist`` are still to port.
"""

from .cache import PlanCache
from .matrix import (
    DistBSMatrix,
    NormTableExecutable,
    dist_zeros,
    mesh_key,
    resident_block_norms,
    scatter,
)
from .multiply import (
    dist_multiply,
    dist_spamm,
    multiply_plan_key,
    spamm_delta_plan_key,
)

__all__ = [
    "DistBSMatrix",
    "NormTableExecutable",
    "scatter",
    "dist_zeros",
    "mesh_key",
    "resident_block_norms",
    "PlanCache",
    "dist_multiply",
    "dist_spamm",
    "multiply_plan_key",
    "spamm_delta_plan_key",
]
