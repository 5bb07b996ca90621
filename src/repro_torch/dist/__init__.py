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
* the resident collectives (:mod:`repro_torch.dist.collectives`): add,
  scale, trace, Frobenius norm, leaf and hierarchical truncation,
  owner-inheriting transpose, owner re-layout, quadrant slice and glue.
* the iterative drivers: SP2 purification, Lanczos spectral bounds and the
  S -> Z -> Z^T H Z -> SP2 -> Z D Z^T pipeline (:mod:`repro_torch.dist.purify`),
  and the inverse factorization (:mod:`repro_torch.dist.inverse`).  They
  run on the mesh's device; a host operand needs an explicit mesh.
* dynamic load balancing (:mod:`repro_torch.dist.balance`): a measured
  per-worker cost model and a policy that re-lays operands out through
  :func:`dist_repartition`; the drivers and the multiplies take
  ``rebalance=``.

The drivers' ``tracer=``, ``log=`` and ``health=`` need the observability
layer of the JAX package (``repro.obs``), which is not ported: anything but
``None`` raises ``NotImplementedError``.
"""

from .balance import (
    LoadMonitor,
    RebalancePolicy,
    WorkerLoad,
    owner_imbalance,
    rebalanced_owner,
    worker_load,
)
from .cache import PlanCache
from .collectives import (
    dist_add,
    dist_assemble2x2,
    dist_frobenius_norm,
    dist_repartition,
    dist_scale,
    dist_submatrix,
    dist_trace,
    dist_transpose,
    dist_truncate,
    dist_truncate_hierarchical,
    transpose_permutation,
)
from .inverse import DistInverseStats, dist_inv_chol, dist_localized_inverse_factorization
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
from .purify import (
    DistPurifyStats,
    SqrtInvPipelineStats,
    dist_lanczos_bounds,
    dist_sp2_purify,
    dist_sqrt_inv_pipeline,
)

__all__ = [
    "DistBSMatrix",
    "NormTableExecutable",
    "scatter",
    "dist_zeros",
    "mesh_key",
    "resident_block_norms",
    "PlanCache",
    "dist_add",
    "dist_scale",
    "dist_trace",
    "dist_frobenius_norm",
    "dist_transpose",
    "dist_repartition",
    "dist_submatrix",
    "dist_assemble2x2",
    "transpose_permutation",
    "dist_truncate",
    "dist_truncate_hierarchical",
    "dist_multiply",
    "dist_spamm",
    "multiply_plan_key",
    "spamm_delta_plan_key",
    "dist_inv_chol",
    "dist_localized_inverse_factorization",
    "DistInverseStats",
    "dist_sp2_purify",
    "DistPurifyStats",
    "dist_lanczos_bounds",
    "dist_sqrt_inv_pipeline",
    "SqrtInvPipelineStats",
    "RebalancePolicy",
    "LoadMonitor",
    "WorkerLoad",
    "worker_load",
    "owner_imbalance",
    "rebalanced_owner",
]
