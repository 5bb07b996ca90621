"""Device-resident distributed block-sparse matrix.

:class:`DistBSMatrix` is the persistent distributed object the CHT runtime
keeps in worker chunk storage: the *values* live as one padded store
``[P, cap, bs, bs]`` — the worker axis leading, on the mesh's one device —
and STAY there across operations; the *structure* (Morton-sorted block
coords plus the owner / slot placement maps) lives on the host where all
symbolic decisions are made.  A matrix enters the mesh once via
:func:`scatter` and leaves only at the algorithm boundary via
:meth:`DistBSMatrix.gather`.

Layout invariants (relied on by every planner):

* ``owner[g]`` is the worker holding global block ``g``; ``slot[g]`` is its
  row in that worker's store, and slots are assigned in ascending global
  (Morton) order within each owner — exactly
  :func:`repro_torch.core.schedule._owner_slots`.
* ``cap == max(blocks per worker, 1)``; store rows past a worker's last
  valid slot are padding — every consumer masks by validity rather than
  assuming zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.distributed import WorkerMesh, _upload
from ..core.matrix import BSMatrix, _to_numpy, block_frobenius_norms
from ..core.quadtree import morton_encode, structure_fingerprint
from ..core.schedule import _owner_slots, partition_morton
from ..obs.tracer import tracer_of

__all__ = [
    "DistBSMatrix",
    "NormTableExecutable",
    "scatter",
    "dist_zeros",
    "mesh_key",
    "resident_block_norms",
]


def mesh_key(mesh: WorkerMesh) -> tuple:
    """Identity of a mesh — part of every plan-cache key, so a shared
    PlanCache never replays an executable built for another mesh."""
    return (str(mesh.device), int(mesh.nparts))


@dataclasses.dataclass(frozen=True)
class DistBSMatrix:
    """Block-sparse matrix resident on a worker mesh.

    Attributes:
      shape:  logical (rows, cols).
      bs:     leaf block size.
      coords: host [nnzb, 2] block (row, col), Morton sorted.
      owner:  host [nnzb] int32 — worker holding each block.
      slot:   host [nnzb] int32 — row within the owner's store.
      cap:    store rows per worker (max blocks on any worker, >= 1).
      store:  torch [P, cap, bs, bs] on the mesh's device; rows past a
              worker's valid count are padding.
      mesh:   the worker mesh the store lives on.
    """

    shape: tuple[int, int]
    bs: int
    coords: np.ndarray
    owner: np.ndarray
    slot: np.ndarray
    cap: int
    store: torch.Tensor
    mesh: WorkerMesh

    def __post_init__(self):
        assert self.coords.ndim == 2 and self.coords.shape[1] == 2
        assert self.owner.shape == self.slot.shape == (self.coords.shape[0],)
        assert tuple(self.store.shape) == (self.nparts, self.cap, self.bs, self.bs), (
            tuple(self.store.shape), self.nparts, self.cap, self.bs)

    @property
    def nnzb(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nparts(self) -> int:
        return int(self.mesh.nparts)

    @property
    def dtype(self) -> torch.dtype:
        return self.store.dtype

    @property
    def device(self) -> torch.device:
        return self.store.device

    def codes(self) -> np.ndarray:
        """The blocks' Morton codes, read-only.  The structure of a resident
        matrix never changes, so they are encoded once per matrix: plan keys,
        collectives and the locality ledger ask for them on every dispatch."""
        codes = self.__dict__.get("_codes")
        if codes is None:
            codes = morton_encode(self.coords[:, 0], self.coords[:, 1])
            codes.setflags(write=False)
            object.__setattr__(self, "_codes", codes)  # frozen: a cache, not a field
        return codes

    def store_maps(self) -> tuple[np.ndarray, np.ndarray]:
        """(store_idx [P, cap] global block per slot, store_valid [P, cap])."""
        idx = np.zeros((self.nparts, self.cap), dtype=np.int32)
        valid = np.zeros((self.nparts, self.cap), dtype=bool)
        idx[self.owner, self.slot] = np.arange(self.nnzb, dtype=np.int32)
        valid[self.owner, self.slot] = True
        return idx, valid

    def stack_blocks(self) -> torch.Tensor:
        """The blocks ``[nnzb, bs, bs]`` in stack (Morton) order, on the store's device.

        A reduction over this stack depends on the structure alone, never on
        the owner layout: the resident reductions go through it so that a
        re-layout cannot move a single bit of a norm, a trace or a decision
        taken on them.
        """
        return self.store[_upload(self.owner, self.device), _upload(self.slot, self.device)]

    # -- boundary conversions ----------------------------------------------
    def gather(self) -> BSMatrix:
        """The matrix as a BSMatrix in stack order, on the store's device (boundary op)."""
        return BSMatrix(shape=tuple(self.shape), bs=self.bs, coords=self.coords,
                        data=self.stack_blocks())

    # -- worker-local ops ---------------------------------------------------
    def scale(self, alpha) -> "DistBSMatrix":
        """alpha * A; elementwise on the resident store, stays in place."""
        return dataclasses.replace(self, store=self.store * torch.tensor(alpha, dtype=self.dtype))

    def astype(self, dtype) -> "DistBSMatrix":
        return dataclasses.replace(self, store=self.store.to(dtype))


class NormTableExecutable:
    """Device-side compaction + norm reduction for one structure.

    Gathers the valid store rows into stack order on the device and reduces
    each to its Frobenius norm there, so only the ``[nnzb]`` leaf bounds the
    hierarchical descents consume cross device -> host.  Reducing the
    stack-order blocks (not the padded ``[P, cap]`` store) makes every norm
    independent of the owner layout and equal to the single-device
    :meth:`~repro_torch.core.matrix.BSMatrix.block_norms` of the same
    blocks.  (The JAX package scatters each device's norms to their stack
    positions and sums over the mesh; on one card the gather is the whole
    of it.)
    """

    def __init__(self, x: DistBSMatrix):
        # the stack position each store slot's norm lands at (padding: the
        # trash position nnzb); the gather reads the slots in position order.
        # The host table is kept for the verifier at cache admission
        # (repro_torch.analysis.verify, kind="norm-table")
        gpos = np.full((x.nparts, x.cap), x.nnzb, dtype=np.int64)
        gpos[x.owner, x.slot] = np.arange(x.nnzb, dtype=np.int64)
        self._verify_plan = dict(kind="norm-table", gpos=gpos, owner=np.asarray(x.owner),
                                 slot=np.asarray(x.slot), nnzb=x.nnzb, nparts=x.nparts, cap=x.cap)
        p, s = np.nonzero(gpos < x.nnzb)
        order = np.argsort(gpos[p, s], kind="stable")
        self._owner = _upload(p[order], x.device)
        self._slot = _upload(s[order], x.device)

    def __call__(self, store: torch.Tensor) -> np.ndarray:
        return _to_numpy(block_frobenius_norms(store[self._owner, self._slot]))


def resident_block_norms(x: DistBSMatrix, cache=None) -> np.ndarray:
    """Per-block Frobenius norms in stack order from the resident store (float64).

    Runs :func:`repro_torch.core.matrix.block_frobenius_norms` — the same
    reduction the single-device path uses, same fp32 accumulation — on the
    stack-order blocks, so single-device and resident SpAMM make the same
    prune decisions near ``tau`` and a re-layout changes no norm.  With a
    :class:`~repro_torch.dist.cache.PlanCache` the compaction runs on the
    device (:class:`NormTableExecutable`, cached per structure) and only the
    ``[nnzb]`` vector crosses to the host.
    """
    if x.nnzb == 0:
        return np.zeros((0,), dtype=np.float64)
    tr = tracer_of(cache)
    with tr.span("norm_fetch", cat="collective", nnzb=x.nnzb):
        if tr.annotates:
            tr.counter("norm_fetch_bytes").add(x.nnzb * 4)
        mm = getattr(cache, "memory_meter", None) if cache is not None else None
        if mm is not None:
            # the JAX package's [P, cap] norm table, in its account
            mm.note_bytes("norm_table", np.full(x.nparts, x.cap * 4, dtype=np.int64), cache=cache)
        if cache is not None:
            key = (
                "norms",
                structure_fingerprint(x.codes(), x.owner, x.nparts, x.bs),
                mesh_key(x.mesh),
            )
            exe = cache.get_or_build(key, lambda: NormTableExecutable(x))
            return exe(x.store).astype(np.float64)
        return _to_numpy(block_frobenius_norms(x.stack_blocks())).astype(np.float64)


def dist_zeros(shape: tuple[int, int], bs: int, mesh: WorkerMesh, dtype=torch.float32) -> DistBSMatrix:
    """Structurally-empty resident matrix (cap-1 padding store, no blocks)."""
    return DistBSMatrix(
        shape=tuple(shape),
        bs=bs,
        coords=np.zeros((0, 2), dtype=np.int64),
        owner=np.zeros((0,), dtype=np.int32),
        slot=np.zeros((0,), dtype=np.int32),
        cap=1,
        store=torch.zeros((mesh.nparts, 1, bs, bs), dtype=dtype, device=mesh.device),
        mesh=mesh,
    )


def scatter(a: BSMatrix, mesh: WorkerMesh, *, owner: np.ndarray | None = None) -> DistBSMatrix:
    """Lay a BSMatrix out onto the mesh once; default Morton placement.

    The inverse of :meth:`DistBSMatrix.gather`.  ``owner`` pins an explicit
    placement (every block a worker id < ``mesh.nparts``).  The store is
    built on the mesh's device; padding rows are zero.
    """
    nparts = int(mesh.nparts)
    if owner is None:
        owner = partition_morton(a.nnzb, nparts)
    owner = np.asarray(owner, dtype=np.int32)
    if owner.shape != (a.nnzb,):
        raise ValueError(f"owner map of shape {owner.shape} for {a.nnzb} blocks")
    if a.nnzb and (owner.min() < 0 or owner.max() >= nparts):
        raise ValueError(f"owner map assigns blocks outside the mesh of {nparts}")
    slot, stores = _owner_slots(owner, nparts)
    cap = max(max((len(s) for s in stores), default=0), 1)
    dev = mesh.device
    store = torch.zeros((nparts, cap, a.bs, a.bs), dtype=a.dtype, device=dev)
    if a.nnzb:
        store[_upload(owner, dev), _upload(slot, dev)] = a.data.to(dev)
    return DistBSMatrix(
        shape=tuple(a.shape), bs=a.bs, coords=a.coords, owner=owner, slot=slot,
        cap=cap, store=store, mesh=mesh,
    )
