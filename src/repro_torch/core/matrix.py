"""Block-sparse matrix with quadtree (Morton) structure.

``BSMatrix`` is the Chunks-side object of the paper: the *structure* (which
leaf blocks are nonzero) lives on the host as Morton-sorted block coordinates,
the *values* live on a device as one stacked tensor ``data[nnzb, bs, bs]``.
All structure decisions (symbolic multiply, truncation selection) are
host-side and cheap; all flops run on the device over the stacked blocks.

The constructors put the values on ``device="cuda"`` unless the caller asks
for the CPU, and raise when no card is there; every other operation follows
its operands' device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels.block_spmm import segment_sum_sorted
from .quadtree import (
    QuadtreeIndex,
    build_quadtree_index,
    morton_decode,
    morton_encode,
    morton_sort,
    quadtree_depth,
    structure_fingerprint,
)

__all__ = ["BSMatrix", "block_frobenius_norms", "resolve_device"]

_NUMPY_DTYPES = {
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it names a card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; dtypes numpy lacks (bf16) come back as fp32."""
    t = t.detach()
    if t.dtype not in _NUMPY_DTYPES:
        t = t.float()
    return t.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class BSMatrix:
    """Block-sparse matrix.

    Attributes:
      shape:  logical (rows, cols); may be any size, blocks pad with zeros.
      bs:     leaf block size (uniform, square).
      coords: host numpy int64 [nnzb, 2] block (row, col), Morton sorted.
      data:   torch [nnzb, bs, bs] leaf values, on the matrix's device.
    """

    shape: tuple[int, int]
    bs: int
    coords: np.ndarray
    data: torch.Tensor

    # -- invariants ---------------------------------------------------------
    def __post_init__(self):
        assert self.coords.ndim == 2 and self.coords.shape[1] == 2
        assert self.data.ndim == 3 and self.data.shape[0] == self.coords.shape[0]
        assert self.data.shape[1] == self.bs and self.data.shape[2] == self.bs

    @property
    def nnzb(self) -> int:
        return int(self.coords.shape[0])

    @property
    def nblocks(self) -> tuple[int, int]:
        return (_ceil_div(self.shape[0], self.bs), _ceil_div(self.shape[1], self.bs))

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def codes(self) -> np.ndarray:
        return morton_encode(self.coords[:, 0], self.coords[:, 1])

    @property
    def structure_key(self) -> str:
        """Fingerprint of the sparsity structure (codes + grid + block size).

        The :class:`~repro_torch.core.cache.SymbolicCache` key:
        value-independent, stable across processes, and equal to the JAX
        package's key for the same structure.  Cached — the object is frozen.
        """
        key = self.__dict__.get("_structure_key")
        if key is None:
            key = structure_fingerprint(self.codes(), self.nblocks, self.bs)
            object.__setattr__(self, "_structure_key", key)
        return key

    def quadtree_index(
        self, depth: int | None = None, *, with_norms: bool = True
    ) -> QuadtreeIndex:
        """The hierarchical quadtree over this structure.

        ``with_norms=True`` includes subtree Frobenius norms (needed by SpAMM
        and hierarchical truncation; costs one device reduction and a copy to
        the host via :func:`block_frobenius_norms`); structure-only consumers
        (the plain multiply descent) pass ``with_norms=False`` and pay
        nothing.  Cached on the matrix per (depth, norms) — a norm-carrying
        index satisfies structure-only requests.
        """
        if depth is None:
            depth = quadtree_depth(*self.nblocks)
        cache = self.__dict__.get("_qt_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_qt_cache", cache)
        if (depth, True) in cache:
            return cache[(depth, True)]
        key = (depth, with_norms)
        if key not in cache:
            cache[key] = build_quadtree_index(
                self.coords,
                self.block_norms() if with_norms else None,
                depth=depth,
            )
        return cache[key]

    # -- constructors -------------------------------------------------------
    @staticmethod
    def zeros(
        shape: tuple[int, int], bs: int, dtype=torch.float32, *, device="cuda"
    ) -> "BSMatrix":
        return BSMatrix(
            shape=tuple(shape),
            bs=bs,
            coords=np.zeros((0, 2), dtype=np.int64),
            data=torch.zeros((0, bs, bs), dtype=dtype, device=resolve_device(device)),
        )

    @staticmethod
    def from_dense(a, bs: int, prune_tol: float = 0.0, *, device="cuda") -> "BSMatrix":
        """Build from a dense host array, pruning blocks with Frobenius norm <= tol."""
        dev = resolve_device(device)
        a = np.asarray(a)
        m, n = a.shape
        nbr, nbc = _ceil_div(m, bs), _ceil_div(n, bs)
        pad = np.zeros((nbr * bs, nbc * bs), dtype=a.dtype)
        pad[:m, :n] = a
        blocks = pad.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
        norms = np.sqrt((blocks.astype(np.float64) ** 2).sum(axis=(2, 3)))
        rows, cols = np.nonzero(norms > prune_tol)
        coords = np.stack([rows, cols], axis=1).astype(np.int64)
        order = morton_sort(coords)
        coords = coords[order]
        data = torch.from_numpy(np.ascontiguousarray(blocks[coords[:, 0], coords[:, 1]]))
        return BSMatrix(shape=(m, n), bs=bs, coords=coords, data=data.to(dev))

    @staticmethod
    def from_blocks(
        shape: tuple[int, int], bs: int, coords: np.ndarray, data, *, device="cuda"
    ) -> "BSMatrix":
        """Build from explicit block coords (deduplicated, Morton-sorted here).

        Duplicate blocks are summed in the order they are given, by the same
        ordered segment sum as the plain block GEMM — never a scatter-add, so
        the result is bit-identical from run to run on every device.
        """
        dev = resolve_device(device)
        coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
        data = torch.as_tensor(data).to(dev)
        if coords.shape[0] == 0:
            return BSMatrix.zeros(shape, bs, data.dtype, device=dev)
        codes = morton_encode(coords[:, 0], coords[:, 1])
        order = np.argsort(codes, kind="stable")
        codes_s = codes[order]
        uniq, first = np.unique(codes_s, return_index=True)
        data = data[torch.from_numpy(order).to(dev)]
        if uniq.size != codes_s.size:  # sum duplicates
            run_ptr = np.append(first, codes_s.size)
            data = segment_sum_sorted(data, torch.from_numpy(run_ptr).to(dev))
            coords = coords[order][first]
        else:
            coords = coords[order]
        return BSMatrix(shape=tuple(shape), bs=bs, coords=coords, data=data)

    @staticmethod
    def from_coo(
        shape: tuple[int, int],
        bs: int,
        rows: Sequence[int],
        cols: Sequence[int],
        vals,
        dtype=torch.float32,
        *,
        device="cuda",
    ) -> "BSMatrix":
        """Paper functionality: assignment from (row, col, value) vectors."""
        dev = resolve_device(device)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        br, bc = rows // bs, cols // bs
        codes = morton_encode(br, bc)
        uniq, inv = np.unique(codes, return_inverse=True)
        nblk = int(uniq.size)
        if nblk == 0:
            return BSMatrix.zeros(shape, bs, dtype, device=dev)
        # scatter element values into stacked blocks (host, then ship once)
        blocks = np.zeros((nblk, bs, bs), dtype=_NUMPY_DTYPES.get(dtype, np.float32))
        np.add.at(blocks, (inv, rows % bs, cols % bs), vals)
        r, c = morton_decode(uniq)  # np.unique sorts: already Morton order
        coords = np.stack([r, c], axis=1)
        data = torch.from_numpy(blocks).to(device=dev, dtype=dtype)
        return BSMatrix(shape=tuple(shape), bs=bs, coords=coords, data=data)

    # -- extraction ---------------------------------------------------------
    def to_dense(self) -> np.ndarray:
        """Dense host copy (numpy; bf16 values come back as fp32)."""
        m, n = self.shape
        nbr, nbc = self.nblocks
        data = _to_numpy(self.data)
        # vectorized scatter: stack -> (nbr, nbc, bs, bs) grid -> 2-D layout
        grid = np.zeros((nbr, nbc, self.bs, self.bs), dtype=data.dtype)
        if self.nnzb:
            grid[self.coords[:, 0], self.coords[:, 1]] = data
        out = grid.transpose(0, 2, 1, 3).reshape(nbr * self.bs, nbc * self.bs)
        return out[:m, :n]

    def get_elements(self, rows: Sequence[int], cols: Sequence[int]) -> np.ndarray:
        """Paper functionality: extract elements by (row, col) index vectors."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        codes = morton_encode(rows // self.bs, cols // self.bs)
        my = self.codes()
        np_dtype = _NUMPY_DTYPES.get(self.dtype, np.float32)
        out = np.zeros(rows.shape, dtype=np_dtype)
        if my.size == 0:
            return out
        pos = np.searchsorted(my, codes)
        hit = (pos < my.size) & (my[np.minimum(pos, my.size - 1)] == codes)
        if hit.any():
            idx = [torch.from_numpy(x).to(self.device) for x in
                   (pos[hit], rows[hit] % self.bs, cols[hit] % self.bs)]
            out[hit] = _to_numpy(self.data[idx[0], idx[1], idx[2]])
        return out

    # -- simple ops ---------------------------------------------------------
    def scale(self, alpha) -> "BSMatrix":
        return dataclasses.replace(
            self, data=self.data * torch.tensor(alpha, dtype=self.dtype)
        )

    def transpose(self) -> "BSMatrix":
        coords = self.coords[:, ::-1]
        order = morton_sort(coords)
        data = self.data
        if self.nnzb:
            data = data.transpose(1, 2)[torch.from_numpy(order).to(self.device)].contiguous()
        return BSMatrix(
            shape=(self.shape[1], self.shape[0]),
            bs=self.bs,
            coords=np.ascontiguousarray(coords[order]),
            data=data,
        )

    def block_norms(self) -> np.ndarray:
        """Frobenius norm of each stored block (host numpy float64)."""
        if self.nnzb == 0:
            return np.zeros((0,), dtype=np.float64)
        return _to_numpy(block_frobenius_norms(self.data)).astype(np.float64)

    def frobenius_norm(self) -> float:
        n = self.block_norms()
        return float(np.sqrt((n.astype(np.float64) ** 2).sum()))

    def trace(self) -> float:
        diag = self.coords[:, 0] == self.coords[:, 1]
        if not diag.any():
            return 0.0
        d = self.data[torch.from_numpy(np.nonzero(diag)[0]).to(self.device)]
        # per-block traces, then their sum, both in the data dtype (as the
        # JAX package's jnp.sum(jnp.trace(...)))
        return float(d.diagonal(dim1=1, dim2=2).sum(dim=1).sum())

    def density(self) -> float:
        nbr, nbc = self.nblocks
        return self.nnzb / float(nbr * nbc)

    def astype(self, dtype) -> "BSMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))


def block_frobenius_norms(data: torch.Tensor, inner: int | None = None) -> torch.Tensor:
    """Frobenius norm over the trailing (bs, bs) axes; any leading batch shape.

    Accumulates in fp32, as the JAX package does, so that truncation and
    SpAMM prune decisions — which compare these norms against ``tau`` — keep
    the same block sets.

    ``inner`` (a divisor of ``bs``) switches to the leaf-policy resolution of
    :class:`repro_torch.core.leaf.LeafSpec`: the result gains trailing
    ``(ni, ni)`` axes holding the Frobenius norm of each ``inner x inner``
    internal block.  Zero internal blocks come out as exact zeros, so the
    inner-norm matrices double as the leaf's inner sparsity mask.
    """
    if inner is None:
        return torch.sqrt(torch.sum(torch.square(data.float()), dim=(-2, -1)))
    bs = data.shape[-1]
    assert bs % inner == 0, (bs, inner)
    ni = bs // inner
    tiles = data.reshape(*data.shape[:-2], ni, inner, ni, inner)
    return torch.sqrt(torch.sum(torch.square(tiles.float()), dim=(-3, -1)))
