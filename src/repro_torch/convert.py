"""Carry state between the JAX package and the port as plain numpy arrays.

A matrix's state is its block stack and its structure: these functions move
a ``BSMatrix`` — or a resident ``DistBSMatrix`` with its placement — across
as the JAX package's fields (``shape``, ``bs``, ``coords``, ``owner``,
``slot``, ``cap`` and ``np.asarray(m.data)`` / ``np.asarray(x.store)``).  An
LM's state is its parameter tree: :func:`lm_params_from_arrays` takes the
JAX package's tree as numpy arrays (``jax.tree.map(np.asarray, params)``)
and :func:`lm_params_to_arrays` gives it back, so neither package imports
the other.  A train state (parameters, AdamW moments, ``count``, an optional
fp32 ``master`` copy, ``step``) crosses with :func:`train_state_from_arrays`
and :func:`train_state_to_arrays` the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.matrix import BSMatrix, _to_numpy, resolve_device
from .dist.matrix import DistBSMatrix
from .tree import tree_map

__all__ = [
    "bsmatrix_from_arrays",
    "bsmatrix_to_arrays",
    "distmatrix_from_arrays",
    "distmatrix_to_arrays",
    "lm_params_from_arrays",
    "lm_params_to_arrays",
    "train_state_from_arrays",
    "train_state_to_arrays",
]


def _tensor(data) -> torch.Tensor:
    """A writable torch copy of a host array; numpy's bf16 extension type arrives as torch bf16."""
    data = np.asarray(data)
    if data.dtype.name == "bfloat16":
        return torch.from_numpy(data.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(data))


def bsmatrix_from_arrays(shape, bs: int, coords, data, *, device) -> BSMatrix:
    """The port's ``BSMatrix`` from host arrays (coords Morton-sorted, unique).

    ``data`` may be bf16 as numpy's ``ml_dtypes`` extension type; it arrives
    as a torch bf16 tensor (the conversion through fp32 is exact).
    """
    return BSMatrix(
        shape=tuple(int(s) for s in shape),
        bs=int(bs),
        coords=np.asarray(coords, dtype=np.int64).reshape(-1, 2),
        data=_tensor(data).to(resolve_device(device)),
    )


def bsmatrix_to_arrays(m: BSMatrix) -> tuple[tuple[int, int], int, np.ndarray, np.ndarray]:
    """``(shape, bs, coords, data)`` on the host; bf16 data comes back as fp32."""
    return tuple(m.shape), m.bs, m.coords.copy(), _to_numpy(m.data)


def distmatrix_from_arrays(shape, bs: int, coords, owner, slot, cap: int, store, *, mesh):
    """The port's ``DistBSMatrix`` on ``mesh`` from host arrays.

    ``store`` is the ``[P, cap, bs, bs]`` stack with one row per worker (the
    JAX package's sharded store gathered to the host, ``np.asarray(x.store)``);
    ``mesh`` is a :class:`repro_torch.core.distributed.WorkerMesh` of P
    workers.
    """
    return DistBSMatrix(
        shape=tuple(int(s) for s in shape),
        bs=int(bs),
        coords=np.asarray(coords, dtype=np.int64).reshape(-1, 2),
        owner=np.asarray(owner, dtype=np.int32),
        slot=np.asarray(slot, dtype=np.int32),
        cap=int(cap),
        store=_tensor(store).to(mesh.device),
        mesh=mesh,
    )


def distmatrix_to_arrays(x) -> dict:
    """``shape, bs, coords, owner, slot, cap, store`` of a ``DistBSMatrix`` on the
    host; a bf16 store comes back as fp32."""
    return dict(shape=tuple(x.shape), bs=x.bs, coords=x.coords.copy(), owner=x.owner.copy(),
                slot=x.slot.copy(), cap=x.cap, store=_to_numpy(x.store))


def _stack(trees):
    """One tree of stacked arrays from a non-empty list of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def lm_params_from_arrays(tree, cfg, *, device):
    """The port's LM parameters (:mod:`repro_torch.models.transformer`) from the
    JAX package's parameter tree as numpy arrays.

    The JAX tree stacks the layers by position in the block pattern for its
    scan: ``blocks.p{j}[i]`` is layer ``i * len(pattern) + j`` and
    ``tail[i]`` is layer ``periods * len(pattern) + i``, the order in which
    the JAX forward runs them.  The port keeps one dict per layer in that
    order.  bf16 arrays arrive as torch bf16.
    """
    dev = resolve_device(device)
    up = lambda a: _tensor(a).to(dev)  # noqa: E731
    pattern = cfg.block_pattern
    periods = cfg.num_layers // len(pattern)
    layers = [None] * cfg.num_layers
    for j in range(len(pattern)):
        stacked = tree["blocks"][f"p{j}"]
        for i in range(periods):
            layers[i * len(pattern) + j] = tree_map(lambda a, i=i: up(np.asarray(a)[i]), stacked)
    for i, t in enumerate(tree.get("tail", [])):
        layers[periods * len(pattern) + i] = tree_map(up, t)
    out = {k: tree_map(up, v) for k, v in tree.items() if k not in ("blocks", "tail")}
    out["layers"] = layers
    return out


def lm_params_to_arrays(params, cfg) -> dict:
    """The inverse of :func:`lm_params_from_arrays`: the JAX package's tree
    (layers stacked by pattern position, remainder layers in ``tail``) as
    numpy arrays; bf16 comes back as fp32."""
    pattern = cfg.block_pattern
    periods = cfg.num_layers // len(pattern)
    layers = tree_map(_to_numpy, params["layers"])
    out = {k: tree_map(_to_numpy, v) for k, v in params.items() if k != "layers"}
    out["blocks"] = {f"p{j}": _stack([layers[i * len(pattern) + j] for i in range(periods)])
                     for j in range(len(pattern))}
    tail = layers[periods * len(pattern):]
    if tail:
        out["tail"] = tail
    return out


# the entries of a train state's "opt" that mirror the parameter tree
_PARAM_SLOTS = ("mu", "nu", "master")


def train_state_from_arrays(tree, cfg, *, device) -> dict:
    """The port's train state (:func:`repro_torch.models.model.init_train_state`)
    from the JAX package's as numpy arrays (``jax.tree.map(np.asarray, state)``).

    The parameters and every optimizer slot that mirrors them (``mu``,
    ``nu``, an optional ``master``) cross with :func:`lm_params_from_arrays`;
    ``count`` and ``step`` arrive as int32 0-d tensors on ``device``.
    """
    dev = resolve_device(device)
    scalar = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=dev)  # noqa: E731
    opt = {k: (lm_params_from_arrays(v, cfg, device=dev) if k in _PARAM_SLOTS else scalar(v))
           for k, v in tree["opt"].items()}
    return {"params": lm_params_from_arrays(tree["params"], cfg, device=dev), "opt": opt,
            "step": scalar(tree["step"])}


def train_state_to_arrays(state, cfg) -> dict:
    """The inverse of :func:`train_state_from_arrays`: the JAX package's train
    state as numpy arrays (bf16 comes back as fp32, ``count`` and ``step`` as
    int32 0-d arrays)."""
    scalar = lambda t: np.asarray(int(t), dtype=np.int32)  # noqa: E731
    opt = {k: (lm_params_to_arrays(v, cfg) if k in _PARAM_SLOTS else scalar(v))
           for k, v in state["opt"].items()}
    return {"params": lm_params_to_arrays(state["params"], cfg), "opt": opt,
            "step": scalar(state["step"])}
