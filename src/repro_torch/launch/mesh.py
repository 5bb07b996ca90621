"""Device meshes: the production shapes, and meshes of ranks over ``torch.distributed``.

Port of the JAX package's ``repro/launch/mesh.py``.  The production meshes
are axis-name -> size maps for the dry run (no device is created);
:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the initialised process group, and :func:`run_on_mesh` starts
those ranks.

JAX is single-controller: one process sees every device and ``shard_map``
runs a body on each.  torch is multi-controller: one process per rank, each
running the same program on its own shard.  :func:`run_on_mesh` is that
launcher — one spawned process per rank, a process group set up from a
``FileStore`` in a temporary directory (no port to collide with when several
meshes start at once), the mesh, then ``fn(ctx, *args)`` on every rank.

The backend follows one rule (:func:`mesh_backend`): ``nccl`` where every
rank has a card of its own, ``gloo`` where ranks share one (NCCL refuses two
ranks on one device) or run on the CPU.  Rank ``r`` takes card
``r % device_count``.  The mesh records ``backend`` and ``ranks_per_card``.

:func:`fake_mesh` is a mesh of any size in one process: torch's ``fake``
process-group backend (``torch.testing._internal.distributed.fake_pg``),
whose collectives return at once and move nothing, with this process as
rank 0 of the group.  The dry run runs a cell's step there on fake tensors
to count one device's collectives on the production meshes
(:func:`make_fake_production_mesh`).
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch

__all__ = ["fake_mesh", "make_fake_production_mesh", "make_mesh", "make_production_mesh",
           "mesh_backend", "production_mesh_axes", "rank_device", "run_on_mesh"]

#: how often :func:`run_on_mesh` looks for a rank that has ended without a result
_POLL_S = 1.0


def production_mesh_axes(multi_pod: bool = False) -> dict[str, int]:
    """Single pod: 16 x 16 = 256 chips (data, model).
    Multi-pod: 2 pods x 256 = 512 chips (pod, data, model)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production mesh over the process group's ranks (256 or 512 of them)."""
    axes = production_mesh_axes(multi_pod)
    return make_mesh(tuple(axes.values()), tuple(axes), device=device)


def _init_fake_group(world: int) -> None:
    """This process as rank 0 of a ``world``-rank group on the ``fake`` backend."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; destroy it first")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh (256 or 512 ranks) on the CPU over the ``fake``
    backend, this process rank 0: :func:`make_production_mesh`'s
    ``DeviceMesh``, for counting (see :func:`fake_mesh`).  The group stays
    initialised; ``torch.distributed.destroy_process_group()`` ends it, as a
    process that builds both meshes must between them."""
    _init_fake_group(math.prod(production_mesh_axes(multi_pod).values()))
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


@contextlib.contextmanager
def fake_mesh(axes: dict[str, int]):
    """``with fake_mesh({"data": 16, "model": 16}) as mesh``: a ``DeviceMesh`` of
    those axes on the CPU over torch's ``fake`` process-group backend, this
    process rank 0, the group destroyed on exit.  Its collectives return at
    once and leave their outputs as they were: the values are meaningless,
    the shapes, the calls and their groups are the real program's.  Meant
    for fake tensors (:func:`repro_torch.models.model.fake_mode`)."""
    import torch.distributed as dist

    _init_fake_group(math.prod(axes.values()))
    try:
        yield make_mesh(tuple(axes.values()), tuple(axes), device="cpu")
    finally:
        dist.destroy_process_group()


def _check_device(device: str) -> str:
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: 'cuda' or 'cpu'")
    return kind


def mesh_backend(device: str, world: int) -> str:
    """``nccl`` where every one of ``world`` ranks has a card of its own, else ``gloo``."""
    if _check_device(device) == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def rank_device(rank: int, device: str) -> torch.device:
    """Rank ``rank``'s device: card ``rank % device_count``, or the CPU."""
    if _check_device(device) == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first ``prod(shape)``
    ranks of the initialised process group (a larger pool is allowed, as the
    reference's ``make_mesh`` allows more devices than the mesh).

    Every rank of the group calls it.  Raises without a card unless
    ``device="cpu"``.  The mesh records the group's ``backend`` (chosen for
    the whole group by :func:`run_on_mesh`) and ``ranks_per_card``, the
    group's ranks over the cards.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kind = _check_device(device)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with run_on_mesh "
                           "or torch.distributed.init_process_group")
    n, world = math.prod(shape), dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if kind == "cuda":
        torch.cuda.set_device(rank_device(dist.get_rank(), "cuda"))
    mesh = DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))
    mesh.backend = dist.get_backend()
    mesh.ranks_per_card = 1 if kind == "cpu" else -(-world // torch.cuda.device_count())
    return mesh


def _rank_main(rank: int, world: int, store_path: str, shape, axes, device: str, backend: str,
               fn, args, results, timeout_s: float) -> None:
    import torch.distributed as dist

    from ..sharding.rules import MeshCtx

    try:
        if device == "cpu":
            torch.set_num_threads(1)  # the ranks share the host's cores
        else:
            torch.cuda.set_device(rank_device(rank, device))  # before anything is allocated
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(shape, axes, device=device)
            out = fn(MeshCtx.on(mesh), *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def run_on_mesh(fn, shape: tuple[int, ...], axes: tuple[str, ...], *, device: str = "cuda",
                args: tuple = (), timeout_s: float = 600.0) -> list:
    """``fn(ctx, *args)`` on every rank of a ``shape`` mesh named ``axes``; returns
    the ranks' results in rank order.

    One spawned process per rank (``fn`` and ``args`` are pickled, so ``fn``
    is a module-level function); the process group comes from a
    ``FileStore`` in a temporary directory, with :func:`mesh_backend`'s
    backend.  ``ctx`` is :meth:`MeshCtx.on` the mesh.  A rank that raises
    makes this raise with its traceback, and so does a rank that ends
    without a result (killed for memory, a fatal CUDA error), as soon as it
    has ended; when not every rank has answered ``timeout_s`` after the
    start, the ranks are ended and this raises.
    """
    import multiprocessing as mp
    import queue as queue_mod

    kind = _check_device(device)
    world = math.prod(shape)
    backend = mesh_backend(kind, world)
    spawn = mp.get_context("spawn")
    results = spawn.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        procs = [spawn.Process(target=_rank_main, daemon=True,
                               args=(r, world, os.path.join(tmp, "store"), tuple(shape),
                                     tuple(axes), kind, backend, fn, args, results, timeout_s))
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        got, failed = {}, []
        try:
            while len(got) < world and not failed:
                try:
                    rank, ok, out = results.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    silent = [r for r, p in enumerate(procs)
                              if r not in got and p.exitcode is not None]
                    if not silent:
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"run_on_mesh: {world - len(got)} ranks silent "
                                               f"{timeout_s} s after the start") from None
                        continue
                    try:  # its last message may still be in flight: one more look
                        rank, ok, out = results.get(timeout=_POLL_S)
                    except queue_mod.Empty:
                        failed.append((silent[0], f"ended with exit code "
                                       f"{procs[silent[0]].exitcode} and sent no result"))
                        continue
                if ok:
                    got[rank] = out
                else:
                    failed.append((rank, out))  # the other ranks may wait on it forever
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 1)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    if failed:
        rank, tb = failed[0]
        raise RuntimeError(f"rank {rank} of the {shape} mesh failed:\n{tb}")
    return [got[r] for r in range(world)]
