"""Resident multiply execution over a worker mesh on one card.

The host-side :class:`~repro_torch.core.schedule.SpgemmPlan` partitions a
multiply over P workers.  The JAX package runs the workers as the devices
of a ``shard_map`` mesh; one H100 cannot host several ranks, so here the
worker axis is the leading dimension of every store, ``[P, cap, bs, bs]``,
in one process on one device (:class:`WorkerMesh`):

* an exchange round with offset ``d`` (a ``ppermute`` in the JAX package:
  worker ``p`` sends its payload to ``(p + d) % P``) is one gather along the
  worker axis, ``recv[q] = store[(q - d) % P, send[(q - d) % P]]`` — the
  same as ``torch.roll(store[arange(P)[:, None], send], d, dims=0)`` without
  the intermediate copy;
* every worker's tasks run in one kernel launch.

Two exchange modes:

* ``p2p``: one round per active ring offset — only blocks actually
  referenced by remote tasks move (the paper's locality claim).
* ``allgather``: the baseline — both operands fully replicated.  On one card
  every worker indexes the one flattened ``[P * cap]`` stack instead of
  holding P copies; the plan's byte accounting is unchanged.

Two numeric engines:

* staged (:class:`SpgemmExecutable`, ``impl="ref"`` the plain version or
  ``"kernel"`` the ``block_spmm`` CUDA kernel): each worker's concatenated
  operand buffer ``[own store | recv rounds...]``, then one grouped GEMM over
  all workers' tasks;
* fused (:class:`FusedSpgemmExecutable`, ``impl="fused"``): the exchange
  into stacked receive buffers ``[P, R, capU, bs, bs]`` and one fused leaf
  engine call (:func:`repro_torch.kernels.ops.fused_block_spmm`) that reads
  operands by ``(src, off)`` — the concatenated buffer is never built.

Both sum each output block's tasks in the plan's order, so they agree bit
for bit in fp32.  The executables upload a plan's index arrays once; a call
then uploads at most its per-task masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analysis.errors import PlanError
from ..kernels import ops as kops
from ..kernels.fused_leaf import fused_task_runs
from ..kernels.precision import FP32, Precision
from .matrix import BSMatrix, resolve_device
from .schedule import SpgemmPlan

__all__ = [
    "WorkerMesh",
    "make_worker_mesh",
    "dist_spgemm",
    "shard_stores",
    "unshard_result",
    "SpgemmExecutable",
    "MaskedSpgemmExecutable",
    "FusedSpgemmExecutable",
    "MaskedFusedSpgemmExecutable",
    "OuterSpgemmExecutable",
    "dist_spgemm_outer",
]

#: the staged engines: the plain version, the block_spmm kernel, or the one
#: the tensors' device takes (kernel on the card, plain version on the CPU)
STAGED_IMPLS = ("ref", "kernel", "auto")


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """P workers living on one device as the leading axis of every store."""

    nparts: int
    device: torch.device


def make_worker_mesh(nworkers: int, device="cuda") -> WorkerMesh:
    """A mesh of ``nworkers`` workers on ``device`` (the card unless asked for the CPU).

    ``nworkers`` is required: one card has no "all devices" to default to.
    Raises when ``device`` names a card that is not there.
    """
    if int(nworkers) < 1:
        raise ValueError(f"a worker mesh needs at least one worker, got {nworkers}")
    return WorkerMesh(int(nworkers), resolve_device(device))


def _upload(x, device, dtype=np.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


def shard_stores(plan: SpgemmPlan, a_data: torch.Tensor, b_data: torch.Tensor):
    """Global block stacks -> per-worker padded stores ``[P, cap, bs, bs]`` (padding zero)."""

    def store(data, idx, valid):
        idx_t = _upload(idx, data.device)
        if data.shape[0] == 0:
            return torch.zeros((*idx.shape, *data.shape[1:]), dtype=data.dtype, device=data.device)
        keep = torch.from_numpy(valid).to(data.device).to(data.dtype)
        return data[idx_t] * keep[..., None, None]

    return (store(a_data, plan.a_store_idx, plan.a_store_valid),
            store(b_data, plan.b_store_idx, plan.b_store_valid))


def _receive(store: torch.Tensor, d: int, send: torch.Tensor, keep=None) -> torch.Tensor:
    """One exchange round: worker ``p`` ships ``store[p, send[p]]`` to ``(p + d) % P``.

    Returns what each worker receives, ``[P, cap_d, bs, bs]``.  ``keep``
    (``[P, cap_d]`` bool, by sender) zeroes the slots no live task reads.
    """
    P = store.shape[0]
    sender = torch.remainder(torch.arange(P, device=store.device) - d, P)
    payload = store[sender[:, None], send[sender]]
    if keep is not None:
        payload = payload * keep[sender].to(store.dtype)[..., None, None]
    return payload


def _exchange_bufs(store: torch.Tensor, offsets, sends) -> torch.Tensor:
    """Staged layout per worker: ``[own store | recv per offset, in offset order]``."""
    bufs = [store] + [_receive(store, d, send) for d, send in zip(offsets, sends)]
    return torch.cat(bufs, dim=1) if len(bufs) > 1 else store


def _exchange_stack(store: torch.Tensor, offsets, sends, keeps=None, live=None) -> torch.Tensor:
    """Planned exchange rounds -> stacked receive buffers ``[P, R, capU, bs, bs]``.

    Unlike :func:`_exchange_bufs` the worker's own store is not copied into
    an operand buffer — the fused engine reads it in place — and each round
    is padded with zeros to the uniform ``capU`` so the stack is one tensor
    the engine indexes by ``(round, row)``.

    ``keeps``: optional per-round ``[P, cap_d]`` bool — send slots whose
    block no live task references ship zeros (delta-plan exchange pruning).
    ``live``: optional collection of round indices to run at all; dead
    rounds (every slot masked) stay zeros and copy nothing.  With no rounds
    the stack is a dummy ``[P, 1, 1, bs, bs]`` that no task reads.
    """
    P, _, bm, bk = store.shape
    if len(offsets) == 0:
        return torch.zeros((P, 1, 1, bm, bk), dtype=store.dtype, device=store.device)
    cap_u = max(send.shape[1] for send in sends)
    out = torch.zeros((P, len(offsets), cap_u, bm, bk), dtype=store.dtype, device=store.device)
    for r, (d, send) in enumerate(zip(offsets, sends)):
        if live is not None and r not in live:
            continue
        out[:, r, : send.shape[1]] = _receive(store, d, send, None if keeps is None else keeps[r])
    return out


def _check_mesh(plan: SpgemmPlan, mesh: WorkerMesh) -> None:
    if mesh.nparts != plan.nparts:
        raise PlanError(
            f"plan partitions over {plan.nparts} workers but the mesh has {mesh.nparts}")


class SpgemmExecutable:
    """A planned multiply bound to a mesh, through the staged engine.

    The plan's task list is laid out once, at construction, as one flat list
    over all workers — operand rows into the flattened per-worker operand
    buffers, output rows ``p * c_cap + c`` — and uploaded to the mesh's
    device; every ``__call__`` then only runs the exchange and the grouped
    GEMM over the resident stores.  ``impl`` is ``"ref"`` (the plain
    version), ``"kernel"`` (the ``block_spmm`` CUDA kernel, which raises off
    the card) or ``"auto"`` (whichever the stores' device takes).
    """

    def __init__(self, plan: SpgemmPlan, mesh: WorkerMesh, *, impl: str = "ref"):
        _check_mesh(plan, mesh)
        if impl not in STAGED_IMPLS:
            raise ValueError(f"staged impl={impl!r} not in {STAGED_IMPLS}")
        self.plan = plan
        self.mesh = mesh
        self.impl = impl
        dev = mesh.device
        self._a_sends = [_upload(plan.a_send[d], dev) for d in plan.a_offsets]
        self._b_sends = [_upload(plan.b_send[d], dev) for d in plan.b_offsets]
        P = plan.nparts
        valid = np.arange(plan.t_cap)[None, :] < plan.task_count[:, None]
        p, t = np.nonzero(valid)  # worker-major, each worker's tasks ascending
        if plan.exchange == "p2p":
            a_len = plan.a_cap + sum(plan.a_send[d].shape[1] for d in plan.a_offsets)
            b_len = plan.b_cap + sum(plan.b_send[d].shape[1] for d in plan.b_offsets)
        else:  # every worker indexes the one gathered [P * cap] stack
            a_len = b_len = 0
        self._valid = valid
        self._flat = (
            p * a_len + plan.task_a[p, t].astype(np.int64),
            p * b_len + plan.task_b[p, t].astype(np.int64),
            p * plan.c_cap + plan.task_c[p, t].astype(np.int64),
            (p, t),
        )
        self._num_out = P * plan.c_cap
        self._tasks = kops.task_arrays(*self._flat[:3], self._num_out, dev)

    def _operands(self, a_store: torch.Tensor, b_store: torch.Tensor):
        plan = self.plan
        if plan.exchange == "p2p":
            a_all = _exchange_bufs(a_store, plan.a_offsets, self._a_sends)
            b_all = _exchange_bufs(b_store, plan.b_offsets, self._b_sends)
        else:
            a_all, b_all = a_store, b_store
        flat = lambda x: x.reshape(-1, *x.shape[2:]).contiguous()  # noqa: E731
        return flat(a_all), flat(b_all)

    def _run(self, a_store, b_store, tasks) -> torch.Tensor:
        a_all, b_all = self._operands(a_store, b_store)
        c = kops.block_spmm_tensors(a_all, b_all, *tasks, self._num_out, impl=self.impl)
        return c.reshape(self.plan.nparts, self.plan.c_cap, *c.shape[1:])

    def __call__(self, a_store: torch.Tensor, b_store: torch.Tensor) -> torch.Tensor:
        """Run on per-worker padded stores ``[P, cap, bs, bs]``; returns C stores
        ``[P, c_cap, bs, bs]`` in fp32."""
        return self._run(a_store, b_store, self._tasks)


class MaskedSpgemmExecutable(SpgemmExecutable):
    """A full-structure staged multiply that takes a per-task on/off mask at call time.

    Built once from the *full* (unpruned) plan; each ``__call__`` receives
    ``task_on`` ``[P, t_cap]`` bool and drops the off tasks from the flat host
    task list before uploading it — so one executable serves every
    fluctuating ``tau``-prune pattern of delta-plan SpAMM without
    re-planning.  (The JAX package redirects off tasks to the trash row
    instead; the sums are the same.)
    """

    def __call__(self, a_store: torch.Tensor, b_store: torch.Tensor, task_on) -> torch.Tensor:
        p, t = self._flat[3]
        keep = np.asarray(task_on, dtype=bool)[p, t]
        a, b, c = (x[keep] for x in self._flat[:3])
        tasks = kops.task_arrays(a, b, c, self._num_out, self.mesh.device)
        return self._run(a_store, b_store, tasks)


class FusedSpgemmExecutable:
    """The planned multiply through the fused leaf engine.

    Uploads the plan's ``(src, off)`` task operand decomposition and each
    worker's CSR runs of its sorted output slots (built once from
    ``plan.task_c``; the trash row ``c_cap`` is never computed).  A call runs
    the exchange into stacked receive buffers and one fused
    unpack + GEMM + accumulate over all workers.  ``precision`` selects the
    storage/exchange dtype policy (``fp32`` | ``bf16``: bf16 casts the own
    stores before the exchange); ``adaptive`` needs a per-task mask and lives
    on :class:`MaskedFusedSpgemmExecutable`.
    """

    def __init__(self, plan: SpgemmPlan, mesh: WorkerMesh, *, impl: str = "fused",
                 precision: Precision = FP32):
        if precision.mode == "adaptive":
            raise ValueError("adaptive precision needs the masked fused executable")
        self._setup(plan, mesh, impl, precision)

    def _setup(self, plan, mesh, impl, precision) -> None:
        _check_mesh(plan, mesh)
        if impl != "fused":
            raise ValueError(f"the fused executables take impl='fused', got {impl!r}")
        if plan.task_a_src is None:
            raise PlanError("the fused engine needs a p2p plan with the (src, off) task decomposition")
        self.plan = plan
        self.mesh = mesh
        self.impl = impl
        self.precision = precision
        dev = mesh.device
        self._idx = [_upload(x, dev) for x in
                     (plan.task_a_src, plan.task_a_off, plan.task_b_src, plan.task_b_off)]
        self._run_ptr = _upload(fused_task_runs(plan.task_c, plan.c_cap), dev)
        self._a_sends = [_upload(plan.a_send[d], dev) for d in plan.a_offsets]
        self._b_sends = [_upload(plan.b_send[d], dev) for d in plan.b_offsets]

    def kernel_args(self, a_store, b_store, keeps=None, live=(None, None)) -> tuple:
        """Run the exchange; return the fused engine's positional arguments
        ``(a_store, a_recv, b_store, b_recv, a_src, a_off, b_src, b_off,
        run_ptr, c_cap)`` exactly as a call launches them."""
        plan = self.plan
        if self.precision.mode == "bf16":
            # cast before the exchange: halves the exchanged bytes too
            a_store, b_store = a_store.to(torch.bfloat16), b_store.to(torch.bfloat16)
        elif a_store.dtype != b_store.dtype:
            a_store, b_store = a_store.float(), b_store.float()
        a_keeps, b_keeps = keeps if keeps is not None else (None, None)
        a_recv = _exchange_stack(a_store, plan.a_offsets, self._a_sends, a_keeps, live[0])
        b_recv = _exchange_stack(b_store, plan.b_offsets, self._b_sends, b_keeps, live[1])
        return (a_store.contiguous(), a_recv, b_store.contiguous(), b_recv, *self._idx,
                self._run_ptr, plan.c_cap)

    def _run(self, a_store, b_store, *, keeps=None, live=(None, None), on=None, low=None):
        return kops.fused_block_spmm(*self.kernel_args(a_store, b_store, keeps, live),
                                     on=on, low=low, adaptive=self.precision.mode == "adaptive")

    def __call__(self, a_store: torch.Tensor, b_store: torch.Tensor) -> torch.Tensor:
        """Run on per-worker padded stores ``[P, cap, bs, bs]``; returns C stores
        ``[P, c_cap, bs, bs]`` in fp32."""
        return self._run(a_store, b_store)


def _send_task_spans(plan: SpgemmPlan):
    """Per (operand, round) CSR map: send slot ``(src, pos)`` -> the global
    task ids that read the delivered block.  Host-side, memoized on the plan
    — this is what lets the masked fused executable decide per call which
    send slots still matter."""
    maps = getattr(plan, "_send_task_spans", None)
    if maps is not None:
        return maps
    nparts = plan.nparts
    t_owner = plan.c_owner[plan.tasks.c_idx]
    tasks_of = [np.nonzero(t_owner == p)[0] for p in range(nparts)]
    maps = {}
    for name, offsets, send, send_cnt, store_idx, x_idx in (
        ("a", plan.a_offsets, plan.a_send, plan.a_send_count,
         plan.a_store_idx, plan.tasks.a_idx),
        ("b", plan.b_offsets, plan.b_send, plan.b_send_count,
         plan.b_store_idx, plan.tasks.b_idx),
    ):
        for d in offsets:
            cap_d = send[d].shape[1]
            starts = np.zeros(nparts * cap_d + 1, np.int64)
            cat = []
            for src in range(nparts):
                dst = (src + d) % nparts
                cnt = int(send_cnt[d][src])
                t_dst = tasks_of[dst]
                refs = x_idx[t_dst]
                order = np.argsort(refs, kind="stable")
                sorted_refs = refs[order]
                blocks = store_idx[src][send[d][src, :cnt]]
                lo = np.searchsorted(sorted_refs, blocks, "left")
                hi = np.searchsorted(sorted_refs, blocks, "right")
                base = src * cap_d
                for pos in range(cap_d):
                    if pos < cnt:
                        ids = t_dst[order[lo[pos] : hi[pos]]]
                        cat.append(ids)
                        starts[base + pos + 1] = starts[base + pos] + ids.size
                    else:
                        starts[base + pos + 1] = starts[base + pos]
            maps[(name, d)] = (
                starts,
                np.concatenate(cat) if cat else np.zeros(0, np.int64),
            )
    object.__setattr__(plan, "_send_task_spans", maps)
    return maps


def _exchange_keep_masks(plan: SpgemmPlan, keep_task: np.ndarray):
    """Per-round send keep masks + live round sets from a global kept-task
    mask.  Returns ``(a_keeps, b_keeps, live_a, live_b, stats)`` where each
    keeps entry is ``[P, cap_d]`` bool and stats counts pruned payload."""
    maps = _send_task_spans(plan)
    nparts = plan.nparts
    keeps_by, live_by = {}, {}
    stats = {"send_blocks": 0, "kept_blocks": 0, "dropped_rounds": 0}
    for name, offsets, send, send_cnt in (
        ("a", plan.a_offsets, plan.a_send, plan.a_send_count),
        ("b", plan.b_offsets, plan.b_send, plan.b_send_count),
    ):
        keeps, live = [], []
        for r, d in enumerate(offsets):
            starts, cat = maps[(name, d)]
            kt = keep_task[cat].astype(np.int64)
            cs = np.concatenate([[0], np.cumsum(kt)])
            keep = (cs[starts[1:]] - cs[starts[:-1]]) > 0
            keep = keep.reshape(nparts, send[d].shape[1])
            stats["send_blocks"] += int(np.asarray(send_cnt[d]).sum())
            stats["kept_blocks"] += int(keep.sum())
            if keep.any():
                live.append(r)
            else:
                stats["dropped_rounds"] += 1
            keeps.append(keep)
        keeps_by[name] = keeps
        live_by[name] = tuple(live)
    return keeps_by["a"], keeps_by["b"], live_by["a"], live_by["b"], stats


class MaskedFusedSpgemmExecutable(FusedSpgemmExecutable):
    """Delta-plan SpAMM through the fused engine, with exchange pruning.

    One full-structure executable serves every prune pattern: a call takes
    ``task_on`` ``[P, t_cap]`` bool, and the engine skips the off tasks in
    place (no trash-row redirect).  The mask also reaches the exchange: send
    slots referenced only by masked-out tasks ship zeros, and rounds whose
    every slot is masked are skipped.  ``task_low`` feeds the adaptive
    precision mode.  ``last_exchange`` records the pruning stats of the most
    recent call and ``last_keeps`` its host keep-mask pair
    ``(a_keeps, b_keeps)``, which the locality ledger reads to meter only the
    blocks that shipped (both None when it ran the full exchange).
    """

    def __init__(self, plan: SpgemmPlan, mesh: WorkerMesh, *, impl: str = "fused",
                 precision: Precision = FP32, prune_exchange: bool = True):
        self._setup(plan, mesh, impl, precision)
        self.prune_exchange = prune_exchange
        self.last_exchange: dict | None = None
        self.last_keeps: tuple | None = None

    def _keep_task_from_mask(self, task_on: np.ndarray) -> np.ndarray:
        plan = self.plan
        valid = np.arange(plan.t_cap)[None, :] < plan.task_count[:, None]
        keep_task = np.zeros(max(plan.tasks.num_tasks, 1), dtype=bool)
        keep_task[plan.task_gidx[task_on & valid]] = True
        return keep_task

    def __call__(self, a_store: torch.Tensor, b_store: torch.Tensor, task_on,
                 task_low=None) -> torch.Tensor:
        plan = self.plan
        dev = self.mesh.device
        task_on = np.asarray(task_on, dtype=bool)
        keeps, live = None, (None, None)
        self.last_exchange = self.last_keeps = None
        if self.prune_exchange and (plan.a_offsets or plan.b_offsets):
            a_keeps, b_keeps, live_a, live_b, stats = _exchange_keep_masks(
                plan, self._keep_task_from_mask(task_on))
            self.last_exchange = stats
            self.last_keeps = (a_keeps, b_keeps)
            keeps = ([_upload(k, dev, bool) for k in a_keeps], [_upload(k, dev, bool) for k in b_keeps])
            live = (live_a, live_b)
        low = None
        if self.precision.mode == "adaptive":
            low_host = np.zeros(task_on.shape, bool) if task_low is None else np.asarray(task_low) != 0
            low = _upload(low_host, dev, bool)
        return self._run(a_store, b_store, keeps=keeps, live=live,
                         on=_upload(task_on, dev, bool), low=low)


def dist_spgemm(
    plan: SpgemmPlan,
    a_data: torch.Tensor,
    b_data: torch.Tensor,
    mesh: WorkerMesh | None = None,
    *,
    impl: str = "fused",
) -> torch.Tensor:
    """Execute the planned multiply.  Returns C stores ``[P, c_cap, bs, bs]``.

    One-shot form: lays the global block stacks out into worker stores each
    call.  Iterative algorithms should hold an executable (via
    :mod:`repro_torch.dist`) instead.  The mesh defaults to the data's
    device.  ``impl="fused"`` (the default) runs the fused leaf engine on a
    p2p plan and the staged engine of the data's device (kernel on the card)
    on an allgather plan; ``"ref"`` / ``"kernel"`` pick the staged engine.
    """
    mesh = mesh or WorkerMesh(plan.nparts, a_data.device)
    a_store, b_store = shard_stores(plan, a_data.to(mesh.device), b_data.to(mesh.device))
    if impl == "fused" and plan.exchange == "p2p":
        exe = FusedSpgemmExecutable(plan, mesh)
    else:
        exe = SpgemmExecutable(plan, mesh, impl="auto" if impl == "fused" else impl)
    return exe(a_store, b_store)


def outer_accumulate_table(plan) -> np.ndarray:
    """``[P, c_cap, 1 + R]`` gather table of an outer plan's accumulate.

    Worker ``p``'s accumulate buffer is ``[own partials (p_cap) | receive
    buffer per offset, in offset order | one zero row]`` — the layout of the
    plan's ``acc_idx``.  Column 0 of C slot ``j`` indexes the worker's own
    partial of ``j``, column ``1 + r`` the partial of ``j`` that arrives in
    round ``r``; a source that sends nothing points at the zero row.  Each
    slot receives at most one partial from each source, so summing a row's
    columns left to right adds its partials in ascending ``acc_idx``
    position, the order of the JAX package's ``segment_sum``.
    """
    P, c_cap = plan.nparts, plan.c_cap
    widths = [plan.p_cap] + [int(plan.send[d].shape[1]) for d in plan.offsets]
    zero_row = sum(widths)
    if plan.acc_idx.shape != (P, zero_row):
        raise PlanError(f"acc_idx of shape {plan.acc_idx.shape} for an accumulate "
                        f"buffer of {zero_row} rows")
    col = np.repeat(np.arange(len(widths)), widths)
    table = np.full((P, c_cap + 1, len(widths)), zero_row, dtype=np.int64)
    for p in range(P):
        live = np.nonzero(plan.acc_idx[p] < c_cap)[0]
        slot, c = plan.acc_idx[p, live].astype(np.int64), col[live]
        flat = slot * len(widths) + c
        if np.unique(flat).size != flat.size:
            raise PlanError(f"outer plan: worker {p} receives two partials of one C slot "
                            "from one source")
        table[p, slot, c] = live
    return table[:, :c_cap]


class OuterSpgemmExecutable:
    """The outer-product multiply (:mod:`repro_torch.core.outer`) bound to a mesh.

    Both operands of every task are local by construction, so the numeric
    phase is one ``block_spmm`` launch over every worker's task list: the
    stores are flattened to ``[P * a_cap]`` / ``[P * b_cap]``, worker
    ``p``'s operand rows are offset by ``p * a_cap`` / ``p * b_cap`` and its
    partial slots by ``p * p_cap``, and the padded task slots are dropped on
    the host (each worker's first ``task_count[p]`` tasks are real).  Each
    worker's partial slots are sorted, so the flat output list is sorted
    across workers and no trash row is written.  Then one exchange round per
    offset ships the partials to their C owners (:func:`_receive` on the
    ``[P, p_cap]`` partial store), and the accumulate is a gather over
    :func:`outer_accumulate_table` summed column by column — no scatter-add,
    no atomics.  ``impl`` picks the ``block_spmm`` route as
    :class:`SpgemmExecutable` does.  The plan's index arrays are uploaded
    once, at construction.
    """

    def __init__(self, plan, mesh: WorkerMesh, *, impl: str = "auto"):
        if mesh.nparts != plan.nparts:
            raise PlanError(
                f"plan partitions over {plan.nparts} workers but the mesh has {mesh.nparts}")
        if impl not in STAGED_IMPLS:
            raise ValueError(f"outer impl={impl!r} not in {STAGED_IMPLS}")
        self.plan = plan
        self.mesh = mesh
        self.impl = impl
        dev = mesh.device
        valid = np.arange(plan.t_cap)[None, :] < plan.task_count[:, None]
        p, t = np.nonzero(valid)  # worker-major, each worker's tasks ascending
        self._num_out = plan.nparts * plan.p_cap
        self._tasks = kops.task_arrays(
            p * plan.a_cap + plan.task_a[p, t].astype(np.int64),
            p * plan.b_cap + plan.task_b[p, t].astype(np.int64),
            p * plan.p_cap + plan.task_c[p, t].astype(np.int64),
            self._num_out, dev)
        self._sends = [_upload(plan.send[d], dev) for d in plan.offsets]
        self._p = _upload(np.arange(plan.nparts)[:, None], dev)
        self._table = _upload(outer_accumulate_table(plan), dev)

    def partials(self, a_store: torch.Tensor, b_store: torch.Tensor) -> torch.Tensor:
        """Every worker's partial C blocks, ``[P, p_cap, bs, bs]`` fp32: one kernel launch."""
        flat = lambda x: x.reshape(-1, *x.shape[2:]).contiguous()  # noqa: E731
        c = kops.block_spmm_tensors(flat(a_store), flat(b_store), *self._tasks,
                                    self._num_out, impl=self.impl)
        return c.reshape(self.plan.nparts, self.plan.p_cap, *c.shape[1:])

    def exchange(self, partials: torch.Tensor) -> list[torch.Tensor]:
        """One round per offset: what each worker receives, ``[P, cap_d, bs, bs]``."""
        return [_receive(partials, d, send) for d, send in zip(self.plan.offsets, self._sends)]

    def accumulate(self, partials: torch.Tensor, received: list) -> torch.Tensor:
        """C stores ``[P, c_cap, bs, bs]`` from the own partials and the received ones."""
        return self._sum_columns(self._buffer(partials, received))

    @staticmethod
    def _buffer(partials: torch.Tensor, received: list) -> torch.Tensor:
        """Each worker's accumulate buffer ``[own partials | received per offset | zero row]``."""
        P, _, bm, bn = partials.shape
        return torch.cat([partials, *received, partials.new_zeros((P, 1, bm, bn))], dim=1)

    def _sum_columns(self, buf: torch.Tensor) -> torch.Tensor:
        table = self._table
        c = buf[self._p, table[..., 0]]
        for col in range(1, table.shape[2]):
            c += buf[self._p, table[..., col]]
        return c

    def __call__(self, a_store: torch.Tensor, b_store: torch.Tensor) -> torch.Tensor:
        """Run on per-worker operand stores (``a_store`` ``[P, a_cap, bs, bs]``,
        ``b_store`` ``[P, b_cap, bs, bs]``); returns C stores ``[P, c_cap, bs, bs]`` fp32."""
        partials = self.partials(a_store, b_store)
        buf = self._buffer(partials, self.exchange(partials))
        del partials  # the buffer holds a copy: free it before the gather allocates C
        return self._sum_columns(buf)


def dist_spgemm_outer(plan, a_data: torch.Tensor, b_data: torch.Tensor,
                      mesh: WorkerMesh | None = None, *, impl: str = "auto") -> torch.Tensor:
    """Execute an :class:`~repro_torch.core.outer.OuterPlan`.  Returns C stores
    ``[P, c_cap, bs, bs]`` (reassemble with :func:`unshard_result`).

    One-shot form: lays the global block stacks out into the plan's
    contraction-index stores each call.  The mesh defaults to the data's
    device; ``impl`` is ``"auto"`` (the ``block_spmm`` kernel on the card,
    its plain version on the CPU), ``"kernel"`` or ``"ref"``.
    """
    mesh = mesh or WorkerMesh(plan.nparts, a_data.device)
    a_store, b_store = shard_stores(plan, a_data.to(mesh.device), b_data.to(mesh.device))
    return OuterSpgemmExecutable(plan, mesh, impl=impl)(a_store, b_store)


def unshard_result(plan: SpgemmPlan, c_stores: torch.Tensor, shape, bs) -> BSMatrix:
    """Reassemble the global BSMatrix from per-worker C stores (on their device)."""
    dev = c_stores.device
    owner = _upload(plan.c_owner, dev)
    slot = _upload(plan.c_slot, dev)
    return BSMatrix(shape=tuple(shape), bs=bs, coords=plan.c_coords,
                    data=c_stores[owner, slot])
