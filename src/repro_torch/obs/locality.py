"""Data-locality ledger — who owned each operand byte, who fetched it, how often.

The paper's central empirical claim is that the runtime "dynamically
exploit[s] data locality to avoid movement of data".  The tracer measures
*time* and the memory meter measures *bytes resident*, but neither
attributes movement to *placement decisions*.  This module closes that gap:

* :class:`LocalityLedger` — rides on the plan cache like the tracer and
  event log (``cache.locality_ledger``, installed via :meth:`install`,
  read back with ``getattr`` so un-instrumented dispatches pay nothing).
  Every multiply-family dispatch feeds it one :meth:`note_dispatch` call;
  the ledger decomposes the executed plan's operand reads into
  locally-owned vs shipped bytes (static residency split, from
  :func:`repro_torch.core.schedule.plan_byte_provenance`), meters what actually
  crossed the wire (delta-mask pruning and bf16 wire halving applied), and
  accumulates per-block movement lineage — who owned a block, who fetched
  it, and how many times across the run.  A block re-fetched every
  iteration is the cache-opportunity signal a future exchange cache would
  exploit.
* :func:`locality_snapshot` / :func:`locality_iteration` — the driver-side
  per-iteration emission pair: fraction fields into the stats row, span
  attrs on the iteration span, tracer gauges, and one ``locality``
  :class:`~repro_torch.obs.log.EventLog` record.

Accounting invariants (tested in ``tests/test_locality.py``):

* ``local_bytes + shipped_bytes == referenced_bytes`` exactly — the static
  residency split conserves, per worker and in total.
* ``local_bytes`` is a placement property, not a mask property: delta-mask
  pruning shrinks ``wire_recv_bytes`` but never ``local_bytes`` (a locally
  owned block is resident whether or not this dispatch's mask reads it).
* For p2p plans the static ``shipped`` decomposition equals
  ``plan_worker_bytes``'s ``recv_actual`` bit-for-bit (hypothesis-tested
  in the analysis CI job).

The ledger only ever meters *verified* plans: :meth:`install` refuses a
cache whose static-verification policy is ``"off"``.
"""

from __future__ import annotations

import json
import typing

import numpy as np

from .log import log_of
from .tracer import tracer_of

if typing.TYPE_CHECKING:  # core.cache imports obs.log: keep obs<->core lazy
    from ..core.schedule import SpgemmPlan

__all__ = [
    "LocalityLedger",
    "ledger_of",
    "plan_provenance",
    "locality_snapshot",
    "locality_iteration",
    "LOCALITY_ITER_KEYS",
]

#: rider attribute memoizing a plan's static byte provenance (computed once
#: per plan, like the dispatch annotations' ``_obs_static`` rider)
_PROV_ATTR = "_obs_locality"
_STATIC_ATTR = "_obs_locality_dispatch"
_WIRE_ATTR = "_obs_locality_wire"

#: the per-worker account vectors a ledger sums
_PW_KEYS = ("referenced", "local", "shipped", "wire_recv", "wire_send", "local_flops",
            "total_flops")

#: the per-iteration fields locality_iteration() appends to driver rows —
#: schema-stable like SHARED_ITER_KEYS
LOCALITY_ITER_KEYS = (
    "locality_flops",
    "locality_bytes",
    "local_bytes",
    "shipped_bytes",
    "wire_recv_bytes",
    "wire_send_bytes",
)


def plan_provenance(plan: SpgemmPlan) -> dict:
    """Memoized :func:`~repro_torch.core.schedule.plan_byte_provenance` of a plan.

    The provenance is a pure structural property, so it rides on the frozen
    plan (``object.__setattr__``) and every later dispatch of the same plan
    reuses it — steady-state dispatch cost is a few vector adds.
    """
    prov = getattr(plan, _PROV_ATTR, None)
    if prov is None:
        from ..core.schedule import plan_byte_provenance  # lazy: import cycle

        prov = plan_byte_provenance(plan)
        object.__setattr__(plan, _PROV_ATTR, prov)
    return prov


def _frac(num: float, den: float) -> float:
    return float(num / den) if den > 0 else 1.0


class LocalityLedger:
    """Cumulative locality account of every verified multiply dispatch.

    Scalar totals are mirrored by per-worker vectors (lazily sized to the
    first dispatched plan's ``nparts``).  Movement lineage is appended as
    raw per-dispatch arrays and aggregated only in :meth:`moved_blocks` /
    :meth:`summary`, keeping the dispatch-path cost flat.
    """

    def __init__(self, *, top_k: int = 10):
        self.top_k = int(top_k)
        self.nparts: int | None = None
        self.dispatches = 0
        # static residency split, fp32 itemsize (conserving: local + shipped
        # == referenced, per worker)
        self.referenced_bytes = 0.0
        self.local_bytes = 0.0
        self.shipped_bytes = 0.0
        # what actually crossed the wire: delta-mask pruning drops whole
        # blocks, reduced precision halves the per-block payload
        self.wire_recv_bytes = 0.0
        self.wire_send_bytes = 0.0
        # locally-satisfied flops (both operands resident on the task's
        # worker) vs total executed flops — runtime task masks honored
        self.local_flops = 0.0
        self.total_flops = 0.0
        self._pw: dict[str, np.ndarray] | None = None
        # per-worker increments, or a masked dispatch's inputs, not yet summed
        self._pending: list = []
        # movement lineage: per dispatch (a_codes, b_codes, plan, keeps)
        self._lineage: list[tuple] = []

    # -- wiring ---------------------------------------------------------------
    def install(self, cache) -> "LocalityLedger":
        """Attach as ``cache.locality_ledger``.

        Refuses a cache with static verification off: the ledger's numbers
        are placement claims about executed plans, and an unverified plan
        could mis-attribute every byte.
        """
        if getattr(cache, "verify", "off") == "off":
            raise ValueError(
                "locality ledger only meters verified plans: set "
                "cache.verify to 'cached-once' or 'always', not 'off'")
        cache.locality_ledger = self
        return self

    # -- dispatch-side metering ----------------------------------------------
    def note_dispatch(self, plan: SpgemmPlan, *, wire_itemsize: int = 4,
                      task_on: np.ndarray | None = None,
                      keeps: tuple | None = None,
                      a_codes: np.ndarray | None = None,
                      b_codes: np.ndarray | None = None) -> dict:
        """Meter one executed plan; returns this dispatch's scalar deltas.

        ``task_on`` is the delta-plan runtime task mask (``[P, t_cap]``
        bool) when the dispatch masked tasks; ``keeps`` is the per-round
        exchange keep-mask pair ``(a_keeps, b_keeps)`` when the fused
        masked engine also pruned the wire.  ``a_codes`` / ``b_codes`` are
        the operands' Morton codes — the structure-stable block identity
        lineage is keyed by (falls back to global indices, which are only
        stable within one structure).
        """
        prov = plan_provenance(plan)
        if self._pw is None:
            self.nparts = plan.nparts
            self._pw = {k: np.zeros(plan.nparts, dtype=np.float64) for k in _PW_KEYS}
        if task_on is None and keeps is None:
            # the whole plan ran over its full exchange: every number is a
            # property of the plan and the wire type, computed once
            static = _plan_dispatch_static(plan, prov, wire_itemsize)
            out = static["out"]
            self._pending.append(static["per_worker"])
        else:
            out = _dispatch_totals(plan, prov, wire_itemsize, task_on, keeps)
            # the per-worker split of a masked dispatch is worked out when read
            self._pending.append((plan, prov, wire_itemsize, task_on, keeps))
        # lineage keeps references (a plan's fetches, a matrix's codes and a
        # dispatch's keep masks never change); fetches are resolved and
        # Morton keys looked up only when moved_blocks() aggregates
        self._lineage.append((a_codes, b_codes, plan, keeps))

        self.dispatches += 1
        self.referenced_bytes += out["referenced_bytes"]
        self.local_bytes += out["local_bytes"]
        self.shipped_bytes += out["shipped_bytes"]
        self.wire_recv_bytes += out["wire_recv_bytes"]
        self.wire_send_bytes += out["wire_send_bytes"]
        self.local_flops += out["local_flops"]
        self.total_flops += out["total_flops"]
        return dict(out)

    def _per_worker(self) -> dict | None:
        """The per-worker totals, with every pending dispatch added.  A plan's
        static increments are added once, times the dispatches that ran it:
        every term is a whole number of bytes or FLOPs, so (below 2**53) the
        sums are exact in any order and grouping."""
        pw = self._pw
        if self._pending:
            static: dict[int, list] = {}
            for vec in self._pending:
                if isinstance(vec, tuple):
                    for k, v in _dispatch_account(*vec)[0].items():
                        pw[k] += v
                else:
                    static.setdefault(id(vec), [vec, 0])[1] += 1
            for vec, times in static.values():
                for k, v in vec.items():
                    pw[k] += v * times
            self._pending.clear()
        return pw

    def _fetches(self, name: str):
        """``(codes, gids, src, dst)`` per dispatch with fetches of operand ``name``."""
        for a_codes, b_codes, plan, keeps in self._lineage:
            if keeps is None:
                gids, src, dst = plan_provenance(plan)[f"fetch_{name}"]
            else:
                gids, src, dst = _kept_fetches(plan, name, keeps[0 if name == "a" else 1])
            if gids.size:
                yield (a_codes if name == "a" else b_codes), gids, src, dst

    # -- per-iteration deltas -------------------------------------------------
    def snapshot(self) -> tuple:
        """Scalar snapshot for per-iteration deltas (see :meth:`delta`)."""
        return (self.local_flops, self.total_flops, self.local_bytes,
                self.shipped_bytes, self.referenced_bytes,
                self.wire_recv_bytes, self.wire_send_bytes)

    def delta(self, snap: tuple) -> dict:
        """Locality accumulated since ``snap``: the per-iteration fields
        (:data:`LOCALITY_ITER_KEYS`) the drivers append to stats rows."""
        lf, tf, lb, sb, rb, wr, ws = snap
        d_lf = self.local_flops - lf
        d_tf = self.total_flops - tf
        d_lb = self.local_bytes - lb
        d_rb = self.referenced_bytes - rb
        return dict(
            locality_flops=_frac(d_lf, d_tf),
            locality_bytes=_frac(d_lb, d_rb),
            local_bytes=d_lb,
            shipped_bytes=self.shipped_bytes - sb,
            wire_recv_bytes=self.wire_recv_bytes - wr,
            wire_send_bytes=self.wire_send_bytes - ws,
        )

    # -- aggregation ----------------------------------------------------------
    def moved_blocks(self, top_k: int | None = None) -> list[dict]:
        """The most-fetched blocks across the run, most-moved first.

        One record per (operand, block): fetch count (re-fetch across
        iterations counts every time — the cache-opportunity signal),
        distinct fetching workers, and the owning worker(s) observed.
        """
        top_k = self.top_k if top_k is None else int(top_k)
        out = []
        for op in ("a", "b"):
            chunks = [(np.asarray(gids if codes is None else codes[gids], dtype=np.int64), s, d)
                      for codes, gids, s, d in self._fetches(op)]
            if not chunks:
                continue
            codes = np.concatenate([c for c, _, _ in chunks])
            src = np.concatenate([s for _, s, _ in chunks])
            dst = np.concatenate([d for _, _, d in chunks])
            uniq, inv, cnts = np.unique(codes, return_inverse=True,
                                        return_counts=True)
            for i in np.argsort(-cnts, kind="stable")[:top_k]:
                sel = inv == i
                out.append(dict(
                    operand=op,
                    code=int(uniq[i]),
                    fetches=int(cnts[i]),
                    fetchers=np.unique(dst[sel]).astype(int).tolist(),
                    owners=np.unique(src[sel]).astype(int).tolist(),
                ))
        out.sort(key=lambda r: -r["fetches"])
        return out[:top_k]

    def summary(self) -> dict:
        """JSON-safe run totals: fractions, per-worker table, moved blocks."""
        pw = self._per_worker()
        per_worker = []
        if pw is not None:
            for p in range(self.nparts):
                per_worker.append(dict(
                    worker=p,
                    referenced_bytes=float(pw["referenced"][p]),
                    local_bytes=float(pw["local"][p]),
                    shipped_bytes=float(pw["shipped"][p]),
                    wire_recv_bytes=float(pw["wire_recv"][p]),
                    wire_send_bytes=float(pw["wire_send"][p]),
                    locality_bytes=_frac(pw["local"][p], pw["referenced"][p]),
                    locality_flops=_frac(pw["local_flops"][p],
                                         pw["total_flops"][p]),
                ))
        return dict(
            dispatches=self.dispatches,
            nparts=self.nparts,
            locality_flops=_frac(self.local_flops, self.total_flops),
            locality_bytes=_frac(self.local_bytes, self.referenced_bytes),
            referenced_bytes=self.referenced_bytes,
            local_bytes=self.local_bytes,
            shipped_bytes=self.shipped_bytes,
            wire_recv_bytes=self.wire_recv_bytes,
            wire_send_bytes=self.wire_send_bytes,
            local_flops=self.local_flops,
            total_flops=self.total_flops,
            per_worker=per_worker,
            moved_blocks=self.moved_blocks(),
        )

    def write(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)
            fh.write("\n")
        return path


def _dispatch_account(plan: SpgemmPlan, prov: dict, wire_itemsize: int, task_on, keeps):
    """One dispatch's per-worker increments and scalar deltas: the executed
    tasks (``task_on``, else all of the plan's) and the kept wire (``keeps``,
    else the whole planned exchange at ``wire_itemsize``)."""
    flop = 2.0 * float(plan.bs) ** 3
    if task_on is None:
        counts = plan.task_count.astype(np.float64)
        lcounts = prov["local_tasks"].astype(np.float64)
    else:
        counts = task_on.sum(axis=1).astype(np.float64)
        lcounts = (prov["task_local"] & task_on).sum(axis=1).astype(np.float64)
    if keeps is None:
        scale = wire_itemsize / 4.0
        wrecv = prov["wire_recv"] * scale
        wsend = prov["wire_send"] * scale
    else:
        wrecv, wsend = _kept_wire(plan, keeps, wire_itemsize)
    vec = dict(referenced=prov["referenced"], local=prov["local"], shipped=prov["shipped"],
               total_flops=counts * flop, local_flops=lcounts * flop,
               wire_recv=wrecv, wire_send=wsend)
    out = dict(
        referenced_bytes=float(prov["referenced"].sum()),
        local_bytes=float(prov["local"].sum()),
        shipped_bytes=float(prov["shipped"].sum()),
        wire_recv_bytes=float(wrecv.sum()),
        wire_send_bytes=float(wsend.sum()),
        local_flops=float(lcounts.sum() * flop),
        total_flops=float(counts.sum() * flop),
    )
    return vec, out


def _dispatch_totals(plan: SpgemmPlan, prov: dict, wire_itemsize: int, task_on, keeps) -> dict:
    """:func:`_dispatch_account`'s scalar deltas alone, in a few array passes:
    every term is a whole number of bytes or FLOPs (exact in float64), so a
    total of counts equals the sum of the per-worker terms."""
    flop = 2.0 * float(plan.bs) ** 3
    st = _plan_dispatch_static(plan, prov, wire_itemsize)["out"]
    out = dict(st)
    if task_on is not None:
        out["total_flops"] = float(np.count_nonzero(task_on)) * flop
        out["local_flops"] = float(np.count_nonzero(prov["task_local"] & task_on)) * flop
    if keeps is not None:
        wblk = float(plan.bs * plan.bs * wire_itemsize)
        kept = sum(int(np.count_nonzero(np.concatenate(
            [np.asarray(x, dtype=bool) for x in keep], axis=1) & live))
            for (live, *_), keep in zip(_wire_layout(plan), keeps) if keep)
        out["wire_recv_bytes"] = out["wire_send_bytes"] = float(kept) * wblk
    return out


def _plan_dispatch_static(plan: SpgemmPlan, prov: dict, wire_itemsize: int) -> dict:
    """:func:`_dispatch_account` of a dispatch that ran the whole plan, memoized
    on the frozen plan per wire itemsize, as :func:`plan_provenance` is."""
    memo = getattr(plan, _STATIC_ATTR, None)
    if memo is None:
        memo = {}
        object.__setattr__(plan, _STATIC_ATTR, memo)
    st = memo.get(wire_itemsize)
    if st is None:
        vec, out = _dispatch_account(plan, prov, wire_itemsize, None, None)
        st = memo[wire_itemsize] = dict(per_worker=vec, out=out)
    return st


def _kept_wire(plan: SpgemmPlan, keeps: tuple, wire_itemsize: int):
    """Per-worker wire bytes of a keep-mask-pruned exchange.

    Each operand's rounds are concatenated along the slot axis and counted
    per (sender, round) in one pass; the per-round send counts, slot spans
    and receivers are plan-static (:func:`_wire_layout`).  Every term is a
    whole number of blocks, so the float64 sums are exact in any order."""
    P = plan.nparts
    wblk = float(plan.bs * plan.bs * wire_itemsize)
    wrecv = np.zeros(P, dtype=np.float64)
    wsend = np.zeros(P, dtype=np.float64)
    for (live, bounds, dst, _, _), keep in zip(_wire_layout(plan), keeps):
        if not keep:
            continue
        k = np.concatenate([np.asarray(x, dtype=bool) for x in keep], axis=1) & live
        cs = np.zeros((P, k.shape[1] + 1), dtype=np.int64)
        np.cumsum(k, axis=1, out=cs[:, 1:])
        kept = (cs[:, bounds[1:]] - cs[:, bounds[:-1]]).astype(np.float64) * wblk  # [P, rounds]
        wsend += kept.sum(axis=1)
        wrecv += np.bincount(dst.ravel(), weights=kept.ravel(), minlength=P)
    return wrecv, wsend


def _wire_layout(plan: SpgemmPlan) -> tuple:
    """Per operand ``(live, bounds, dst, send, rnd)``, memoized on the plan:
    ``live`` marks the slots below each sender's count across the
    concatenated rounds, ``bounds`` the rounds' slot spans, ``dst[p, r]`` the
    worker that receives sender ``p``'s round ``r``, ``send`` the rounds'
    send-slot tables concatenated the same way and ``rnd`` each slot's round."""
    memo = getattr(plan, _WIRE_ATTR, None)
    if memo is None:
        P = plan.nparts
        memo = []
        for offs, send, send_cnt in ((plan.a_offsets, plan.a_send, plan.a_send_count),
                                     (plan.b_offsets, plan.b_send, plan.b_send_count)):
            caps = [send[d].shape[1] for d in offs]
            live = np.concatenate(
                [np.arange(c)[None, :] < np.asarray(send_cnt[d])[:, None]
                 for c, d in zip(caps, offs)] or [np.zeros((P, 0), bool)], axis=1)
            bounds = np.concatenate([[0], np.cumsum(caps, dtype=np.int64)])
            dst = (np.arange(P)[:, None] + np.asarray(offs, dtype=np.int64)[None, :]) % P
            slots = np.concatenate([np.asarray(send[d], dtype=np.int64) for d in offs]
                                   or [np.zeros((P, 0), np.int64)], axis=1)
            rnd = np.repeat(np.arange(len(caps)), caps)
            memo.append((live, bounds, dst, slots, rnd))
        memo = tuple(memo)
        object.__setattr__(plan, _WIRE_ATTR, memo)
    return memo


def _kept_fetches(plan: SpgemmPlan, name: str, keep: list):
    """(gids, src, dst) of the blocks a pruned exchange actually delivered, in
    delivery order (by round, then sender, then slot), in one pass over the
    rounds concatenated along the slot axis (:func:`_wire_layout`)."""
    live, _, dst, slots, rnd = _wire_layout(plan)[0 if name == "a" else 1]
    store_idx = plan.a_store_idx if name == "a" else plan.b_store_idx
    src, col = (np.nonzero(np.concatenate([np.asarray(x, dtype=bool) for x in keep], axis=1)
                           & live) if keep else (np.zeros(0, np.int64),) * 2)
    if not src.size:
        z = np.zeros(0, np.int64)
        return z, np.zeros(0, np.int32), np.zeros(0, np.int32)
    r = rnd[col]
    order = np.argsort(r, kind="stable")  # nonzero's (sender, slot) order within a round
    src, col, r = src[order], col[order], r[order]
    return (np.asarray(store_idx[src, slots[src, col]], dtype=np.int64), src.astype(np.int32),
            dst[src, r].astype(np.int32))


def ledger_of(cache) -> LocalityLedger | None:
    """The ledger riding on the plan cache, or None when not installed."""
    if cache is None:
        return None
    return getattr(cache, "locality_ledger", None)


def locality_snapshot(cache) -> tuple | None:
    """Iteration-top ledger snapshot; None when no ledger is installed."""
    lld = ledger_of(cache)
    return lld.snapshot() if lld is not None else None


def locality_iteration(cache, scope, snap: tuple | None, *,
                       iteration, driver: str) -> dict:
    """Per-iteration locality emission: returns the row-extra fields and
    lands the same numbers as span attrs, tracer gauges and an EventLog
    ``locality`` record.  A cheap no-op dict when no ledger is installed,
    so un-instrumented drivers pay a getattr and nothing else."""
    lld = ledger_of(cache)
    if lld is None or snap is None:
        return {}
    fields = lld.delta(snap)
    scope.annotate(**fields)
    tr = tracer_of(cache)
    if tr.enabled:
        tr.gauge("locality_flops").set(fields["locality_flops"])
        tr.gauge("locality_bytes").set(fields["locality_bytes"])
    lg = log_of(cache)
    if lg.enabled:
        lg.info("locality", driver=driver, iteration=iteration, **fields)
    return fields
