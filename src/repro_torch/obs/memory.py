"""Per-worker device-memory accounting for the resident runtime.

The runtime's device footprint is fully determined by host-side symbolic
state: block stores are padded ``[P, cap, bs, bs]`` arrays, exchange receive
buffers are sized by the plan's padded per-round send capacities, norm
tables are one float per block.  :class:`MemoryMeter` folds those into
per-worker byte accounts *without touching the device*:

* :func:`matrix_worker_bytes` — physical store bytes per worker (uniform:
  the padded store allocates ``cap`` rows on every device) plus the actual
  (unpadded) resident block bytes per worker, which *do* skew with the
  owner map and are what a re-layout changes.
* :func:`plan_memory_bytes` — the transient footprint of one planned
  multiply dispatch: operand stores, padded receive buffers per exchange
  round (or the full allgather payload), the output store, and the task
  index arrays.  Memoized on the plan (``plan._obs_mem``) like the
  balancer's ``_obs_static`` so zero-miss replays pay one getattr.
* The meter keeps **peak watermarks per account kind** ("collective") and a
  per-worker peak vector, surfaces them as tracer gauges
  (``mem_<kind>_peak_bytes`` plus per-worker ``mem_peak_w<p>_bytes`` on
  :meth:`MemoryMeter.flush`), so the memory column of
  ``python -m repro_torch.obs.report`` can be reconstructed from a written trace
  file alone.
* :func:`cuda_memory_stats` — the caching allocator's counters
  (``torch.cuda.memory_stats``) of every card, so the symbolic account can
  be cross-checked against the allocator on the card; ``None`` on the CPU.
  (The JAX package's ``jax_memory_stats``.)

The meter rides on the plan cache (``cache.memory_meter``, default None);
the multiply dispatch sites and collectives note into it behind a cheap
``getattr`` so accounting off costs nothing and cannot perturb numerics.
"""

from __future__ import annotations

import numpy as np
import torch

from .tracer import tracer_of

__all__ = [
    "MemoryMeter",
    "meter_of",
    "matrix_worker_bytes",
    "plan_memory_bytes",
    "cuda_memory_stats",
]

#: index arrays shipped per task slot (task_a, task_b, task_c, task_gidx,
#: and the four fused (src, off) address arrays), int32 each
_TASK_INDEX_ARRAYS = 8

_ITEMSIZES: dict = {}


def _itemsize(dtype) -> int:
    v = _ITEMSIZES.get(dtype)
    if v is None:
        v = dtype.itemsize if isinstance(dtype, torch.dtype) else int(np.dtype(str(dtype)).itemsize)
        _ITEMSIZES[dtype] = v
    return v


def matrix_worker_bytes(x) -> dict:
    """Store bytes of a :class:`~repro_torch.dist.matrix.DistBSMatrix`.

    ``physical`` is what the store allocates per worker — the padded store row
    count times the block size, identical on every device by construction.
    ``actual`` is the per-worker bytes of *valid* resident blocks (the
    quantity an owner re-layout moves).
    """
    itemsize = _itemsize(x.dtype) if x.nnzb else 4
    blk = x.bs * x.bs * itemsize
    physical = np.full(x.nparts, float(x.cap * blk))
    actual = np.bincount(x.owner, minlength=x.nparts).astype(np.float64) * blk
    return dict(physical=physical, actual=actual, blk=blk)


def plan_memory_bytes(plan, precision=None) -> dict:
    """Per-worker transient device bytes of one planned multiply dispatch.

    Operand stores are always fp32; the *wire* (receive buffers) honors the
    precision policy's storage dtype (bf16 halves them).  Memoized on the
    plan keyed by wire itemsize, so per-iteration accounting on a cached
    plan is a dict lookup.
    """
    wire_itemsize = 4
    if precision is not None and getattr(precision, "mode", "fp32") != "fp32":
        wire_itemsize = 2
    memo = getattr(plan, "_obs_mem", None)
    if memo is not None and wire_itemsize in memo:
        return memo[wire_itemsize]

    P = plan.nparts
    blk_store = plan.bs * plan.bs * 4
    blk_wire = plan.bs * plan.bs * wire_itemsize
    own = float((plan.a_cap + plan.b_cap) * blk_store)
    out = float(plan.c_cap * blk_store)
    if plan.exchange == "allgather":
        recv = float((P - 1) * (plan.a_cap + plan.b_cap) * blk_wire)
    else:
        recv = 0.0
        for offs, send_pad in ((plan.a_offsets, plan.a_send),
                               (plan.b_offsets, plan.b_send)):
            for d in offs:
                recv += float(send_pad[d].shape[1] * blk_wire)
    index = float(plan.t_cap * 4 * _TASK_INDEX_ARRAYS)
    per_worker = np.full(P, own + recv + out + index)
    result = dict(
        own_bytes=own,
        recv_buffer_bytes=recv,
        out_bytes=out,
        index_bytes=index,
        total_bytes=own + recv + out + index,
        per_worker=per_worker,
    )
    memo = dict(memo) if memo else {}
    memo[wire_itemsize] = result
    try:
        object.__setattr__(plan, "_obs_mem", memo)
    except AttributeError:
        pass
    return result


def cuda_memory_stats() -> list[dict] | None:
    """The caching allocator's counters per CUDA card, or None without one.

    One dict per card: ``device`` plus every numeric key of
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.current`` /
    ``allocated_bytes.all.peak`` / ``reserved_bytes.all.current`` ...).
    Returns None when no card is present (the CPU worker mesh).
    """
    if not torch.cuda.is_available():
        return None
    out = []
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        out.append(dict(device=d, **{k: v for k, v in stats.items()
                                     if isinstance(v, (int, float))}))
    return out or None


class MemoryMeter:
    """Peak-watermark device-memory accounts, per kind and per worker.

    ``current[kind]`` / ``peak[kind]`` are ``[P]`` byte vectors; the
    per-worker total watermark (:meth:`worker_peak`) sums the per-kind
    peaks — an upper bound on concurrent residency (stores persist across
    dispatches, receive buffers do not overlap between collectives).
    """

    enabled = True

    def __init__(self):
        self.nparts = 0
        self.current: dict[str, np.ndarray] = {}
        self.peak: dict[str, np.ndarray] = {}
        self.notes = 0

    def install(self, cache) -> "MemoryMeter":
        cache.memory_meter = self
        return self

    def _bump(self, kind: str, per_worker: np.ndarray, tracer=None) -> None:
        per_worker = np.asarray(per_worker, dtype=np.float64)
        self.nparts = max(self.nparts, per_worker.shape[0])
        self.current[kind] = per_worker
        prev = self.peak.get(kind)
        if prev is None or prev.shape != per_worker.shape:
            self.peak[kind] = per_worker.copy()
        else:
            np.maximum(prev, per_worker, out=prev)
        self.notes += 1
        if tracer is not None and tracer.enabled:
            tracer.gauge(f"mem_{kind}_peak_bytes").set(
                float(self.peak[kind].max()))

    # -- accounting entry points (all host-side symbolic math) ---------------
    def note_matrix(self, x, kind: str = "store", cache=None, worker_bytes=None) -> None:
        """Account a resident matrix's physical store bytes per worker
        (``worker_bytes``: its :func:`matrix_worker_bytes`, when the caller
        holds them)."""
        b = matrix_worker_bytes(x) if worker_bytes is None else worker_bytes
        self._bump(kind, b["physical"], tracer_of(cache))
        self._bump(kind + "_actual", b["actual"])

    def note_plan(self, plan, precision=None, kind: str = "multiply",
                  cache=None) -> None:
        """Account one planned dispatch's transient footprint per worker."""
        m = plan_memory_bytes(plan, precision)
        self._bump(kind, m["per_worker"], tracer_of(cache))

    def note_bytes(self, kind: str, per_worker, cache=None) -> None:
        """Account an arbitrary per-worker byte vector (norm tables, ...)."""
        self._bump(kind, np.asarray(per_worker, dtype=np.float64),
                   tracer_of(cache))

    # -- readout -------------------------------------------------------------
    def worker_peak(self) -> np.ndarray:
        """Per-worker peak-watermark bytes: sum of per-kind peaks (upper
        bound on concurrent residency); excludes the ``*_actual`` accounts,
        which alias the physical stores."""
        out = np.zeros(max(self.nparts, 1))
        for kind, peak in self.peak.items():
            if kind.endswith("_actual"):
                continue
            v = np.zeros_like(out)
            v[: peak.shape[0]] = peak
            out += v
        return out

    def flush(self, tracer) -> None:
        """Emit per-worker peak gauges so a written Chrome trace carries the
        memory column (``mem_peak_w<p>_bytes`` counter events)."""
        if tracer is None or not tracer.enabled:
            return
        wp = self.worker_peak()
        for p in range(wp.shape[0]):
            tracer.gauge(f"mem_peak_w{p}_bytes").set(float(wp[p]))

    def summary(self) -> dict:
        """JSON-safe account summary (driver stats / BENCH files)."""
        wp = self.worker_peak()
        return dict(
            nparts=int(self.nparts),
            notes=int(self.notes),
            worker_peak_bytes=wp.tolist(),
            peak_bytes_max=float(wp.max()) if wp.size else 0.0,
            per_kind={k: dict(peak_bytes_max=float(v.max()),
                              peak_bytes=v.tolist())
                      for k, v in sorted(self.peak.items())},
            cuda=cuda_memory_stats(),
        )


def meter_of(cache):
    """The memory meter riding on the plan cache, or None when accounting
    is off (mirrors :func:`repro_torch.obs.tracer.tracer_of`)."""
    return getattr(cache, "memory_meter", None) if cache is not None else None
