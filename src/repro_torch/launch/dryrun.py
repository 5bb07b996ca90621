"""One-card dry run: FLOPs, bytes, memory and roofline terms of every (arch x shape) cell.

Port of the JAX package's ``repro/launch/dryrun.py``.  The reference lowers
and compiles each cell for a 256- or 512-chip TPU mesh and reads XLA's cost
and memory analyses; the port runs each cell's real step — the train step
(:func:`repro_torch.models.model.make_train_step`: loss, gradients, clip,
AdamW), the prefill forward (:func:`transformer.apply` in bf16) or the decode
step (:func:`model.make_serve_step`) — on fake tensors
(:func:`repro_torch.models.model.fake_mode`: shapes and dtypes, no storage,
no arithmetic), so a cell of any size runs on the host in seconds and
allocates nothing.  It counts, for one H100 holding the whole cell:

* ``flops``: matrix-product FLOPs, each op counted by its formula in
  ``torch.utils.flop_counter``'s registry (the one ``FlopCounterMode`` uses),
  summed over ``flops_by_dtype``, which splits them by operand type (the
  chunked attention's products run in fp32);
* ``bytes``: the input and output bytes of every op that makes a tensor and
  moves data (not a view, a reshape of a fresh tensor or an uninitialised
  allocation) — the unfused analogue of XLA's "bytes accessed" (a fused
  kernel moves less);
* ``activation_bytes``: what autograd saves for the backward
  (``torch.autograd.graph.saved_tensors_hooks``, one count per storage,
  the step's inputs left out; inside a ``cfg.remat`` period checkpoint's own
  hooks take over, so under ``"full"`` this counts the tensors saved outside
  the checkpointed periods);
* ``peak_bytes``: the most bytes of live storage at any moment — the inputs
  (train state or parameters, batch, cache) and every storage an op makes,
  less each one when its last reference dies (a ``weakref.finalize`` on the
  storage).  This sees the transients that saved bytes miss: the fp32 logits
  and their gradient, a checkpointed period's recompute, the optimizer's new
  state beside the old one.  ``peak_bytes_card`` is the same with each
  storage rounded up as the CUDA caching allocator rounds a block
  (:data:`ALLOC_ROUND`), the figure ``torch.cuda.max_memory_allocated``
  reports on the card.

Deep cells are extrapolated per period, as the reference does
(``dryrun.py:175-205``), from runs of 2 and 3 periods of ``block_pattern``
plus the remainder layers (the reference's 1 and 2: in the port the first
period holds one activation less at its peak, see :func:`_extrapolated`);
each count grows by their difference per further period, and a cell of at
most 3 periods runs at full depth (``"exact"``).  From the counts come the compute
and memory terms on one H100 (:data:`PEAK_FLOPS_BF16`, :data:`PEAK_FLOPS_FP32`,
:data:`HBM_BW`), the bottleneck, the roofline fraction and whether the cell
fits one 80 GB card; per-device state bytes on the production meshes (16 x 16
and 2 x 16 x 16) come from the sharding rules (:mod:`repro_torch.sharding`).
The reference's collective term reads a partitioned HLO, which needs the
multi-card slice: ``collective_term_s`` is None with that reason.  A cell
``cfg.supports`` rejects is ``skipped`` with the reference's reason; a cell
that fails is ``error`` with its traceback.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

from ..configs import ARCH_IDS, SHAPES, get_config
from ..configs.base import ArchConfig, ShapeSpec
from ..models import model as model_mod
from ..models import transformer
from ..obs.timing import Stopwatch
from ..sharding.rules import MeshCtx, shard_bytes, spec_tree
from ..tree import tree_leaves
from .mesh import production_mesh_axes
from .specs import make_ctx, serve_input_specs, train_input_specs

__all__ = ["HBM_BW", "HBM_BYTES", "PEAK_FLOPS_BF16", "PEAK_FLOPS_FP32", "ALLOC_ROUND",
           "lower_cell", "reduced_overrides", "run_cells"]

# NVIDIA H100 SXM (data sheet, dense rates, 700 W)
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor cores
PEAK_FLOPS_FP32 = 67e12  # fp32 FFMA (the port keeps TF32 off)
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9  # one card's memory
#: the CUDA caching allocator rounds every block up to a multiple of 512 bytes
ALLOC_ROUND = 512

#: why the collective term is missing
COLLECTIVE_WHY = "needs the multi-card slice (the reference reads it from a partitioned HLO)"

MESHES = {"16x16": False, "2x16x16": True}


#: ops that make a tensor without moving data: a reshape of a fresh tensor, an
#: allocation left uninitialised, a constant's wrapping
_NO_DATA = frozenset({torch.ops.aten._unsafe_view, torch.ops.aten.empty,
                      torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
                      torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
                      torch.ops.aten.lift_fresh})


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class CostMeter(TorchDispatchMode):
    """Counts every op below it: bytes in and out (views move none), matrix-product
    FLOPs by operand type, and live storage bytes with their peak."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self.bytes = 0
        self.flops_by_dtype: dict[str, int] = {}
        self.live = self.live_card = 0
        self.phase = "setup"
        self.peaks: dict[str, list[int]] = {}  # phase -> [peak bytes, peak bytes rounded]
        self._storages: dict[int, tuple[int, int]] = {}

    def begin(self, phase: str) -> None:
        """Keep the peaks from here on under ``phase``."""
        self.phase = phase
        self.peaks[phase] = [self.live, self.live_card]

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last reference dies."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nb = st.nbytes()
        card = _round_up(nb, ALLOC_ROUND)
        self._storages[key] = (nb, card)
        self.live += nb
        self.live_card += card
        peak = self.peaks.setdefault(self.phase, [0, 0])
        peak[0] = max(peak[0], self.live)
        peak[1] = max(peak[1], self.live_card)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        nb, card = self._storages.pop(key)
        self.live -= nb
        self.live_card -= card

    def track_tree(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self.track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not func.is_view and func.overloadpacket not in _NO_DATA:
            ins = [t for t in _leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        fn = self._flop_fns.get(func.overloadpacket)
        if fn is not None:
            dt = next(t for t in _leaves(args)
                      if isinstance(t, torch.Tensor)).dtype
            key = str(dt).removeprefix("torch.")
            self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0) + int(
                fn(*args, **kwargs, out_val=out))
        for t in outs:
            self.track(t)
        return out


class _SavedMeter:
    """Bytes autograd saves for the backward, one count per storage while it
    lives, the storages of ``skip`` (the step's inputs) left out.  The first
    saved tensor the backward unpacks starts ``meter``'s ``"backward"`` phase."""

    def __init__(self, skip, meter: CostMeter):
        self._seen = {t.untyped_storage()._cdata for t in tree_leaves(skip)
                      if isinstance(t, torch.Tensor)}
        self._meter = meter
        self.bytes = 0

    def unpack(self, t):
        if self._meter.phase == "forward":
            self._meter.begin("backward")
        return t

    def pack(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._seen:
            self._seen.add(key)
            self.bytes += st.nbytes()
            weakref.finalize(st, self._seen.discard, key)  # the address may be reused
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)


def _bf16_params(cfg: ArchConfig, mode):
    """Serving stores bf16 weights: the parameters as fake bf16 tensors."""
    with mode:
        return model_mod.cast_params(transformer.init_params(cfg, seed=0, device="cpu"),
                                     torch.bfloat16)


def _measure(cfg: ArchConfig, shape: ShapeSpec, *, kv_dtype=None, param_dtype=torch.float32,
             pos=None) -> dict:
    """One run of the cell's step at ``cfg``'s depth on fake tensors: its counts.

    The train step is :func:`model.make_train_step`'s own; its ``on_update``
    hook starts the meter's ``"update"`` phase, so the peak is kept per
    phase (forward, backward, update): each phase's peak grows linearly with
    depth, their maximum need not.
    """
    mode = model_mod.fake_mode()
    meter = CostMeter()
    if shape.kind == "train":
        inputs = (model_mod.abstract_train_state(cfg, param_dtype=param_dtype, mode=mode),
                  train_input_specs(cfg, shape, mode=mode))
        step = model_mod.make_train_step(cfg, on_update=lambda: meter.begin("update"))
        phase, fn = "forward", step
    elif shape.kind == "prefill":
        inputs = (_bf16_params(cfg, mode), train_input_specs(cfg, shape, mode=mode))

        def forward(params, batch):
            with torch.no_grad():
                b = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
                     for k, v in batch.items()}
                return transformer.apply(params, cfg, b)

        phase, fn = "forward", forward
    else:
        cache, tokens, _ = serve_input_specs(cfg, shape, kv_dtype, mode=mode)
        inputs = (_bf16_params(cfg, mode), cache, tokens)
        serve = model_mod.make_serve_step(cfg)
        at = shape.seq_len - 1 if pos is None else int(pos)

        def decode(params, cache, tokens):
            with torch.no_grad():
                return serve(params, cache, tokens, at)

        phase, fn = "decode", decode

    saved = _SavedMeter(inputs, meter)
    with mode:
        meter.track_tree(inputs)
        input_bytes = meter.live
        with meter, saved.hooks():
            meter.begin(phase)
            out = fn(*inputs)
        del out
    peaks = {k: v for k, v in meter.peaks.items() if k != "setup"}
    return dict(flops=sum(meter.flops_by_dtype.values()),
                flops_by_dtype=dict(meter.flops_by_dtype),
                bytes=meter.bytes, activation_bytes=saved.bytes,
                peak_bytes={k: v[0] for k, v in peaks.items()},
                peak_bytes_card={k: v[1] for k, v in peaks.items()},
                input_bytes=input_bytes)


def _extrapolated(cfg: ArchConfig, shape: ShapeSpec, **kw):
    """Per-period extrapolation: ``(counts, "exact" | "per-period")``.

    The reference runs 1 and 2 periods and grows each count by their
    difference.  In the port the first period is special: the embedding
    output stays referenced through the layer loop, so from the second
    period on a layer's peak holds one activation more than the first
    layer's.  So the port runs 2 and 3 periods (plus the remainder layers)
    and a cell of at most 3 periods at full depth; every count, the peaks
    and the saved bytes included, is then linear in the periods.
    """
    pat = len(cfg.block_pattern)
    periods, rem = divmod(cfg.num_layers, pat)
    if periods <= 3:
        return _measure(cfg, shape, **kw), "exact"
    f2 = _measure(dataclasses.replace(cfg, num_layers=2 * pat + rem), shape, **kw)
    f3 = _measure(dataclasses.replace(cfg, num_layers=3 * pat + rem), shape, **kw)

    def grow(a, b):
        if isinstance(a, dict):
            return {k: grow(a.get(k, 0), b.get(k, 0)) for k in a.keys() | b.keys()}
        return a + (periods - 2) * (b - a)

    return {k: grow(f2[k], f3[k]) for k in f2}, "per-period"


def _state_tree(cfg: ArchConfig, shape: ShapeSpec, *, kv_dtype, param_dtype):
    """The cell's resident state at full depth as fake tensors, with its logical axes:
    the train state, or bf16 parameters (and the decode cache)."""
    mode = model_mod.fake_mode()
    p_axes = transformer.param_axes(cfg)
    if shape.kind == "train":
        state = model_mod.abstract_train_state(cfg, param_dtype=param_dtype, mode=mode)
        opt_axes = {k: (p_axes if k in ("mu", "nu", "master") else ()) for k in state["opt"]}
        return state, {"params": p_axes, "opt": opt_axes, "step": ()}
    params = _bf16_params(cfg, mode)
    if shape.kind == "prefill":
        return {"params": params}, {"params": p_axes}
    cache, _, _ = serve_input_specs(cfg, shape, kv_dtype, mode=mode)
    return ({"params": params, "cache": cache},
            {"params": p_axes, "cache": transformer.cache_axes(cfg, int8=kv_dtype == torch.int8)})


def _per_device_bytes(ctx: MeshCtx, tree, axes) -> int:
    specs = spec_tree(ctx, tree, axes)
    return sum(shard_bytes(ctx, tuple(t.shape), s, t.element_size())
               for t, s in zip(tree_leaves(tree), _spec_leaves(specs), strict=True))


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def reduced_overrides(arch: str) -> dict:
    """``lower_cell``'s ``cfg_overrides`` that make ``arch``'s config its reduced
    one (:func:`repro_torch.configs.reduced_config`), for runs at test size."""
    from ..configs import reduced_config

    full, small = get_config(arch), reduced_config(arch)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
            if getattr(small, f.name) != getattr(full, f.name)}


def _model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), N = matmul params."""
    n = cfg.flops_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def lower_cell(arch_id: str, shape_name, multi_pod: bool = False, *, grad_accum=None,
               cfg_overrides=None, kv_dtype=None, train_opts=None, pos=None) -> dict:
    """One cell's record.  ``shape_name`` is a key of ``SHAPES`` or a ``ShapeSpec``.

    ``multi_pod`` only labels the record's ``mesh`` (the reference's
    signature; there it picks the compiled mesh): every record carries the
    per-device state bytes of both production meshes.

    The variant arguments are the reference's that change what one card runs:
    ``grad_accum``, ``cfg_overrides`` (``remat``, ``moe_capacity_factor``,
    ...), ``kv_dtype`` (``torch.int8``) and ``train_opts`` (``param_dtype``;
    ``grad_reshard`` needs the multi-card slice and raises).  The train step
    and the prefill forward use the chunked attention, the path autograd
    runs.  ``pos``: the decode position (default the cell's last).
    """
    cfg = get_config(arch_id)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    mesh = "2x16x16" if multi_pod else "16x16"
    ok, why = cfg.supports(shape)
    if not ok:
        return {"arch": arch_id, "shape": shape.name, "mesh": mesh, "status": "skipped",
                "why": why}
    topts = dict(train_opts or {})
    if topts.pop("grad_reshard", False):
        raise NotImplementedError("grad_reshard pins gradients to a multi-card sharding")
    param_dtype = topts.pop("param_dtype", torch.float32)
    if topts:
        raise ValueError(f"unknown train_opts {sorted(topts)}")
    if grad_accum is not None:
        cfg = dataclasses.replace(cfg, grad_accum=grad_accum)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)

    clock = Stopwatch()
    counts, extrap = _extrapolated(cfg, shape, kv_dtype=kv_dtype, param_dtype=param_dtype,
                                   pos=pos)
    state, axes = _state_tree(cfg, shape, kv_dtype=kv_dtype, param_dtype=param_dtype)
    per_device = {}
    for name, multi in MESHES.items():
        per_device[name] = _per_device_bytes(make_ctx(production_mesh_axes(multi), cfg, shape),
                                             state, axes)
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    run_s = clock.elapsed()

    flops, nbytes = counts["flops"], counts["bytes"]
    by_dtype = counts["flops_by_dtype"]
    fp32 = by_dtype.get("float32", 0)
    compute = (flops - fp32) / PEAK_FLOPS_BF16 + fp32 / PEAK_FLOPS_FP32
    memory = nbytes / HBM_BW
    model_flops = _model_flops(cfg, shape)
    terms = {"compute": compute, "memory": memory}
    rec = {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh,
        "chips": 1,
        "status": "ok",
        "extrapolation": extrap,
        "run_s": run_s,
        "remat": cfg.remat,
        "grad_accum": cfg.grad_accum,
        "flops": flops,
        "flops_by_dtype": by_dtype,
        "bytes": nbytes,
        "bytes_kind": "unfused: the input and output bytes of every op that moves data",
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else 0.0,
        "state_bytes": state_bytes,
        "state_bytes_per_device": per_device,
        "activation_bytes": counts["activation_bytes"],
        "peak_bytes": max(counts["peak_bytes"].values()),
        "peak_bytes_card": max(counts["peak_bytes_card"].values()),
        "peak_bytes_by_phase": counts["peak_bytes"],
        "fits_one_card": max(counts["peak_bytes_card"].values()) <= HBM_BYTES,
        "compute_term_s": compute,
        "memory_term_s": memory,
        "collective_term_s": None,
        "collective_why": COLLECTIVE_WHY,
        "bottleneck": max(terms, key=terms.get),
        "roofline_fraction": (model_flops / PEAK_FLOPS_BF16) / max(terms.values())
        if max(terms.values()) > 0 else 0.0,
        "hardware": dict(card="NVIDIA H100 SXM", peak_flops_bf16=PEAK_FLOPS_BF16,
                         peak_flops_fp32=PEAK_FLOPS_FP32, hbm_bw=HBM_BW, hbm_bytes=HBM_BYTES),
    }
    if kv_dtype is not None:
        rec["kv_dtype"] = str(kv_dtype).removeprefix("torch.")
    if param_dtype != torch.float32:
        rec["param_dtype"] = str(param_dtype).removeprefix("torch.")
    return rec


def _error_record(arch: str, shape: str, multi_pod: bool, e: BaseException) -> dict:
    return {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16",
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-3000:]}


def _one(cell) -> dict:
    arch, shape, multi = cell
    try:
        return lower_cell(arch, shape, multi)
    except Exception as e:  # a failing cell is a bug: report it, never fake it
        return _error_record(arch, shape, multi, e)


def run_cells(cells, workers: int = 1) -> list[dict]:
    """The records of ``(arch, shape, multi_pod)`` cells, in order, over ``workers``
    processes (a worker that dies raises ``BrokenProcessPool``, never hangs)."""
    cells = list(cells)
    if workers <= 1:
        return [_one(c) for c in cells]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    # the costliest cells first, so the workers end together
    order = sorted(range(len(cells)), key=lambda i: -get_config(cells[i][0]).num_layers)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        out = list(pool.map(_one, [cells[i] for i in order]))
    recs = [None] * len(cells)
    for i, r in zip(order, out):
        recs[i] = r
    return recs


def _summary_line(rec: dict) -> str:
    key = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
    if rec["status"] != "ok":
        return f"[{rec['status']}] {key}: {rec.get('why', rec.get('error'))}"
    return (f"[ok] {key}: {rec['run_s']:.1f}s flops={rec['flops']:.3e} bytes={rec['bytes']:.3e} "
            f"peak={rec['peak_bytes_card'] / 1e9:.2f}GB fits={rec['fits_one_card']} "
            f"bottleneck={rec['bottleneck']} frac={rec['roofline_fraction']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--workers", type=int, default=1, help="processes for --all")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s, False) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, False)]
    clock = Stopwatch()
    recs = run_cells(cells, args.workers)
    for rec in recs:
        print(_summary_line(rec))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = f"{rec['arch']}__{rec['shape']}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)
    n = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skipped", "error")}
    print(f"{n['ok']} ok, {n['skipped']} skipped, {n['error']} error in "
          f"{clock.elapsed():.1f} s")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
