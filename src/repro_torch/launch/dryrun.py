"""Dry run: FLOPs, bytes, memory, collectives and roofline terms of every (arch x shape) cell.

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

The same step also runs on each production mesh (``on_mesh``), as rank 0 of
a 256- or 512-rank group on torch's ``fake`` process-group backend
(:func:`repro_torch.launch.mesh.fake_mesh`), on that rank's blocks of the
state under :func:`make_ctx`'s rules: the port's own mesh path, whose
collectives (``sharding/rules.py``) are counted by kind and mesh axis.  Where
the reference reads its collectives from a partitioned HLO, the port counts
the ones it makes.  Wire bytes follow the reference's conventions
(:func:`wire_bytes`) and the collective term is their sum over the link each
axis runs on (:func:`link_bw`: NVLink 4 within an 8-card H100 node,
InfiniBand between nodes; a 16-wide axis spans two nodes) — a prediction
that no one-card machine measures.  The record's top level keeps the
one-card account and carries its mesh's ``collective_term_s``.  A cell
``cfg.supports`` rejects is ``skipped`` with the reference's reason; a cell
that fails is ``error`` with its traceback.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single|multi --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
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
from ..runtime.elastic import state_specs
from ..sharding import rules
from ..sharding.rules import MeshCtx, shard_bytes, spec_tree
from ..tree import tree_leaves, tree_map
from .mesh import fake_mesh, production_mesh_axes
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
# an H100 SXM node (data sheet): 8 cards joined by NVLink 4, and one 400 Gb/s
# NDR InfiniBand link a card between nodes; bytes/s in one direction
NODE_CARDS = 8
NVLINK_BW = 450e9
IB_BW = 50e9

MESHES = {"16x16": False, "2x16x16": True}


#: ops that make a tensor without moving data: a reshape of a fresh tensor, an
#: allocation left uninitialised, a constant's wrapping
_NO_DATA = frozenset({torch.ops.aten._unsafe_view, torch.ops.aten.empty,
                      torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
                      torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided,
                      torch.ops.aten.lift_fresh})


#: the namespaces of torch.distributed's ops (on the fake mesh their outputs are
#: the tensors the port passed in)
_COMM_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


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
        """Count ``t``'s storage (a ``DTensor``'s block's) as live until its last
        reference dies."""
        st = rules.block(t).untyped_storage()
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
        if func.namespace in _COMM_NAMESPACES:
            return out  # a collective: counted by the port's helpers, not as HBM bytes
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


def _cell_ctx(mesh, cfg: ArchConfig, shape: ShapeSpec, rules_override=None) -> MeshCtx:
    """:func:`make_ctx`'s rules for the cell, with ``rules_override`` laid over them."""
    ctx = make_ctx(mesh, cfg, shape)
    return ctx.with_rules(**rules_override) if rules_override else ctx


def _serve_params(cfg: ArchConfig, mode, dtype=torch.bfloat16):
    """Serving stores bf16 weights: the parameters as fake tensors of ``dtype``."""
    with mode:
        return model_mod.cast_params(transformer.init_params(cfg, seed=0, device="cpu"), dtype)


def _rank_blocks(ctx: MeshCtx, tree, specs, mode):
    """Rank 0's blocks of a whole tree of fake tensors laid out by ``specs``, as
    ``DTensor`` objects whose local blocks are fresh fake tensors."""
    with mode:
        return tree_map(lambda t, spec: rules.as_dtensor(
            ctx, torch.empty(rules.shard_shape(ctx, tuple(t.shape), spec), dtype=t.dtype),
            spec, tuple(t.shape)), tree, specs)


def _block_bytes(tree) -> int:
    return sum(rules.block(t).numel() * rules.block(t).element_size() for t in tree_leaves(tree))


def _measure(cfg: ArchConfig, shape: ShapeSpec, *, kv_dtype=None, param_dtype=None,
             pos=None, mesh=None, compute_dtype=torch.bfloat16,
             grad_reshard: bool = False, rules_override=None) -> dict:
    """One run of the cell's step at ``cfg``'s depth on fake tensors: its counts.

    The train step is :func:`model.make_train_step`'s own; its ``on_update``
    hook starts the meter's ``"update"`` phase, so the peak is kept per
    phase (forward, backward, update): each phase's peak grows linearly with
    depth, their maximum need not.  ``param_dtype``: the train state's
    (default fp32) or the served weights' (default bf16).

    ``mesh``: a ``DeviceMesh`` (:func:`repro_torch.launch.mesh.fake_mesh`).
    Then the step runs as that mesh's rank 0, on its blocks of the state laid
    out by :func:`make_ctx`'s rules (the whole batch, as every rank of the
    port takes it), and the counts are that device's, with its collectives
    (``rules.collective_counts(by_axis=True)``) and its ``argument_bytes``,
    the bytes of its blocks of the state.  ``rules_override``: rules laid over
    :func:`make_ctx`'s (the reference's ``ctx.with_rules``; ``{"seq":
    ("model",)}`` is sequence parallelism).
    """
    mode = model_mod.fake_mode()
    meter = CostMeter()
    ctx = None if mesh is None else _cell_ctx(MeshCtx.on(mesh), cfg, shape, rules_override)
    p_axes = transformer.param_axes(cfg)
    if shape.kind == "train":
        state = model_mod.abstract_train_state(cfg, param_dtype=param_dtype or torch.float32,
                                               mode=mode)
        if ctx is not None:
            state = _rank_blocks(ctx, state, state_specs(ctx, state, p_axes), mode)
        inputs = (state, train_input_specs(cfg, shape, mode=mode))
        step = model_mod.make_train_step(cfg, ctx, compute_dtype=compute_dtype,
                                         grad_reshard=grad_reshard,
                                         on_update=lambda: meter.begin("update"))
        phase, fn = "forward", step
    elif shape.kind == "prefill":
        params = _serve_params(cfg, mode, param_dtype or torch.bfloat16)
        if ctx is not None:
            params = _rank_blocks(ctx, params, spec_tree(ctx, params, p_axes), mode)
        inputs = (params, train_input_specs(cfg, shape, mode=mode))

        def forward(params, batch):
            with torch.no_grad():
                b = {k: (v.to(compute_dtype) if v.is_floating_point() else v)
                     for k, v in batch.items()}
                return transformer.apply(params, cfg, b, ctx=ctx)

        phase, fn = "forward", forward
    else:
        params = _serve_params(cfg, mode, param_dtype or torch.bfloat16)
        cache, tokens, _ = serve_input_specs(cfg, shape, kv_dtype, mode=mode)
        if ctx is not None:
            params = _rank_blocks(ctx, params, spec_tree(ctx, params, p_axes), mode)
            c_axes = transformer.cache_axes(cfg, int8=kv_dtype == torch.int8)
            cache = _rank_blocks(ctx, cache, spec_tree(ctx, cache, c_axes), mode)
        inputs = (params, cache, tokens)
        serve = model_mod.make_serve_step(cfg, ctx, compute_dtype=compute_dtype)
        at = shape.seq_len - 1 if pos is None else int(pos)

        def decode(params, cache, tokens):
            with torch.no_grad():
                return serve(params, cache, tokens, at)

        phase, fn = "decode", decode

    saved = _SavedMeter(inputs, meter)
    rules.reset_collective_counts()
    with mode:
        meter.track_tree(inputs)
        input_bytes = meter.live
        with meter, saved.hooks():
            meter.begin(phase)
            out = fn(*inputs)
        del out
    peaks = {k: v for k, v in meter.peaks.items() if k != "setup"}
    counts = dict(flops=sum(meter.flops_by_dtype.values()),
                  flops_by_dtype=dict(meter.flops_by_dtype),
                  bytes=meter.bytes, activation_bytes=saved.bytes,
                  peak_bytes={k: v[0] for k, v in peaks.items()},
                  peak_bytes_card={k: v[1] for k, v in peaks.items()},
                  input_bytes=input_bytes)
    if ctx is not None:
        counts["collectives"] = rules.collective_counts(by_axis=True)
        counts["argument_bytes"] = _block_bytes(inputs[0] if shape.kind != "decode"
                                                else inputs[:2])
    rules.reset_collective_counts()
    return counts


def _extrapolated(cfg: ArchConfig, shape: ShapeSpec, *, measure=None, **kw):
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
    measure = measure or _measure
    if periods <= 3:
        return measure(cfg, shape, **kw), "exact"
    f2 = measure(dataclasses.replace(cfg, num_layers=2 * pat + rem), shape, **kw)
    f3 = measure(dataclasses.replace(cfg, num_layers=3 * pat + rem), shape, **kw)

    def grow(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            a, b = a or {}, b or {}
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
    params = _serve_params(cfg, mode)
    if shape.kind == "prefill":
        return {"params": params}, {"params": p_axes}
    cache, _, _ = serve_input_specs(cfg, shape, kv_dtype, mode=mode)
    return ({"params": params, "cache": cache},
            {"params": p_axes, "cache": transformer.cache_axes(cfg, int8=kv_dtype == torch.int8)})


def _per_device_bytes(ctx: MeshCtx, tree, axes) -> int:
    """One device's bytes of ``tree`` laid out by the logical ``axes``."""
    per_leaf = tree_map(lambda t, spec: shard_bytes(ctx, tuple(t.shape), spec, t.element_size()),
                        tree, spec_tree(ctx, tree, axes))
    return sum(tree_leaves(per_leaf))


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


def link_bw(axes: dict[str, int], axis: str) -> float:
    """The link a collective over mesh axis ``axis`` of a mesh of ``axes`` runs on:
    NVLink where the group's ranks lie in one node of :data:`NODE_CARDS`
    cards (ranks consecutive, the last axis fastest; the group of rank 0),
    InfiniBand where it spans nodes."""
    names = list(axes)
    stride = math.prod(axes[a] for a in names[names.index(axis) + 1:])
    return NVLINK_BW if (axes[axis] - 1) * stride < NODE_CARDS else IB_BW


def wire_bytes(kind: str, operand_bytes: float, group: int) -> float:
    """One device's link traffic for a collective under ring algorithms, the
    reference's conventions (``launch/hlo_analysis.py``): an all-gather
    receives the result (``group`` times its operand), an all-reduce moves
    twice its operand, a reduce-scatter its operand (the whole input)."""
    if kind == "all_gather":
        return operand_bytes * group
    if kind == "all_reduce":
        return 2 * operand_bytes
    if kind == "reduce_scatter":
        return operand_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


def _terms(flops_by_dtype: dict, nbytes: float, collective_s, model_flops_dev: float) -> dict:
    """The roofline terms of one device's counts, the bottleneck and the
    roofline fraction (the model's FLOPs at the bf16 peak over the largest term)."""
    fp32 = flops_by_dtype.get("float32", 0)
    flops = sum(flops_by_dtype.values())
    terms = {"compute": (flops - fp32) / PEAK_FLOPS_BF16 + fp32 / PEAK_FLOPS_FP32,
             "memory": nbytes / HBM_BW}
    if collective_s is not None:
        terms["collective"] = collective_s
    top = max(terms.values())
    return dict(compute_term_s=terms["compute"], memory_term_s=terms["memory"],
                collective_term_s=collective_s, bottleneck=max(terms, key=terms.get),
                roofline_fraction=(model_flops_dev / PEAK_FLOPS_BF16) / top if top > 0 else 0.0)


def collectives_by_kind(axes: dict[str, int], collectives: dict) -> dict:
    """``{kind: {calls, operand_bytes, wire_bytes, seconds, by_axis}}`` of one device's
    counts by kind and axis (:func:`repro_torch.sharding.rules.collective_counts`
    with ``by_axis``), ``seconds`` the wire bytes over each axis's link."""
    out = {}
    for kind, per_axis in sorted(collectives.items()):
        rows = {}
        for axis, c in sorted(per_axis.items()):
            wire = wire_bytes(kind, c["bytes"], c["group"])
            rows[axis] = dict(calls=c["calls"], operand_bytes=c["bytes"], group=c["group"],
                              wire_bytes=wire, link_bw=link_bw(axes, axis),
                              seconds=wire / link_bw(axes, axis))
        out[kind] = dict(calls=sum(r["calls"] for r in rows.values()),
                         operand_bytes=sum(r["operand_bytes"] for r in rows.values()),
                         wire_bytes=sum(r["wire_bytes"] for r in rows.values()),
                         seconds=sum(r["seconds"] for r in rows.values()), by_axis=rows)
    return out


def measure_on_mesh(cfg: ArchConfig, shape: ShapeSpec, axes: dict[str, int], **kw) -> dict:
    """One device's counts of the cell's step on a mesh of ``axes`` (a
    :func:`repro_torch.launch.mesh.fake_mesh` in this process, rank 0), at
    ``cfg``'s depth: :func:`_measure`'s keys, with ``collectives_by_kind``
    in place of the raw collective counts.  ``kw``: :func:`_measure`'s
    (``kv_dtype``, ``param_dtype``, ``compute_dtype``, ``pos``,
    ``grad_reshard``, ``rules_override``)."""
    counts = _on_fake_mesh(axes, cfg, shape, **kw)
    counts["collectives_by_kind"] = collectives_by_kind(axes, counts.pop("collectives"))
    return counts


def _on_fake_mesh(axes: dict[str, int], cfg: ArchConfig, shape: ShapeSpec, **kw) -> dict:
    """:func:`_measure` as rank 0 of a fake mesh of ``axes``."""
    with fake_mesh(axes) as mesh:
        return _measure(cfg, shape, mesh=mesh, **kw)


def _mesh_record(counts: dict, extrap: str, multi: bool, model_flops: float) -> dict:
    """The ``on_mesh`` entry of one production mesh from its rank's counts."""
    axes = production_mesh_axes(multi)
    chips = math.prod(axes.values())
    coll = collectives_by_kind(axes, counts["collectives"])
    rec = dict(axes=axes, chips=chips, extrapolation=extrap, flops=counts["flops"],
               flops_by_dtype=counts["flops_by_dtype"], bytes=counts["bytes"],
               argument_bytes=counts["argument_bytes"], input_bytes=counts["input_bytes"],
               activation_bytes=counts["activation_bytes"],
               peak_bytes=max(counts["peak_bytes"].values()),
               peak_bytes_card=max(counts["peak_bytes_card"].values()),
               peak_bytes_by_phase=counts["peak_bytes"],
               collectives_by_kind=coll,
               collective_operand_bytes=sum(k["operand_bytes"] for k in coll.values()),
               collective_wire_bytes=sum(k["wire_bytes"] for k in coll.values()),
               useful_flops_ratio=(model_flops / chips) / counts["flops"]
               if counts["flops"] else 0.0)
    rec.update(_terms(counts["flops_by_dtype"], counts["bytes"],
                      sum(k["seconds"] for k in coll.values()), model_flops / chips))
    return rec


@dataclasses.dataclass(frozen=True)
class _Cell:
    """A cell with its variant resolved: the config, the shape and the step's options."""

    arch: str
    cfg: ArchConfig
    shape: ShapeSpec
    mesh: str
    kv_dtype: object
    param_dtype: object
    grad_reshard: bool
    pos: object
    rules_override: tuple = ()  # (logical name, mesh axes) pairs over make_ctx's rules

    def measure_kw(self) -> dict:
        return dict(kv_dtype=self.kv_dtype, pos=self.pos,
                    param_dtype=self.param_dtype if self.shape.kind == "train" else None)


def _resolve(arch_id: str, shape_name, multi_pod: bool = False, *, grad_accum=None,
             cfg_overrides=None, kv_dtype=None, train_opts=None, pos=None,
             rules_override=None):
    """``lower_cell``'s arguments as a :class:`_Cell`, or the skipped record of a
    cell ``cfg.supports`` rejects."""
    cfg = get_config(arch_id)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    mesh = "2x16x16" if multi_pod else "16x16"
    ok, why = cfg.supports(shape)
    if not ok:
        return {"arch": arch_id, "shape": shape.name, "mesh": mesh, "status": "skipped",
                "why": why}
    topts = dict(train_opts or {})
    grad_reshard = bool(topts.pop("grad_reshard", False))
    param_dtype = topts.pop("param_dtype", torch.float32)
    if topts:
        raise ValueError(f"unknown train_opts {sorted(topts)}")
    if grad_accum is not None:
        cfg = dataclasses.replace(cfg, grad_accum=grad_accum)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return _Cell(arch_id, cfg, shape, mesh, kv_dtype, param_dtype, grad_reshard, pos,
                 tuple((rules_override or {}).items()))


def _part(cell: _Cell, part: str) -> tuple:
    """``(counts, extrapolation, seconds)`` of one part of a cell: ``"one_card"``
    (the step whole on one card) or a production mesh's name (rank 0's
    share, on a fake mesh)."""
    clock = Stopwatch()
    kw = cell.measure_kw()
    if part != "one_card":
        kw["measure"] = functools.partial(_on_fake_mesh, production_mesh_axes(MESHES[part]),
                                          grad_reshard=cell.grad_reshard,
                                          rules_override=dict(cell.rules_override))
    counts, extrap = _extrapolated(cell.cfg, cell.shape, **kw)
    return counts, extrap, clock.elapsed()


def _record(cell: _Cell, parts: dict) -> dict:
    """The cell's record from its parts (:func:`_part`'s results by part name)."""
    cfg, shape = cell.cfg, cell.shape
    counts, extrap, run_s = parts["one_card"]
    model_flops = _model_flops(cfg, shape)
    on_mesh = {name: _mesh_record(c, e, MESHES[name], model_flops)
               for name, (c, e, _) in parts.items() if name != "one_card"}
    state, axes = _state_tree(cfg, shape, kv_dtype=cell.kv_dtype, param_dtype=cell.param_dtype)
    per_device = {name: _per_device_bytes(_cell_ctx(production_mesh_axes(multi), cfg, shape,
                                                    dict(cell.rules_override)), state, axes)
                  for name, multi in MESHES.items()}
    for name, m in on_mesh.items():  # the rank ran on its blocks of the very state counted
        if m["argument_bytes"] != per_device[name]:
            raise AssertionError(f"{name}: rank 0's arguments hold {m['argument_bytes']} bytes, "
                                 f"the rules lay out {per_device[name]} a device")
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    flops, nbytes = counts["flops"], counts["bytes"]
    peak_card = max(counts["peak_bytes_card"].values())
    rec = {
        "arch": cell.arch,
        "shape": shape.name,
        "mesh": cell.mesh,
        "chips": 1,
        "status": "ok",
        "extrapolation": extrap,
        "run_s": sum(t for _, _, t in parts.values()),
        "remat": cfg.remat,
        "grad_accum": cfg.grad_accum,
        "flops": flops,
        "flops_by_dtype": counts["flops_by_dtype"],
        "bytes": nbytes,
        "bytes_kind": "unfused: the input and output bytes of every op that moves data",
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else 0.0,
        "state_bytes": state_bytes,
        "state_bytes_per_device": per_device,
        "activation_bytes": counts["activation_bytes"],
        "peak_bytes": max(counts["peak_bytes"].values()),
        "peak_bytes_card": peak_card,
        "peak_bytes_by_phase": counts["peak_bytes"],
        "fits_one_card": peak_card <= HBM_BYTES,
        **_terms(counts["flops_by_dtype"], nbytes, None, model_flops),
        # the record's mesh's, one device's share (the one-card account has no term)
        "collective_term_s": on_mesh[cell.mesh]["collective_term_s"]
        if cell.mesh in on_mesh else None,
        "on_mesh": on_mesh,
        "hardware": dict(card="NVIDIA H100 SXM", peak_flops_bf16=PEAK_FLOPS_BF16,
                         peak_flops_fp32=PEAK_FLOPS_FP32, hbm_bw=HBM_BW, hbm_bytes=HBM_BYTES,
                         node_cards=NODE_CARDS, nvlink_bw=NVLINK_BW, ib_bw=IB_BW),
    }
    if cell.grad_reshard:
        rec["grad_reshard"] = True
    if cell.rules_override:
        rec["rules_override"] = {k: list(v) for k, v in cell.rules_override}
    if cell.kv_dtype is not None:
        rec["kv_dtype"] = str(cell.kv_dtype).removeprefix("torch.")
    if cell.param_dtype != torch.float32:
        rec["param_dtype"] = str(cell.param_dtype).removeprefix("torch.")
    return rec


def lower_cell(arch_id: str, shape_name, multi_pod: bool = False, *, grad_accum=None,
               cfg_overrides=None, kv_dtype=None, train_opts=None, pos=None,
               rules_override=None, meshes=tuple(MESHES)) -> dict:
    """One cell's record.  ``shape_name`` is a key of ``SHAPES`` or a ``ShapeSpec``.

    The top level is the cell run whole on one card.  ``on_mesh`` holds, for
    each of ``meshes`` (``"16x16"``, ``"2x16x16"``), the same step run as
    rank 0 of that production mesh on a fake mesh (:func:`_measure`): one
    device's FLOPs, bytes, peak, argument bytes (its blocks of the state,
    which must equal ``state_bytes_per_device``), collectives by kind and
    axis, and the three roofline terms, the collective one at
    :func:`link_bw`.  ``multi_pod`` labels the record's ``mesh``, whose
    ``collective_term_s`` the top level carries (the reference's signature;
    there it picks the compiled mesh); every record carries the per-device
    state bytes of both production meshes.

    The variant arguments are the reference's: ``grad_accum``,
    ``cfg_overrides`` (``remat``, ``moe_capacity_factor``, ...), ``kv_dtype``
    (``torch.int8``) and ``train_opts`` (``param_dtype``; ``grad_reshard``,
    the FSDP gradients' reduction on the meshes: ``reduce_scatter`` for
    ``True``, else ``all_reduce``) and ``rules_override`` (rules laid over
    :func:`make_ctx`'s on the meshes, as the reference's ``ctx.with_rules``:
    ``{"seq": ("model",)}``, sequence parallelism).  The train step and the prefill forward
    use the chunked attention, the path autograd runs.  ``pos``: the decode
    position (default the cell's last).
    """
    if unknown := set(meshes) - set(MESHES):
        raise ValueError(f"unknown meshes {sorted(unknown)}")
    cell = _resolve(arch_id, shape_name, multi_pod, grad_accum=grad_accum,
                    cfg_overrides=cfg_overrides, kv_dtype=kv_dtype, train_opts=train_opts,
                    pos=pos, rules_override=rules_override)
    if isinstance(cell, dict):
        return cell
    return _record(cell, {part: _part(cell, part) for part in ("one_card", *meshes)})


def _error_record(arch: str, shape: str, multi_pod: bool, e: BaseException) -> dict:
    return {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16",
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-3000:]}


def _one_part(task):
    """A worker's task: one part of one cell, or the exception it raised."""
    (arch, shape, multi, *kw), part = task
    try:
        cell = _resolve(arch, shape, multi, **(kw[0] if kw else {}))
        return cell if isinstance(cell, dict) else _part(cell, part)
    except Exception as e:  # a failing cell is a bug: report it, never fake it
        return _error_record(arch, shape, multi, e)


def _cost(task) -> float:
    """A task's weight, for the order of the pool's queue: layers run x microbatches."""
    (arch, shape, _, *kw), _ = task
    cfg = get_config(arch)
    accum = (kw[0] if kw else {}).get("grad_accum") or cfg.grad_accum
    return cfg.num_layers * (3 * accum if SHAPES[shape].kind == "train" else 1)


def run_cells(cells, workers: int = 1, meshes=tuple(MESHES)) -> list[dict]:
    """The records of ``(arch, shape, multi_pod)`` cells, in order, over ``workers``
    processes (a worker that dies raises ``BrokenProcessPool``, never hangs);
    ``meshes``: the production meshes each record's ``on_mesh`` holds.  A
    cell may carry a fourth entry, :func:`lower_cell`'s variant arguments
    (``hillclimb.variant_kwargs``).  Each cell's parts (the one-card run and
    one per mesh) run as tasks of their own, the costliest first, so the
    workers end together."""
    cells = list(cells)
    parts = ("one_card", *meshes)
    tasks = [(c, p) for c in cells for p in parts]
    if workers <= 1:
        done = [_one_part(t) for t in tasks]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        order = sorted(range(len(tasks)), key=lambda i: -_cost(tasks[i]))
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            out = list(pool.map(_one_part, [tasks[i] for i in order]))
        done = [None] * len(tasks)
        for i, r in zip(order, out):
            done[i] = r
    recs = []
    for i, (arch, shape, multi, *kw) in enumerate(cells):
        got = dict(zip(parts, done[i * len(parts):(i + 1) * len(parts)]))
        bad = next((r for r in got.values() if isinstance(r, dict)), None)
        if bad is not None:  # skipped, or a part in error
            recs.append(bad)
            continue
        try:
            recs.append(_record(_resolve(arch, shape, multi, **(kw[0] if kw else {})), got))
        except Exception as e:
            recs.append(_error_record(arch, shape, multi, e))
    return recs


def _summary_line(rec: dict) -> str:
    key = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
    if rec["status"] != "ok":
        return f"[{rec['status']}] {key}: {rec.get('why', rec.get('error'))}"
    m = rec["on_mesh"].get(rec["mesh"])
    mesh = "" if m is None else (
        f" | per device: peak={m['peak_bytes_card'] / 1e9:.2f}GB "
        f"wire={m['collective_wire_bytes']:.3e} collective={m['collective_term_s']:.3e}s "
        f"bottleneck={m['bottleneck']} frac={m['roofline_fraction']:.3f}")
    return (f"[ok] {key}: {rec['run_s']:.1f}s flops={rec['flops']:.3e} bytes={rec['bytes']:.3e} "
            f"peak={rec['peak_bytes_card'] / 1e9:.2f}GB fits={rec['fits_one_card']} "
            f"bottleneck={rec['bottleneck']} frac={rec['roofline_fraction']:.3f}{mesh}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"],
                    help="the record's mesh: 16x16 (single) or 2x16x16 (multi); every "
                         "record holds both meshes' per-device counts under on_mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--workers", type=int, default=1, help="processes for --all")
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    if args.all:
        cells = [(a, s, multi) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, multi)]
    clock = Stopwatch()
    recs = run_cells(cells, args.workers)
    for rec in recs:
        print(_summary_line(rec))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = f"{rec['arch']}__{rec['shape']}__{args.mesh}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)
    n = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skipped", "error")}
    print("collective terms: a prediction for NVLink 4 within an 8-card node and one 400 Gb/s "
          "InfiniBand link a card between nodes, from the port's own collectives on a fake "
          "mesh; no one-card machine measures them")
    print(f"{n['ok']} ok, {n['skipped']} skipped, {n['error']} error in "
          f"{clock.elapsed():.1f} s")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
