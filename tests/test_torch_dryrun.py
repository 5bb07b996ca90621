"""The port's dry-run tools (``launch/specs.py``, ``launch/dryrun.py``, ``launch/hillclimb.py``,
``models/model.abstract_train_state``, ``benchmarks/torch_roofline.py``) against the JAX package.

The reference's abstract state and input specs come from ``jax.eval_shape``;
the port's are fake tensors, laid out per layer, and are compared leaf for
leaf in the reference's stacking (layers stacked by position in the block
pattern, the remainder in ``tail``, as ``convert.train_state_to_arrays``
stacks them).  ``repro.launch.dryrun`` and ``repro.launch.hillclimb`` are
never imported here: they set ``XLA_FLAGS`` to 512 host devices at import.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, hillclimb, specs  # noqa: E402
from repro_torch.launch.mesh import production_mesh_axes  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _sd(x) -> str:
    """A leaf as ``dtype[shape]`` (a fake tensor or a ShapeDtypeStruct)."""
    dt = str(x.dtype).removeprefix("torch.")
    return f"{jnp.dtype(dt).name if dt != 'bfloat16' else dt}{list(x.shape)}"


def _stacked(tree, cfg):
    """The port's per-layer tree (``{"layers": [...], ...}``) as the reference
    stacks it: ``blocks.p{j}`` ``[periods, ...]`` and ``tail``, leaves as strings."""
    if isinstance(tree, dict) and "layers" in tree:
        pattern = cfg.block_pattern
        periods = cfg.num_layers // len(pattern)
        layers = tree["layers"]

        def stack(trees):
            if isinstance(trees[0], dict):
                return {k: stack([t[k] for t in trees]) for k in trees[0]}
            first = trees[0]
            assert all(_sd(t) == _sd(first) for t in trees)
            return f"{_sd(first).split('[')[0]}{[len(trees), *first.shape]}"

        out = {k: _stacked(v, cfg) for k, v in tree.items() if k != "layers"}
        out["blocks"] = {f"p{j}": stack([layers[i * len(pattern) + j] for i in range(periods)])
                         for j in range(len(pattern))}
        tail = layers[periods * len(pattern):]
        if tail:
            out["tail"] = [_stacked(t, cfg) for t in tail]
        return out
    if isinstance(tree, dict):
        return {k: _stacked(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked(v, cfg) for v in tree]
    return _sd(tree)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(k): v for k, v in leaves}


# --- abstract train state ---------------------------------------------------------


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_equals_the_reference(arch, param_dtype):
    cfg = get_config(arch)
    state = tmodel.abstract_train_state(cfg, param_dtype=getattr(torch, param_dtype))
    leaves = [t for t in jax.tree.leaves(state, is_leaf=lambda x: isinstance(x, torch.Tensor))]
    assert all(type(t).__name__ == "FakeTensor" for t in leaves)
    got = {"params": _stacked(state["params"], cfg), "step": _sd(state["step"]),
           "opt": {k: (_stacked(v, cfg) if k in ("mu", "nu", "master") else _sd(v))
                   for k, v in state["opt"].items()}}
    want = jax.tree.map(_sd, jmodel.abstract_train_state(
        j_get_config(arch), param_dtype=getattr(jnp, param_dtype)))
    assert _flat(got) == _flat(want)
    assert ("master" in state["opt"]) == (param_dtype == "bfloat16")


# --- input specs and their sharding specs ----------------------------------------


def _ref_ctx(cfg, shape, multi_pod):
    """The reference's ``make_ctx`` on a stand-in mesh (its axis names and shape)."""
    sizes = production_mesh_axes(multi_pod)
    mesh = types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=np.int8))
    return jspecs.make_ctx(mesh, cfg, shape)


def _ref_layer_specs(tree_specs, cfg):
    """The reference's stacked spec tree in the port's per-layer layout (``"layers"``
    entry dropped)."""
    pattern = cfg.block_pattern
    periods = cfg.num_layers // len(pattern)
    layers = [None] * cfg.num_layers
    to_tuple = lambda s: tuple(s)  # noqa: E731
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for j in range(len(pattern)):
        per = jax.tree.map(lambda s: tuple(s)[1:], tree_specs["blocks"][f"p{j}"], is_leaf=is_spec)
        for i in range(periods):
            layers[i * len(pattern) + j] = per
    for i, t in enumerate(tree_specs.get("tail", [])):
        layers[periods * len(pattern) + i] = jax.tree.map(to_tuple, t, is_leaf=is_spec)
    return {"layers": layers}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_input_specs_equal_the_reference(arch, multi_pod):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        got = specs.train_input_specs(cfg, SHAPES[name])
        want = jspecs.train_input_specs(jcfg, J_SHAPES[name])
        assert {k: _sd(v) for k, v in got.items()} == {k: _sd(v) for k, v in want.items()}
        jctx = _ref_ctx(jcfg, J_SHAPES[name], multi_pod)
        ctx = specs.make_ctx(production_mesh_axes(multi_pod), cfg, SHAPES[name])
        assert ctx.rule_map == jctx.rule_map
        _, axes = jspecs._token_specs(jcfg, J_SHAPES[name].global_batch, J_SHAPES[name].seq_len)
        want_specs = {k: tuple(jrules.logical_to_spec(jctx, want[k].shape, axes[k])) for k in want}
        assert specs.train_input_spec_tree(ctx, cfg, SHAPES[name]) == want_specs


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "hubert-xlarge"])
def test_serve_input_specs_equal_the_reference(arch, kv):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in [s for s in ("decode_32k", "long_500k") if cfg.supports(SHAPES[s])[0]]:
        cache, tokens, pos = specs.serve_input_specs(cfg, SHAPES[name], getattr(torch, kv))
        jcache, jtokens, jpos = jspecs.serve_input_specs(jcfg, J_SHAPES[name], getattr(jnp, kv))
        assert _flat(_stacked(cache, cfg)) == _flat(jax.tree.map(_sd, jcache))
        assert (_sd(tokens), _sd(pos)) == (_sd(jtokens), _sd(jpos))
        for multi_pod in (False, True):
            ctx = specs.make_ctx(production_mesh_axes(multi_pod), cfg, SHAPES[name])
            jctx = _ref_ctx(jcfg, J_SHAPES[name], multi_pod)
            c_spec, t_spec, p_spec = specs.serve_input_spec_tree(ctx, cfg, SHAPES[name],
                                                                 getattr(torch, kv))
            want = jrules.spec_tree(jctx, jcache, jtf.cache_axes(jcfg, int8=kv == "int8"))
            assert c_spec == _ref_layer_specs(want, jcfg)
            assert t_spec == tuple(jrules.logical_to_spec(jctx, jtokens.shape, ("batch", None)))
            assert p_spec == ()


# --- FLOPs: the model count and the counted matrix products -----------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_6nd_from_the_reference(arch):
    n = j_get_config(arch).flops_param_count()
    for name, shape in SHAPES.items():
        want = {"train": 6.0 * n * shape.global_batch * shape.seq_len,
                "prefill": 2.0 * n * shape.global_batch * shape.seq_len,
                "decode": 2.0 * n * shape.global_batch}[shape.kind]
        assert dryrun._model_flops(get_config(arch), shape) == want, name


def test_counted_train_flops_equal_the_matrix_products():
    """Reduced qwen2 (B 2 x S 64: the direct attention path), ``remat="none"``:
    the forward's products are the q/k/v/o projections, QK^T and PV, the
    gated MLP's three and the tied head; the backward takes two products of
    each (both operands need a gradient), so the step counts three times the
    forward.  AdamW and the clip do no matrix product."""
    over = {**dryrun.reduced_overrides("qwen2-0.5b"), "remat": "none"}
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **over)
    B, S = 2, 64
    T, d, H, KH, hd, ff, V = B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, \
        cfg.d_ff, cfg.vocab_size
    layer = (2 * T * d * hd * (H + 2 * KH) + 2 * T * H * hd * d + 2 * 2 * B * H * S * S * hd
             + 3 * 2 * T * d * ff)
    fwd = cfg.num_layers * layer + 2 * T * d * V
    assert cfg.tie_embeddings and cfg.mlp_act == "silu"
    rec = dryrun.lower_cell("qwen2-0.5b", ShapeSpec("t", S, B, "train"), cfg_overrides=over)
    assert rec["flops"] == 3 * fwd
    assert sum(rec["flops_by_dtype"].values()) == rec["flops"]
    # the attention products run in fp32 (the chunked and direct paths upcast q, k, v)
    assert rec["flops_by_dtype"]["float32"] == 3 * cfg.num_layers * 2 * 2 * B * H * S * S * hd


# --- per-period extrapolation against a full-depth run ------------------------------


EXTRAPOLATED = ("flops", "flops_by_dtype", "bytes", "activation_bytes", "peak_bytes",
                "peak_bytes_card")


@pytest.mark.parametrize("cell", ["train-none", "train-full", "prefill", "decode"])
@pytest.mark.parametrize("arch,layers", [("qwen2-0.5b", 6), ("recurrentgemma-9b", 14)])
def test_extrapolation_equals_a_full_depth_run(arch, layers, cell):
    kind, _, remat = cell.partition("-")
    shape = ShapeSpec(cell, 64, 4 if kind == "train" else 2, kind)
    over = {**dryrun.reduced_overrides(arch), "num_layers": layers, "remat": remat or "none"}
    got = dryrun.lower_cell(arch, shape, cfg_overrides=over)
    full_cfg = dataclasses.replace(get_config(arch), **over)
    want = dryrun._measure(full_cfg, shape)  # the step at full depth
    assert got["extrapolation"] == "per-period"
    want["peak_bytes"] = max(want["peak_bytes"].values())
    want["peak_bytes_card"] = max(want["peak_bytes_card"].values())
    assert {k: got[k] for k in EXTRAPOLATED} == {k: want[k] for k in EXTRAPOLATED}
    state, _ = dryrun._state_tree(full_cfg, shape, kv_dtype=None, param_dtype=torch.float32)
    assert got["state_bytes"] == sum(t.numel() * t.element_size() for t in tree_leaves(state))


def test_a_short_cell_runs_at_full_depth():
    over = dryrun.reduced_overrides("recurrentgemma-9b")  # 5 layers: one period of 3, tail 2
    rec = dryrun.lower_cell("recurrentgemma-9b", ShapeSpec("t", 32, 2, "train"),
                            cfg_overrides=over)
    assert rec["extrapolation"] == "exact"


# --- the meters --------------------------------------------------------------------


def test_cost_meter_counts_live_storage_and_op_bytes():
    mode = tmodel.fake_mode()
    meter = dryrun.CostMeter()
    with mode, meter:
        kept = [torch.empty(1 << 20) for _ in range(5)]  # 5 x 4 MiB
        tmp = torch.empty(1 << 20)
        del tmp  # freed: the peak saw it, the live count drops it
        y = kept[0] * 2.0  # one op: 4 MiB in, 4 MiB out
        view = y.view(-1)  # a view: no bytes, no new storage
        del y
        assert meter.live == 6 * 4 << 20
    assert meter.peaks["setup"][0] == 6 * 4 << 20
    assert meter.bytes == 8 << 20 and view.shape == (1 << 20,)
    assert meter.peaks["setup"][1] % dryrun.ALLOC_ROUND == 0


def test_train_peak_is_the_larger_phase_and_the_inputs_are_live():
    over = {**dryrun.reduced_overrides("qwen2-0.5b"), "remat": "none"}
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **over)
    counts = dryrun._measure(cfg, ShapeSpec("t", 32, 2, "train"))
    assert set(counts["peak_bytes"]) == {"forward", "backward", "update"}
    assert min(counts["peak_bytes"].values()) >= counts["input_bytes"]
    rec = dryrun.lower_cell("qwen2-0.5b", ShapeSpec("t", 32, 2, "train"), cfg_overrides=over)
    assert rec["peak_bytes"] == max(counts["peak_bytes"].values())
    assert rec["activation_bytes"] > 0 and rec["fits_one_card"]
    full = dryrun.lower_cell("qwen2-0.5b", ShapeSpec("t", 32, 2, "train"),
                             cfg_overrides={**over, "remat": "full"})
    assert full["activation_bytes"] < rec["activation_bytes"]
    assert full["flops"] > rec["flops"]  # the recompute


def test_state_bytes_per_device_follow_the_rules():
    rec = dryrun.lower_cell("qwen2-72b", "decode_32k",
                            cfg_overrides=dryrun.reduced_overrides("qwen2-72b"))
    per = rec["state_bytes_per_device"]
    assert set(per) == {"16x16", "2x16x16"}
    assert rec["state_bytes"] / 512 <= per["2x16x16"] <= per["16x16"] <= rec["state_bytes"]


def test_lower_cell_refuses_what_needs_several_cards():
    with pytest.raises(NotImplementedError, match="multi-card"):
        dryrun.lower_cell("qwen2-0.5b", ShapeSpec("t", 32, 2, "train"),
                          train_opts={"grad_reshard": True})


# --- hillclimb ---------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(hillclimb.VARIANTS))
def test_hillclimb_variant_at_a_reduced_cell(variant):
    arch = "qwen3-moe-235b-a22b"
    over = dryrun.reduced_overrides(arch)
    kind = "decode" if variant == "kv_int8" else "train"
    shape = ShapeSpec(f"reduced_{kind}", 32, 8, kind)
    rec = hillclimb.run_variant(arch, shape, variant, cfg_overrides=over)
    assert rec["variant"] == variant
    if variant in hillclimb.MULTI_CARD:
        assert rec["status"] == "needs_multi_card" and "multi-card" in rec["why"]
        return
    assert rec["status"] == "ok"
    base = hillclimb.run_variant(arch, shape, "baseline", cfg_overrides=over)
    if variant.startswith("accum"):
        assert rec["grad_accum"] == int(variant[5:])
        assert rec["flops"] == base["flops"]  # the same products over fewer rows at a time
    elif variant == "remat_dots":
        assert rec["remat"] == "dots" and rec["flops"] > base["flops"]
    elif variant == "kv_int8":
        assert rec["kv_dtype"] == "int8" and rec["state_bytes"] < base["state_bytes"]
    elif variant == "bf16master":
        assert rec["param_dtype"] == "bfloat16" and rec["state_bytes"] > base["state_bytes"]
    elif variant.startswith("moe_cf"):
        cf = float(variant[6:])
        assert rec["flops"] != base["flops"] or cf == over["moe_capacity_factor"]
    assert set(hillclimb.VARIANTS) >= hillclimb.MULTI_CARD


# --- the command lines and the roofline table ---------------------------------------


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "torch_roofline", os.path.join(ROOT, "benchmarks", "torch_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_cli_and_the_roofline_table(tmp_path, capsys):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--out", out]) == 0
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--out", out]) == 0
    assert "1 ok, 0 skipped, 0 error" in capsys.readouterr().out
    rf = _roofline()
    recs = rf.load(out)
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    json.dumps(recs)  # JSON-safe
    table = rf.table(recs)
    assert "| mamba2-370m | long_500k |" in table and "skipped: pure full-attention" in table
    s = rf.summary(recs)
    assert (s["cells_ok"], s["cells_skipped"], s["cells_error"]) == (1, 1, 0)
    assert s["fit_one_card"] == [("mamba2-370m", "long_500k")]
    assert rf.HW["peak_flops_bf16"] == dryrun.PEAK_FLOPS_BF16 and rf.HW["hbm_bw"] == dryrun.HBM_BW


def test_hillclimb_cli_records_a_multi_card_variant(tmp_path):
    out = str(tmp_path / "hc")
    assert hillclimb.main(["--arch", "qwen2-72b", "--shape", "train_4k", "--variant", "sp",
                           "--out", out]) == 0
    rec = json.load(open(os.path.join(out, "qwen2-72b__train_4k__sp.json")))
    assert rec["status"] == "needs_multi_card"
