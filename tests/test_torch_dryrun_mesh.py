"""The dry run on a mesh: its fake-mesh counts against gloo ranks running the same step.

:func:`repro_torch.launch.dryrun.measure_on_mesh` runs a cell's step as rank
0 of a mesh on torch's ``fake`` process-group backend, on fake tensors, and
counts the port's collectives by kind and mesh axis.  Here gloo processes,
one per rank (``run_on_mesh(device="cpu")``), run the same steps on real
tensors at reduced configs on (data 2, model 2); every rank's counts must
equal the prediction exactly, kind for kind and axis for axis, in calls and
bytes: qwen2's train step in both ``grad_reshard`` modes and under
sequence parallelism (the rule override ``seq -> model``), and the decode
steps of qwen3-moe, recurrentgemma and mamba2 under ``decode_32k`` and
(the recurrent two) ``long_500k``.  Rank bodies: ``tests/torch_mesh_ranks.py``.

Also: the wire-byte conventions, the links, the argument bytes against
``state_bytes_per_device`` on both production meshes, the CLI's ``--mesh
multi``, and the hillclimb variants that split work across cards.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import SHAPES, reduced_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.models import transformer

AXES = {"data": 2, "model": 2}
DECODE = ShapeSpec("decode_32k", 16, 4, "decode")  # decode_32k's rules at a test size
TRAIN = ShapeSpec("train_4k", 16, 4, "train")

#: name -> (arch, shape, grad_reshard)
CASES = {
    "qwen2_train_rs": ("qwen2-0.5b", TRAIN, True),
    "qwen2_train_ar": ("qwen2-0.5b", TRAIN, False),
    "moe_decode": ("qwen3-moe-235b-a22b", DECODE, False),
    "rglru_decode": ("recurrentgemma-9b", DECODE, False),
    "ssd_decode": ("mamba2-370m", DECODE, False),
    "rglru_long": ("recurrentgemma-9b", SHAPES["long_500k"], False),
    "ssd_long": ("mamba2-370m", SHAPES["long_500k"], False),
    "qwen2_train_sp": ("qwen2-0.5b", TRAIN, True),
}
#: name -> the rules laid over the cell's (``make_ctx(...).with_rules``)
RULES = {"qwen2_train_sp": {"seq": ("model",)}}


def _pos(shape) -> int:
    return shape.seq_len - 1


@pytest.fixture(scope="module")
def gloo_counts():
    cases = {}
    for i, (name, (arch, shape, rs)) in enumerate(CASES.items()):
        cfg = reduced_config(arch)
        c = dict(cfg=cfg, shape=shape, dtype=torch.float32, grad_reshard=rs, pos=_pos(shape),
                 rules=RULES.get(name))
        if shape.kind == "train":
            c["state"] = tmodel.init_train_state(cfg, seed=i, device="cpu")
            c["batch"] = {"tokens": np.random.default_rng(i).integers(
                0, cfg.vocab_size, (shape.global_batch, shape.seq_len)).astype(np.int32)}
        else:
            c["params"] = transformer.init_params(cfg, seed=i, device="cpu")
        cases[name] = c
    return tmesh.run_on_mesh(ranks.step_counts_body, tuple(AXES.values()), tuple(AXES),
                             device="cpu", args=(cases,), timeout_s=600)


@pytest.mark.parametrize("name", list(CASES))
def test_fake_mesh_counts_equal_the_gloo_ranks(gloo_counts, name):
    arch, shape, rs = CASES[name]
    got = dryrun.measure_on_mesh(reduced_config(arch), shape, AXES, param_dtype=torch.float32,
                                 kv_dtype=torch.float32, compute_dtype=torch.float32,
                                 pos=_pos(shape), grad_reshard=rs,
                                 rules_override=RULES.get(name))["collectives_by_kind"]
    predicted = {k: {a: {"calls": v["calls"], "bytes": v["operand_bytes"], "group": v["group"]}
                     for a, v in per["by_axis"].items()} for k, per in got.items()}
    assert predicted, "the step makes collectives"
    for rank in gloo_counts:
        assert rank[name] == predicted
    if shape.kind == "train":  # the FSDP reduction is the mode's collective
        assert ("reduce_scatter" in predicted) == rs
        # sequence parallelism's reduce-scatters run over the model axis
        assert ("model" in predicted.get("reduce_scatter", {})) == (name in RULES)


def test_wire_bytes_follow_the_reference_conventions():
    assert dryrun.wire_bytes("all_gather", 100, 16) == 1600  # the result
    assert dryrun.wire_bytes("all_reduce", 100, 16) == 200  # twice the operand
    assert dryrun.wire_bytes("reduce_scatter", 1600, 16) == 1600  # the operand
    with pytest.raises(ValueError):
        dryrun.wire_bytes("all_to_all", 1, 2)
    # a group inside one 8-card node rides NVLink; a 16-wide axis spans two nodes
    assert dryrun.link_bw({"data": 2, "model": 2}, "data") == dryrun.NVLINK_BW
    assert dryrun.link_bw({"data": 16, "model": 16}, "model") == dryrun.IB_BW
    assert dryrun.link_bw({"data": 16, "model": 16}, "data") == dryrun.IB_BW
    assert dryrun.link_bw({"data": 32, "model": 8}, "model") == dryrun.NVLINK_BW
    assert dryrun.link_bw({"pod": 2, "data": 16, "model": 16}, "pod") == dryrun.IB_BW
    coll = dryrun.collectives_by_kind({"data": 16, "model": 16}, {
        "all_gather": {"data": {"calls": 2, "bytes": 10, "group": 16}},
        "all_reduce": {"model": {"calls": 3, "bytes": 30, "group": 16},
                       "data": {"calls": 1, "bytes": 5, "group": 16}}})
    assert coll["all_gather"]["wire_bytes"] == 160 and coll["all_reduce"]["wire_bytes"] == 70
    assert coll["all_reduce"]["calls"] == 4 and coll["all_reduce"]["operand_bytes"] == 35
    assert math.isclose(sum(k["seconds"] for k in coll.values()), 230 / dryrun.IB_BW)


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", ShapeSpec("train_4k", 64, 64, "train")),
    ("qwen3-moe-235b-a22b", ShapeSpec("decode_32k", 256, 64, "decode")),
    ("recurrentgemma-9b", "long_500k"),
    ("paligemma-3b", ShapeSpec("prefill_32k", 256, 32, "prefill"))], ids=str)
def test_argument_bytes_equal_state_bytes_per_device(arch, shape):
    """Rank 0 of each production mesh runs on its blocks of the very state the
    rules lay out: its argument bytes are ``state_bytes_per_device`` (the
    cells' rules at a test size)."""
    rec = dryrun.lower_cell(arch, shape, cfg_overrides=dryrun.reduced_overrides(arch))
    assert set(rec["on_mesh"]) == {"16x16", "2x16x16"}
    for name, m in rec["on_mesh"].items():
        assert m["argument_bytes"] == rec["state_bytes_per_device"][name]
        assert m["chips"] == math.prod(m["axes"].values())
        assert m["peak_bytes"] >= m["argument_bytes"]
        assert math.isfinite(m["collective_term_s"]) and m["collective_term_s"] >= 0
        assert m["bottleneck"] in ("compute", "memory", "collective")
    assert rec["collective_term_s"] == rec["on_mesh"]["16x16"]["collective_term_s"]


def test_cli_mesh_multi(tmp_path, capsys):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--mesh", "multi",
                        "--out", out]) == 0
    text = capsys.readouterr().out
    assert "1 ok, 0 skipped, 0 error" in text and "mamba2-370m|long_500k|2x16x16" in text
    rec = json.load(open(os.path.join(out, "mamba2-370m__long_500k__multi.json")))
    assert rec["mesh"] == "2x16x16"
    assert rec["collective_term_s"] == rec["on_mesh"]["2x16x16"]["collective_term_s"]
    assert rec["on_mesh"]["2x16x16"]["chips"] == 512 and rec["on_mesh"]["16x16"]["chips"] == 256


@pytest.mark.parametrize("variant", ["gradrs", "bf16_rs", "bf16_rs_accum4", "bf16_rs_accum1",
                                     "token_dispatch", "sp", "sp_accum1", "sp_accum2",
                                     "sp_accum4", "sp_accum4_dots"])
def test_hillclimb_variants_run_on_the_meshes(variant):
    arch = "qwen3-moe-235b-a22b"
    kind = "decode" if variant == "token_dispatch" else "train"
    shape = ShapeSpec(f"reduced_{kind}", 32, 128, kind)  # 32 rows a microbatch at accum 4
    rec = hillclimb.run_variant(arch, shape, variant, cfg_overrides=dryrun.reduced_overrides(arch))
    assert rec["status"] == "ok" and rec["variant"] == variant
    sp = variant.startswith("sp")
    for m in rec["on_mesh"].values():
        kinds = m["collectives_by_kind"]
        assert ("reduce_scatter" in kinds) == (kind == "train")
        # the stream's reduce-scatters over model (the FSDP ones run over data)
        assert ("model" in kinds.get("reduce_scatter", {}).get("by_axis", {})) == sp
        assert math.isfinite(m["collective_term_s"]) and m["collective_term_s"] > 0
    if sp:
        assert rec["rules_override"] == {"seq": ["model"]} and "grad_reshard" not in rec
    elif kind == "train":
        assert rec["grad_reshard"] is True


def test_run_cells_takes_a_variant_beside_the_cells():
    """A cell may carry a variant's ``lower_cell`` arguments (the smoke runs the
    hillclimb's records in the sweep's pool): the record is ``lower_cell``'s,
    and the pool's queue weighs the variant's microbatches."""
    arch = "qwen2-0.5b"
    over = dryrun.reduced_overrides(arch)
    kw = hillclimb.variant_kwargs("sp_accum2", over)
    shape = ShapeSpec("train_4k", 64, 64, "train")  # the cell's rules at a test size
    (rec,) = dryrun.run_cells([(arch, shape, False, kw)], meshes=("16x16",))
    want = dryrun.lower_cell(arch, shape, meshes=("16x16",), **kw)
    assert rec["grad_accum"] == 2 and rec["rules_override"] == {"seq": ["model"]}
    for key in ("flops", "bytes", "peak_bytes_card"):
        assert rec[key] == want[key]
    assert rec["on_mesh"]["16x16"]["collectives_by_kind"] == (
        want["on_mesh"]["16x16"]["collectives_by_kind"])
    cost = dryrun._cost(((arch, "train_4k", False, kw), "16x16"))
    assert cost == dryrun._cost(((arch, "train_4k", False), "16x16")) * 2
    assert cost == 24 * 3 * 2


def test_fake_production_meshes_one_after_the_other():
    """Rank 0 of the 256- and 512-rank production meshes in this process, the
    group destroyed between them."""
    import torch.distributed as dist

    for multi, names, shape in ((False, ("data", "model"), (16, 16)),
                                (True, ("pod", "data", "model"), (2, 16, 16))):
        mesh = tmesh.make_fake_production_mesh(multi_pod=multi)
        try:
            assert mesh.mesh_dim_names == names and tuple(mesh.shape) == shape
            assert dist.get_world_size() == math.prod(shape) and dist.get_rank() == 0
            assert mesh.device_type == "cpu" and dist.get_backend() == "fake"
        finally:
            dist.destroy_process_group()
    with tmesh.fake_mesh({"data": 2, "model": 2}):
        with pytest.raises(RuntimeError, match="already initialised"):
            tmesh.make_fake_production_mesh()
    assert not dist.is_initialized()


#: the expert-parallel body's gathers at full width on the fake (2, 2) mesh, B 2 x
#: S 4096 prefill: (arch, layers, dtype) -> (all_gather calls and operand bytes over
#: data, all_reduce calls and bytes over model).  qwen3-moe's are the counts of the
#: body that gathered each weight whole up front (unchanged: its 64 experts a rank
#: fit EP_GATHER_BYTES); kimi-k2's 192 experts a rank run in 3 chunks of 64
EP_PREFILL = {("qwen3-moe-235b-a22b", 2, torch.float32): ((6, 4_831_838_208), (5, 335_544_320)),
              ("qwen3-moe-235b-a22b", 2, torch.bfloat16): ((6, 2_415_919_104), (5, 167_772_160)),
              ("kimi-k2-1t-a32b", 1, torch.bfloat16): ((9, 8_455_716_864), (3, 176_160_768))}
#: kimi-k2's one-layer bf16 prefill a rank on (2, 2): four ranks and their CUDA
#: contexts fit one 80 GB card (33.83e9 when the body held all three weights gathered)
KIMI_PREFILL_PEAK = 18.5e9


@pytest.mark.parametrize("arch,layers,dtype", list(EP_PREFILL), ids=str)
def test_ep_prefill_gathers_at_full_width(arch, layers, dtype):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    got = dryrun.measure_on_mesh(cfg, ShapeSpec("prefill_32k", 4096, 2, "prefill"), AXES,
                                 param_dtype=dtype, compute_dtype=dtype)
    kinds = got["collectives_by_kind"]
    (ag_calls, ag_bytes), (ar_calls, ar_bytes) = EP_PREFILL[(arch, layers, dtype)]
    assert set(kinds) == {"all_gather", "all_reduce"}
    assert set(kinds["all_gather"]["by_axis"]) == {"data"}
    assert set(kinds["all_reduce"]["by_axis"]) == {"model"}
    assert (kinds["all_gather"]["calls"], kinds["all_gather"]["operand_bytes"]) == (ag_calls,
                                                                                    ag_bytes)
    assert (kinds["all_reduce"]["calls"], kinds["all_reduce"]["operand_bytes"]) == (ar_calls,
                                                                                    ar_bytes)
    if arch.startswith("kimi"):
        assert max(got["peak_bytes_card"].values()) <= KIMI_PREFILL_PEAK


EP_CHUNKS = (4, 2, 1)  # experts a chunk, of a rank's 4


@pytest.fixture(scope="module")
def ep_chunk_runs():
    rng = np.random.default_rng(5)
    E, K, D, F = 8, 2, 64, 128
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * D**-0.5,
         "w1": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
         "wg": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
         "w2": rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5}
    x = rng.standard_normal((4, 16, D)).astype(np.float32)
    return tmesh.run_on_mesh(ranks.ep_chunks_body, tuple(AXES.values()), tuple(AXES),
                             device="cpu", args=(p, x, dict(E=E, K=K), EP_CHUNKS),
                             timeout_s=600)


@pytest.mark.parametrize("impl", ["einsum", "block_spmm"])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_ep_layer_in_chunks_keeps_the_bits(ep_chunk_runs, dtype, impl):
    """The EP layer on gloo CPU ranks gives the bits of the body that gathered
    each weight whole before routing, in one chunk or several; each chunk
    gathers its slice of the three weights (after the router's gather), the
    bytes the same."""
    for rank in ep_chunk_runs:
        whole = None
        for chunk in EP_CHUNKS:
            equal, counts = rank[(dtype, impl, chunk)]
            assert equal, chunk
            gathers = counts["all_gather"]["data"]
            assert gathers["calls"] == 1 + 3 * (4 // chunk)  # the router, then each chunk's
            whole = whole or gathers["bytes"]
            assert gathers["bytes"] == whole
            assert counts["all_reduce"] == {"model": {"calls": 1, "bytes": 2 * 16 * 64 * (
                4 if dtype == "torch.float32" else 2), "group": 2}}
