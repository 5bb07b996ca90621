"""Sequence parallelism on the mesh (the rule override ``seq -> model``) against the JAX package.

Under the override the residual stream ``[B_l, S, d]`` is cut along its
sequence over the model axis between blocks: each block gathers it where it
enters the column-parallel products, and each row-parallel sum becomes a
reduce-scatter back to the rank's block (``rules.sp_gather`` /
``rules.sp_scatter``).  The JAX side runs once in a subprocess with 8 fake
devices: ``jax.jit`` of the reference's forward and of its loss's
``value_and_grad`` under ``make_ctx(mesh, cfg, SHAPES["train_4k"])
.with_rules(seq=("model",))`` on a (data 2, model 2) ``jax.sharding.Mesh``.
The port runs as gloo processes, one per rank, in one spawn, under the same
rules and, for the comparison within the port, without the override; its
rank bodies are ``tests/torch_mesh_sp_ranks.py``.

The cases, reduced configs at B 4 x S 16: qwen2-0.5b (attention, the
vocab-parallel lookup), with one kv head (the kv projections computed whole
on every rank, of which each keeps its queries' slice), with every dim the
model axis cannot split (3 heads, d_ff 129, vocab 255: the logits stay cut
along the sequence), qwen3-moe (the expert-parallel body), recurrentgemma
(rec and local), mamba2 (ssm), paligemma (a vision prefix) and hubert (an
audio encoder, sinusoidal positions); and qwen2 at S 15, which the model
axis does not divide: the override then changes nothing.

Limits, those of ``tests/test_torch_mesh_train.py``: logits within
``LM_REL`` times their largest magnitude, the loss within ``LOSS_REL``
relative, each gradient leaf within ``GRAD_REL`` times its largest
magnitude, in both ``grad_reshard`` modes.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_mesh_sp_ranks as ranks  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402
from torch_parity import randomize_lm  # noqa: E402

LM_REL = 1e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-4
B = 4

#: name -> (arch, config changes, sequence length)
CASES = {
    "qwen2": ("qwen2-0.5b", {}, 16),
    "qwen2_kv1": ("qwen2-0.5b", {"num_kv_heads": 1}, 16),
    "qwen2_whole": ("qwen2-0.5b", {"num_heads": 3, "num_kv_heads": 1, "d_ff": 129,
                                   "vocab_size": 255}, 16),
    "moe_ep": ("qwen3-moe-235b-a22b", {}, 16),
    "rglru": ("recurrentgemma-9b", {}, 16),
    "ssd": ("mamba2-370m", {}, 16),
    "paligemma": ("paligemma-3b", {}, 16),
    "hubert": ("hubert-xlarge", {}, 16),
    "qwen2_s15": ("qwen2-0.5b", {}, 15),
}
MODES = (True, False)

_JAX_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs import SHAPES, reduced_config
from repro.launch.specs import abstract_state_and_shardings, make_ctx
from repro.models import model as jmodel, transformer

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
whole = NamedSharding(mesh, PartitionSpec())
out = {}
for name, c in inp.items():
    cfg = dataclasses.replace(reduced_config(c["arch"]), **c["changes"])
    ctx = make_ctx(mesh, cfg, SHAPES["train_4k"]).with_rules(seq=("model",))
    _, st_sh = abstract_state_and_shardings(ctx, cfg, param_dtype=jnp.float32)
    params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), st_sh["params"])
    batch = jax.device_put({k: jnp.asarray(v) for k, v in c["batch"].items()}, whole)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits = jax.jit(lambda p, x: transformer.apply(p, cfg, ctx, x))(params, inputs)
    loss_fn = jmodel.make_loss_fn(cfg, ctx, compute_dtype=jnp.float32)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    out[name] = dict(logits=np.asarray(logits), loss=float(loss),
                     grads=jax.tree.map(lambda a: np.asarray(a, np.float32), grads))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _batch(cfg, S: int, rng) -> dict:
    """A train batch as ``launch/specs.py`` shapes it (hubert's labels beside its frames)."""
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
                    np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on every case: the JAX subprocess runs while the port's
    one (2, 2) spawn does."""
    tmp = tmp_path_factory.mktemp("mesh_sp")
    jax_in, port = {}, {}
    for i, (name, (arch, changes, S)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(reduced_config(arch), **changes)
        jcfg = dataclasses.replace(jax_reduced_config(arch), **changes)
        rng = np.random.default_rng(60 + i)
        tree = jax.tree.map(np.asarray, jmodel.init_train_state(jax.random.key(60 + i), jcfg))
        tree["params"] = randomize_lm(tree["params"], rng)
        batch = _batch(cfg, S, rng)
        jax_in[name] = dict(arch=arch, changes=changes, params=tree["params"], batch=batch)
        port[name] = dict(cfg=cfg, state=convert.train_state_from_arrays(tree, cfg, device="cpu"),
                          batch=batch, modes=MODES)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(jax_in, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            res = tmesh.run_on_mesh(ranks.body, (2, 2), ("data", "model"), device="cpu",
                                    args=(port,), timeout_s=600)
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return dict(jax=want, port=res, inputs=port)


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


def _close(got, want, rel: float, what):
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _jax_grads(runs, case) -> dict:
    cfg = runs["inputs"][case]["cfg"]
    return {p: t.float().numpy() for p, t in tree_paths(
        convert.lm_params_from_arrays(runs["jax"][case]["grads"], cfg, device="cpu"))}


def _layer_inputs(cfg) -> int:
    """The stream's gathers a forward's layers make: the mixer's input, and the
    FFN's where the block has one (every kind but ``ssm``)."""
    return sum(1 if kind == "ssm" else 2 for kind in transformer.layer_kinds(cfg))


def _model(counts: dict, kind: str, key: str = "calls") -> int:
    return counts.get(kind, {}).get("model", {}).get(key, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallelism_applies_where_the_model_axis_divides_the_sequence(runs, case):
    """The stream is cut over ``model`` when the model axis divides S: the
    reference's divisibility fallback, evaluated on the real shape."""
    for rank in runs["port"]:
        assert rank[case]["seq_axis"] == (None if CASES[case][2] % 2 else "model")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    """Every rank's logits, gathered from its blocks, against the reference's
    under the same override; a head the vocab's fallback keeps whole leaves
    the logits cut along the sequence, as the reference lays them out."""
    cut = CASES[case][2] % 2 == 0 and runs["inputs"][case]["cfg"].vocab_size % 2
    for rank in runs["port"]:
        sp = rank[case]["sp"]
        _close(sp["logits"], runs["jax"][case]["logits"], LM_REL, case)
        assert sp["logits_spec"] == (("data", "model", None) if cut else ("data", None, "model"))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(runs, case):
    """The loss of the global batch and every gradient leaf against the
    reference's, in both FSDP reductions."""
    want = _jax_grads(runs, case)
    for rank in runs["port"]:
        for rs in MODES:
            got = rank[case]["sp"][rs]
            assert _rel(got["loss"], runs["jax"][case]["loss"]) <= LOSS_REL
            assert got["grads"].keys() == want.keys()
            for path in want:
                _close(got["grads"][path], want[path], GRAD_REL, (case, rs, path))


@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallelism_matches_the_port_without_it(runs, case):
    """The same state and batch under the train rules without the override:
    the same logits, loss and gradients within the limits."""
    for rank in runs["port"]:
        sp, plain = rank[case]["sp"], rank[case]["plain"]
        _close(sp["logits"], plain["logits"], LM_REL, case)
        assert _rel(sp[True]["loss"], plain[True]["loss"]) <= LOSS_REL
        for path, g in plain[True]["grads"].items():
            _close(sp[True]["grads"][path], g, GRAD_REL, (case, path))


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_gradients_agree_on_every_rank(runs, case):
    """A gradient block that several ranks hold (a norm scale on the model
    axis, which each rank's sequence block reaches; a bias on the data axis)
    is the same bits on all of them: the sequence-parallel parameters were
    summed over the model axis."""
    res = runs["port"]
    for rs in MODES:
        for path in res[0][case]["sp"][rs]["blocks"]:
            assert ranks.replicated_blocks_agree(res, case, path, rs), (case, rs, path)


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_scatter_and_all_reduce_give_the_same_bits(runs, case):
    """On (data 2, model 2) the FSDP reduction sums two partials either way:
    the modes' losses and gradients are the same bits under the override."""
    for rank in runs["port"]:
        t, f = rank[case]["sp"][True], rank[case]["sp"][False]
        assert t["loss"] == f["loss"]
        assert all(np.array_equal(t["grads"][p], f["grads"][p]) for p in t["grads"])


@pytest.mark.parametrize("case", list(CASES))
def test_row_sums_become_reduce_scatters(runs, case):
    """A forward's collectives over the model axis: each row-parallel
    ``all_reduce`` (a layer's ``o``, ``wo``, ``w_out``, ``out_proj``, the
    MoE's expert sum, the lookup's sum) becomes a ``reduce_scatter`` of the
    same operand, and every layer gathers its inputs (``all_gather`` of the
    block), as does a vocab-parallel head.  Where the axis does not divide S,
    the forward and the gradients move what they move without the override."""
    cfg = runs["inputs"][case]["cfg"]
    n = _layer_inputs(cfg)
    for rank in runs["port"]:
        sp, plain = rank[case]["sp"], rank[case]["plain"]
        s, p = sp["forward_counts"], plain["forward_counts"]
        if CASES[case][2] % 2:
            assert s == p and sp[True]["counts"] == plain[True]["counts"]
            continue
        head = 1 if cfg.vocab_size % 2 == 0 else 0  # the head's gather of the stream
        assert _model(s, "all_gather") - _model(p, "all_gather") == n + head
        replaced = _model(p, "all_reduce") - _model(s, "all_reduce")
        assert _model(s, "reduce_scatter") == replaced
        if case == "qwen2_whole":  # every product whole on every rank: no sum to replace
            assert replaced == 0
            continue
        lookup = 0 if cfg.frontend == "audio_stub" else 1
        assert replaced == n + lookup
        if cfg.frontend != "vision_stub":  # the lookup's sum covers the tokens, not the patches
            assert _model(s, "reduce_scatter", "bytes") == (
                _model(p, "all_reduce", "bytes") - _model(s, "all_reduce", "bytes"))
        # a gather moves the block: a model-axis share of the sum it replaces
        assert _model(s, "all_gather", "bytes") - _model(p, "all_gather", "bytes") == (
            (n + head) * _model(s, "reduce_scatter", "bytes") // (2 * replaced))


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] != "hubert-xlarge"])
def test_a_decode_step_is_unchanged_by_the_override(runs, case):
    """A decode step's S is 1, which no axis splits: the same collectives, by
    kind and axis, and the same logits as without the override."""
    for rank in runs["port"]:
        d = rank[case]["decode"]
        assert d["sp"]["counts"] == d["plain"]["counts"]
        assert np.array_equal(d["sp"]["logits"], d["plain"]["logits"])


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2}], ids=str)
def test_the_override_changes_nothing_without_a_split(axes):
    """On a fake mesh: a train step on a mesh without a ``model`` axis (pure
    FSDP), and a decode step on one with it, count the same collectives with
    and without the override."""
    cfg = reduced_config("qwen2-0.5b")
    shape = (ShapeSpec("train_4k", 16, 4, "train") if "model" not in axes
             else ShapeSpec("decode_32k", 16, 4, "decode"))
    kw = dict(param_dtype=torch.float32, kv_dtype=torch.float32, compute_dtype=torch.float32)
    plain = dryrun.measure_on_mesh(cfg, shape, axes, **kw)
    sp = dryrun.measure_on_mesh(cfg, shape, axes, rules_override=ranks.SP, **kw)
    assert sp["collectives_by_kind"] == plain["collectives_by_kind"]
    assert sp["flops"] == plain["flops"]
    assert plain["collectives_by_kind"]


def test_a_train_step_under_the_override_on_a_fake_mesh():
    """The dry run's train step under the override on (data 2, model 2) at a
    reduced config: the reduce-scatters over ``model`` of sequence
    parallelism, and the same one-device FLOPs as without it."""
    cfg = reduced_config("qwen2-0.5b")
    shape = ShapeSpec("train_4k", 16, 4, "train")
    kw = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    plain = dryrun.measure_on_mesh(cfg, shape, {"data": 2, "model": 2}, **kw)
    sp = dryrun.measure_on_mesh(cfg, shape, {"data": 2, "model": 2}, rules_override=ranks.SP,
                                **kw)
    assert "model" in sp["collectives_by_kind"]["reduce_scatter"]["by_axis"]
    assert "model" not in plain["collectives_by_kind"].get("reduce_scatter", {}).get(
        "by_axis", {})
    assert sp["flops"] == plain["flops"]
    assert sp["argument_bytes"] == plain["argument_bytes"]


def test_the_stream_axis_follows_the_rules():
    """``seq_axis``: the model axis where the rules map ``seq`` to it and it
    divides the stream (a vision prefix counts), else ``None``; another mesh
    axis is refused."""
    from repro_torch.sharding.rules import MeshCtx

    # the arithmetic alone: a ctx that claims a mesh
    ctx = dataclasses.replace(MeshCtx.of({"data": 2, "model": 2}), mesh=object())
    sp = ctx.with_rules(**ranks.SP)
    pali = reduced_config("paligemma-3b")
    qwen = reduced_config("qwen2-0.5b")
    tok = {"tokens": torch.zeros((4, 16), dtype=torch.long)}
    vis = {"patches": torch.zeros((4, pali.num_patches, pali.d_model)),
           "tokens": torch.zeros((4, 16 - pali.num_patches), dtype=torch.long)}
    assert transformer.seq_axis(ctx, qwen, tok) is None
    assert transformer.seq_axis(sp, qwen, tok) == "model"
    assert transformer.seq_axis(sp, pali, vis) == "model"
    assert transformer.seq_axis(sp, pali, {**vis, "tokens": vis["tokens"][:, 1:]}) is None
    assert transformer.seq_axis(sp, qwen, {"tokens": tok["tokens"][:, :15]}) is None
    assert transformer.seq_axis(None, qwen, tok) is None
    with pytest.raises(NotImplementedError, match="model axis"):  # 3 rows leave data free
        transformer.seq_axis(ctx.with_rules(seq=("data",)), qwen,
                             {"tokens": tok["tokens"][:3]})
