"""The port's mesh path against the JAX package's, on the CPU.

The JAX side needs 8 devices, so it runs once per module in a subprocess
with ``--xla_force_host_platform_device_count=8`` (as tests/test_moe.py
does) and writes its results as numpy arrays.  The port runs the same
inputs as gloo processes, one per rank (``run_on_mesh(device="cpu")``), one
spawn per mesh: the MoE layer on the reference test's ``(data 2, model 4)``
mesh, the reduced qwen3-moe on ``(data 2, model 2)``.  Weights cross with
``convert``.

Tolerances, each no looser than the reference's own (1e-3 absolute for the
expert-parallel layer, 1e-4 for token dispatch): the MoE layer within
``MOE_REL * max|out|``, the LM's logits within ``LM_REL * max|logits|`` (the
packages sum the expert products, the psums over the model axis and the
attention in other orders).
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

MOE_REL = 1e-5
LM_REL = 1e-5
ARCH = "qwen3-moe-235b-a22b"
DIMS = dict(D=16, F=32, E=8, K=2)  # the reference's EP test
LM = dict(batch=4, seq=16, decode_steps=4, prompt=4, new_tokens=6)

_JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import SHAPES, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import make_ctx
from repro.models import model as jmodel, moe, transformer
from repro.sharding.rules import MeshCtx

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
d = inp["dims"]
ctx = MeshCtx(mesh=make_mesh((2, 4), ("data", "model")))
p = {k: jnp.asarray(v) for k, v in inp["moe_params"].items()}
kw = dict(num_experts=d["E"], top_k=d["K"], act="silu")
for cf in (1.25, 8.0):
    out[f"ep/{cf}"] = np.asarray(moe.moe_apply(p, jnp.asarray(inp["x_prefill"]), ctx,
                                               capacity_factor=cf, **kw))
out["local/1.25"] = np.asarray(moe.moe_apply(p, jnp.asarray(inp["x_prefill"]), None, **kw))
out["dispatch"] = np.asarray(moe.moe_apply(p, jnp.asarray(inp["x_decode"]), ctx, dropless=True,
                                           token_dispatch=True, **kw))

cfg = reduced_config("qwen3-moe-235b-a22b")
params = jax.tree.map(jnp.asarray, inp["lm_params"])
mesh = make_mesh((2, 2), ("data", "model"))
pctx = make_ctx(mesh, cfg, SHAPES["prefill_32k"])
dctx = make_ctx(mesh, cfg, SHAPES["decode_32k"])
tokens = inp["tokens"]
fwd = jax.jit(lambda p, t: transformer.apply(p, cfg, pctx, {"tokens": t}))
out["prefill"] = np.asarray(fwd(params, jnp.asarray(tokens)))
serve = jax.jit(jmodel.make_serve_step(cfg, dctx, compute_dtype=jnp.float32))
cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1], jnp.float32)
steps = []
for pos in range(inp["decode_steps"]):
    logits, cache = serve(params, cache, jnp.asarray(tokens[:, pos:pos + 1]), jnp.int32(pos))
    steps.append(np.asarray(logits[:, 0]))
out["decode"] = np.stack(steps, 1)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the same inputs and weights (drawn by the port from
    seeds): the JAX subprocess runs while the port's two meshes do."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    cfg = reduced_config(ARCH)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    gqa_cfg = reduced_config("qwen2-0.5b")
    gqa_params = transformer.init_params(gqa_cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    moe_params = {k: v.numpy() for k, v in
                  tmoe.moe_init(gen, DIMS["D"], DIMS["F"], DIMS["E"], "silu").items()}
    inp = dict(dims=DIMS, x_prefill=rng.standard_normal((4, 8, DIMS["D"])).astype(np.float32),
               x_decode=rng.standard_normal((4, 1, DIMS["D"])).astype(np.float32),
               tokens=rng.integers(0, 256, (LM["batch"], LM["seq"])).astype(np.int32),
               prompts=rng.integers(0, 256, (LM["batch"], LM["prompt"])),
               decode_steps=LM["decode_steps"], moe_params=moe_params,
               lm_params=convert.lm_params_to_arrays(params, cfg))
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            wide = tmesh.run_on_mesh(
                ranks.mesh24_body, (2, 4), ("data", "model"), device="cpu",
                args=((moe_params, inp["x_prefill"], inp["x_decode"], DIMS),
                      (gqa_cfg, gqa_params, inp["tokens"][:, :8], inp["prompts"],
                       LM["new_tokens"])))
            lm = tmesh.run_on_mesh(ranks.lm_body, (2, 2), ("data", "model"), device="cpu",
                                   args=(cfg, params, inp["tokens"], inp["prompts"],
                                         dict(decode_steps=LM["decode_steps"],
                                              new_tokens=LM["new_tokens"])))
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return dict(inp=inp, jax=out, moe=[r["moe"] for r in wide], gqa=[r["gqa"] for r in wide],
                lm=lm, cfg=cfg, params=params, gqa_cfg=gqa_cfg, gqa_params=gqa_params)


def _close(got, want, rel):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("impl", ["einsum", "block_spmm"])
@pytest.mark.parametrize("layout", ["ep", "ep_sharded"])
def test_expert_parallel_layer_drops_the_pairs_jax_drops(runs, layout, impl):
    """Capacity factor 1.25 on the local 16 tokens of a data rank: ceil(16 * 2 *
    1.25 / 8) = 5 slots an expert, so pairs drop, and the same ones as in the
    JAX package's EP layer (not one process's: its capacity counts 32 tokens)."""
    out = runs["jax"]
    want = out["ep/1.25"]
    assert np.abs(want - out["local/1.25"]).max() > 1e-3  # the EP capacity drops other pairs
    for rank in runs["moe"]:
        _close(rank["out"][f"{layout}/1.25/{impl}"], want, MOE_REL)


@pytest.mark.parametrize("impl", ["einsum", "block_spmm"])
def test_expert_parallel_layer_without_drops_equals_the_local_path(runs, impl):
    """At capacity factor 8.0 nothing drops: the EP layer equals the port's own
    one-device path and the JAX package's EP layer."""
    out = runs["jax"]
    for rank in runs["moe"]:
        got = rank["out"][f"ep/8.0/{impl}"]
        _close(got, rank["out"]["local/8.0"], MOE_REL)
        _close(got, out["ep/8.0"], MOE_REL)
        _close(rank["out"][f"ep_sharded/8.0/{impl}"], got, MOE_REL)


def test_experts_that_do_not_split_run_whole_on_every_rank(runs):
    """6 experts on 4 model ranks: the reference's no-EP branch, every expert on
    every rank over the whole batch, equal to the one-device layer."""
    for rank in runs["moe"]:
        _close(rank["out"]["no_ep"], rank["out"]["no_ep_local"], MOE_REL)


def test_token_dispatch_matches_jax_and_the_dropless_local_path(runs):
    out = runs["jax"]
    for rank in runs["moe"]:
        for key in ("dispatch", "dispatch_resident"):
            _close(rank["out"][key], out["dispatch"], MOE_REL)
            _close(rank["out"][key], rank["out"]["dispatch_local"], MOE_REL)


def test_collectives_are_counted_by_kind(runs):
    """The EP layer on whole weights: one psum over the model axis of the local
    rows [2, 8, 16] fp32; token dispatch on resident weights: the batch
    gathered over data, one psum over each of the two axes."""
    moe_run = runs["moe"]

    def calls_and_bytes(counts):
        assert all(c["seconds"] >= 0 for c in counts.values())
        return {k: {"calls": c["calls"], "bytes": c["bytes"]} for k, c in counts.items()}

    for rank in moe_run:
        assert calls_and_bytes(rank["counts"]["ep/1.25/einsum"]) == {
            "all_reduce": {"calls": 1, "bytes": 2 * 8 * 16 * 4}}
        assert calls_and_bytes(rank["counts"]["dispatch_resident"]) == {
            "all_gather": {"calls": 1, "bytes": 2 * 16 * 4},
            "all_reduce": {"calls": 2, "bytes": 2 * 4 * 16 * 4}}
    assert sorted(tuple(r["coord"]) for r in moe_run) == [(d, m) for d in range(2) for m in range(4)]
    assert {(r["backend"], r["ranks_per_card"]) for r in moe_run} == {("gloo", 1)}


def test_constrain_and_distribute_lay_out_by_the_rules(runs):
    """``constrain`` (a no-op without a mesh) and ``distribute`` give the
    reference's layout: the (4, 8, 16) activation batch-sharded over data."""
    for rank in runs["moe"]:
        c = rank["constrain"]
        assert c["spec"] == ("data", None, None) and c["local"] == (2, 8, 16)
        assert c["same_storage"] and c["no_mesh_is_noop"] and c["whole_equal"]
        assert c["router_spec"] == ("data", None)  # embed -> data under the default rules


def test_lm_prefill_on_mesh_matches_jax(runs):
    """The reduced qwen3-moe forward under the prefill ctx on (2, 2): logits
    vocab-sharded and batch-sharded, as the reference's constrain leaves them."""
    out, cfg = runs["jax"], runs["cfg"]
    for rank in runs["lm"]:
        _close(rank["prefill"], out["prefill"], LM_REL)
        assert rank["prefill_spec"] == ("data", None, "model")
        assert rank["prefill_local"] == (LM["batch"] // 2, LM["seq"], cfg.vocab_size // 2)


def test_lm_decode_steps_on_mesh_match_jax(runs):
    """Four decode steps under the decode ctx, after reshard_state from the
    prefill layout: expert weights d_ff-sharded over data (moe_ff), the cache
    over batch and kv heads, the MoE dispatching tokens."""
    out = runs["jax"]
    for rank in runs["lm"]:
        _close(rank["decode"], out["decode"], LM_REL)
        assert rank["decode_w1_spec"] == ("model", None, "data")
        assert rank["cache_spec"] == ("data", None, "model", None)
        np.testing.assert_array_equal(rank["greedy_last"][:, 0], out["decode"][:, -1].argmax(-1))


def test_greedy_serving_on_mesh_equals_one_process(runs):
    want = generate(runs["cfg"], runs["params"], runs["inp"]["prompts"], LM["new_tokens"],
                    device="cpu")
    for rank in runs["lm"]:
        np.testing.assert_array_equal(rank["seqs"], want)


def test_kv_heads_that_do_not_split_compute_whole(runs):
    """Reduced qwen2-0.5b (4 query heads, 2 kv heads, d_ff 128) on (2, 4): the
    query heads, the MLP and the vocab split four ways, the kv projections
    compute whole on each rank (each rank's queries read their kv head), the
    cache shards head_dim instead (the reference's fallback); the forward,
    the decode steps and greedy serving equal one process's (which
    tests/test_torch_lm.py holds against the JAX package)."""
    cfg, params, inp = runs["gqa_cfg"], runs["gqa_params"], runs["inp"]
    tokens = torch.from_numpy(inp["tokens"][:, :8])
    want = transformer.apply(params, cfg, {"tokens": tokens}).numpy()
    B, S = tokens.shape
    cache = transformer.init_cache(cfg, B, S, torch.float32, device="cpu")
    serve = tmodel.make_serve_step(cfg, compute_dtype=torch.float32)
    steps = []
    for pos in range(S):
        logits, cache = serve(params, cache, tokens[:, pos:pos + 1].long(), pos)
        steps.append(logits[:, 0].numpy())
    want_steps = np.stack(steps, 1)
    want_seqs = generate(cfg, params, inp["prompts"], LM["new_tokens"], device="cpu")
    for rank in runs["gqa"]:
        assert rank["q_spec"] == (None, "model", None) and rank["k_spec"] == (None, None, None)
        assert rank["wo_spec"] == ("model", None)
        assert rank["cache_spec"] == ("data", None, None, "model")
        _close(rank["prefill"], want, LM_REL)
        _close(rank["decode"], want_steps, LM_REL)
        np.testing.assert_array_equal(rank["seqs"], want_seqs)


def test_train_gradients_where_kv_heads_do_not_split(runs):
    """The same reduced qwen2-0.5b on (2, 4) under the train rules: the kv
    projections compute whole and each rank's queries read a slice of their
    heads, so the slice's cotangents are summed over the model axis; the loss
    and every gradient equal one process's (which tests/test_torch_train.py
    holds against the JAX package) within its limits."""
    from repro_torch.tree import tree_paths

    cfg, params = runs["gqa_cfg"], runs["gqa_params"]
    tokens = runs["inp"]["tokens"][:, :8]
    loss, grads = tmodel.make_grad_fn(cfg, compute_dtype=torch.float32)(params,
                                                                       {"tokens": tokens})
    for rank in runs["gqa"]:
        got = rank["train"]
        assert got["k_spec"] == ("data", None, None)
        assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
        for path, g in tree_paths(grads):
            _close(got["grads"][path], g.numpy(), 1e-4)


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.run_on_mesh(ranks.failing_body, (2,), ("data",))
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")


def test_backend_rule(monkeypatch):
    """nccl where every rank has a card of its own, gloo where ranks share one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.mesh_backend("cuda", 4) == "nccl"
    assert tmesh.mesh_backend("cuda", 8) == "gloo"
    assert tmesh.mesh_backend("cpu", 1) == "gloo"
    assert [tmesh.rank_device(r, "cuda").index for r in range(6)] == [0, 1, 2, 3, 0, 1]


def test_a_mesh_over_part_of_a_larger_pool():
    """As the reference's ``make_mesh`` takes the first devices of a larger
    pool.  On cards: four ranks on two cards run gloo (two ranks a card), and
    a mesh over two of them keeps gloo and two ranks a card, though two ranks
    alone would each have a card of their own."""
    res = tmesh.run_on_mesh(ranks.pool_body, (4,), ("pool",), device="cpu", args=(2,),
                            timeout_s=120)
    assert [r["coord"] for r in res] == [[0], [1], None, None]
    assert all(r["pool"] == {"pool": 4} and r["backend"] == "gloo" for r in res)
    assert all(r["on_cards"] == dict(backend="gloo", ranks_per_card=2, device_type="cuda")
               for r in res)


def test_a_rank_that_ends_without_a_result_fails_the_launch_at_once():
    """Not after ``timeout_s``: the launcher sees the process end."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 .*exit code 3 and sent no result"):
        tmesh.run_on_mesh(ranks.dying_body, (2,), ("data",), device="cpu", args=(3,),
                          timeout_s=300)
    assert time.monotonic() - t0 < 60


def test_ranks_silent_past_the_timeout_fail_the_launch():
    """``timeout_s`` counts from the start, not from the last message."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="2 ranks silent 5 s after the start"):
        tmesh.run_on_mesh(ranks.dying_body, (2,), ("data",), device="cpu", args=(None,),
                          timeout_s=5)
    assert time.monotonic() - t0 < 60


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="(?s)rank 1 .*failed on purpose"):
        tmesh.run_on_mesh(ranks.failing_body, (2,), ("data",), device="cpu", timeout_s=120)


def test_moe_without_ctx_keeps_its_signature():
    """``ctx=None`` (the default) is the one-device layer, as before."""
    g = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(g, 8, 16, 4, "silu")
    x = torch.randn(2, 4, 8, generator=g)
    kw = dict(num_experts=4, top_k=2, act="silu")
    assert torch.equal(tmoe.moe_apply(p, x, **kw), tmoe.moe_apply(p, x, ctx=None, **kw))
