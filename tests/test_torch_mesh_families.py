"""The port's ``rec`` (RG-LRU) and ``ssm`` (SSD) blocks on a mesh against the JAX package's.

The JAX side runs once per module in a subprocess with 8 fake devices:
``jax.jit`` of the reference's ``transformer.apply`` under the prefill ctx
and its ``make_serve_step`` under the decode ctx, on the same mesh shapes.
Its meshes are built with ``jax.sharding.Mesh`` directly: over all 8
devices, ``repro.launch.mesh.make_mesh`` goes through ``jax.make_mesh``,
whose Explicit axes ``with_sharding_constraint`` refuses.  The port runs
the same inputs as gloo processes, one per rank (``run_on_mesh(device=
"cpu")``), one spawn per mesh, while the subprocess runs; weights cross with
``convert``.  Rank bodies: ``tests/torch_mesh_ranks.py``.

The reduced recurrentgemma-9b (rec, rec, local, rec, rec; 4 heads of 16
channels) and mamba2-370m (4 ssm layers; ``in_proj`` 292 columns, 4 heads,
``d_inner`` 128, 160 conv channels) at B 4 x S 16, on (data 2, model 2),
where every ``rnn`` and ``heads`` dim splits, and on (data 1, model 8), the
divisibility fallbacks: recurrentgemma's heads whole with 8 channels a
rank; mamba2's ``in_proj`` and heads whole, ``norm_scale`` / ``out_proj``
split, 20 conv channels a rank.  Limit: ``LM_REL * max|x|``, the mesh
tests' (the packages sum over the model axis in other orders).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

LM_REL = 1e-5
FAMILIES = ("recurrentgemma-9b", "mamba2-370m")
MESHES = ((2, 2), (1, 8))
B, S, LONG_S, STEPS, PROMPT, NEW = 4, 16, 48, 4, 4, 6

_JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, reduced_config
from repro.launch.specs import make_ctx
from repro.models import model as jmodel, transformer

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for shape in inp["meshes"]:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    for arch, c in inp["families"].items():
        cfg = reduced_config(arch)
        params = jax.tree.map(jnp.asarray, c["params"])
        pctx = make_ctx(mesh, cfg, SHAPES["prefill_32k"])
        dctx = make_ctx(mesh, cfg, SHAPES["decode_32k"])
        fwd = jax.jit(lambda p, t: transformer.apply(p, cfg, pctx, {"tokens": t}))
        res = {key: np.asarray(fwd(params, jnp.asarray(c[key])))
               for key in ("tokens", "long_tokens") if c.get(key) is not None}
        serve = jax.jit(jmodel.make_serve_step(cfg, dctx, compute_dtype=jnp.float32))
        tokens = c["tokens"]
        cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1], jnp.float32)
        steps = []
        for pos in range(inp["steps"]):
            logits, cache = serve(params, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                                  jnp.int32(pos))
            steps.append(np.asarray(logits[:, 0]))
        res["decode"] = np.stack(steps, 1)
        res["cache"] = jax.tree.map(np.asarray, cache)
        out[(arch, tuple(shape))] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the same inputs and weights (drawn by the port from
    seeds): the JAX subprocess runs while the port's two meshes do."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    rng = np.random.default_rng(0)
    cases, jax_in = {}, {}
    for i, arch in enumerate(FAMILIES):
        cfg = reduced_config(arch)
        params = transformer.init_params(cfg, seed=10 + i, device="cpu")
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        # mamba2 at S 48 too: 96 rows a data rank outnumber in_proj's 64, so the
        # weight's block is gathered, where S 16 gathers the outputs
        long_tokens = (rng.integers(0, cfg.vocab_size, (B, LONG_S)).astype(np.int32)
                       if cfg.family == "ssm" else None)
        prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT))
        cases[arch] = dict(cfg=cfg, params=params, tokens=tokens, decode_steps=STEPS,
                           prompts=prompts, new_tokens=NEW, long_tokens=long_tokens)
        jax_in[arch] = dict(params=convert.lm_params_to_arrays(params, cfg), tokens=tokens,
                            long_tokens=long_tokens)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(meshes=MESHES, families=jax_in, steps=STEPS), f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    port = {}
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            for shape in MESHES:
                mine = cases if shape == (2, 2) else {  # greedy serving on (2, 2) only
                    a: dict(c, prompts=None, new_tokens=0) for a, c in cases.items()}
                res = tmesh.run_on_mesh(ranks.families_body, shape, ("data", "model"),
                                        device="cpu", args=(mine,), timeout_s=600)
                for arch in FAMILIES:
                    port[(arch, shape)] = [r[arch] for r in res]
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return dict(jax=want, port=port, cases=cases)


def _close(got, want, rel=LM_REL):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


CELLS = [(a, m) for m in MESHES for a in FAMILIES]
IDS = [f"{a.split('-')[0]}-{m[0]}x{m[1]}" for a, m in CELLS]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_prefill_on_mesh_matches_jax(runs, cell):
    """The forward under the prefill rules: every rank's gathered logits."""
    want = runs["jax"][cell]
    for rank in runs["port"][cell]:
        _close(rank["prefill"], want["tokens"])
        if "long_tokens" in want:
            _close(rank["prefill_long"], want["long_tokens"])


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_decode_steps_on_mesh_match_jax(runs, cell):
    """Four steps of ``make_serve_step(cfg, dctx)`` on the mesh's cache."""
    want = runs["jax"][cell]
    for rank in runs["port"][cell]:
        _close(rank["decode"], want["decode"])


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_cache_after_decode_matches_jax_in_its_layout(runs, cell):
    """The cache after the steps, gathered, against JAX's (whose conv tail is laid
    out by ``cache_axes``, as the port's is); each leaf kept its spec and block
    shape from step to step."""
    cfg = runs["cases"][cell[0]]["cfg"]
    want = {path: t.numpy() for path, t in tree_paths(
        convert.lm_params_from_arrays(runs["jax"][cell]["cache"], cfg, device="cpu"))}
    for rank in runs["port"][cell]:
        assert rank["cache_layout_kept"]
        assert rank["cache"].keys() == want.keys()
        for path in want:
            _close(rank["cache"][path], want[path])


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_serving_on_mesh_equals_one_process(runs, arch):
    c = runs["cases"][arch]
    want = generate(c["cfg"], c["params"], c["prompts"], NEW, device="cpu")
    for rank in runs["port"][(arch, (2, 2))]:
        np.testing.assert_array_equal(rank["seqs"], want)


def test_layouts_on_both_meshes():
    """The rule table's layouts, and the fallbacks on (1, 8), from the specs alone."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import make_ctx
    from repro_torch.sharding.rules import MeshCtx, spec_tree

    def specs(arch, shape):
        cfg = reduced_config(arch)
        ctx = make_ctx(MeshCtx.of(dict(zip(("data", "model"), shape))), cfg,
                       SHAPES["decode_32k"])
        whole = transformer.init_params(cfg, seed=0, device="cpu")
        cache = transformer.init_cache(cfg, B, S, device="cpu")
        return (spec_tree(ctx, whole, transformer.param_axes(cfg))["layers"][0]["mix"],
                spec_tree(ctx, cache, transformer.cache_axes(cfg))["layers"][0])

    rec, rc = specs("recurrentgemma-9b", (2, 2))
    assert rec["w_r"] == ("model", None, None) and rec["w_in_x"] == (None, "model")
    assert rc == {"h": ("data", "model"), "conv": ("data", None, "model")}
    rec, rc = specs("recurrentgemma-9b", (1, 8))  # 4 heads on 8 ranks: whole; 8 channels a rank
    assert rec["w_r"] == (None, None, None) and rec["lam"] == ("model",)
    assert rc["h"] == ("data", "model")
    ssm, sc = specs("mamba2-370m", (2, 2))
    assert ssm["in_proj"] == (None, "model") and ssm["a_log"] == ("model",)
    assert sc == {"h": ("data", "model", None, None), "conv": ("data", None, "model")}
    ssm, sc = specs("mamba2-370m", (1, 8))  # 292 columns and 4 heads whole, d_inner split
    assert ssm["in_proj"] == (None, None) and ssm["a_log"] == (None,)
    assert ssm["norm_scale"] == ("model",) and ssm["out_proj"] == ("model", None)
    assert sc == {"h": ("data", None, None, None), "conv": ("data", None, "model")}


def test_ssd_decode_step_collectives_are_the_design(runs):
    """One mamba2 decode step on (2, 2), per rank: each ssm layer makes its whole
    projection and conv tail in one ``all_gather`` of the rank's 146 output
    columns and 3 x 80 tail channels (2 rows: 386 floats a row; no weight is
    gathered), then sums the norm's squares and ``out_proj``'s partials; one
    more ``all_reduce`` is the vocab-parallel lookup."""
    L = reduced_config("mamba2-370m").num_layers
    for rank in runs["port"][("mamba2-370m", (2, 2))]:
        assert rank["step_counts"] == {
            "all_gather": {"calls": L, "bytes": L * 2 * (146 + 3 * 80) * 4},
            "all_reduce": {"calls": 2 * L + 1, "bytes": L * (2 * 4 + 2 * 64 * 4) + 2 * 64 * 4}}


def test_ssd_prefill_gathers_the_smaller_of_outputs_and_weight(runs):
    """S 16: 2 x 16 rows a rank, fewer than in_proj's 64, so each layer gathers
    its [2, 16, 146] outputs; S 48: 96 rows, so it gathers the [64, 146]
    weight block instead.  On (1, 8) in_proj is whole: no gather."""
    L = reduced_config("mamba2-370m").num_layers
    for rank in runs["port"][("mamba2-370m", (2, 2))]:
        assert rank["prefill_counts"]["all_gather"] == {"calls": L, "bytes": L * 2 * 16 * 146 * 4}
        assert rank["prefill_long_counts"]["all_gather"] == {"calls": L,
                                                             "bytes": L * 64 * 146 * 4}
    for rank in runs["port"][("mamba2-370m", (1, 8))]:
        assert "all_gather" not in rank["prefill_counts"]
        assert "all_gather" not in rank["prefill_long_counts"]
