"""``long_500k`` on a mesh: the sequence-sharded KV cache against the JAX package's.

Under ``make_ctx(mesh, cfg, SHAPES["long_500k"])`` (B 1, the batch
replicated by the divisibility fallback) the KV cache's sequence dim is
sharded over ``data`` (``seq_kv -> data``): recurrentgemma's ``local`` ring
buffer of ``window`` slots is cut into ``window / data`` slots a data rank,
and its head_dim over ``model`` (one kv head).  The decode step reads the
window gathered and writes the new row only on the ranks whose block holds
its slot.  mamba2 has no KV cache; its state follows the decode rules with
its one row replicated.

The JAX side runs once per module in a subprocess with 8 fake devices:
``jax.jit(make_serve_step(cfg, ctx))`` on meshes built with
``jax.sharding.Mesh`` (as ``tests/test_torch_mesh_families.py`` does), the
port as gloo processes, one per rank (``run_on_mesh(device="cpu")``), one
spawn per mesh.  Reduced recurrentgemma-9b (window 16, 1 kv head, head_dim
16) and mamba2-370m on (data 2, model 2) and (data 4, model 2): 8 and 4
ring slots a data rank.  Each family decodes, for an fp32 and an int8
cache: 40 steps from position 0 (the ring wraps twice, every boundary
between data ranks is crossed), and 8 steps from position 524,270 (slots
14, 15, 0, ...: across the wrap) from a cache drawn with numpy from a seed,
so rope runs at the cell's positions.  Limits: ``LM_REL * max|x|``, the
mesh tests', on the logits and on every cache leaf in its own layout; an
int8 cache's codes may differ by one where the packages' products round
to the other side of a half, and its bf16 leaves by one bf16 rounding.
Rank bodies: ``tests/torch_mesh_ranks.py``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import SHAPES, reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402

LM_REL = 1e-5
BF16_ULP = 2.0 ** -8  # one bf16 rounding, relative
FAMILIES = ("recurrentgemma-9b", "mamba2-370m")
MESHES = ((2, 2), (4, 2))
LONG = SHAPES["long_500k"]
WRAP_STEPS, LATE_POS, LATE_STEPS = 40, 524_270, 8
RUNS = [(dtype, start) for dtype in ("fp32", "int8") for start in ("zero", "late")]

_JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, reduced_config
from repro.launch.specs import make_ctx
from repro.models import model as jmodel, transformer

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
long = SHAPES["long_500k"]
out = {}
for shape in inp["meshes"]:
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    for arch, c in inp["families"].items():
        cfg = reduced_config(arch)
        params = jax.tree.map(jnp.asarray, c["params"])
        ctx = make_ctx(mesh, cfg, long)
        serve = jax.jit(jmodel.make_serve_step(cfg, ctx, compute_dtype=jnp.float32))
        for key, run in c["runs"].items():
            dt = jnp.int8 if run["int8"] else jnp.float32
            like = transformer.init_cache(cfg, 1, long.seq_len, dt)
            cache = like if run["cache"] is None else jax.tree.map(
                lambda a, l: jnp.asarray(a).astype(l.dtype), run["cache"], like)
            steps = []
            for i in range(run["tokens"].shape[1]):
                logits, cache = serve(params, cache, jnp.asarray(run["tokens"][:, i:i + 1]),
                                      jnp.int32(run["pos0"] + i))
                steps.append(np.asarray(logits[:, 0], np.float32))
            out[(arch, tuple(shape), key)] = dict(
                decode=np.stack(steps, 1), cache=jax.tree.map(lambda a: np.asarray(a), cache))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _draw_cache(cfg, int8: bool, rng) -> dict:
    """A whole cache of the cell's length (the port's tree, numpy leaves in the
    leaf's values: bf16 rounded, int8 codes, positive scales)."""
    like = transformer.init_cache(cfg, 1, LONG.seq_len, torch.int8 if int8 else torch.float32,
                                  device="cpu")

    def draw(path_leaf):
        path, t = path_leaf
        if t.dtype == torch.int8:
            return rng.integers(-127, 128, t.shape).astype(np.int8)
        if path.endswith("_scale"):
            x = rng.uniform(0.02, 0.2, t.shape)
        else:
            x = 0.5 * rng.standard_normal(t.shape)
        return torch.from_numpy(x).to(t.dtype).float().numpy()

    return _unflat(like, {p: draw((p, t)) for p, t in tree_paths(like)})


def _unflat(like, by_path, prefix=""):
    if isinstance(like, dict):
        return {k: _unflat(v, by_path, f"{prefix}/{k}" if prefix else k) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflat(v, by_path, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(like)]
    return by_path[prefix]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on the same weights, caches and tokens (drawn by the port
    from seeds): the JAX subprocess runs while the port's two meshes do."""
    tmp = tmp_path_factory.mktemp("mesh_long")
    rng = np.random.default_rng(0)
    cases, jax_in = {}, {}
    for i, arch in enumerate(FAMILIES):
        cfg = reduced_config(arch)
        params = transformer.init_params(cfg, seed=20 + i, device="cpu")
        fam_runs, jax_runs = {}, {}
        for dtype, start in RUNS:
            int8 = dtype == "int8"
            late = start == "late"
            steps = LATE_STEPS if late else WRAP_STEPS
            cache = _draw_cache(cfg, int8, rng) if late else None
            tokens = rng.integers(0, cfg.vocab_size, (1, steps)).astype(np.int32)
            run = dict(int8=int8, cache=cache, pos0=LATE_POS if late else 0, tokens=tokens)
            fam_runs[(dtype, start)] = run
            jax_runs[(dtype, start)] = dict(
                run, cache=None if cache is None else convert.lm_params_to_arrays(
                    tree_map(torch.from_numpy, cache), cfg))
        cases[arch] = dict(cfg=cfg, params=params, runs=fam_runs)
        jax_in[arch] = dict(params=convert.lm_params_to_arrays(params, cfg), runs=jax_runs)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(meshes=MESHES, families=jax_in), f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    port = {}
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            for shape in MESHES:
                res = tmesh.run_on_mesh(ranks.long_families_body, shape, ("data", "model"),
                                        device="cpu", args=(cases,), timeout_s=600)
                for arch in FAMILIES:
                    for key in RUNS:
                        port[(arch, shape, key)] = [dict(r[arch]["runs"][key],
                                                         coord=r[arch]["coord"]) for r in res]
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return dict(jax=want, port=port, cases=cases)


def _close(got, want, rel=LM_REL, extra=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    limit = rel * np.abs(want).max() + extra * np.abs(want)
    excess = (np.abs(got - want) - limit).max()
    assert excess <= 0, (excess, np.abs(want).max())


CELLS = [(a, m, r) for m in MESHES for a in FAMILIES for r in RUNS]
IDS = [f"{a.split('-')[0]}-{m[0]}x{m[1]}-{r[0]}-{r[1]}" for a, m, r in CELLS]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_long_decode_matches_jax(runs, cell):
    """Every step's logits, gathered on every rank."""
    want = runs["jax"][cell]["decode"]
    for rank in runs["port"][cell]:
        _close(rank["decode"], want)


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_long_cache_matches_jax_in_its_layout(runs, cell):
    """The cache after the steps, gathered, against JAX's; each leaf kept its
    spec and block shape, and the ring buffer is laid out over ``data``."""
    arch, _, (dtype, _) = cell
    cfg = runs["cases"][arch]["cfg"]
    want = {path: t.float().numpy() for path, t in tree_paths(
        convert.lm_params_from_arrays(runs["jax"][cell]["cache"], cfg, device="cpu"))}
    kinds = transformer.layer_kinds(cfg)
    for rank in runs["port"][cell]:
        assert rank["layout_kept"]
        assert rank["cache"].keys() == want.keys()
        for path, spec in rank["cache_specs"].items():
            layer, name = path.split("/")[1:]
            if kinds[int(layer)] == "local":
                assert spec[:2] == (None, "data"), (path, spec)
        for path in want:
            leaf = want[path]
            if dtype == "int8" and path.endswith(("/k", "/v")):  # int8 codes: within one
                assert np.abs(rank["cache"][path] - leaf).max() <= 1, path
            elif dtype == "int8":  # bf16 scales and states: one bf16 rounding more
                _close(rank["cache"][path], leaf, extra=BF16_ULP)
            else:
                _close(rank["cache"][path], leaf)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m[0]}x{m[1]}" for m in MESHES])
@pytest.mark.parametrize("run", RUNS, ids=[f"{d}-{s}" for d, s in RUNS])
def test_write_back_touches_only_the_owning_block(runs, shape, run):
    """On the first step, each attention leaf's block changed only on the data
    ranks that own the slot, and there only at its local row."""
    pos0 = runs["cases"]["recurrentgemma-9b"]["runs"][run]["pos0"]
    cfg = runs["cases"]["recurrentgemma-9b"]["cfg"]
    w_l = cfg.window // shape[0]
    slot = pos0 % cfg.window
    owner = slot // w_l
    seen = set()
    for rank in runs["port"][("recurrentgemma-9b", shape, run)]:
        assert rank["touched"], "the family has a local layer"
        for leaf, rows in rank["touched"].items():
            if rank["coord"]["data"] == owner:
                assert rows == [slot % w_l], (leaf, rows)
                seen.add(rank["coord"]["model"])
            else:
                assert rows == [], (leaf, rank["coord"], rows)
    assert seen == set(range(shape[1]))  # every model rank wrote its head_dim cut


def test_long_layouts_from_the_specs():
    """The rules alone: B 1 replicated, the ring over data and head_dim over model;
    mamba2's state as under decode_32k with its one row whole."""
    from repro_torch.launch.specs import make_ctx
    from repro_torch.sharding.rules import MeshCtx, spec_tree

    def cache_specs(arch, shape):
        cfg = reduced_config(arch)
        ctx = make_ctx(MeshCtx.of(dict(zip(("data", "model"), shape))), cfg, LONG)
        cache = transformer.init_cache(cfg, 1, LONG.seq_len, device="cpu")
        return spec_tree(ctx, cache, transformer.cache_axes(cfg))["layers"]

    for shape in MESHES:
        rg = cache_specs("recurrentgemma-9b", shape)
        assert rg[2] == {"k": (None, "data", None, "model"), "v": (None, "data", None, "model")}
        assert rg[0] == {"h": (None, "model"), "conv": (None, None, "model")}
        ssm = cache_specs("mamba2-370m", shape)[0]
        assert ssm == {"h": (None, "model", None, None), "conv": (None, None, "model")}
