"""The port's train step on a mesh against the JAX package's, on the CPU.

The JAX side runs once per module in a subprocess with 8 fake devices
(as tests/test_torch_mesh.py does): ``jax.jit`` of the reference's
``make_train_step(cfg, make_ctx(mesh, cfg, SHAPES["train_4k"]),
grad_reshard=...)`` with the state and batch placed by the train rules, and
the gradients of its loss.  The port runs the same state and batch as gloo
processes, one per rank (``run_on_mesh(device="cpu")``), one spawn per mesh
shape, while the subprocess runs; weights cross with ``convert``.

The recurrent families (reduced recurrentgemma-9b and mamba2-370m, the
latter also with ``d_model`` 16 so that its ``in_proj`` gathers the weight
rather than the outputs, and each with one head, the divisibility
fallbacks) take every check the attention cases take.

Limits, those of ``tests/test_torch_train.py``: the loss and the gradient
norm within ``LOSS_REL`` relative, each gradient leaf within ``GRAD_REL``
times its largest magnitude (bf16 parameters: plus one bf16 rounding of
each element).  The new state is held two ways.  The mesh's own update of
its gradients equals one process's update of the same gradients within
``STATE_REL`` times each leaf's largest magnitude.  Against the JAX
package's new state the moments are held to the gradients' limit (the first
step's moments are ``0.1 g`` and ``0.05 g^2``) and the parameters within
``2 * lr``: Adam's first step is about ``lr * sign(g)``, and a gradient that
is rounding noise, as a key bias's is (softmax ignores a shift of all of a
query's scores), moves its parameter by up to ``2 * lr`` either way.
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
import jax.numpy as jnp  # noqa: E402

import torch_mesh_train_ranks as ranks  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402
from torch_parity import randomize_lm  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 1e-4
STATE_REL = 1e-6
LR = 3e-4  # the step's peak rate, reached at once (warmup 0)
B, S = 4, 16

#: name -> (arch, mesh shape, axes, config changes, grad_accum, bf16 params, grad_reshard modes)
CASES = {
    "qwen2_2x2": ("qwen2-0.5b", (2, 2), ("data", "model"), {}, 1, False, (True, False)),
    "qwen2_fsdp4": ("qwen2-0.5b", (4,), ("data",), {}, 1, False, (True,)),
    "olmo_accum_remat": ("olmo-1b", (2, 2), ("data", "model"), {"remat": "full"}, 2, False,
                         (True, False)),
    "moe_ep": ("qwen3-moe-235b-a22b", (2, 2), ("data", "model"), {}, 1, False, (True, False)),
    "qwen2_bf16": ("qwen2-0.5b", (2, 2), ("data", "model"), {}, 1, True, (True,)),
    "rglru_2x2": ("recurrentgemma-9b", (2, 2), ("data", "model"), {}, 1, False, (True, False)),
    "ssd_2x2": ("mamba2-370m", (2, 2), ("data", "model"), {}, 1, False, (True, False)),
    # d_model 16: a data rank's 32 rows outnumber in_proj's 16, so the SSD
    # gathers the weight's column block, not its outputs
    "ssd_weight_gather": ("mamba2-370m", (2, 2), ("data", "model"), {"d_model": 16}, 1, False,
                          (True, False)),
    # one head: the divisibility fallbacks (heads whole, channels / d_inner split;
    # mamba2's 289 in_proj columns whole)
    "rglru_fallback": ("recurrentgemma-9b", (2, 2), ("data", "model"), {"num_heads": 1}, 1, False,
                       (True,)),
    "ssd_fallback": ("mamba2-370m", (2, 2), ("data", "model"), {"ssm_heads": 1}, 1, False,
                     (True,)),
    # one row a microbatch on two data ranks: the divisibility fallback replicates
    # it, every data rank computes it whole and no gradient is summed over data
    "qwen2_same_rows": ("qwen2-0.5b", (2, 2), ("data", "model"), {}, 4, False, (True,)),
}

_JAX_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import SHAPES, reduced_config
from repro.launch.mesh import make_mesh
from repro.launch.specs import abstract_state_and_shardings, make_ctx
from repro.models import model as jmodel
from repro.sharding.rules import logical_to_spec

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, c in inp.items():
    cfg = dataclasses.replace(reduced_config(c["arch"]), **c["changes"])
    mesh = make_mesh(c["shape"], c["axes"])
    ctx = make_ctx(mesh, cfg, SHAPES["train_4k"])
    pdt = jnp.bfloat16 if c["bf16"] else jnp.float32
    _, st_sh = abstract_state_and_shardings(ctx, cfg, param_dtype=pdt)
    tokens = c["batch"]["tokens"]
    b_sh = {"tokens": NamedSharding(mesh, logical_to_spec(ctx, tokens.shape, ("batch", "seq")))}
    state = jax.device_put(jax.tree.map(jnp.asarray, c["state"]), st_sh)
    batch = jax.device_put({"tokens": jnp.asarray(tokens)}, b_sh)
    res = {}
    for rs in c["modes"]:
        step = jax.jit(jmodel.make_train_step(cfg, ctx, compute_dtype=jnp.float32, warmup=0,
                                              grad_accum=c["grad_accum"], param_dtype=pdt,
                                              grad_reshard=rs),
                       in_shardings=(st_sh, b_sh), out_shardings=(st_sh, None))
        new, m = step(state, batch)
        res[rs] = dict(new=jax.tree.map(lambda a: np.asarray(a, np.float32), new),
                       loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    loss_fn = jmodel.make_loss_fn(cfg, ctx, compute_dtype=jnp.float32)
    micro = tokens.reshape(c["grad_accum"], -1, tokens.shape[1])
    mb_sh = {"tokens": NamedSharding(mesh, logical_to_spec(ctx, micro.shape[1:],
                                                           ("batch", "seq")))}
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), in_shardings=(st_sh["params"], mb_sh))
    grads, loss = None, 0.0
    for mb in micro:  # the reference's accumulation: fp32 sums in microbatch order, then a mean
        (l, _), g = vg(state["params"], {"tokens": jnp.asarray(mb)})
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g) if c["grad_accum"] > 1 else g
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
        loss = loss + l
    if c["grad_accum"] > 1:
        grads = jax.tree.map(lambda x: x / c["grad_accum"], grads)
    res["grads"] = jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    res["loss"] = float(loss / c["grad_accum"])
    out[name] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _jax_state(jcfg, seed: int, bf16: bool):
    """The JAX package's train state as numpy arrays, biases and scales random
    (``tests/test_torch_train.py``'s)."""
    pdt = jnp.bfloat16 if bf16 else jnp.float32
    tree = jax.tree.map(np.asarray, jmodel.init_train_state(jax.random.key(seed), jcfg,
                                                            param_dtype=pdt))
    rng = np.random.default_rng(seed + 100)
    if not bf16:
        tree["params"] = randomize_lm(tree["params"], rng)
    else:
        tree["opt"]["master"] = randomize_lm(tree["opt"]["master"], rng)
        tree["params"] = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                      tree["opt"]["master"])
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on every case: the JAX subprocess runs while the port's
    two spawns (the (2, 2) cases and the missing-backward step, then the
    (4,) case) do."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jax_in, port = {}, {}
    for i, (name, (arch, shape, axes, changes, accum, bf16, modes)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(reduced_config(arch), **changes)
        jcfg = dataclasses.replace(jax_reduced_config(arch), **changes)
        tree = _jax_state(jcfg, seed=i, bf16=bf16)
        batch = {"tokens": np.random.default_rng(10 + i).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)}
        jax_in[name] = dict(arch=arch, shape=shape, axes=axes, changes=changes,
                            grad_accum=accum, bf16=bf16, modes=modes, state=tree, batch=batch)
        port[name] = dict(cfg=cfg, state=convert.train_state_from_arrays(tree, cfg, device="cpu"),
                          batch=batch, grad_accum=accum, modes=modes,
                          remat_none=changes.get("remat") == "full")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(jax_in, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    neg = port["qwen2_2x2"]
    results = {}
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            for shape, axes in (((2, 2), ("data", "model")), ((4,), ("data",))):
                mine = {n: c for n, c in port.items() if CASES[n][1] == shape}
                negative = ((neg["cfg"], neg["state"], neg["batch"]) if shape == (2, 2)
                            else None)
                res = tmesh.run_on_mesh(ranks.body, shape, axes, device="cpu",
                                        args=(mine, negative), timeout_s=600)
                for n in mine:
                    results[n] = [r[n] for r in res]
                if negative is not None:
                    for key in ("missing_backward", "collectives"):
                        results[key] = [r[key] for r in res]
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return dict(jax=want, port=results, inputs=port)


def _rel(got, want) -> float:
    return abs(got - want) / abs(want)


def _within(got: dict, want: dict, rel: float, what: str, extra=None):
    """Every leaf of ``got`` within ``rel`` times the largest magnitude of the
    leaf in ``want`` (plus ``extra(want)`` elementwise)."""
    assert got.keys() == want.keys()
    for path in want:
        g, w = got[path], want[path]
        assert g.shape == w.shape and np.isfinite(g).all(), (what, path)
        bound = rel * np.abs(w).max() + (0.0 if extra is None else extra(w))
        assert (np.abs(g - w) <= bound).all(), (what, path, np.abs(g - w).max(),
                                                np.abs(w).max())


def _jax_tree(tree, cfg) -> dict:
    """A JAX parameter tree (numpy) as ``{port path: array}``."""
    return {p: t.float().numpy() for p, t in
            tree_paths(convert.lm_params_from_arrays(tree, cfg, device="cpu"))}


def _jax_state_paths(state, cfg) -> dict:
    return {p: t.float().numpy() for p, t in
            tree_paths(convert.train_state_from_arrays(state, cfg, device="cpu"))}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(runs, case):
    """The loss of the global batch and every gradient, gathered from the
    ranks' blocks, against the JAX package's on its mesh; each mode's."""
    cfg, want = runs["inputs"][case]["cfg"], runs["jax"][case]
    bf16 = CASES[case][5]
    grads = _jax_tree(want["grads"], cfg)
    for rank in runs["port"][case]:
        for rs in CASES[case][6]:
            got = rank[rs]
            assert _rel(got["loss"], want["loss"]) <= LOSS_REL
            assert _rel(got["loss"], want[rs]["loss"]) <= LOSS_REL
            assert _rel(got["grad_norm"], want[rs]["grad_norm"]) <= LOSS_REL
            _within(got["grads"], grads, GRAD_REL, "grads",
                    (lambda w: 2.0**-7 * np.abs(w)) if bf16 else None)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_update_equals_one_process_update(runs, case):
    """The mesh step's new state (clip over sharded blocks, AdamW on blocks)
    is one process's update of the same gradients, within ``STATE_REL``."""
    state = runs["inputs"][case]["state"]
    update = tmodel.make_update_fn(warmup=0)
    for rank in runs["port"][case]:
        for rs in CASES[case][6]:
            got = rank[rs]
            grads = _unflat(got["grads"], state["params"])
            want, metrics = update(state, grads)
            assert _rel(got["grad_norm"], float(metrics["grad_norm"])) <= STATE_REL
            _within(got["new"], {p: t.float().numpy() for p, t in tree_paths(want)},
                    STATE_REL, "update")
            assert got["step"] == 1


def _unflat(paths: dict, like) -> dict:
    """``{path: array}`` as tensors in ``like``'s tree, each in its leaf's type."""
    from repro_torch.tree import tree_unflatten

    return tree_unflatten(like, [torch.from_numpy(paths[p]).to(t.dtype)
                                 for p, t in tree_paths(like)])


@pytest.mark.parametrize("case", list(CASES))
def test_new_state_matches_jax(runs, case):
    """Against the JAX package's step: the moments within the gradients'
    limits, the parameters (the master copy, for bf16 weights) within
    ``2 * lr``, and bf16 weights the bf16 rounding of their master."""
    cfg, want = runs["inputs"][case]["cfg"], runs["jax"][case]
    bf16 = CASES[case][5]
    for rs in CASES[case][6]:
        ref = _jax_state_paths(want[rs]["new"], cfg)
        for rank in runs["port"][case]:
            got = rank[rs]["new"]
            assert got.keys() == ref.keys()
            for path in ref:
                g, w = got[path], ref[path]
                # bf16 gradients: one more rounding, 2^-7 of g and so 2^-6 of g^2
                if path.startswith("opt/mu"):
                    limit = GRAD_REL * np.abs(w).max() + (2.0**-7 * np.abs(w) if bf16 else 0)
                elif path.startswith("opt/nu"):
                    limit = 2 * GRAD_REL * np.abs(w).max() + (2.0**-6 * np.abs(w) if bf16 else 0)
                elif path.startswith(("opt/master", "params")) and not (
                        bf16 and path.startswith("params")):
                    limit = 2 * LR * (1 + 1e-3)
                else:
                    continue
                assert (np.abs(g - w) <= limit).all(), (case, rs, path, np.abs(g - w).max())
            if bf16:
                for path in (p for p in got if p.startswith("params/")):
                    master = torch.from_numpy(got["opt/master/" + path[len("params/"):]])
                    assert np.array_equal(got[path], master.to(torch.bfloat16).float().numpy())
                    assert rank[rs]["dtypes"][path[len("params/"):]] == "torch.bfloat16"


@pytest.mark.parametrize("case", list(CASES))
def test_every_block_is_the_same_on_the_ranks_that_hold_it(runs, case):
    """A replicated leaf's gradient (a bias on the data axis, a norm scale on
    the model axis) is the same bits on every rank that holds it."""
    res = runs["port"][case]
    for rs in CASES[case][6]:
        for path in res[0][rs]["blocks"]:
            assert ranks.replicated_blocks_agree(res, path, rs), (case, rs, path)
        for rank in res[1:]:
            assert rank[rs]["new"].keys() == res[0][rs]["new"].keys()
            assert all(np.array_equal(rank[rs]["new"][p], res[0][rs]["new"][p])
                       for p in rank[rs]["new"])


@pytest.mark.parametrize("case", [c for c in CASES if len(CASES[c][6]) == 2])
def test_reduce_scatter_and_all_reduce_give_the_same_bits(runs, case):
    """On (data 2, model 2) the FSDP reduction sums two partials either way:
    ``grad_reshard=True`` and ``False`` give the same gradients and state
    bit for bit, and their collectives differ as asked."""
    for rank in runs["port"][case]:
        t, f = rank[True], rank[False]
        assert t["loss"] == f["loss"] and t["grad_norm"] == f["grad_norm"]
        for key in ("grads", "new"):
            assert all(np.array_equal(t[key][p], f[key][p]) for p in t[key]), key
        assert t["counts"]["reduce_scatter"]["calls"] > 0
        assert "reduce_scatter" not in f["counts"]
        # the scatter's bytes move as all_reduce instead: the same payload, once per call
        assert (f["counts"]["all_reduce"]["bytes"] - t["counts"]["all_reduce"]["bytes"]
                == t["counts"]["reduce_scatter"]["bytes"])
        assert f["counts"]["all_gather"] == t["counts"]["all_gather"]


def test_pure_fsdp_reduces_with_reduce_scatter(runs):
    """On (data 4) every sharded leaf's gradient comes back by reduce_scatter,
    and the replicated biases by one all_reduce; no model-axis collective."""
    for rank in runs["port"]["qwen2_fsdp4"]:
        counts = rank[True]["counts"]
        assert counts["reduce_scatter"]["calls"] == counts["all_gather"]["calls"]
        assert counts["all_reduce"]["calls"] == 2  # the loss's sum, the biases' gradients


def test_remat_recomputes_the_periods_collectives(runs):
    """``remat="full"`` on the mesh: each period's gathers run again in the
    backward (more calls than ``"none"``), and the gradients are the same bits."""
    for rank in runs["port"]["olmo_accum_remat"]:
        full, none = rank[True], rank["remat_none"]
        assert full["counts"]["all_gather"]["calls"] > none["counts"]["all_gather"]["calls"]
        assert all(np.array_equal(full["grads"][p], none["grads"][p]) for p in full["grads"])


def test_a_gather_without_backward_raises(runs):
    """With the FSDP gather's output detached, its parameters get no gradient:
    the step raises on every rank instead of training them on zeros."""
    for rank in runs["port"]["missing_backward"]:
        assert rank["raised"] is not None
        assert "no gradient reaches" in rank["raised"] and "on the mesh" in rank["raised"]


def test_collectives_and_their_transposes(runs):
    """On (data 2, model 2), exact sums: psum_scatter is psum's block; a gather's
    backward sums the ranks' cotangents by reduce_scatter or by all_reduce as
    ``MeshCtx.fsdp_grad`` says; pbroadcast sums its cotangent, psum passes it."""
    for rank in runs["port"]["collectives"]:
        assert rank["scatter"] and rank["pbroadcast"] and rank["psum"]
        assert rank["gather/reduce_scatter"] and rank["gather/all_reduce"]
        assert rank["gather/reduce_scatter/kinds"] == ["all_gather", "reduce_scatter"]
        assert rank["gather/all_reduce/kinds"] == ["all_gather", "all_reduce"]


def test_unreached_leaves_are_the_audio_table_alone():
    """Only hubert's token table is outside the loss, on one device and a mesh."""
    from repro_torch.configs import ARCH_IDS

    assert {a: tmodel.unreached(reduced_config(a)) for a in ARCH_IDS
            if tmodel.unreached(reduced_config(a))} == {"hubert-xlarge":
                                                        frozenset({"embed/table"})}
