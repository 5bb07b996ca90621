"""The five architectures the mesh tests did not hold yet, on a mesh against the JAX package.

hubert-xlarge (an encoder over audio frames), paligemma-3b (a vision prefix
before the tokens, one kv head), stablelm-1.6b (layernorm, partial rotary),
qwen2-72b (GQA, qkv bias) and kimi-k2-1t-a32b (the MoE: 8 experts top 2
reduced) at their reduced configs on (data 2, model 2): the forward under
the prefill rules and, for the decoders, three decode steps under the
decode rules (``make_serve_step(cfg, ctx)``, after ``reshard_state``, on a
zero fp32 cache).  The JAX side runs once in a subprocess with 8 fake
devices, ``jax.jit`` of the reference on a mesh built with
``jax.sharding.Mesh`` (as ``tests/test_torch_mesh_families.py`` does); the
port as gloo processes, one per rank.  The dry run runs every architecture
on the production meshes (``tests/test_torch_dryrun_sweep.py``); these
cases hold the values.  Limit: ``LM_REL * max|x|``, the mesh tests'.
Rank bodies: ``tests/torch_mesh_ranks.py``.
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
from repro_torch.models import transformer  # noqa: E402

LM_REL = 1e-5
ARCHS = ("hubert-xlarge", "paligemma-3b", "stablelm-1.6b", "qwen2-72b", "kimi-k2-1t-a32b")
MESH = (2, 2)
B, S, STEPS = 4, 16, 3

_JAX_SCRIPT = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, reduced_config
from repro.launch.specs import make_ctx
from repro.models import model as jmodel, transformer

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
shape = inp["mesh"]
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))
out = {}
for arch, c in inp["archs"].items():
    cfg = reduced_config(arch)
    params = jax.tree.map(jnp.asarray, c["params"])
    pctx = make_ctx(mesh, cfg, SHAPES["prefill_32k"])
    fwd = jax.jit(lambda p, x: transformer.apply(p, cfg, pctx, x))
    res = {"prefill": np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in c["inputs"].items()}))}
    if c["tokens"] is not None:
        dctx = make_ctx(mesh, cfg, SHAPES["decode_32k"])
        serve = jax.jit(jmodel.make_serve_step(cfg, dctx, compute_dtype=jnp.float32))
        tokens = c["tokens"]
        cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1], jnp.float32)
        steps = []
        for pos in range(tokens.shape[1]):
            logits, cache = serve(params, cache, jnp.asarray(tokens[:, pos:pos + 1]),
                                  jnp.int32(pos))
            steps.append(np.asarray(logits[:, 0]))
        res["decode"] = np.stack(steps, 1)
    out[arch] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _inputs(cfg, rng) -> dict:
    """The forward's inputs, as ``launch/specs.py`` shapes them."""
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(
                    np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(
                    np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_archs")
    rng = np.random.default_rng(0)
    cases, jax_in = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = reduced_config(arch)
        params = transformer.init_params(cfg, seed=40 + i, device="cpu")
        tokens = (None if cfg.kind == "encoder"
                  else rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32))
        inputs = _inputs(cfg, rng)
        cases[arch] = dict(cfg=cfg, params=params, inputs=inputs, tokens=tokens)
        jax_in[arch] = dict(params=convert.lm_params_to_arrays(params, cfg), inputs=inputs,
                            tokens=tokens)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(mesh=MESH, archs=jax_in), f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    with subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
                           str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True) as proc:
        try:
            port = tmesh.run_on_mesh(ranks.archs_body, MESH, ("data", "model"), device="cpu",
                                     args=(cases,), timeout_s=600)
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    return dict(jax=want, port=port)


def _close(got, want, rel=LM_REL):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_mesh_matches_jax(runs, arch):
    for rank in runs["port"]:
        _close(rank[arch]["prefill"], runs["jax"][arch]["prefill"])


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_decode_steps_on_mesh_match_jax(runs, arch):
    for rank in runs["port"]:
        _close(rank[arch]["decode"], runs["jax"][arch]["decode"])
