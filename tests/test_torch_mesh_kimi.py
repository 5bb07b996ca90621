"""The MoE models served in bf16 on a mesh against the JAX package's bf16 serve step.

The reference serves in bf16 (``make_serve_step``'s ``compute_dtype``
defaults to ``jnp.bfloat16``); the mesh tests before held fp32 only.  Here
reduced kimi-k2-1t-a32b (8 experts top 2, head_dim 8) and qwen3-moe-235b-a22b
run on (data 2, model 2): the forward under the prefill rules on bf16
parameters, and three decode steps under the decode rules
(``make_serve_step(cfg, dctx, compute_dtype=bf16)``, token dispatch) on a
bf16 cache.  Each rank draws its parameters in bf16 straight into its
blocks (``init_params(..., dtype=bf16, keep=keep_blocks(ctx, axes))``),
under each rule table in turn, as the card's four ranks do at full width.
The JAX side runs once in a subprocess with 8 fake devices, ``jax.jit``
of the reference on a mesh built with ``jax.sharding.Mesh``, on the fp32
draw cast to bf16 (the same bits: cast and cut commute).  Rank bodies:
``tests/torch_mesh_ranks.py``.

Limit: ``BF16_REL * max|x|`` at every position compared.  Both packages
round every product and every sum to bf16 (a relative step of 2^-8 at
most), but in other orders: the model axis's partial sums, XLA's fusions
(which keep fp32 between the ops of one fusion) against the port's
op-by-op roundings.  Each of the few layers adds a few such roundings of
values up to max|x|: 2^-8 for each of 8 roundings, 2^-5 of max|x|.  (The
fp32 mesh tests hold 1e-5.)  Where a router's k-th and (k+1)-th
probabilities lie a few bf16 steps apart, the two packages may pick
different experts, and the output moves by a whole expert's share.  Both
sides return the experts each device routed every token to in every MoE
layer (the JAX side through a callback in ``_moe_local``, on the
unrolled step, which is the same math), and a position is left out only
where the sets differ; so are the later positions of its row where the
layer is not the last, since later layers read it through attention (in
decode, the row's later steps through the cache).  At least
``MIN_COMPARED_SHARE`` of the positions (steps) stay compared: B 64 x S
16 keeps 868 and 871 of 1024 prefill positions and 179 and 186 of 192
decode steps, whose errors reach 0.013 of max|x| against 0.15-0.41 at the
positions left out.
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

BF16_REL = 8 * 2.0**-8
MIN_COMPARED_SHARE = 0.75
ARCHS = ("kimi-k2-1t-a32b", "qwen3-moe-235b-a22b")
MESH = (2, 2)
B, S, STEPS = 64, 16, 3

_JAX_SCRIPT = r"""
import functools, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, reduced_config
from repro.launch.specs import make_ctx
from repro.models import model as jmodel, moe as jmoe, transformer

assert jax.device_count() == 8
inp = pickle.load(open(sys.argv[1], "rb"))
shape = inp["mesh"]
mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), ("data", "model"))

# each device's routing in every MoE layer, sent out by a callback: the top-k
# of the probabilities _moe_local computes from the same operands (XLA
# computes the two as one); the layer is counted as the unrolled step traces
routes, where = {}, {}
moe_local = jmoe._moe_local


def record(run, layer, eidx, d, m):
    routes[(run, layer, int(d), int(m))] = np.asarray(eidx)


def recording(x, router, *args, top_k, **kw):
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xf @ router.astype(xf.dtype)).astype(jnp.float32), axis=-1)
    layer, where["layer"] = where["layer"], where["layer"] + 1
    jax.debug.callback(lambda e, d, m: record(where["run"], layer, e, d, m),
                       jax.lax.top_k(probs, top_k)[1], jax.lax.axis_index("data"),
                       jax.lax.axis_index("model"))
    return moe_local(x, router, *args, top_k=top_k, **kw)


jmoe._moe_local = recording
out = {}
for arch, c in inp["archs"].items():
    cfg = reduced_config(arch)
    routes.clear()
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), c["params"])
    pctx = make_ctx(mesh, cfg, SHAPES["prefill_32k"])
    fwd = jax.jit(lambda p, t: transformer.apply(p, cfg, pctx, {"tokens": t}, unroll=True))
    where.update(run="prefill", layer=0)
    res = {"prefill": np.asarray(fwd(params, jnp.asarray(c["inputs"])).astype(jnp.float32))}
    jax.effects_barrier()
    dctx = make_ctx(mesh, cfg, SHAPES["decode_32k"])
    serve = jax.jit(jmodel.make_serve_step(cfg, dctx, compute_dtype=jnp.bfloat16, unroll=True))
    tokens = c["tokens"]
    cache = transformer.init_cache(cfg, tokens.shape[0], tokens.shape[1], jnp.bfloat16)
    steps = []
    for pos in range(tokens.shape[1]):
        where.update(run=pos, layer=0)  # a call may trace the step again
        logits, cache = serve(params, cache, jnp.asarray(tokens[:, pos:pos + 1]), jnp.int32(pos))
        steps.append(np.asarray(logits[:, 0].astype(jnp.float32)))
        jax.effects_barrier()
    res["decode"] = np.stack(steps, 1)
    res["routes"] = dict(routes)
    out[arch] = res
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_kimi")
    rng = np.random.default_rng(0)
    cases, jax_in = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = reduced_config(arch)
        seed = 60 + i
        params = transformer.init_params(cfg, seed=seed, device="cpu")  # fp32, whole
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tokens = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
        cases[arch] = dict(cfg=cfg, seed=seed, inputs=inputs, tokens=tokens)
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
            port = tmesh.run_on_mesh(ranks.bf16_serve_body, MESH, ("data", "model"),
                                     device="cpu", args=(cases,), timeout_s=600)
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    rerouted = {arch: _rerouted(cases[arch]["cfg"], want[arch]["routes"], port, arch)
                for arch in ARCHS}
    return dict(jax=want, port=port, rerouted=rerouted)


def _rerouted(cfg, jax_routes, port, arch) -> dict:
    """``{"prefill": [B, S], "decode": [B, STEPS]}`` bool: the positions (steps)
    where some rank's set of experts in some MoE layer differs from the JAX
    run's on the same device, and, for a layer before the last, every later
    position (step) of the row, which reads it through attention (in decode,
    through the next layers' cache)."""
    n_moe = sum(1 for k in transformer.layer_kinds(cfg) if k in ("attn", "local"))
    last_moe = transformer.layer_kinds(cfg)[-1] in ("attn", "local")
    B_l = B // MESH[0]
    early = {"prefill": np.zeros((B, S), bool), "decode": np.zeros((B, STEPS), bool)}
    last = {k: np.zeros_like(v) for k, v in early.items()}
    for rank in port:
        d, m = rank["coord"]
        got = rank[arch]["routes"]
        for run, key, rows, col in (
                [("prefill", "prefill", slice(d * B_l, (d + 1) * B_l), slice(None))]
                + [("decode", t, slice(None), t) for t in range(STEPS)]):
            for layer in range(n_moe):
                mine = got[run][layer if run == "prefill" else key * n_moe + layer]
                theirs = jax_routes[(key, layer, d, m)]
                differ = (np.sort(mine, -1) != np.sort(theirs, -1)).any(-1)
                hit = last if last_moe and layer == n_moe - 1 else early
                hit[run][rows, col] |= differ.reshape(hit[run][rows, col].shape)
    return {k: np.maximum.accumulate(early[k], axis=1) | last[k] for k in early}


def _close(got, want, tied):
    """Within the limit at every position (step) not left out, of which there are
    :data:`MIN_COMPARED_SHARE` of all at least."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert tied.shape == got.shape[:2] and (~tied).mean() >= MIN_COMPARED_SHARE, tied
    err = np.abs(got - want).max(-1)[~tied].max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max(), tied.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_on_mesh_matches_jax(runs, arch):
    for rank in runs["port"]:
        assert rank[arch]["prefill_dtype"] == "torch.bfloat16"
        assert rank[arch]["param_dtypes"] == ["torch.bfloat16"]
        _close(rank[arch]["prefill"], runs["jax"][arch]["prefill"],
               runs["rerouted"][arch]["prefill"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_steps_on_mesh_match_jax(runs, arch):
    for rank in runs["port"]:
        assert rank[arch]["cache_dtype"] == "torch.bfloat16"
        _close(rank[arch]["decode"], runs["jax"][arch]["decode"], runs["rerouted"][arch]["decode"])
