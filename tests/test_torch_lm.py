"""The port's dense-attention LMs against the JAX package's, at reduced size.

Parameters are drawn by the JAX package, given random biases and norm scales
(they start at 0 and 1, so a dropped bias or scale would pass on fresh
parameters), and carried across as numpy arrays with
``convert.lm_params_from_arrays``.  JAX runs its flash path on the CPU in
Pallas interpret mode, as ``tests/test_kernels.py`` does.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

DENSE_ARCHS = ["qwen2-0.5b", "qwen2-72b", "olmo-1b", "stablelm-1.6b", "hubert-xlarge", "paligemma-3b"]
# every fp32 logit within REL * max|logits| of the JAX package's
REL = 1e-5


def _randomize(tree, rng):
    """Random values for every bias and norm scale (0 and 1 at init)."""
    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        if name in ("b", "bias"):
            return (0.5 * rng.standard_normal(node.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.5 * rng.standard_normal(node.shape)).astype(np.float32)
        return node
    return visit(tree)


def _jax_params(cfg, seed=0):
    params, _ = jt.init_params(jax.random.key(seed), cfg)
    return _randomize(jax.tree.map(np.asarray, params), np.random.default_rng(seed + 100))


def _inputs(cfg, B, S, rng):
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _forward_pair(jcfg, cfg, tree, inputs, impl):
    want = np.asarray(jt.apply(jax.tree.map(jnp.asarray, tree), jcfg, None,
                               {k: jnp.asarray(v) for k, v in inputs.items()}, attn_impl=impl))
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    got = tt.apply(params, cfg, {k: torch.from_numpy(v) for k, v in inputs.items()}, attn_impl=impl)
    return got.numpy(), want


def _assert_logits_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("impl", ["flash", "chunked"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_jax(arch, impl):
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = _jax_params(jcfg)
    got, want = _forward_pair(jcfg, cfg, tree, _inputs(cfg, 2, 32, np.random.default_rng(1)), impl)
    _assert_logits_close(got, want)


def _local_configs():
    """qwen2-0.5b at reduced size with (attn, local) blocks and a window of 8;
    the JAX package's and the port's dataclass of the same fields."""
    kw = dict(block_pattern=("attn", "local"), window=8, num_layers=5)
    return (dataclasses.replace(reduced_config("qwen2-0.5b"), **kw),
            dataclasses.replace(jax_reduced_config("qwen2-0.5b"), **kw))


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_local_window_forward_matches_jax(impl):
    """Two periods of (attn, local) plus one tail layer: the banded local path."""
    cfg, jcfg = _local_configs()
    tree = _jax_params(jcfg, seed=2)
    assert len(tree["tail"]) == 1
    fa.launches = 0
    got, want = _forward_pair(jcfg, cfg, tree, _inputs(cfg, 2, 24, np.random.default_rng(3)), impl)
    assert fa.launches == 0
    _assert_logits_close(got, want)


def _jax_decode(jcfg, tree, tokens, cache_dtype):
    """Per-step logits of the JAX serve step fed ``tokens`` one by one."""
    B, S = tokens.shape
    params = jax.tree.map(jnp.asarray, tree)
    cache = jt.init_cache(jcfg, B, S, cache_dtype)
    serve = jax.jit(jmodel.make_serve_step(jcfg, None, compute_dtype=jnp.float32))
    out = []
    for pos in range(S):
        logits, cache = serve(params, cache, jnp.asarray(tokens[:, pos:pos + 1]), jnp.int32(pos))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1)


@pytest.mark.parametrize("local", [False, True])
def test_decode_step_matches_jax_and_the_forward(local):
    """Per-step logits equal the JAX serve step's and the port's own forward
    (the ring buffer of a local layer included)."""
    cfg, jcfg = _local_configs() if local else (reduced_config("qwen2-0.5b"),
                                                 jax_reduced_config("qwen2-0.5b"))
    tree = _jax_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    B, S = 2, 20
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = _jax_decode(jcfg, tree, tokens, jnp.float32)
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    cache = tt.init_cache(cfg, B, S, torch.float32, device="cpu")
    if local:
        assert [c["k"].shape[1] for c in cache["layers"]] == [S, 8, S, 8, S]
    serve = tmodel.make_serve_step(cfg, compute_dtype=torch.float32)
    steps = []
    for pos in range(S):
        logits, cache = serve(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
        steps.append(logits[:, 0].numpy())
    got = np.stack(steps, 1)
    _assert_logits_close(got, want)
    full = tt.apply(params, cfg, {"tokens": torch.from_numpy(tokens)}, attn_impl="flash").numpy()
    _assert_logits_close(got, full)


def test_int8_cache_decode_matches_jax():
    """int8 KV cache with bf16 scales: both packages quantise the same fp32
    keys (round half to even) and round q and p to bf16; the limit is the
    bf16 rounding of q and p, 2^-7 of max|logits|."""
    cfg, jcfg = reduced_config("qwen2-0.5b"), jax_reduced_config("qwen2-0.5b")
    tree = _jax_params(jcfg, seed=6)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = _jax_decode(jcfg, tree, tokens, jnp.int8)
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    cache = tt.init_cache(cfg, 2, 12, torch.int8, device="cpu")
    assert cache["layers"][0]["k_scale"].dtype == torch.bfloat16
    steps = []
    for pos in range(12):
        logits, cache = tt.decode_step(params, cfg, cache, torch.from_numpy(tokens[:, pos:pos + 1]).long(), pos)
        steps.append(logits[:, 0].numpy())
    got = np.stack(steps, 1)
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def test_generate_matches_jax():
    """Greedy tokens equal the JAX package's; the logits of every step are
    within REL; each greedy step's top-2 margin exceeds 100x that limit, so
    no token is decided by a near tie."""
    cfg, jcfg = reduced_config("qwen2-0.5b"), jax_reduced_config("qwen2-0.5b")
    tree = _jax_params(jcfg, seed=8)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    gen = 10
    want = jserve.generate(jcfg, jax.tree.map(jnp.asarray, tree), prompts, gen)
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    got, logits = tserve.generate(cfg, params, prompts, gen, device="cpu", return_logits=True)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 6 + gen)
    want_logits = _jax_decode(jcfg, tree, want[:, :-1], jnp.float32)
    logits = logits.numpy()
    _assert_logits_close(logits, want_logits)
    top2 = np.sort(logits[:, prompts.shape[1] - 1:], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 100 * REL * np.abs(logits).max()


def test_serve_step_casts_the_parameters_once(monkeypatch):
    """A bf16 serve step casts the tree on its first step and reuses the cast
    after; its logits equal decode_step on a tree cast by hand, and a new
    tree is cast anew."""
    cfg = reduced_config("qwen2-0.5b")
    params = tt.init_params(cfg, seed=0, device="cpu")
    casts = []
    cast = tmodel.cast_params
    monkeypatch.setattr(tmodel, "cast_params", lambda p, dt: casts.append(dt) or cast(p, dt))
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 3))
    tserve.generate(cfg, params, prompts, 4, dtype=torch.bfloat16, device="cpu")
    assert casts == [torch.bfloat16]

    serve = tmodel.make_serve_step(cfg, compute_dtype=torch.bfloat16)
    cache = tt.init_cache(cfg, 2, 2, torch.bfloat16, device="cpu")
    ref = tt.init_cache(cfg, 2, 2, torch.bfloat16, device="cpu")
    tok = torch.from_numpy(prompts[:, :1])
    by_hand = cast(params, torch.bfloat16)
    for pos in range(2):
        got, cache = serve(params, cache, tok, pos)
        want, ref = tt.decode_step(by_hand, cfg, ref, tok, pos)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    serve(dict(params), cache, tok, 1)
    assert len(casts) == 3


def test_generate_cli_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen2-0.5b", "--reduced", "--batch", "2", "--prompt-len", "3",
                 "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 7)" in out and "device=cpu" in out


def test_convert_round_trip_is_exact():
    cfg, jcfg = _local_configs()
    tree = _jax_params(jcfg, seed=10)
    params = convert.lm_params_from_arrays(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    back = convert.lm_params_to_arrays(params, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    again = convert.lm_params_from_arrays(back, cfg, device="cpu")
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params), strict=True):
        assert torch.equal(a, b)


def test_init_params_shapes_match_jax():
    """Same tree, shapes and zero/one initialisations as the JAX package."""
    for arch in DENSE_ARCHS:
        cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
        tree = jax.tree.map(np.asarray, jt.init_params(jax.random.key(0), jcfg)[0])
        params = tt.init_params(cfg, seed=0, device="cpu")
        mine = convert.lm_params_to_arrays(params, cfg)
        assert jax.tree.structure(mine) == jax.tree.structure(tree), arch
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mine), jax.tree.leaves(tree),
                                strict=True):
            assert a.shape == b.shape, (arch, path)
            name = jax.tree_util.keystr(path)
            if name.endswith("['b']") or name.endswith("['bias']"):
                assert not a.any()
            elif name.endswith("['scale']"):
                assert (a == 1).all()
            else:  # the normal draws have the JAX package's scale
                assert abs(a.std() / b.std() - 1) < 0.2, (arch, name)


def test_init_params_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    cfg = reduced_config("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_cache(cfg, 1, 4)
    with pytest.raises(ValueError):
        tt.init_params(cfg, device="cpu")  # neither a seed nor a generator


@pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) - set(DENSE_ARCHS)))
def test_moe_hybrid_and_ssm_archs_are_not_ported_yet(arch):
    cfg = reduced_config(arch)
    assert cfg.is_moe or set(cfg.block_pattern) - {"attn", "local"}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        tt.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        tt.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        tt.apply({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_full_size_configs_equal_the_jax_package():
    from repro.configs import get_config as jax_get_config

    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    # the analytic count: matrices and the tied table (biases and norm scales add 71,552)
    assert get_config("qwen2-0.5b").param_count() == 493_961_216
