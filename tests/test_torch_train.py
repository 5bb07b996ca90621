"""The port's training path (loss, gradients, accumulation, mixed precision, the
train step) against the JAX package's, at reduced size.

The JAX package draws the train state; biases and norm scales get random
values (:func:`torch_parity.randomize_lm`), and the state crosses as numpy
arrays (``convert.train_state_from_arrays``).  Both packages differentiate
the same loss on the same batch in fp32: the loss agrees within
``LOSS_REL`` relative, and each gradient leaf within ``GRAD_REL`` times the
largest magnitude of that leaf (the packages sum in other orders).  A full
step's parameters are not held across packages elementwise: Adam's first
step is about ``lr * sign(g)``, so a gradient element near zero rounded
the other way moves its parameter by up to ``2 * lr``; the optimizer is held
on identical inputs in ``test_torch_optim.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, reduced_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402
from torch_parity import randomize_lm  # noqa: E402

ARCHS = list(ARCH_IDS)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
# a router's k-th and (k+1)-th probabilities closer than this share of the
# k-th may be ordered either way by fp32 rounding: no test input has one
NEAR_TIE_REL = 1e-4


def _configs(arch, **kw):
    cfg, jcfg = reduced_config(arch), jax_reduced_config(arch)
    return dataclasses.replace(cfg, **kw), dataclasses.replace(jcfg, **kw)


def _jax_state(jcfg, seed=0, param_dtype=jnp.float32):
    """The JAX package's train state as numpy arrays, biases and scales random."""
    tree = jax.tree.map(np.asarray, jmodel.init_train_state(jax.random.key(seed), jcfg,
                                                            param_dtype=param_dtype))
    rng = np.random.default_rng(seed + 100)
    if param_dtype == jnp.float32:
        tree["params"] = randomize_lm(tree["params"], rng)
    else:
        tree["opt"]["master"] = randomize_lm(tree["opt"]["master"], rng)
        tree["params"] = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                      tree["opt"]["master"])
    return tree


def _batch(cfg, B, S, rng):
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        return {"patches": rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - cfg.num_patches)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _jax_loss_grads(jcfg, params, batch, compute_dtype=jnp.float32, attn_impl="chunked"):
    loss_fn = jmodel.make_loss_fn(jcfg, None, compute_dtype=compute_dtype, attn_impl=attn_impl)
    (loss, _), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.fixture
def router_margins(monkeypatch):
    """The smallest relative top-k margin of every routing decision the port makes."""
    margins = []
    route = tmoe.route

    def recording(x, router, top_k):
        xf = x.reshape(-1, x.shape[-1])
        with torch.no_grad():
            probs = torch.softmax((xf @ router.to(xf.dtype)).float(), dim=-1)
        top = probs.topk(top_k + 1, dim=-1).values
        margins.append(float(((top[:, -2] - top[:, -1]) / top[:, -2]).min()))
        return route(x, router, top_k)

    monkeypatch.setattr(tmoe, "route", recording)
    return margins


def _assert_grads_close(got, want_tree, cfg, rel=GRAD_REL):
    want = convert.lm_params_from_arrays(want_tree, cfg, device="cpu")
    got_paths, want_paths = tree_paths(got), tree_paths(want)
    assert [p for p, _ in got_paths] == [p for p, _ in want_paths]
    for (path, g), (_, w) in zip(got_paths, want_paths):
        g, w = g.float().numpy(), w.float().numpy()
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert np.isfinite(g).all() and err <= rel * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, router_margins):
    cfg, jcfg = _configs(arch)
    tree = _jax_state(jcfg)
    batch = _batch(cfg, 2, 16, np.random.default_rng(1))
    want_loss, want_grads = _jax_loss_grads(jcfg, tree["params"], batch)
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    loss, grads = tmodel.make_grad_fn(cfg, compute_dtype=torch.float32)(state["params"], batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_grads_close(grads, want_grads["params"] if "params" in want_grads else want_grads, cfg)
    assert (len(router_margins) > 0) == cfg.is_moe
    assert min(router_margins, default=1.0) > NEAR_TIE_REL


def test_chunked_attention_gradient_matches_jax():
    """S 640 takes the port's chunked path with two kv chunks of 512, the last
    ragged, held against the JAX package's direct path.  The JAX package's
    own chunked path pads a ragged last chunk with keys at position -10^9,
    which its causal mask lets every query see, so at this length it is not
    a reference (its logits differ from its direct path's by half their
    range)."""
    cfg, jcfg = _configs("qwen2-0.5b", num_layers=2)
    tree = _jax_state(jcfg, seed=1)
    batch = _batch(cfg, 2, 640, np.random.default_rng(2))
    want_loss, want_grads = _jax_loss_grads(jcfg, tree["params"], batch, attn_impl="direct")
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    loss, grads = tmodel.make_grad_fn(cfg, compute_dtype=torch.float32)(state["params"], batch)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_grads_close(grads, want_grads, cfg)


def test_grad_accum_matches_jax():
    """Two microbatches of equal size: the accumulated gradient is the whole
    batch's (JAX's gradient of the whole batch), and the step's loss and
    gradient norm are JAX's accumulated step's."""
    cfg, jcfg = _configs("olmo-1b")
    tree = _jax_state(jcfg, seed=2)
    batch = _batch(cfg, 4, 16, np.random.default_rng(3))
    want_loss, want_grads = _jax_loss_grads(jcfg, tree["params"], batch)
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    loss, grads = tmodel.make_grad_fn(cfg, compute_dtype=torch.float32, grad_accum=2)(
        state["params"], batch)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_grads_close(grads, want_grads, cfg)

    kw = dict(compute_dtype=jnp.float32, grad_accum=2)
    _, want_m = jax.jit(jmodel.make_train_step(jcfg, None, **kw))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    _, got_m = tmodel.make_train_step(cfg, compute_dtype=torch.float32, grad_accum=2)(state, batch)
    for k, rel in (("loss", LOSS_REL), ("grad_norm", GRAD_REL), ("lr", 0.0)):
        assert abs(float(got_m[k]) - float(want_m[k])) <= rel * abs(float(want_m[k])), k


def test_bf16_params_keep_an_fp32_master_and_match_jax():
    """``param_dtype=bf16``: bf16 weights and gradients, an fp32 master copy
    in the optimizer.  Gradients are held to GRAD_REL plus one bf16 rounding
    of each element (one bf16 ulp, at most 2^-7 relative); after one step at the peak rate the
    master is within ``2 * lr`` of JAX's (see the module docstring) and the
    weights are its bf16 rounding."""
    cfg, jcfg = _configs("qwen2-0.5b")
    tree = _jax_state(jcfg, seed=3, param_dtype=jnp.bfloat16)
    batch = _batch(cfg, 2, 16, np.random.default_rng(4))
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(state["params"]))
    assert all(p.dtype == torch.float32 for p in tree_leaves(state["opt"]["master"]))

    want_loss, want_grads = _jax_loss_grads(jcfg, tree["params"], batch)
    loss, grads = tmodel.make_grad_fn(cfg, compute_dtype=torch.float32)(state["params"], batch)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    want = convert.lm_params_from_arrays(want_grads, cfg, device="cpu")
    for (path, g), (_, w) in zip(tree_paths(grads), tree_paths(want)):
        assert g.dtype == torch.bfloat16, path
        g, w = g.float().numpy(), w.float().numpy()
        assert (np.abs(g - w) <= GRAD_REL * np.abs(w).max() + 2.0**-7 * np.abs(w)).all(), path

    lr = 3e-4
    kw = dict(compute_dtype=jnp.float32, param_dtype=jnp.bfloat16, warmup=0, lr_peak=lr)
    want_state, _ = jax.jit(jmodel.make_train_step(jcfg, None, **kw))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    new, _ = tmodel.make_train_step(cfg, compute_dtype=torch.float32, warmup=0,
                                    lr_peak=lr)(state, batch)
    want_state = convert.train_state_from_arrays(jax.tree.map(np.asarray, want_state), cfg,
                                                 device="cpu")
    for m, w in zip(tree_leaves(new["opt"]["master"]), tree_leaves(want_state["opt"]["master"])):
        assert m.dtype == torch.float32 and float((m - w).abs().max()) <= 2 * lr * (1 + 1e-3)
    for p, m in zip(tree_leaves(new["params"]), tree_leaves(new["opt"]["master"])):
        assert torch.equal(p, m.to(torch.bfloat16))
    assert int(new["step"]) == 1 and int(new["opt"]["count"]) == 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b", "mamba2-370m"])
def test_bf16_compute_loss_matches_jax(arch):
    """bf16 compute (the default): the loss within 2e-2 relative, the packages
    rounding their bf16 activations in other places."""
    cfg, jcfg = _configs(arch)
    tree = _jax_state(jcfg, seed=4)
    batch = _batch(cfg, 2, 16, np.random.default_rng(5))
    want_loss, _ = _jax_loss_grads(jcfg, tree["params"], batch, compute_dtype=jnp.bfloat16)
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    loss, grads = tmodel.make_grad_fn(cfg)(state["params"], batch)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    assert abs(float(loss) - want_loss) <= 2e-2 * abs(want_loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_steps_learn(arch):
    """``tests/test_models_smoke.py::test_forward_and_train_step``'s check on the port."""
    cfg = reduced_config(arch)
    state = tmodel.init_train_state(cfg, seed=0, device="cpu")
    batch = _batch(cfg, 4, 32, np.random.default_rng(0))
    step = tmodel.make_train_step(cfg, compute_dtype=torch.float32)
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]
    assert int(state["step"]) == 4 and int(state["opt"]["count"]) == 4


def test_train_step_leaves_its_state_unchanged():
    """The step builds a new state: the old one's tensors keep their values,
    and the new one shares no storage with them."""
    cfg = reduced_config("qwen2-0.5b")
    state = tmodel.init_train_state(cfg, seed=0, device="cpu", param_dtype=torch.bfloat16)
    before = [t.clone() for t in tree_leaves(state)]
    new, _ = tmodel.make_train_step(cfg, warmup=0)(
        state, _batch(cfg, 2, 16, np.random.default_rng(0)))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    old_ptrs = {t.data_ptr() for t in tree_leaves(state)}
    assert not old_ptrs & {t.data_ptr() for t in tree_leaves(new)}
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                                      tree_leaves(new["params"])))
    # the step reads bf16 mode from the state: the master copy is kept, the weights stay bf16
    assert all(m.dtype == torch.float32 for m in tree_leaves(new["opt"]["master"]))
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(new["params"]))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_round_trip_is_exact(arch, param_dtype):
    """JAX state -> port -> ``train_state_to_arrays`` gives back every array,
    ``count``, ``step`` and the master copy, bit for bit (bf16 as fp32)."""
    jcfg = jax_reduced_config(arch)
    tree = jax.tree.map(np.asarray, jmodel.init_train_state(
        jax.random.key(0), jcfg, param_dtype=getattr(jnp, param_dtype)))
    rng = np.random.default_rng(6)
    tree["opt"]["mu"] = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                     tree["opt"]["mu"])
    tree["opt"]["count"], tree["step"] = np.int32(7), np.int32(42)
    cfg = reduced_config(arch)
    state = convert.train_state_from_arrays(tree, cfg, device="cpu")
    assert ("master" in state["opt"]) == (param_dtype == "bfloat16")
    back = convert.train_state_to_arrays(state, cfg)
    want, got = jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        assert g.shape == w.shape and g.dtype == (np.float32 if w.dtype.name == "bfloat16" else w.dtype), path
        np.testing.assert_array_equal(g, np.asarray(w, dtype=g.dtype), err_msg=str(path))


def test_flash_train_step_raises_like_jax():
    """Neither package has a gradient rule for its flash kernel: the JAX
    package's step fails inside ``jax.grad`` of the Pallas call, the port's
    with the kernel entry point's ``TypeError``."""
    cfg, jcfg = _configs("qwen2-0.5b")
    batch = _batch(cfg, 2, 16, np.random.default_rng(7))
    jstep = jmodel.make_train_step(jcfg, None, attn_impl="flash", compute_dtype=jnp.float32)
    with pytest.raises(AssertionError):
        jstep(jmodel.init_train_state(jax.random.key(0), jcfg),
              {k: jnp.asarray(v) for k, v in batch.items()})
    step = tmodel.make_train_step(cfg, attn_impl="flash", compute_dtype=torch.float32)
    with pytest.raises(TypeError, match="flash_attention has no gradient rule"):
        step(tmodel.init_train_state(cfg, seed=0, device="cpu"), batch)
