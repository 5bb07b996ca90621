"""The port's optimizer (AdamW, clipping, the cosine schedule, int8 compression)
against the JAX package's on the same arrays, and mirrors of ``tests/test_optim.py``.

Tolerances: every fp32 result within ``ULPS`` units in the last place of
the JAX package's (``np.spacing``), for the ops the two packages may round
differently (``pow`` in the bias corrections, ``cos`` in the schedule, the
order of a norm's sum); the int8 codes and their scales exactly.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    cosine_lr,
    decompress_grads,
    error_feedback_update,
)
from repro_torch.tree import tree_leaves  # noqa: E402

ULPS = 4


def _assert_ulps(got, want, ulps=ULPS):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert (np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all(), np.abs(got - want).max()


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "layers": {"0": (4, 4), "1": (5,)}}

    def draw(shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    def tree(s=1.0):
        return {"w": draw(shapes["w"], s), "b": draw(shapes["b"], s),
                "layers": {k: draw(v, s) for k, v in shapes["layers"].items()}}

    return tree(), tree(0.1), tree(0.01), jax.tree.map(np.abs, tree(1e-3))  # params, grads, mu, nu


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("count", [0, 3, 250])
def test_adamw_update_matches_jax(count):
    params, grads, mu, nu = _trees(count)
    lr = np.float32(3e-4)
    want_p, want_s = joptim.adamw_update(
        jax.tree.map(jnp.asarray, grads),
        {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
         "count": jnp.int32(count)},
        jax.tree.map(jnp.asarray, params), lr=jnp.asarray(lr))
    got_p, got_s = adamw_update(
        _to_torch(grads),
        {"mu": _to_torch(mu), "nu": _to_torch(nu), "count": torch.tensor(count, dtype=torch.int32)},
        _to_torch(params), lr=torch.tensor(lr))
    assert got_s["count"].dtype == torch.int32 and int(got_s["count"]) == count + 1
    for tree_got, tree_want in ((got_p, want_p), (got_s["mu"], want_s["mu"]),
                                (got_s["nu"], want_s["nu"])):
        for g, w in zip(tree_leaves(tree_got), jax.tree.leaves(tree_want)):
            _assert_ulps(g, w)


def test_adamw_update_leaves_its_inputs_unchanged():
    params, grads, mu, nu = (_to_torch(t) for t in _trees(1))
    state = {"mu": mu, "nu": nu, "count": torch.tensor(2, dtype=torch.int32)}
    before = [t.clone() for t in tree_leaves([params, grads, state])]
    adamw_update(grads, state, params, lr=torch.tensor(1e-3))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves([params, grads, state])))


@pytest.mark.parametrize("max_norm", [1e9, 1.0, 0.01])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads, _, _ = _trees(7)
    want, want_norm = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    got, norm = clip_by_global_norm(_to_torch(grads), max_norm)
    _assert_ulps(norm, want_norm)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        _assert_ulps(g, w)


def test_clip_norm_is_accurate_on_a_large_leaf():
    """A leaf of 2^24 elements (an embedding table's gradient is 136 M at
    qwen2-0.5b's width): the norm within 1e-6 of float64's.  PyTorch's CPU
    ``vector_norm`` accumulates one element after another in fp32 and misses
    by far more there."""
    g = torch.randn(2**24, generator=torch.Generator().manual_seed(0)) * 1e-3
    _, norm = clip_by_global_norm({"table": g, "b": torch.ones(3)}, 1.0)
    want = float(torch.cat([g, torch.ones(3)]).double().norm())
    assert abs(float(norm) - want) <= 1e-6 * want


def test_cosine_lr_matches_jax():
    for warmup, total in ((10, 100), (0, 50), (1, 8), (100, 10_000)):
        for s in list(range(0, 120)) + [5000, 9999, 10_000, 20_000]:
            want = joptim.cosine_lr(jnp.int32(s), peak=1e-3, warmup=warmup, total=total)
            got = cosine_lr(torch.tensor(s, dtype=torch.int32), peak=1e-3, warmup=warmup,
                            total=total)
            assert got.dtype == torch.float32
            _assert_ulps(got, want)


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_compression_codes_equal_jax(scale):
    rng = np.random.default_rng(11)
    g = {"w": (scale * rng.standard_normal((64, 32))).astype(np.float32),
         "half": (np.arange(-10, 11, dtype=np.float32) * 0.5),  # x.5 codes: half to even
         "zero": np.zeros(4, np.float32)}
    want_q, want_s = joptim.compress_grads(jax.tree.map(jnp.asarray, g))
    got_q, got_s = compress_grads(_to_torch(g))
    for k in g:
        assert got_q[k].dtype == torch.int8
        np.testing.assert_array_equal(got_q[k].numpy(), np.asarray(want_q[k]))
        np.testing.assert_array_equal(got_s[k].numpy(), np.asarray(want_s[k]))
    back = decompress_grads(got_q, got_s)
    want_back = joptim.decompress_grads(want_q, want_s)
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(want_back[k]))


def test_adam_init_state():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.zeros(2, 2)]}
    s = adamw_init(params)
    assert s["count"].dtype == torch.int32 and int(s["count"]) == 0
    assert all(t.dtype == torch.float32 and not t.any() for t in tree_leaves([s["mu"], s["nu"]]))
    assert s["mu"]["b"][0].data_ptr() != s["nu"]["b"][0].data_ptr()


# --- mirrors of tests/test_optim.py ------------------------------------------


def test_adamw_converges_quadratic():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(8).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = adamw_init(params)
    for _ in range(300):
        grads = {"w": params["w"] - target}
        params, state = adamw_update(grads, state, params, lr=0.05, weight_decay=0.0)
    assert float((params["w"] - target).abs().max()) < 0.05


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(9) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum(torch.sum(x**2) for x in tree_leaves(clipped)))
    assert float(total) == pytest.approx(1.0, rel=1e-5)
    # below threshold: untouched
    same, _ = clip_by_global_norm(g, 1e9)
    assert float((same["a"] - 3.0).abs().max()) < 1e-6


def test_cosine_lr_shape():
    peak, warm, total = 1e-3, 10, 100
    lrs = [float(cosine_lr(torch.tensor(s), peak=peak, warmup=warm, total=total))
           for s in range(total)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(peak, rel=1e-3)
    assert lrs[-1] < 0.2 * peak
    assert np.argmax(lrs) == warm


@given(seed=st.integers(0, 50), scale=st.floats(1e-4, 1e3))
@settings(max_examples=20, deadline=None)
def test_compression_bounded_error(seed, scale):
    rng = np.random.default_rng(seed)
    g = {"w": torch.from_numpy((rng.standard_normal((16, 16)) * scale).astype(np.float32))}
    q, s = compress_grads(g)
    back = decompress_grads(q, s)
    max_err = float((back["w"] - g["w"]).abs().max())
    # quantization error bounded by half a quantization step
    step = float(g["w"].abs().max()) / 127.0
    assert max_err <= 0.51 * step + 1e-12
    assert q["w"].dtype == torch.int8  # 4x wire reduction vs f32


def test_error_feedback_accumulates():
    rng = np.random.default_rng(1)
    true_g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    err = {"w": torch.zeros(64)}
    sent_sum = torch.zeros(64)
    for _ in range(50):
        intended = {"w": true_g + err["w"]}
        q, s = compress_grads(intended)
        transmitted = decompress_grads(q, s)
        err = error_feedback_update(intended, transmitted)
        sent_sum = sent_sum + transmitted["w"]
    # long-run average of transmitted gradients converges to the true gradient
    assert float((sent_sum / 50 - true_g).abs().max()) < 0.02
