"""The port's SSD (Mamba-2) and RG-LRU (Griffin) blocks against the JAX package's, on the CPU.

Inputs and parameters come from numpy seeds (or the JAX package's init,
carried across as numpy arrays).  Parallel forms (the chunked SSD, the
doubling scan) are held to the JAX package's at 1e-4; a recurrence against
a scan, or decode steps against the block's forward, to the JAX package's
own tests' tolerance for that comparison.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import rglru as jrec  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch.models import rglru as trec  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # parallel form against parallel form
STEP_TOL = dict(rtol=1e-3, atol=1e-3)  # decode steps against the forward (tests/test_ssd_rglru.py)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _ssd_inputs(seed, B=2, S=64, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(rng.standard_normal((B, S, H, P))), f32(rng.random((B, S, H)) * 0.5 + 0.1),
            f32(np.log(rng.random(H) * 2 + 0.5)), f32(rng.standard_normal((B, S, N))),
            f32(rng.standard_normal((B, S, N))))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    args = _ssd_inputs(0)
    y_j, h_j = jssd.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, h = tssd.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **TOL)
    # the naive recurrence, in float64 (tests/test_ssd_rglru.py's reference)
    xh, dt, a_log, Bm, Cm = (a.astype(np.float64) for a in args)
    A = -np.exp(a_log)
    state = np.zeros(h.shape)
    for t in range(xh.shape[1]):
        state = (state * np.exp(dt[:, t] * A)[..., None, None]
                 + np.einsum("bh,bhp,bn->bhpn", dt[:, t], xh[:, t], Bm[:, t]))
        np.testing.assert_allclose(y[:, t].numpy(), np.einsum("bhpn,bn->bhp", state, Cm[:, t]), **TOL)
    np.testing.assert_allclose(h.numpy(), state, **TOL)


def test_ssd_chunked_keeps_the_chunk_restriction():
    args = map(torch.from_numpy, _ssd_inputs(1, S=24))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tssd.ssd_chunked(*args, chunk=16)


def _ssd_block(seed):
    d, d_inner, heads, d_state = 16, 32, 4, 8
    p, _ = jssd.ssd_block_init(jax.random.key(seed), d, d_inner=d_inner, heads=heads, d_state=d_state)
    p = {k: np.array(v) for k, v in p.items()}
    rng = np.random.default_rng(seed)
    # random values for the constants that start at zero or one
    for k in ("d_skip", "dt_bias", "norm_scale"):
        p[k] = (p[k] + 0.5 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p, dict(d_inner=d_inner, heads=heads, d_state=d_state)


def test_ssd_block_apply_and_decode_match_jax():
    p, kw = _ssd_block(0)
    B, S = 2, 12
    x = np.random.default_rng(2).standard_normal((B, S, 16)).astype(np.float32)
    want = np.asarray(jssd.ssd_block_apply({k: jnp.asarray(v) for k, v in p.items()},
                                           jnp.asarray(x), chunk=4, **kw))
    got = tssd.ssd_block_apply(_t(p), torch.from_numpy(x), chunk=4, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jstate = jssd.ssd_init_state(B, **kw)
    state = tssd.ssd_init_state(B, **kw, device="cpu")
    steps, jsteps = [], []
    for t in range(S):
        y, state = tssd.ssd_decode_step(_t(p), torch.from_numpy(x[:, t:t + 1]), state, **kw)
        yj, jstate = jssd.ssd_decode_step({k: jnp.asarray(v) for k, v in p.items()},
                                          jnp.asarray(x[:, t:t + 1]), jstate, **kw)
        steps.append(y.numpy())
        jsteps.append(np.asarray(yj))
    np.testing.assert_allclose(np.concatenate(steps, 1), np.concatenate(jsteps, 1), **TOL)
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(jstate["h"]), **TOL)
    np.testing.assert_allclose(state["conv"].numpy(), np.asarray(jstate["conv"]), **TOL)
    np.testing.assert_allclose(np.concatenate(steps, 1), got.numpy(), **STEP_TOL)


def _rglru_block(seed, d=16, heads=4):
    p, _ = jrec.rglru_block_init(jax.random.key(seed), d, heads)
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("S", [1, 20, 64])
def test_rglru_scan_matches_jax_and_a_sequential_loop(S):
    """The doubling scan at a power of two, a ragged length and one step."""
    p = _rglru_block(1)
    u = np.random.default_rng(3).standard_normal((2, S, 16)).astype(np.float32)
    y_j, h_j = jrec._rglru_scan({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(u), 4)
    y, h_last = trec._rglru_scan(_t(p), torch.from_numpy(u), 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(h_j), **TOL)
    # sequential, in float64, from the port's gates
    r, i = (g.double().numpy() for g in trec._gates(_t(p), torch.from_numpy(u), 4))
    a = np.exp(-trec._C * np.logaddexp(p["lam"].astype(np.float64), 0.0) * r)
    g = np.sqrt(np.maximum(1 - a**2, 1e-12)) * i * u
    h = np.zeros((2, 16))
    for t in range(S):
        h = a[:, t] * h + g[:, t]
        np.testing.assert_allclose(y[:, t].numpy(), h, **TOL)
    np.testing.assert_allclose(h_last.numpy(), h, **TOL)


def test_rglru_block_apply_and_decode_match_jax():
    p = _rglru_block(2)
    B, S = 2, 10
    x = np.random.default_rng(4).standard_normal((B, S, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = np.asarray(jrec.rglru_block_apply(jp, jnp.asarray(x), heads=4))
    got = trec.rglru_block_apply(_t(p), torch.from_numpy(x), heads=4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jstate, state = jrec.rglru_init_state(B, 16), trec.rglru_init_state(B, 16, device="cpu")
    steps, jsteps = [], []
    for t in range(S):
        y, state = trec.rglru_decode_step(_t(p), torch.from_numpy(x[:, t:t + 1]), state, heads=4)
        yj, jstate = jrec.rglru_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, heads=4)
        steps.append(y.numpy())
        jsteps.append(np.asarray(yj))
    np.testing.assert_allclose(np.concatenate(steps, 1), np.concatenate(jsteps, 1), **TOL)
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(jstate["h"]), **TOL)
    np.testing.assert_allclose(np.concatenate(steps, 1), got.numpy(), **STEP_TOL)


def test_rglru_decode_promotes_a_narrower_conv_tail_like_jax():
    """A bf16 tail (an int8 cache's) fed fp32 inputs becomes fp32, as
    ``jnp.concatenate`` promotes it."""
    p = _rglru_block(3)
    x = np.random.default_rng(5).standard_normal((2, 1, 16)).astype(np.float32)
    _, state = trec.rglru_decode_step(_t(p), torch.from_numpy(x),
                                      trec.rglru_init_state(2, 16, torch.bfloat16, "cpu"), heads=4)
    _, jstate = jrec.rglru_decode_step({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                       jrec.rglru_init_state(2, 16, jnp.bfloat16), heads=4)
    assert state["conv"].dtype == torch.float32 and jstate["conv"].dtype == jnp.float32
    np.testing.assert_allclose(state["conv"].numpy(), np.asarray(jstate["conv"]), **TOL)


def test_state_constructors_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trec.rglru_init_state(1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tssd.ssd_init_state(1, d_inner=32, heads=4, d_state=8)
    assert trec.rglru_init_state(1, 16, device="cpu")["h"].device.type == "cpu"
    assert tssd.ssd_init_state(1, d_inner=32, heads=4, d_state=8, device="cpu")["conv"].shape == (1, 3, 48)


def _within_rounding_of_the_grid(got, want, grid, fn):
    """``|got - want| <= |fn(v + ulp(v)) - fn(v)| + 8 ulp(want)`` elementwise, in float64.

    Both packages build the constant in fp32 on ``linspace``'s grid ``v``, and
    XLA's CPU code and PyTorch round a grid point one ulp apart in places: the
    limit is what one ulp of ``v`` moves the constant, plus its own rounding.
    """
    v = grid.astype(np.float64)
    ulp = np.spacing(grid).astype(np.float64)
    tol = np.abs(fn(v + ulp) - fn(v)) + 8 * np.spacing(np.abs(want)).astype(np.float64)
    assert got.dtype == want.dtype == np.float32
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


@pytest.mark.parametrize("d,heads", [(16, 4), (4096, 16)])
def test_deterministic_constants_equal_jax(d, heads):
    """lam (RG-LRU) and a_log (SSD) to fp32 rounding; the ones and zeros exactly."""
    gen = torch.Generator().manual_seed(0)
    lam = trec.rglru_block_init(gen, d, heads)["lam"].numpy()
    jlam = np.asarray(jrec.rglru_block_init(jax.random.key(0), d, heads)[0]["lam"])
    _within_rounding_of_the_grid(lam, jlam, np.asarray(jnp.linspace(0.9, 0.999, d)),
                                 lambda v: np.log(np.expm1(-np.log(v) / trec._C)))
    H = 2 * heads
    p = tssd.ssd_block_init(gen, 16, d_inner=32 * H, heads=H, d_state=8)
    jp, _ = jssd.ssd_block_init(jax.random.key(0), 16, d_inner=32 * H, heads=H, d_state=8)
    _within_rounding_of_the_grid(p["a_log"].numpy(), np.asarray(jp["a_log"]),
                                 np.asarray(jnp.linspace(1.0, 16.0, H)), np.log)
    for k in ("d_skip", "dt_bias", "norm_scale"):
        assert p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
