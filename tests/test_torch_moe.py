"""The port's MoE FFN and dropless grouped GEMM against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages.  JAX runs
``gemm_impl="block_spmm"`` and ``grouped_gemm_varsize`` through its Pallas
kernel in interpret mode where the block shapes are multiples of 8, and
through its plain reference otherwise, as its own tests do; the port takes
the plain version of ``block_spmm`` on the CPU.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

# every fp32 output within REL * max|out| of the JAX package's: the two sum
# the expert products and the combine in different orders
REL = 1e-5


def _params(D, F, E, act, seed):
    p, _ = jmoe.moe_init(jax.random.key(seed), D, F, E, act)
    return {k: np.array(v) for k, v in p.items()}


def _pair(p, x, **kw):
    want = np.asarray(jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                     None, **kw))
    got = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), **kw)
    return got.numpy(), want


def _assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
@pytest.mark.parametrize("gemm_impl", ["einsum", "block_spmm"])
def test_moe_apply_matches_jax(gemm_impl, act):
    """Ce = 2 * 16 * 2 * 2 / 4 = 32 rows an expert: the block route takes the
    JAX package's Pallas kernel (interpret mode) and the port's plain version."""
    D, F, E, K = 16, 32, 4, 2
    p = _params(D, F, E, act, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 16, D)).astype(np.float32)
    got, want = _pair(p, x, num_experts=E, top_k=K, act=act, capacity_factor=2.0,
                      gemm_impl=gemm_impl)
    _assert_close(got, want)
    assert (np.abs(want).sum(-1) > 0).all()  # no token dropped at this capacity
    again, _ = _pair(p, x, num_experts=E, top_k=K, act=act, capacity_factor=2.0,
                     gemm_impl=gemm_impl)
    np.testing.assert_array_equal(again, got)  # the combine is a gather, not a scatter-add


@pytest.mark.parametrize("gemm_impl", ["einsum", "block_spmm"])
def test_capacity_drops_the_same_pairs_as_jax(gemm_impl):
    """tests/test_moe.py's case: E 2, top 1, 16 tokens, capacity ceil(16 * 0.25 / 2) = 2;
    the first two arrivals of each expert survive, in both packages."""
    D, F, E, K = 8, 16, 2, 1
    p = _params(D, F, E, "silu", seed=2)
    x = np.random.default_rng(2).standard_normal((1, 16, D)).astype(np.float32)
    got, want = _pair(p, x, num_experts=E, top_k=K, act="silu", capacity_factor=0.25,
                      gemm_impl=gemm_impl)
    _assert_close(got, want)
    served = np.abs(got[0]).sum(-1) > 0
    np.testing.assert_array_equal(served, np.abs(want[0]).sum(-1) > 0)
    choice = (x.reshape(-1, D) @ p["router"]).argmax(-1)
    assert served.sum() == sum(min(2, int((choice == e).sum())) for e in range(E)) < 16


def test_dropless_serves_every_token_like_jax():
    """An adversarial router sends every token's top 2 to the same experts;
    ``dropless`` keeps them all."""
    D, F, E, K = 8, 16, 4, 2
    p = _params(D, F, E, "silu", seed=3)
    p["router"] = np.full((D, E), 1e-3, np.float32)
    p["router"][:, 1] = 100.0
    x = np.abs(np.random.default_rng(3).standard_normal((1, 8, D))).astype(np.float32)
    got, want = _pair(p, x, num_experts=E, top_k=K, act="silu", dropless=True)
    _assert_close(got, want)
    assert (np.abs(got[0]).sum(-1) > 0).all()
    dropped, _ = _pair(p, x, num_experts=E, top_k=K, act="silu", capacity_factor=1.0)
    assert (np.abs(dropped[0]).sum(-1) == 0).any()  # the same tokens overflow without it


def test_routing_ties_go_to_the_lower_expert_like_lax_top_k():
    """A zero router gives every expert the same probability: ``jax.lax.top_k``
    takes experts 0 .. k-1, and so does the port's stable sort."""
    D, F, E, K = 8, 16, 6, 3
    p = _params(D, F, E, "silu", seed=4)
    p["router"] = np.zeros((D, E), np.float32)
    x = np.random.default_rng(4).standard_normal((1, 5, D)).astype(np.float32)
    _, experts = tmoe.route(torch.from_numpy(x), torch.from_numpy(p["router"]), K)
    assert (experts.numpy() == np.arange(K)).all()
    got, want = _pair(p, x, num_experts=E, top_k=K, act="silu", dropless=True)
    _assert_close(got, want)


# -- grouped_gemm_varsize ------------------------------------------------------


def _recorded_calls(x, sizes, w, tile_m):
    """Both packages' outputs, and the arguments each handed to its ``block_spmm``."""
    calls = {}

    def recorder(key, fn):
        def record(*args, **kw):
            calls[key] = args
            return fn(*args, **kw)
        return record

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "block_spmm", recorder("jax", jops.block_spmm))
        mp.setattr(tops, "block_spmm", recorder("port", tops.block_spmm))
        want = np.asarray(jops.grouped_gemm_varsize(jnp.asarray(x), sizes, jnp.asarray(w),
                                                    tile_m=tile_m))
        got = tops.grouped_gemm_varsize(torch.from_numpy(x), sizes, torch.from_numpy(w),
                                        tile_m=tile_m).numpy()
    return got, want, calls


def _check_grouped(sizes, K, N, tile_m, seed):
    rng = np.random.default_rng(seed)
    T, G = sum(sizes), len(sizes)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = rng.standard_normal((G, K, N)).astype(np.float32)
    got, want, calls = _recorded_calls(x, sizes, w, tile_m)
    # the task arrays (a_idx, b_idx, c_idx), the masked tiles and num_out, array for array
    (ja, jw, *jtasks, jnum), (ta, tw, *ttasks, tnum) = calls["jax"], calls["port"]
    assert tnum == jnum == -(-T // tile_m)
    for mine, theirs in zip(ttasks, jtasks, strict=True):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # outputs within 1e-4 (the JAX test's tolerance), and against a per-group product
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for g in range(G):
        np.testing.assert_allclose(got[starts[g]:starts[g + 1]],
                                   x[starts[g]:starts[g + 1]] @ w[g], rtol=1e-4, atol=1e-4)
    return ttasks


@pytest.mark.parametrize("sizes", [[5, 11, 0, 16], [32], [1, 1, 1, 29], [8, 8, 8, 8]])
def test_grouped_gemm_varsize_matches_jax(sizes):
    _check_grouped(sizes, K=16, N=24, tile_m=8, seed=sum(sizes))


def test_grouped_gemm_tasks_split_boundary_tiles_by_group():
    """[1, 1, 1, 29] at tile 8: tile 0 spans four groups (one task each, masked
    to one row apiece), the padded rows of the last tile belong to group 3."""
    a, b, c, lo, hi = tops.grouped_gemm_tasks([1, 1, 1, 29], 8)
    np.testing.assert_array_equal(a, [0, 0, 0, 0, 1, 2, 3])
    np.testing.assert_array_equal(b, [0, 1, 2, 3, 3, 3, 3])
    np.testing.assert_array_equal(c, a)
    np.testing.assert_array_equal(lo, [0, 1, 2, 3, 0, 0, 0])
    np.testing.assert_array_equal(hi, [1, 2, 3, 8, 8, 8, 8])
    # 21 rows: 3 padded rows in the last tile, which group 2's (last) task owns
    a, b, c, lo, hi = tops.grouped_gemm_tasks([0, 13, 8], 8)
    np.testing.assert_array_equal(b, [1, 1, 2, 2])
    np.testing.assert_array_equal(lo, [0, 0, 5, 0])
    np.testing.assert_array_equal(hi, [8, 5, 8, 8])


@given(g1=st.integers(0, 40), g2=st.integers(0, 40), g3=st.integers(1, 40), seed=st.integers(0, 50))
@settings(max_examples=15, deadline=None)
def test_grouped_gemm_varsize_property(g1, g2, g3, seed):
    """Empty groups anywhere but last (as tests/test_kernels.py's property)."""
    _check_grouped([g1, g2, g3], K=8, N=8, tile_m=8, seed=seed)


def test_grouped_gemm_varsize_rejects_sizes_that_do_not_cover_x():
    with pytest.raises(ValueError, match="sum to"):
        tops.grouped_gemm_varsize(torch.zeros((5, 8)), [2, 2], torch.zeros((2, 8, 8)))
