"""The GEMM kernels' tile-engine rule and TileRows' packed step walk, on the host.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the host mirrors are held to the rule and to the plain versions:
``tile_engine`` / ``engine_takes`` / ``engine_id`` against the shapes and
alignments each engine takes, and ``packed_steps`` (the order in which a
TileRows tile walks the runs of its packed output blocks) against the
properties the kernel's bit-for-bit results rest on, then applied with plain
fp32 arithmetic against ``block_spmm_ref`` / ``fused_block_spmm_ref``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_spmm as bsp
from repro_torch.kernels import fused_leaf as fl
from repro_torch.kernels import ops

# |dC|_max <= 1e-5 * sum_t ||A_t||_F ||B_t||_F per output block (the steps
# and the plain version sum each element's products in different orders)
REL = 1e-5


def _stack(shape, offset=0):
    """A contiguous CPU stack whose data starts ``offset`` floats past an aligned base."""
    base = torch.empty(int(np.prod(shape)) + 4, dtype=torch.float32)
    lead = (-base.data_ptr() % 16) // 4 + offset
    return base[lead:lead + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("bm,bk,bn,offset,want", [
    (8, 4096, 1536, 0, "tilerows"),   # the dropless grouped GEMM
    (32, 32, 32, 0, "tilerows"),
    (64, 64, 64, 0, "tilerows"),
    (24, 24, 24, 1, "tilerows"),      # unaligned: TileRows' masked scalar loads
    (10, 10, 10, 0, "tilerows"),      # ragged bk
    (1, 8, 8, 0, "tilerows"),
    (65, 64, 64, 0, "tile64"),
    (96, 96, 96, 0, "tile64"),
    (130, 70, 66, 0, "tile64"),
    (192, 192, 192, 0, "tile64"),
    (128, 128, 128, 0, "tile128"),
    (128, 256, 128, 0, "tile128"),
    (256, 256, 256, 0, "tile128"),
    (128, 128, 128, 1, "tile64"),     # unaligned: not Tile128, too tall for TileRows
    (128, 124, 128, 0, "tile64"),     # bk not a multiple of 8
    (128, 128, 64, 0, "tile64"),      # bn not a multiple of 128
])
def test_tile_engine_rule(bm, bk, bn, offset, want):
    A, B = _stack((3, bm, bk), offset), _stack((3, bk, bn))
    assert bsp.tile_engine(bm, bk, bn, (A, B)) == want
    assert bsp.engine_takes(want, bm, bk, bn, (A, B))
    assert bsp.engine_id(None, bm, bk, bn, (A, B)) == 0
    assert bsp.engine_id(want, bm, bk, bn, (A, B)) == bsp.ENGINES[want]


def test_engine_rule_over_a_grid_of_shapes_and_alignments():
    """Tile64 takes every shape, TileRows exactly bm <= 64, Tile128 exactly
    the aligned multiples of 128; the rule picks Tile128 where it can, else
    TileRows where it can, else Tile64."""
    seen = set()
    for bm in (1, 7, 8, 9, 16, 24, 40, 56, 63, 64, 65, 96, 127, 128, 130, 256):
        for bk in (1, 8, 10, 16, 100, 128, 256):
            for bn in (1, 8, 33, 64, 128, 130, 256):
                for offset in (0, 1, 2):
                    A, B = _stack((2, bm, bk), offset), _stack((2, bk, bn))
                    takes = {e for e in bsp.ENGINES if bsp.engine_takes(e, bm, bk, bn, (A, B))}
                    aligned = offset == 0
                    assert "tile64" in takes
                    assert ("tilerows" in takes) == (bm <= 64)
                    assert ("tile128" in takes) == (
                        aligned and bm % 128 == 0 and bn % 128 == 0 and bk % 8 == 0)
                    pick = bsp.tile_engine(bm, bk, bn, (A, B))
                    want = ("tile128" if "tile128" in takes else
                            "tilerows" if "tilerows" in takes else "tile64")
                    assert pick == want
                    seen.add(pick)
                    for e in bsp.ENGINES:
                        if e in takes:
                            assert bsp.engine_id(e, bm, bk, bn, (A, B)) == bsp.ENGINES[e]
                        else:
                            with pytest.raises(ValueError, match=e):
                                bsp.engine_id(e, bm, bk, bn, (A, B))
    assert seen == set(bsp.ENGINES)
    with pytest.raises(ValueError):
        bsp.engine_id("tile32", 8, 8, 8)
    assert not bsp.engine_takes("tile64", 0, 8, 8)


@pytest.mark.parametrize("bn,tm", [(8, 64), (32, 64), (64, 64), (65, 128), (1536, 128)])
def test_rows_pack_pads_at_most_one_row_step(bn, tm):
    for bm in range(1, 65):
        R = bsp.rows_pack(bm, bn)
        rows = -(-bm // 8) * 8
        assert R >= 1 and R * rows <= tm and rows - bm < 8 and (R + 1) * rows > tm
    want = [8, 4, 2, 2, 1, 1] if tm == 64 else [16, 8, 5, 4, 2, 2]
    assert [bsp.rows_pack(b, bn) for b in (8, 16, 24, 32, 48, 64)] == want


def _check_steps(steps, run_ptr, key, pack, on=None):
    """The properties of the walk the kernel's bits rest on."""
    key = np.asarray(key).reshape(len(key), -1)
    live = np.ones(len(key), bool) if on is None else np.asarray(on, bool)
    num_out = len(run_ptr) - 1
    seen = {c: [] for c in range(num_out)}
    groups = [g for g, _ in steps]
    assert groups == sorted(groups)
    for g in set(groups):
        blocks = range(g * pack, min(g * pack + pack, num_out))
        pos = dict.fromkeys(blocks, 0)
        runs = {c: [t for t in range(run_ptr[c], run_ptr[c + 1]) if live[t]] for c in blocks}
        for _, step in (s for s in steps if s[0] == g):
            heads = {c: runs[c][pos[c]] for c in blocks if pos[c] < len(runs[c])}
            lead = min(heads)
            # the lowest block with tasks left leads; a block joins iff its head names the same B
            assert step[0] == (lead, heads[lead])
            assert [c for c, _ in step] == [c for c in heads
                                            if np.array_equal(key[heads[c]], key[heads[lead]])]
            for c, t in step:
                assert t == heads[c] and g * pack <= c < g * pack + pack
                pos[c] += 1
                seen[c].append(t)
    for c in range(num_out):  # every live task once, in its run's order
        assert seen[c] == [t for t in range(run_ptr[c], run_ptr[c + 1]) if live[t]]


def _apply_steps(steps, A, B, a, b, num_out, low=None):
    """C[block] += A[a[t]] @ B[b[t]] in step order, fp32; ``low`` rounds a task's operands."""
    C = torch.zeros((num_out, A.shape[1], B.shape[2]))
    for _, step in steps:
        for c, t in step:
            x, y = A[a[t]].float(), B[b[t]].float()
            if low is not None and low[t]:
                x, y = x.bfloat16().float(), y.bfloat16().float()
            C[c] += x @ y
    return C


def _bound(A, B, a, b, run_ptr, live=None):
    na = torch.linalg.matrix_norm(A.double()).numpy()
    nb = torch.linalg.matrix_norm(B.double()).numpy()
    per = na[a] * nb[b] * (1.0 if live is None else live)
    csum = np.concatenate([[0.0], np.cumsum(per)])
    return REL * (csum[run_ptr[1:]] - csum[run_ptr[:-1]])


def test_packed_steps_of_the_grouped_gemm():
    """bm 8: tiles spanning several groups (one task per group), empty groups
    (leading, inner, several in a row), a last tile of fewer than 8 blocks.
    The 8 tiles of one group share one step; applied with plain arithmetic
    the steps give ``block_spmm_ref``'s sums within the GEMM limit."""
    sizes = [0, 3, 2, 11, 0, 30, 0, 0, 45, 1, 200, 0]
    a, b, c, lo, hi = ops.grouped_gemm_tasks(sizes, 8)
    nt = int(c.max()) + 1
    rp = bsp.task_runs(c, nt)
    R = bsp.rows_pack(8, 40)
    steps = bsp.packed_steps(rp, b, R)
    _check_steps(steps, rp, b, R)
    assert len(steps) < len(b)  # blocks share steps
    assert max(len(s) for _, s in steps) == R  # a whole tile of one group in one step
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((len(a), 8, 24)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((len(sizes), 24, 40)).astype(np.float32))
    got = _apply_steps(steps, A, W, np.arange(len(a)), b, nt)
    want = bsp.block_spmm_ref(A, W, *ops.task_arrays(np.arange(len(a)), b, c, nt, "cpu"), nt)
    err = (got - want).abs().flatten(1).amax(1).double().numpy()
    assert (err <= _bound(A, W, np.arange(len(a)), b, rp)).all()


@pytest.mark.parametrize("bs", [24, 32, 64])
def test_packed_steps_of_random_runs(bs):
    """Runs with empty blocks and B operands drawn from few blocks (so heads
    agree now and then), at the pack of bs 24 / 32 (2) and 64 (1)."""
    rng = np.random.default_rng(bs)
    num_out, nb = 23, 4
    lens = rng.integers(0, 7, num_out)
    lens[[0, 5, 6, 22]] = 0
    c = np.repeat(np.arange(num_out), lens)
    a = rng.integers(0, 9, c.size)
    b = rng.integers(0, nb, c.size)
    rp = bsp.task_runs(c, num_out)
    R = bsp.rows_pack(bs, bs)
    steps = bsp.packed_steps(rp, b, R)
    _check_steps(steps, rp, b, R)
    if R > 1:
        assert any(len(s) > 1 for _, s in steps)
    else:
        assert all(len(s) == 1 for _, s in steps) and len(steps) == c.size
    A = torch.from_numpy(rng.standard_normal((9, bs, bs)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((nb, bs, bs)).astype(np.float32))
    got = _apply_steps(steps, A, B, a, b, num_out)
    want = bsp.block_spmm_ref(A, B, *ops.task_arrays(a, b, c, num_out, "cpu"), num_out)
    err = (got - want).abs().flatten(1).amax(1).double().numpy()
    assert (err <= _bound(A, B, a, b, rp)).all()
    assert not got[[0, 5, 6, 22]].any()


def test_packed_steps_of_the_fused_kernel_with_on_and_low():
    """The fused kernel's key is (src, off, low): the same stored block with
    another rounding flag is another B.  Off tasks are never visited.  One
    worker's steps, applied with plain arithmetic, give the adaptive masked
    ``fused_block_spmm_ref`` within the GEMM limit."""
    rng = np.random.default_rng(7)
    bs, num_out, T, cap, R_, cu = 16, 13, 90, 5, 2, 3
    c = np.sort(rng.choice(np.setdiff1d(np.arange(num_out), (2, 7)), T))
    a_src, b_src = rng.integers(0, R_ + 1, T), rng.integers(0, R_ + 1, T)
    a_off = np.where(a_src == 0, rng.integers(0, cap, T), rng.integers(0, cu, T))
    b_off = np.where(b_src == 0, rng.integers(0, 2, T), rng.integers(0, 2, T))  # few distinct B
    on = rng.random(T) < 0.8
    low = rng.random(T) < 0.5
    rp = fl.fused_task_runs(c[None], num_out)[0]
    pack = bsp.rows_pack(bs, bs)
    key = np.stack([b_src, b_off, low], 1)
    steps = bsp.packed_steps(rp, key, pack, on=on)
    _check_steps(steps, rp, key, pack, on=on)
    assert any(len(s) > 1 for _, s in steps)
    for _, step in steps:  # one B operand and one rounding flag a step
        assert len({(b_src[t], b_off[t], low[t]) for _, t in step}) == 1
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    stores = (f32(1, cap, bs, bs), f32(1, R_, cu, bs, bs), f32(1, cap, bs, bs), f32(1, R_, cu, bs, bs))
    lin = lambda src, off: np.where(src == 0, off, cap + (src - 1) * cu + off)  # noqa: E731
    A = torch.cat([stores[0][0], stores[1][0].flatten(0, 1)])
    B = torch.cat([stores[2][0], stores[3][0].flatten(0, 1)])
    got = _apply_steps(steps, A, B, lin(a_src, a_off), lin(b_src, b_off), num_out, low=low)
    up = lambda x: torch.from_numpy(np.asarray(x)[None])  # noqa: E731
    want = fl.fused_block_spmm_ref(*stores, up(a_src), up(a_off), up(b_src), up(b_off), up(rp),
                                   num_out, on=up(on), low=up(low), adaptive=True)[0]
    err = (got - want).abs().flatten(1).amax(1).double().numpy()
    bound = _bound(A, B, lin(a_src, a_off), lin(b_src, b_off), rp, live=on)
    assert (err <= bound).all()
    assert not got[[2, 7]].any()
