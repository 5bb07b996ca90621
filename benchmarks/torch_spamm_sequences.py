"""SpAMM on the paper's matrix sequences, on the port: leaf-level vs hierarchical pruning.

The port's mirror of ``benchmarks/spamm_sequences.py``, and the home of the
port's own copy of its three structure generators (``banded``,
``exp_decay``, ``random_offdiag``) and of ``dist_balance.sequences``, the
SP2-ready symmetric form of the three families: values equal the JAX
package's array for array at the same sizes.  The generators take the block
size; :func:`sequences` scales the element-level parameters by ``bs / 16``
so every family keeps the reference's block-level shape (banded half-width
24 elements at bs 16 is 192 at bs 128, exp-decay rate 0.08 becomes 0.01,
random-offdiag block density stays 0.08).

For a range of tolerances tau it compares the two SpAMM symbolic phases:

* ``leaf``          — enumerate every leaf task, then greedily prune
                      (symbolic cost scales with the *full* task list);
* ``hierarchical``  — apply the ||A_node||*||B_node|| bound during the
                      quadtree descent, so pruned subtrees are never
                      enumerated.

Reported per (sequence, tau): symbolic wall time, node pairs visited, tasks
kept/pruned, the returned error bound, and the true ||AB - C||_F (the
numeric phase on the device: the ``block_spmm`` kernel on the card).
Writes ``BENCH_spamm_torch.json``.

Run:  python benchmarks/torch_spamm_sequences.py [--device cpu] [--smoke | --card]
"""

from __future__ import annotations

import time

import numpy as np

import torch_bench

import torch  # noqa: E402
from repro_torch.core import BSMatrix, spamm_symbolic, spgemm_numeric, spgemm_symbolic  # noqa: E402
from repro_torch.core.matrix import _to_numpy, block_frobenius_norms  # noqa: E402
from repro_torch.core.quadtree import morton_sort  # noqa: E402
from repro_torch.core.spgemm import _common_depth  # noqa: E402

#: the reference's size and block size
N, BS = 1024, 16
SMOKE_N = 256
TAUS = (1e-2, 1e-1, 1e0, 1e1)


def _banded_dense(n: int, halfwidth: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo, hi = max(0, i - halfwidth), min(n, i + halfwidth + 1)
        a[i, lo:hi] = rng.standard_normal(hi - lo)
    return a


def _exp_decay_dense(n: int, rate: float, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a *= np.exp(-rate * np.abs(np.subtract.outer(np.arange(n), np.arange(n)))).astype(np.float32)
    return a


def _pruned(a: np.ndarray, bs: int, tol: float) -> np.ndarray:
    """``a`` with the blocks that ``BSMatrix.from_dense(a, bs, tol)`` drops set
    to zero: the dense of that matrix, without building it."""
    m, n = a.shape
    pad = np.zeros((-(-m // bs) * bs, -(-n // bs) * bs), dtype=a.dtype)
    pad[:m, :n] = a
    blocks = pad.reshape(pad.shape[0] // bs, bs, pad.shape[1] // bs, bs).transpose(0, 2, 1, 3)
    blocks[np.sqrt((blocks.astype(np.float64) ** 2).sum(axis=(2, 3))) <= tol] = 0
    return pad[:m, :n]


def _random_offdiag_dense(n: int, density: float, seed: int = 2, bs: int = BS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nb = n // bs
    a = np.zeros((n, n), dtype=np.float32)
    for b in range(nb):
        a[b * bs : (b + 1) * bs, b * bs : (b + 1) * bs] = rng.standard_normal((bs, bs))
    mask = rng.random((nb, nb)) < density
    np.fill_diagonal(mask, False)
    for i, j in zip(*np.nonzero(mask)):
        scale = 10.0 ** rng.uniform(-4, 0)  # widely varying block magnitudes
        a[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = scale * rng.standard_normal((bs, bs))
    return a


def banded(n: int, halfwidth: int, seed: int = 0, *, bs: int = BS, device="cuda") -> BSMatrix:
    return BSMatrix.from_dense(_banded_dense(n, halfwidth, seed), bs, device=device)


#: exp_decay drops the blocks whose Frobenius norm is at most this
EXP_DECAY_PRUNE = 1e-6


def exp_decay(n: int, rate: float, seed: int = 1, *, bs: int = BS, device="cuda") -> BSMatrix:
    """Exponential off-diagonal decay — the electronic-structure regime."""
    return BSMatrix.from_dense(_exp_decay_dense(n, rate, seed), bs, prune_tol=EXP_DECAY_PRUNE,
                               device=device)


def random_offdiag(n: int, density: float, seed: int = 2, *, bs: int = BS,
                   device="cuda") -> BSMatrix:
    """Strong diagonal + sparse random off-diagonal blocks of decaying size."""
    return BSMatrix.from_dense(_random_offdiag_dense(n, density, seed, bs), bs, device=device)


def family_params(bs: int) -> dict:
    """The families' element-level parameters at block size ``bs``: the
    reference's (bs 16) scaled by ``bs / 16``, so the block-level shape stays."""
    scale = bs / BS
    return dict(banded=int(round(24 * scale)), exp_decay=0.08 / scale, random_offdiag=0.08)


def raw_sequences(n: int, bs: int = BS, device="cuda") -> dict[str, BSMatrix]:
    """The three structure families at ``n`` / ``bs`` (``spamm_sequences.main``'s)."""
    p = family_params(bs)
    return {
        "banded": banded(n, p["banded"], bs=bs, device=device),
        "exp-decay": exp_decay(n, p["exp_decay"], bs=bs, device=device),
        "random-offdiag": random_offdiag(n, p["random_offdiag"], bs=bs, device=device),
    }


def sequences(n: int, bs: int = BS, device="cuda") -> dict[str, BSMatrix]:
    """The three families, SP2-ready (symmetric + spread): ``dist_balance.sequences``."""
    p = family_params(bs)
    raw = {  # the dense of each raw_sequences() matrix, built on the host directly
        "banded": lambda: _banded_dense(n, p["banded"]),
        "exp-decay": lambda: _pruned(_exp_decay_dense(n, p["exp_decay"]), bs, EXP_DECAY_PRUNE),
        "random-offdiag": lambda: _random_offdiag_dense(n, p["random_offdiag"], bs=bs),
    }
    return {name: _blocks_of(_sp2_ready(dense_of(), device), bs) for name, dense_of in raw.items()}


def _sp2_ready(a: np.ndarray, device) -> torch.Tensor:
    """``0.2 (a + a^T) / (2 max|a|) + diag(linspace(-1, 1, n))`` as float32,
    computed in float64 on ``device`` with the reference's operations in its
    order (each correctly rounded on the card as on the host)."""
    n = a.shape[0]
    d = torch.from_numpy(a).to(device, torch.float64)
    h = 0.2 * (d + d.T) / (2 * max(float(d.abs().max()), 1e-12))
    del d
    h.diagonal().add_(torch.from_numpy(np.linspace(-1.0, 1.0, n)).to(device))
    return h.to(torch.float32)


def _blocks_of(h: torch.Tensor, bs: int) -> BSMatrix:
    """``BSMatrix.from_dense(h, bs)`` for a dense tensor already on its device:
    the blocks holding a nonzero, in Morton order."""
    m, n = h.shape
    nbr, nbc = -(-m // bs), -(-n // bs)
    pad = h.new_zeros((nbr * bs, nbc * bs))
    pad[:m, :n] = h
    blocks = pad.reshape(nbr, bs, nbc, bs).permute(0, 2, 1, 3)
    rows, cols = np.nonzero(blocks.ne(0).any(dim=3).any(dim=2).cpu().numpy())
    coords = np.stack([rows, cols], axis=1).astype(np.int64)
    coords = coords[morton_sort(coords)]
    idx = torch.from_numpy(coords).to(h.device)
    return BSMatrix(shape=(m, n), bs=bs, coords=coords, data=blocks[idx[:, 0], idx[:, 1]].contiguous())


def eig_bounds(f: BSMatrix) -> tuple[float, float]:
    """The reference's spectral interval: dense host eigenvalues, 0.05 margin."""
    w = np.linalg.eigvalsh(np.asarray(f.to_dense(), np.float64))
    return float(w.min()) - 0.05, float(w.max()) + 0.05


def dense(m: BSMatrix, dtype=None):
    """The dense matrix of a BSMatrix, built on its device."""
    nbr, nbc = m.nblocks
    dtype = dtype or torch.float64
    grid = torch.zeros((nbr, nbc, m.bs, m.bs), dtype=dtype, device=m.device)
    if m.nnzb:
        c = torch.from_numpy(m.coords).to(m.device)
        grid[c[:, 0], c[:, 1]] = m.data.to(dtype)
    return grid.permute(0, 2, 1, 3).reshape(nbr * m.bs, nbc * m.bs)[: m.shape[0], : m.shape[1]]


def leaf_spamm_symbolic(a: BSMatrix, b: BSMatrix, tau: float) -> dict:
    """Flat reference: full enumeration, then greedy leaf pruning."""
    t0 = time.perf_counter()
    tasks = spgemm_symbolic(a.coords, b.coords)
    na = _to_numpy(block_frobenius_norms(a.data)).astype(np.float64)
    nb = _to_numpy(block_frobenius_norms(b.data)).astype(np.float64)
    bound = na[tasks.a_idx] * nb[tasks.b_idx]
    order = np.argsort(bound)
    csum = np.cumsum(bound[order])
    ndrop = int(np.searchsorted(csum, tau, side="right"))
    err = float(csum[ndrop - 1]) if ndrop else 0.0
    dt = time.perf_counter() - t0
    return dict(time_s=dt, visited=tasks.num_tasks, kept=tasks.num_tasks - ndrop,
                pruned=ndrop, err_bound=err)


def hier_spamm_symbolic(a: BSMatrix, b: BSMatrix, tau: float) -> dict:
    depth = _common_depth(a, b)
    ia, ib = a.quadtree_index(depth), b.quadtree_index(depth)  # cached across taus
    t0 = time.perf_counter()
    tasks, err, visited = spamm_symbolic(ia, ib, tau)
    dt = time.perf_counter() - t0
    full = spgemm_symbolic(a.coords, b.coords).num_tasks
    return dict(time_s=dt, visited=visited, kept=tasks.num_tasks,
                pruned=full - tasks.num_tasks, err_bound=err, tasks=tasks)


def true_error(a: BSMatrix, b: BSMatrix, tasks, exact) -> float:
    """||C - AB||_F of the pruned product, in float64 on the device."""
    data = spgemm_numeric(a.data, b.data, tasks)
    c = BSMatrix(shape=(a.shape[0], b.shape[1]), bs=a.bs, coords=tasks.c_coords, data=data)
    return float(torch.linalg.matrix_norm(dense(c) - exact))


def run(n: int, bs: int, dev, taus=TAUS) -> dict:
    """The sweep on the three families; returns the BENCH payload's ``sequences``."""
    out = {}
    for name, a in raw_sequences(n, bs, device=dev).items():
        full = spgemm_symbolic(a.coords, a.coords).num_tasks
        depth = _common_depth(a, a)
        ia = a.quadtree_index(depth)
        _, _, full_visits = spamm_symbolic(ia, ia, 0.0)
        print(f"\n== {name}: n={n} bs={bs} nnzb={a.nnzb} full tasks={full} "
              f"(descent visits {full_visits} node pairs at tau=0) ==")
        print(f"{'tau':>8} | {'leaf t(ms)':>10} {'visited':>9} | "
              f"{'hier t(ms)':>10} {'visited':>9} {'pruned':>8} | "
              f"{'bound':>9} {'true err':>9}")
        da = dense(a)
        exact = da @ da
        del da
        rows = []
        for tau in taus:
            leaf = leaf_spamm_symbolic(a, a, tau)
            hier = hier_spamm_symbolic(a, a, tau)
            err = true_error(a, a, hier.pop("tasks"), exact)
            assert hier["err_bound"] <= tau + 1e-9
            assert err <= hier["err_bound"] + 1e-2
            print(f"{tau:8.0e} | {leaf['time_s']*1e3:10.2f} {leaf['visited']:9d} | "
                  f"{hier['time_s']*1e3:10.2f} {hier['visited']:9d} "
                  f"{hier['pruned']:8d} | {hier['err_bound']:9.2e} {err:9.2e}")
            rows.append(dict(tau=tau, leaf=leaf, hierarchical=hier, true_err=err))
        out[name] = dict(nnzb=a.nnzb, full_tasks=full, full_visits=full_visits, taus=rows)
    return out


def sizes(args) -> tuple[int, int]:
    """``(n, bs)``: a quarter of the reference's size for ``--smoke``, its own, or the card's."""
    if args.card:
        return torch_bench.CARD_N, torch_bench.CARD_BS
    return (SMOKE_N if args.smoke else N), BS


def main(argv=None) -> int:
    args = torch_bench.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = torch_bench.device(args.device)
    n, bs = sizes(args)
    payload = dict(
        meta=dict(n=n, bs=bs, smoke=args.smoke, size=torch_bench.size_name(args),
                  card=torch_bench.card_line(dev),
                  commit=torch_bench.git_commit(), device=dev.type, taus=list(TAUS),
                  params=family_params(bs)),
        sequences=run(n, bs, dev),
    )
    torch_bench.write(payload, "spamm", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
