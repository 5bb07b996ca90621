"""Host seconds of the plan verifier: the port's array form against the JAX package's loops.

    PYTHONPATH=src python benchmarks/torch_verify_speed.py

Builds the p2p plans of the paper's Table 1 at leaf 128 — row 1's
random-blocks structure on 2 workers (N = 100,000, band half-width 3000,
one dense block of 15,716) and row 2's band on 4 workers (N = 200,000) —
with the port's planner, then times ``verify_spgemm_plan`` of both
packages on clones of the same plan (each clone builds its own send-span
memo, as a plan does at cache admission) and checks that both reports are
empty.  Everything runs on the host CPU; the JAX package is imported only
for its verifier (numpy).  Prints one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro.analysis import mutate as jmutate
from repro.analysis import verify as jverify
from repro_torch.analysis import mutate as tmutate
from repro_torch.analysis import verify as tverify
from repro_torch.core.quadtree import morton_sort
from repro_torch.core.schedule import make_spgemm_plan
from repro_torch.core.spgemm import spgemm_symbolic


def table1_coords(n: int, bs: int, hw: int = 3000, block: int | None = None, seed: int = 0):
    """Block coordinates of ``benchmarks/weak_scaling.py``'s band (and, with
    ``block``, its ``random`` family with one dense diagonal block)."""
    nb, hwb = -(-n // bs), -(-hw // bs)
    i = np.arange(nb)
    band = np.concatenate([np.stack([i[(i + d >= 0) & (i + d < nb)], (i + d)[(i + d >= 0) & (i + d < nb)]], 1)
                           for d in range(-hwb, hwb + 1)])
    codes = band[:, 0] * nb + band[:, 1]
    if block is not None:
        gaps = np.random.default_rng(seed).multinomial(n - block, np.ones(2) / 2)
        b0 = int(gaps[0]) // bs
        r = np.arange(b0, min(b0 + -(-block // bs) + 1, nb))
        sq = np.stack(np.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
        codes = np.concatenate([codes, sq[:, 0] * nb + sq[:, 1]])
    codes = np.unique(codes)
    coords = np.stack([codes // nb, codes % nb], 1).astype(np.int64)
    return coords[morton_sort(coords)]


ROWS = {
    "row1_random": dict(n=100_000, workers=2, block=15716),
    "row2_banded": dict(n=200_000, workers=4, block=None),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", nargs="*", default=sorted(ROWS), choices=sorted(ROWS))
    p.add_argument("--bs", type=int, default=128)
    args = p.parse_args(argv)
    for name in args.rows:
        cfg = ROWS[name]
        coords = table1_coords(cfg["n"], args.bs, block=cfg["block"])
        t0 = time.perf_counter()
        tasks = spgemm_symbolic(coords, coords)
        plan = make_spgemm_plan(coords, coords, cfg["workers"], args.bs, tasks=tasks)
        build_s = time.perf_counter() - t0
        port_plan, ref_plan = tmutate.clone_plan(plan), jmutate.clone_plan(plan)
        t0 = time.perf_counter()
        port_report = tverify.verify_spgemm_plan(port_plan)
        port_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_report = jverify.verify_spgemm_plan(ref_plan)
        ref_s = time.perf_counter() - t0
        if port_report or ref_report:
            raise SystemExit(f"{name}: the plan fails verification: {port_report[:1] or ref_report[:1]}")
        print(json.dumps(dict(row=name, n=cfg["n"], workers=cfg["workers"], bs=args.bs,
                              blocks=int(coords.shape[0]), tasks=int(tasks.num_tasks),
                              symbolic_and_plan_build_s=build_s, port_verify_s=port_s,
                              reference_verify_s=ref_s, speedup=ref_s / port_s)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
