"""The comparison that decides ``correct`` for a block-sparse product.

Two numbers, each against its own limit:

* ``structure_mismatch``: the output blocks that are in one structure and
  not the other, plus any block the result holds twice.  Exact: limit 0.
* ``value_gap``: over the blocks of both, the largest
  ``||got_b - want_b||_F / max(||want_b||_F, median_b ||want_b||_F)``, in
  float64.  The median floor keeps blocks near zero (the band's corners) from
  reading rounding as a fault.  Not finite where a value is not.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _keys(coords: np.ndarray, width: int) -> np.ndarray:
    return coords[:, 0].astype(np.int64) * width + coords[:, 1].astype(np.int64)


def compare(want_coords: np.ndarray, want: torch.Tensor, got_coords: np.ndarray, got_blocks,
            *, held: np.ndarray | None = None, chunk: int = 4096) -> dict:
    """Judge a result against the reference's ``want`` ``[num_out, bm, bn]`` at ``want_coords``.

    ``got_coords`` are the result's block coordinates and ``got_blocks(idx)``
    returns its blocks at the positions ``idx`` (a numpy array) in that
    order, on ``want``'s device.  Where ``held`` is given, only the blocks at
    those positions were kept: the structure is judged whole, the values
    over them.  Returns the two numbers of the module docstring.
    """
    width = int(max(want_coords[:, 1].max(initial=0), got_coords[:, 1].max(initial=0))) + 1
    wk, gk = _keys(want_coords, width), _keys(got_coords, width)
    order = np.argsort(wk, kind="stable")
    wk_sorted = wk[order]
    pos = np.minimum(np.searchsorted(wk_sorted, gk), max(len(wk_sorted) - 1, 0))
    hit = (wk_sorted[pos] == gk) if len(wk_sorted) else np.zeros(len(gk), bool)
    got_idx = np.nonzero(hit)[0]
    want_idx = order[pos[got_idx]]
    distinct = len(np.unique(want_idx))
    mismatch = (len(gk) - distinct) + (len(wk) - distinct)
    if held is not None:
        sel = np.isin(got_idx, held)
        got_idx, want_idx = got_idx[sel], want_idx[sel]
    norms = torch.linalg.matrix_norm(want.double()).cpu().numpy() if len(wk) else np.zeros(0)
    floor = float(np.median(norms)) if len(norms) else 0.0
    gap = 0.0
    for k in range(0, len(got_idx), chunk):
        g = got_blocks(got_idx[k:k + chunk]).double()
        w_i = want_idx[k:k + chunk]
        w = want[torch.from_numpy(w_i).to(want.device)].double()
        diff = torch.linalg.matrix_norm(g - w).cpu().numpy()
        scale = np.maximum(norms[w_i], floor)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(diff == 0, 0.0, diff / scale)
        worst = float(np.max(ratio)) if len(ratio) else 0.0
        if not math.isfinite(worst):
            gap = math.inf
            break
        gap = max(gap, worst)
    return dict(structure_mismatch=int(mismatch), value_gap=gap)
