"""Distributed feature importance (paper goal (5), §1), ported from
`repro.core.importance`.

Mean decrease in impurity is additive over (tree, node) pairs: each
splitter can sum the gains of the splits on ITS columns locally, and one
tiny allreduce of m floats merges the per-feature partial sums, which is
how the paper distributes it.  `mdi_partial` is the per-splitter part
(gains restricted to an owned column range), `mdi_importance` the merged
total.  Both work on the host-side flat trees (numpy), as the reference's
do; `permutation_importance` scores a fitted forest on its own device.
"""
from __future__ import annotations

import numpy as np
import torch


def mdi_importance(trees, m: int) -> np.ndarray:
    """Mean decrease in impurity, normalized to sum 1: (m,) float32."""
    imp = np.zeros(m, np.float64)
    for tr in trees:
        sel = tr.feature >= 0
        np.add.at(imp, tr.feature[sel], tr.gain[sel])
    tot = imp.sum()
    return (imp / tot if tot > 0 else imp).astype(np.float32)


def mdi_partial(trees, m: int, lo: int, hi: int) -> np.ndarray:
    """Per-splitter partial MDI: gains of splits on columns [lo, hi) only.

    The sum over splitters of `mdi_partial` is the unnormalized
    `mdi_importance`: the paper's distributed feature-importance
    decomposition.  Returns (m,) float64."""
    imp = np.zeros(m, np.float64)
    for tr in trees:
        sel = (tr.feature >= lo) & (tr.feature < hi)
        np.add.at(imp, tr.feature[sel], tr.gain[sel])
    return imp


def permutation_importance(forest, ds, metric: str = "accuracy",
                           seed: int = 0, max_rows: int = 4096) -> np.ndarray:
    """Permutation importance on a (sub)sample, the model-agnostic check:
    per column, the accuracy lost when that column's values are shuffled
    among the rows.  The subsample and the shuffles come from numpy's
    generator seeded with `seed`, as the reference draws them.  Returns
    (m,) float32."""
    if metric != "accuracy":
        raise ValueError(f"unknown metric {metric!r} (expected 'accuracy')")
    rng = np.random.default_rng(seed)
    n = min(ds.n, max_rows)
    idx = rng.permutation(ds.n)[:n]
    num = np.asarray(ds.num)[idx]
    cat = np.asarray(ds.cat)[idx]
    y = np.asarray(ds.labels)[idx]

    def score(numx, catx):
        pred = torch.as_tensor(forest.predict(numx, catx)).cpu().numpy()
        return float((pred == y).mean())

    base = score(num, cat)
    out = np.zeros(ds.m, np.float32)
    for j in range(ds.m):
        perm = rng.permutation(n)
        if j < ds.m_num:
            numx = num.copy()
            numx[:, j] = numx[perm, j]
            out[j] = base - score(numx, cat)
        else:
            catx = cat.copy()
            jj = j - ds.m_num
            catx[:, jj] = catx[perm, jj]
            out[j] = base - score(num, catx)
    return out
