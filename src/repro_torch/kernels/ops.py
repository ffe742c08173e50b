"""Level-state adapters around the kernels, ported from `repro.kernels.ops`.

They take the tree builder's state — presorted columns, per-tree leaf ids
and bag weights, shared labels — with an explicit leading tree axis (one
launch covers the whole tree batch, as `pallas_call`'s vmap rule did) and
keep the reference's conventions: leaf 0 and w = 0 rows contribute
nothing, and the stat width comes from the caller (`num_classes`), never
from a device-to-host read of the labels.  The CUDA kernels mask their own
ragged edges, so neither rows nor categories need padding here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import breiman, cat_hist, feat_hist, split_scan


def stat_dim(num_classes: int, task: str) -> int:
    return max(int(num_classes), 2) if task == "classification" else 3


def split_scan_supersplit(sorted_vals, sorted_idx, leaf_of, w, labels, cand,
                          totals, impurity="gini", task="classification",
                          min_records=1.0):
    """All-columns exact supersplit through the `split_scan` kernel.

    sorted_vals/sorted_idx (m, n); leaf_of/w (T, n); labels (n,);
    cand (T, m, L1) bool; totals (T, L1, S) — the level's per-leaf totals
    (int32 class counts, or float32 regression sums), shared by every
    column (exact for classification) instead of being recomputed per
    column.  Returns (gain, thr), each (T, m, L1).
    """
    return split_scan.split_scan(
        sorted_vals.contiguous(), sorted_idx.contiguous(),
        leaf_of.contiguous(), w.contiguous(),
        labels.to(torch.float32).contiguous(), cand.contiguous(),
        totals.contiguous(), impurity=impurity, task=task,
        min_records=min_records)


def categorical_tables(cat_cols, leaf_of, w, labels, *, V, Lp,
                       task="classification", num_classes=2, scales=None,
                       fixed=False):
    """Count tables (T, m_cat, Lp+1, V, S) through the `cat_hist` kernel:
    int32 class counts for classification (the bag weights are integers;
    exact to 2^31), float32 for regression.

    cat_cols (m_cat, n) column-major categories; leaf_of/w (T, n);
    labels (n,).  V is the (max) arity every column's table is padded to.
    Regression only: explicit fixed-point `scales`, and `fixed=True` for
    the int64 sums (`cat_hist.cat_hist`).
    """
    return cat_hist.cat_hist(
        cat_cols.contiguous(), leaf_of.contiguous(), w.contiguous(),
        labels.to(torch.float32).contiguous(), L1=Lp + 1, V=V,
        num_stats=stat_dim(num_classes, task), task=task, scales=scales,
        fixed=fixed)


def feature_tables(bin_of, slots, w, labels, *, B, W,
                   task="classification", num_classes=2, scales=None,
                   fixed=False):
    """Hist-mode tables (T, m, W, B, S) for ALL numeric columns in one row
    pass, through the `feat_hist` kernel.

    bin_of (m, n) packed bucket ids; slots (T, n) scatter slots (0 =
    discard: raw leaf ids on the plain path, packed build slots under
    subtraction); w (T, n); labels (n,); W the slot-axis width.
    `scales`/`fixed` as for `categorical_tables`.
    """
    return feat_hist.feat_hist(
        bin_of.contiguous(), slots.to(torch.int32).contiguous(),
        w.contiguous(), labels.to(torch.float32).contiguous(), W=W, B=B,
        num_stats=stat_dim(num_classes, task), task=task, scales=scales,
        fixed=fixed)


def breiman_splits(tables, cand, impurity="gini", min_records=1.0):
    """The best Breiman split per (tree, column, leaf) of classification
    count tables (T, m_cat, L1, V, S) (int32, as `categorical_tables`
    gives them), through the `breiman` kernel: gains (T, m_cat, L1) and
    left-masks (T, m_cat, L1, V); cand (T, m_cat, L1)."""
    return breiman.breiman(tables.contiguous(), cand.contiguous(),
                           impurity=impurity, min_records=min_records)
