"""Frozen work counts: the device's peaks and the least bytes and operations
each level of a tree needs, for `fit_mfu` and the kernels' roofline shares.

The counts are of what the algorithm's inputs require, whatever implements
them, so that no implementation can read above 100%:

  * only the in-bag rows (bag weight > 0) of the nodes that can split are
    read, and of each such row only the node's candidate columns, at the
    widths the configuration states (float32 values, int32 categories,
    one byte per hist bucket id up to 256 buckets);
  * an exact numeric scan reads a value and a row id per (row, column);
    it cannot be derived from the parent's, so a node's own rows count;
  * a count table (a categorical column's, at that column's OWN arity, or
    a hist column's, at its bins) can be derived as parent − sibling, so
    each pair of siblings counts the smaller sibling's rows twice, never
    more than its own;
  * a row's leaf id, bag weight and label (4 bytes each) count once per
    node;
  * each table cell is written once (4 bytes); an exact scan writes a gain
    and a threshold per candidate column.

Operations: one add per class per (row, column) into a table or a prefix,
and `GAIN_OPS` per scored boundary.  Levels do no matrix products, so the
bytes bound them; a share is the least time over the time measured.
"""
from __future__ import annotations

import re

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ROW_STATE_BYTES = 12            # leaf id, bag weight, label
SCAN_VALUE_BYTES = 8            # float32 value + int32 row id
CAT_VALUE_BYTES = 4             # int32 category
CELL_BYTES = 4                  # float32 class weight
GAIN_OPS = 8                    # scoring one boundary for two classes

# The program's kernels, by the name the device trace gives each launch.
_NS = r"^(?:void\s+)?(?:\(anonymous namespace\)::)?"
KERNELS = {"split_scan": re.compile(_NS + r"ss_\w+"),
           "cat_hist": re.compile(_NS + r"cat_\w+"),
           "feat_hist": re.compile(_NS + r"fh_\w+")}


def bin_bytes(bins: int) -> int:
    return 1 if bins <= 256 else 2


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def level_parts(level: dict, *, m_num: int, arities, mode: str, bins: int,
                classes: int) -> dict:
    """Bytes and operations of one level of one tree, by part.

    `level` is what `reference.forest.walk` returns for one depth: `rows`
    (L,) in-bag rows of each frontier node (siblings adjacent, left then
    right), `active` (L,) and `cand` (L, m) bool.  Returns {part: (bytes,
    ops)} for the parts "split_scan" (exact numeric), "feat_hist" (hist
    numeric tables), "cat_hist" (categorical tables) and "level" (the
    whole level: every part, row state once per node, and the scoring of
    every table).
    """
    rows = np.asarray(level["rows"], np.float64)
    active = np.asarray(level["active"], bool)
    cand = np.asarray(level["cand"], bool) & active[:, None]
    L = rows.shape[0]
    # below the root the frontier is sibling pairs: a table needs only
    # the smaller sibling's rows
    table_rows = np.repeat(rows.reshape(-1, 2).min(1), 2) if L > 1 \
        else rows
    ar = np.asarray(arities, np.float64)
    k_num = cand[:, :m_num].sum(1).astype(np.float64)
    k_cat = cand[:, m_num:].sum(1).astype(np.float64)
    cat_cells = (cand[:, m_num:] * ar[None, :]).sum(1) * classes
    has_num, has_cat = k_num > 0, k_cat > 0
    out = {}
    if mode == "exact":
        num_rows = np.where(has_num, rows, 0.0)
        out["split_scan"] = (
            (num_rows * (k_num * SCAN_VALUE_BYTES + ROW_STATE_BYTES)
             + k_num * 8).sum(),
            (rows * k_num * (classes + GAIN_OPS)).sum())
        hist_cells = np.zeros(L)
    else:
        num_rows = np.where(has_num, table_rows, 0.0)
        hist_cells = k_num * bins * classes
        out["feat_hist"] = (
            (num_rows * (k_num * bin_bytes(bins) + ROW_STATE_BYTES)
             + hist_cells * CELL_BYTES).sum(),
            (table_rows * k_num * classes).sum())
    cat_rows = np.where(has_cat, table_rows, 0.0)
    out["cat_hist"] = (
        (cat_rows * (k_cat * CAT_VALUE_BYTES + ROW_STATE_BYTES)
         + cat_cells * CELL_BYTES).sum(),
        (table_rows * k_cat * classes).sum())
    value_bytes = (num_rows * k_num * (SCAN_VALUE_BYTES if mode == "exact"
                                       else bin_bytes(bins))
                   + cat_rows * k_cat * CAT_VALUE_BYTES)
    state = np.maximum(num_rows, cat_rows) * ROW_STATE_BYTES
    cells = hist_cells + cat_cells
    scan_ops = rows * k_num * (classes + GAIN_OPS) if mode == "exact" \
        else table_rows * k_num * classes
    out["level"] = (
        (value_bytes + state + cells * CELL_BYTES
         + (k_num * 8 if mode == "exact" else 0)).sum(),
        (scan_ops + table_rows * k_cat * classes
         + cells / classes * GAIN_OPS).sum())
    return out


def least_time(levels, part: str, **shape) -> float | None:
    """Least seconds of `part` over a list of walked levels (all trees),
    None where the part had nothing to do."""
    total, seen = 0.0, False
    for lv in levels:
        b, o = level_parts(lv, **shape).get(part, (0.0, 0.0))
        if b or o:
            seen = True
            total += least_seconds(b, o)
    return total if seen else None
