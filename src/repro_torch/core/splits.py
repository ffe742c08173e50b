"""Supersplit search (paper §2.4, Alg. 1), ported from `repro.core.splits`.

A *supersplit* is the set of best splits for every open leaf at the current
depth, found in ONE pass per candidate feature over the presorted rows.

Split scoring works on per-leaf stat accumulators, the same for Random
Forests and GBT:

  * classification: stats[k] = bag_weight * one_hot(label, C)        (S = C)
  * regression:     stats[k] = bag_weight * [1, y, y^2]              (S = 3)

`weighted_impurity(H)` returns N·impurity, so that
gain = imp(parent) − imp(left) − imp(right) is additive.  Every impurity
expression keeps the reference's operation order: for binary gini the
port's gains are then bit-equal to the reference's.

Leaf id convention: 0 = closed (sentinel, paper §2.3), open leaves 1..ℓ.
Functions take optional leading batch dimensions (trees, columns) where
the reference vmapped.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core import presort

NEG = float("-inf")


# ---------------------------------------------------------------------------
# Stats & impurities
# ---------------------------------------------------------------------------

def row_stats(labels: torch.Tensor, weights: torch.Tensor, num_classes: int,
              task: str) -> torch.Tensor:
    """Per-row stat contributions (..., n, S); labels broadcast against
    weights (shared labels, per-tree weights)."""
    if task == "classification":
        classes = torch.arange(num_classes, device=labels.device)
        onehot = (labels.long()[..., None] == classes).to(torch.float32)
        return onehot * weights[..., None]
    y = labels.to(torch.float32)
    w, y = torch.broadcast_tensors(weights, y)
    return torch.stack([w, w * y, w * y * y], dim=-1)


def count_fn(task: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if task == "classification":
        return lambda h: h.sum(-1)
    return lambda h: h[..., 0]


def weighted_impurity(h: torch.Tensor, impurity: str) -> torch.Tensor:
    """N * impurity for a stats accumulator h (..., S). Safe at N=0."""
    if impurity == "gini":
        n = h.sum(-1)
        return n - torch.where(n > 0, (h * h).sum(-1) / n.clamp(min=1e-12),
                               0.0)
    if impurity == "entropy":
        n = h.sum(-1, keepdim=True)
        p = h / n.clamp(min=1e-12)
        plogp = torch.where(h > 0, p * torch.log(p.clamp(min=1e-12)), 0.0)
        return -(n[..., 0] * plogp.sum(-1))
    if impurity == "variance":
        w, wy, wy2 = h[..., 0], h[..., 1], h[..., 2]
        return (wy2 - torch.where(w > 0, wy * wy / w.clamp(min=1e-12), 0.0)
                ).clamp(min=0.0)
    raise ValueError(f"unknown impurity {impurity!r}")


def split_gain(left: torch.Tensor, right: torch.Tensor,
               impurity: str) -> torch.Tensor:
    parent = left + right
    return (weighted_impurity(parent, impurity)
            - weighted_impurity(left, impurity)
            - weighted_impurity(right, impurity))


# ---------------------------------------------------------------------------
# Numerical — the Alg. 1 recurrence, in row blocks
# ---------------------------------------------------------------------------

def scan_supersplit(vals, leaf, w, stats, cand, totals, impurity="gini",
                    task="classification", min_records=1.0, block=None):
    """Alg. 1 over rows in scan order, batched over leading dimensions.

    vals/leaf/w (..., n) in per-column presorted order; stats (..., n, S);
    cand (..., L1) bool (leaf 0 = False); totals (..., L1, S) per-leaf stat
    totals.  Returns (best_gain, best_threshold), each (..., L1).

    The recurrence of the reference's sequential scan, evaluated a block of
    rows at a time as the Pallas `split_scan` kernel does: the exclusive
    per-leaf prefix inside a block is a one-hot `cumsum`, the previous
    in-bag value per leaf an exclusive running max, and the per-leaf stat
    sum H, last value v and running best carry from block to block.  A
    leaf's first in-bag row never splits (v starts at "none"), a split
    needs `min_records` on both sides, and the first row in scan order
    wins ties.  Classification stats are integer-valued, so the prefixes —
    and the gains — are bit-equal to the sequential scan's.
    """
    lead = vals.shape[:-1]
    n = vals.shape[-1]
    L1, S = cand.shape[-1], stats.shape[-1]
    B = math.prod(lead)
    dev = vals.device
    vals = vals.reshape(B, n)
    leaf = leaf.reshape(B, n).long()
    w = w.reshape(B, n)
    stats = stats.reshape(B, n, S)
    cand = cand.reshape(B, L1)
    totals = totals.reshape(B, L1, S)
    cnt = count_fn(task)

    active = (leaf > 0) & (w > 0) & torch.gather(cand, 1, leaf)
    H = torch.zeros((B, L1, S), dtype=torch.float32, device=dev)
    v = torch.full((B, L1), NEG, dtype=torch.float32, device=dev)
    best_s = torch.full((B, L1), NEG, dtype=torch.float32, device=dev)
    best_t = torch.zeros((B, L1), dtype=torch.float32, device=dev)
    lanes = torch.arange(L1, device=dev)
    if block is None:   # rows per block: bounds the (B, b, L1, S) one-hot
        elems = 1 << (25 if dev.type == "cuda" else 22)
        block = max(1, min(n, elems // max(1, B * L1 * S)))
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        b = r1 - r0
        a, h, act = vals[:, r0:r1], leaf[:, r0:r1], active[:, r0:r1]
        st = torch.where(act[..., None], stats[:, r0:r1], 0.0)    # (B, b, S)
        in_leaf = h[..., None] == lanes                            # (B, b, L1)
        oh_act = in_leaf & act[..., None]
        contrib = torch.where(oh_act[..., None], st[:, :, None, :], 0.0)
        local_excl = contrib.cumsum(1) - contrib                   # (B,b,L1,S)
        left_full = H[:, None] + local_excl
        left = torch.gather(left_full, 2,
                            h[:, :, None, None].expand(B, b, 1, S))[:, :, 0]
        right = torch.gather(totals, 1, h[..., None].expand(B, b, S)) - left

        mv = torch.where(oh_act, a[..., None], NEG)                # (B, b, L1)
        inc = torch.cummax(mv, dim=1).values
        pv_local = torch.cat(
            [torch.full((B, 1, L1), NEG, device=dev), inc[:, :-1]], dim=1)
        pv_all = torch.maximum(pv_local, v[:, None, :])
        pv = torch.gather(pv_all, 2, h[..., None])[..., 0]         # (B, b)

        tau = (a + pv) * 0.5
        ok = act & (a > pv) & torch.isfinite(pv) \
            & (cnt(left) >= min_records) & (cnt(right) >= min_records)
        gain = torch.where(ok, split_gain(left, right, impurity), NEG)

        # per-leaf best within the block, first row in scan order on ties
        gmat = torch.where(in_leaf, gain[..., None], NEG)          # (B, b, L1)
        blk_best = gmat.max(1).values
        rows = torch.arange(b, device=dev)[None, :, None]
        first = torch.where(gmat >= blk_best[:, None, :], rows, b).min(1).values
        blk_thr = torch.gather(tau, 1, first.clamp(max=b - 1))
        better = blk_best > best_s
        best_s = torch.where(better, blk_best, best_s)
        best_t = torch.where(better, blk_thr, best_t)

        H = H + contrib.sum(1)
        v = torch.maximum(v, mv.max(1).values)
    return best_s.reshape(lead + (L1,)), best_t.reshape(lead + (L1,))


def best_numeric_split_scan(
    vals_sorted: torch.Tensor,   # (n,) float32, ascending
    leaf_sorted: torch.Tensor,   # (n,) int in [0, L], 0 = closed
    w_sorted: torch.Tensor,      # (n,) float32 bag weights
    stats_sorted: torch.Tensor,  # (n, S) float32 row stats
    cand_leaf: torch.Tensor,     # (L+1,) bool
    num_leaves: int,
    impurity: str = "gini",
    task: str = "classification",
    min_records: float = 1.0,
    totals: torch.Tensor | None = None,   # (L+1, S) per-leaf totals
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1 for one column: (best_gain, best_threshold), each (L+1,);
    entry 0 (closed) unused.  Totals default to the column's own in-bag
    per-leaf sums."""
    L1 = num_leaves + 1
    if totals is None:
        contrib = torch.where((w_sorted > 0)[:, None], stats_sorted, 0.0)
        totals = torch.zeros((L1, stats_sorted.shape[-1]),
                             dtype=torch.float32, device=vals_sorted.device)
        totals.index_add_(0, leaf_sorted.long(), contrib)
    return scan_supersplit(vals_sorted, leaf_sorted, w_sorted, stats_sorted,
                           cand_leaf, totals, impurity, task, min_records)


# ---------------------------------------------------------------------------
# Numerical — PLANET-style histogram (approximate) mode
# ---------------------------------------------------------------------------

def best_numeric_split_histogram(table, cand_leaf, impurity="gini",
                                 task="classification", min_records=1.0):
    """Approximate supersplit: score only the B−1 bucket boundaries.

    table (..., L+1, B, S) per-leaf (bin × stat) tables of a column
    quantized once (`presort.quantize`); cand_leaf (..., L+1) bool.
    Buckets are already value-sorted, so the prefix cuts are scored in
    bucket order, with no reordering (the one difference from
    `best_categorical_split_from_table`); the first best cut wins.
    Returns (best_gain (..., L+1), best_cut (..., L+1) float32): the cut
    is the winning BIN INDEX b (bins <= b go left), which the host decodes
    as `edges[col, b]` when it records the node.  Empty buckets give
    zero-gain duplicate cuts and never win over a populated boundary.
    """
    cnt = count_fn(task)
    totals = table.sum(-2)                                  # (..., L+1, S)
    prefix = table.cumsum(-2)                               # cut after bin b
    left = prefix[..., :-1, :]                              # cuts 0..B-2
    right = totals[..., None, :] - left
    ok = (cnt(left) >= min_records) & (cnt(right) >= min_records) \
        & cand_leaf[..., None]
    gains = torch.where(ok, split_gain(left, right, impurity), NEG)
    best_cut = gains.argmax(-1)                             # first max
    best_gain = torch.gather(gains, -1, best_cut[..., None])[..., 0]
    best_cut = torch.where(torch.isfinite(best_gain), best_cut, 0)
    return best_gain, best_cut.to(torch.float32)


def feature_count_tables(bin_of, slots, w, stats, num_slots, num_bins):
    """Per-slot bin tables of ALL m columns for T trees in ONE scatter
    over the flat (tree, feature, slot, bin) index space.

    bin_of (m, n) packed bucket ids; slots/w (T, n); stats (T, n, S) ->
    (T, m, num_slots+1, B, S).  `slots` are scatter slots, 0 = discard:
    raw leaf ids on the plain path, packed build slots under histogram
    subtraction (derive-leaf rows mapped to 0).  The plain version of the
    `feat_hist` kernel, and the reference's jnp twin of its Pallas kernel
    with the tree axis written out.
    """
    T, n = slots.shape
    m = bin_of.shape[0]
    S = stats.shape[-1]
    W = num_slots + 1
    dev = bin_of.device
    inbag = (w > 0) & (slots > 0)
    contrib = torch.where(inbag[..., None], stats, 0.0)        # (T, n, S)
    base = (torch.arange(T * m, device=dev).reshape(T, m, 1) * W
            + slots.long()[:, None, :]) * num_bins            # (T, m, n)
    flat = (base + presort.bin_ids(bin_of).long()[None]).reshape(-1)
    table = torch.zeros((T * m * W * num_bins, S), dtype=torch.float32,
                        device=dev)
    table.index_add_(0, flat,
                     contrib[:, None].expand(T, m, n, S).reshape(-1, S))
    return table.reshape(T, m, W, num_bins, S)


# ---------------------------------------------------------------------------
# Categorical — count tables + Breiman ordering (paper §2.4)
# ---------------------------------------------------------------------------

def categorical_count_tables(x, leaf_of, w, stats, num_leaves, arity):
    """Count tables of several columns for several trees.

    x (m, n) category values; leaf_of/w (T, n); stats (T, n, S) ->
    (T, m, L+1, V, S): the paper's 'attribute value × class -> count'
    table per open leaf, one flat scatter per column.
    """
    T, n = leaf_of.shape
    m = x.shape[0]
    S = stats.shape[-1]
    L1 = num_leaves + 1
    inbag = (w > 0) & (leaf_of > 0)
    contrib = torch.where(inbag[..., None], stats, 0.0).reshape(T * n, S)
    tree_base = (torch.arange(T, device=x.device) * (L1 * arity))[:, None]
    out = torch.zeros((T, m, L1 * arity, S), dtype=torch.float32,
                      device=x.device)
    for j in range(m):
        flat = tree_base + leaf_of.long() * arity + x[j].long()[None]
        tab = torch.zeros((T * L1 * arity, S), dtype=torch.float32,
                          device=x.device)
        tab.index_add_(0, flat.reshape(-1), contrib)
        out[:, j] = tab.reshape(T, L1 * arity, S)
    return out.reshape(T, m, L1, arity, S)


def categorical_count_table(x_col, leaf_of, w, stats, num_leaves, arity):
    """One column, one tree: (L+1, V, S)."""
    return categorical_count_tables(x_col[None], leaf_of[None], w[None],
                                    stats[None], num_leaves, arity)[0, 0]


def best_categorical_split_from_table(table, cand_leaf, impurity="gini",
                                      task="classification",
                                      min_records=1.0):
    """Breiman ordering + ordered prefix cuts on prebuilt count tables.

    table (..., L+1, V, S); cand_leaf (..., L+1) bool.  Categories are
    ordered per leaf by P(last class | v) (classification) or mean(y | v)
    (regression), empty ones last, with a STABLE sort (equal metrics keep
    category order, as the reference's `jnp.argsort` does); only the V−1
    ordered prefix cuts are scored and the first best cut wins.  Returns
    (best_gain (..., L+1), mask (..., L+1, V) bool), mask True = LEFT.
    """
    arity = table.shape[-2]
    cnt = count_fn(task)
    if arity < 2:
        shape = table.shape[:-2]
        return (torch.full(shape, NEG, device=table.device),
                torch.zeros(shape + (arity,), dtype=torch.bool,
                            device=table.device))
    totals = table.sum(-2)                                  # (..., L+1, S)
    tc = cnt(table)                                         # (..., L+1, V)
    col = -1 if task == "classification" else 1
    metric = table[..., col] / tc.clamp(min=1e-12)
    metric = torch.where(tc > 0, metric, float("inf"))
    order = torch.argsort(metric, dim=-1, stable=True)
    sorted_table = torch.gather(
        table, -2, order[..., None].expand(table.shape))
    prefix = sorted_table.cumsum(-2)                        # cut after pos v
    left = prefix[..., :-1, :]
    right = totals[..., None, :] - left
    ok = (cnt(left) >= min_records) & (cnt(right) >= min_records) \
        & cand_leaf[..., None]
    gains = torch.where(ok, split_gain(left, right, impurity), NEG)
    best_cut = gains.argmax(-1)                             # first max
    best_gain = torch.gather(gains, -1, best_cut[..., None])[..., 0]
    pos = torch.arange(arity, device=table.device)
    in_left_sorted = pos <= best_cut[..., None]
    mask = torch.zeros_like(in_left_sorted).scatter_(-1, order,
                                                     in_left_sorted)
    return best_gain, mask


def best_categorical_split(x_col, leaf_of, w, stats, cand_leaf, num_leaves,
                           arity, impurity="gini", task="classification",
                           min_records=1.0):
    """Best subset split x ∈ C per open leaf for one column:
    (best_gain (L+1,), best_mask (L+1, arity) bool)."""
    table = categorical_count_table(x_col, leaf_of, w, stats, num_leaves,
                                    arity)
    return best_categorical_split_from_table(table, cand_leaf, impurity,
                                             task, min_records)
