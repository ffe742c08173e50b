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

def _none_to_neg(v_init):
    """The "no earlier in-bag value" sentinel: the reference passes +inf
    (or any non-finite value); the scorers compare against −inf."""
    return torch.where(torch.isfinite(v_init), v_init, NEG)


def scan_supersplit(vals, leaf, w, stats, cand, totals, impurity="gini",
                    task="classification", min_records=1.0, block=None,
                    h_init=None, v_init=None):
    """Alg. 1 over rows in scan order, batched over leading dimensions.

    vals/leaf/w (..., n) in per-column presorted order; stats (..., n, S);
    cand (..., L1) bool (leaf 0 = False); totals (..., L1, S) per-leaf stat
    totals.  Returns (best_gain, best_threshold), each (..., L1).

    `h_init` (..., L1, S) and `v_init` (..., L1) resume the scan where an
    earlier row shard of the presorted order left it: each leaf's stat
    prefix and last in-bag value before this shard (a non-finite v_init
    means none).  `totals` are then the GLOBAL per-leaf totals.

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
    H = (torch.zeros((B, L1, S), dtype=torch.float32, device=dev)
         if h_init is None else h_init.reshape(B, L1, S).to(torch.float32))
    v = (torch.full((B, L1), NEG, dtype=torch.float32, device=dev)
         if v_init is None else _none_to_neg(v_init.reshape(B, L1)))
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
    totals: torch.Tensor | None = None,   # (L+1, S) GLOBAL per-leaf totals
    h_init: torch.Tensor | None = None,   # (L+1, S) earlier shards' prefix
    v_init: torch.Tensor | None = None,   # (L+1,) their last in-bag value
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1 for one column: (best_gain, best_threshold), each (L+1,);
    entry 0 (closed) unused.  Totals default to the column's own in-bag
    per-leaf sums; `h_init`/`v_init` resume a row shard of the presorted
    order (`scan_supersplit`), and such a call must pass global totals."""
    L1 = num_leaves + 1
    if totals is None:
        if h_init is not None:
            raise ValueError("a row-sharded call must pass GLOBAL totals")
        contrib = torch.where((w_sorted > 0)[:, None], stats_sorted, 0.0)
        totals = torch.zeros((L1, stats_sorted.shape[-1]),
                             dtype=torch.float32, device=vals_sorted.device)
        totals.index_add_(0, leaf_sorted.long(), contrib)
    return scan_supersplit(vals_sorted, leaf_sorted, w_sorted, stats_sorted,
                           cand_leaf, totals, impurity, task, min_records,
                           h_init=h_init, v_init=v_init)


# ---------------------------------------------------------------------------
# Numerical — rows in (leaf, value) order: the segment backends
# ---------------------------------------------------------------------------
#
# Both segment scorers work on rows grouped in contiguous leaf blocks, leaf
# ids ascending, values ascending inside a block.  The reference builds
# their scans with `associative_scan`; PyTorch has none, so each scan is
# rebuilt from primitives that give the same bits on any device: 1-D
# prefix sums (on the card a 1-D `cumsum` is one CUB scan, where a scan
# along an inner dimension of a 2-D or 3-D tensor runs a row per thread
# group, or one thread per row along an outer one) and segmented
# reductions over the blocks (`torch.segment_reduce`, order-free max/min).

def _segmented_cummax_exclusive(vals, inbag, start_idx):
    """Max of the in-bag values at earlier rows of the same block, −inf
    where there is none (the paper's v_h before row i).

    vals/inbag (B, n); start_idx (B or 1, n), where each row's block
    starts.  Values ascend inside a block, so that max is the value at the
    last earlier in-bag row: the k-th in-bag position is scattered to slot
    k of a table (one prefix count over the flattened rows), and row i
    reads the slot of the in-bag count before it, compared against its
    block start.
    """
    B, n = vals.shape
    N = B * n
    inb = inbag.reshape(-1)
    count = torch.cumsum(inb, 0)                 # in-bag rows up to i
    pos = torch.arange(N, device=vals.device)
    slot = torch.full((N + 2,), -1, dtype=torch.int64, device=vals.device)
    slot.scatter_(0, torch.where(inb, count, N + 1), pos)  # N+1: unused
    prev = slot[count - inb.long()].view(B, n)   # last in-bag row before i
    start = start_idx + torch.arange(B, device=vals.device)[:, None] * n
    pv = vals.reshape(-1)[prev.clamp(min=0)].view(B, n)
    return torch.where(prev >= start, pv, NEG)


def _segmented_first_max(gain, tau, lengths):
    """Per segment, the largest gain and the threshold of the FIRST row
    that reaches it (scan-order ties, as Alg. 1 breaks them).

    gain/tau (..., n) flattened row-major are the rows of consecutive
    segments of `lengths` rows each.  A segment with no row gets (−inf,
    0); one whose rows all have gain −inf gets its first row's threshold.
    Both reductions (the max, then the min over the positions reaching
    it) are exact in any order.
    """
    g = gain.reshape(-1)
    N = g.numel()
    best = torch.segment_reduce(g, "max", lengths=lengths, unsafe=True,
                                initial=NEG)
    hit = g >= torch.repeat_interleave(best, lengths, output_size=N)
    pos = torch.arange(N, device=g.device, dtype=torch.float64)
    first = torch.segment_reduce(torch.where(hit, pos, float(N)), "min",
                                 lengths=lengths, unsafe=True,
                                 initial=float(N)).long()
    thr = torch.where(first < N, tau.reshape(-1)[first.clamp(max=N - 1)],
                      0.0)
    return best, thr


def _score_leaf_blocks(vals, lf, inbag, stats, cand, start_idx, end_idx,
                       lengths, num_leaves, impurity, task, min_records,
                       totals, h_init=None, v_init=None):
    """The exact supersplit of B rows of n positions in (leaf, value) order.

    vals/inbag (B, n); stats (B, n, S); cand (B, L+1); lf, start_idx,
    end_idx (B or 1, n) — each position's leaf id and its block's first
    and last position (one shared row when every column has the same
    blocks); lengths (B·(L+1),) int64, the rows of each (row, leaf)
    block.  `totals` (B or 1, L+1, S) gives the parent stats per leaf;
    None reduces them from each row's own blocks.  Returns (best_gain,
    best_threshold), each (B, L+1).

    Prefix sums run in float64, one 1-D scan per stat, and are cast:
    classification stats are integer bag counts, exact below 2^53 (in
    float32 they would be exact only below 2^24), and regression sums
    carry float64's rounding, not float32's.  `h_init` (B, L+1, S) and
    `v_init` (B, L+1) resume a row shard (`best_numeric_split_segment`):
    the prefix is added in float64 before the cast.
    """
    B, n = vals.shape
    S = stats.shape[-1]
    L1 = num_leaves + 1
    cnt = count_fn(task)
    acc = torch.where(inbag[..., None], stats, 0.0).double()
    acc = acc.permute(2, 0, 1).contiguous()              # (S, B, n)
    cum_excl = torch.stack([a.reshape(-1).cumsum(0) for a in acc]).view(
        S, B, n) - acc
    sidx = start_idx.expand(B, n).expand(S, B, n)
    left = cum_excl - torch.gather(cum_excl, 2, sidx)
    if h_init is not None:      # the earlier row shards' per-leaf prefix
        hi = h_init.double().permute(2, 0, 1)            # (S, B, L+1)
        left = left + torch.gather(hi, 2, lf.long().expand(B, n).expand(
            S, B, n))
    left = left.to(torch.float32)
    if totals is None:
        eidx = end_idx.expand(B, n).expand(S, B, n)
        parent = (torch.gather(cum_excl, 2, eidx) + torch.gather(acc, 2, eidx)
                  - torch.gather(cum_excl, 2, sidx)).to(torch.float32)
        parent = parent.permute(1, 2, 0)
    else:
        parent = torch.gather(totals, 1,
                              lf.long()[..., None].expand(*lf.shape, S))
    del acc, cum_excl
    left = left.permute(1, 2, 0)                         # (B, n, S) view
    right = parent - left
    pv = _segmented_cummax_exclusive(vals, inbag, start_idx)
    if v_init is not None:      # the earlier row shards' last in-bag value
        pv = torch.maximum(pv, torch.gather(_none_to_neg(v_init), 1,
                                            lf.long().expand(B, n)))
    ok = inbag & torch.gather(cand, 1, lf.long().expand(B, n)) \
        & (vals > pv) & torch.isfinite(pv) \
        & (cnt(left) >= min_records) & (cnt(right) >= min_records)
    # the parent impurity comes from left + right per row (inside
    # split_gain), as the reference computes it, not from the gathered
    # totals: evaluated at another shape, entropy's log could differ in
    # the last ulp
    gain = torch.where(ok, split_gain(left, right, impurity), NEG)
    del left, right, parent, ok
    tau = (vals + pv) * 0.5
    best_s, best_t = _segmented_first_max(gain, tau, lengths)
    return best_s.reshape(B, L1), best_t.reshape(B, L1)


def best_numeric_split_segment(
    vals_sorted: torch.Tensor,   # (..., n) float32, ascending
    leaf_sorted: torch.Tensor,   # (..., n) int in [0, L], 0 = closed
    w_sorted: torch.Tensor,      # (..., n) float32 bag weights
    stats_sorted: torch.Tensor,  # (..., n, S) float32 row stats
    cand_leaf: torch.Tensor,     # (..., L+1) bool
    num_leaves: int,
    impurity: str = "gini",
    task: str = "classification",
    min_records: float = 1.0,
    totals: torch.Tensor | None = None,   # (..., L+1, S) per-leaf totals
    h_init: torch.Tensor | None = None,   # (..., L+1, S) earlier shards
    v_init: torch.Tensor | None = None,   # (..., L+1) earlier shards
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact vectorized supersplit: a stable counting sort by leaf, then
    segmented prefix sums over each leaf's value-ascending block.

    Leading dimensions (columns) batch.  Returns (best_gain,
    best_threshold), each (..., L+1); totals default to each column's own
    in-bag per-leaf sums.  The seed builder's default scorer.

    A row shard of the presorted order resumes where the earlier shards
    left off: `h_init` is each leaf's stat prefix before the shard and
    `v_init` its last in-bag value there (non-finite, the reference's
    +inf, = none), and `totals` must then be the GLOBAL per-leaf totals.
    """
    if totals is None and h_init is not None:
        raise ValueError("a row-sharded call must pass GLOBAL totals")
    lead = vals_sorted.shape[:-1]
    n = vals_sorted.shape[-1]
    S = stats_sorted.shape[-1]
    L1 = num_leaves + 1
    B = math.prod(lead)
    dev = vals_sorted.device
    order = torch.sort(leaf_sorted.reshape(B, n), dim=-1,
                       stable=True).indices     # leaves contiguous, values
    lf = torch.gather(leaf_sorted.reshape(B, n).long(), 1, order)
    a = torch.gather(vals_sorted.reshape(B, n), 1, order)
    w = torch.gather(w_sorted.reshape(B, n), 1, order)
    st = torch.gather(stats_sorted.reshape(B, n, S), 1,
                      order[..., None].expand(B, n, S))
    seg = lf + torch.arange(B, device=dev)[:, None] * L1
    lengths = torch.bincount(seg.reshape(-1), minlength=B * L1)
    ends = lengths.cumsum(0)
    base = torch.arange(B, device=dev)[:, None] * n
    end_idx = ends[seg] - 1 - base
    start_idx = (ends - lengths)[seg] - base
    if totals is not None:
        totals = totals.reshape(B, L1, S)
    g, t = _score_leaf_blocks(
        a, lf, (w > 0) & (lf > 0), st, cand_leaf.reshape(B, L1), start_idx,
        end_idx, lengths, num_leaves, impurity, task, min_records, totals,
        h_init=None if h_init is None else h_init.reshape(B, L1, S),
        v_init=None if v_init is None else v_init.reshape(B, L1))
    return g.reshape(lead + (L1,)), t.reshape(lead + (L1,))


def best_numeric_split_leaf_ordered(
    vals: torch.Tensor,          # (m, n) float32, (leaf, value)-sorted rows
    lf_pos: torch.Tensor,        # (n,) int leaf id PER POSITION (shared)
    inbag: torch.Tensor,         # (m, n) bool: w > 0 & leaf open, per column
    stats: torch.Tensor,         # (m, n, S) row stats in leaf order
    cand_leaf: torch.Tensor,     # (m, L+1) bool
    num_leaves: int,
    impurity: str = "gini",
    task: str = "classification",
    min_records: float = 1.0,
    totals: torch.Tensor | None = None,     # (L+1, S) shared per-leaf totals
    row_counts: torch.Tensor | None = None,  # (L+1,) rows per leaf (all rows)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact all-columns supersplit over rows already in leaf order.

    Every column holds the same multiset of rows counting-sorted by the
    same leaf ids, so the block structure is column-independent: `lf_pos`
    is the one leaf-of-position array shared by all columns, and each
    block's first and last position follow from the one `row_counts`
    histogram (gathers, no per-column sort).  When `totals` is None the
    per-leaf totals are reduced from each column's own rows; passing the
    level's shared totals saves that — exact for classification, whose
    stats are integer bag counts.  Returns (best_gain, best_threshold),
    each (m, L+1).
    """
    L1 = num_leaves + 1
    lf = lf_pos.long()
    rc = torch.bincount(lf, minlength=L1) if row_counts is None \
        else row_counts.long()
    ends = rc.cumsum(0)
    end_idx = (ends - 1)[lf][None]
    start_idx = (ends - rc)[lf][None]
    return _score_leaf_blocks(
        vals, lf[None], inbag, stats, cand_leaf, start_idx, end_idx,
        rc.repeat(vals.shape[0]), num_leaves, impurity, task, min_records,
        None if totals is None else totals[None])


# ---------------------------------------------------------------------------
# Numerical — PLANET-style histogram (approximate) mode
# ---------------------------------------------------------------------------

def _prefix_cuts(table, task):
    """(left, right) stats of the cuts after each position but the last
    along axis -2 of `table` (..., K, S), in that axis's order.  The
    totals are the last prefix.  Regression's float stats accumulate in
    float64 in that order (as the CPU's float32 `cumsum` already does;
    CUDA's accumulates in float32), so every device rounds them alike;
    class counts are exact in any order."""
    prefix = (table.double().cumsum(-2).to(table.dtype)
              if task == "regression" else table.cumsum(-2))
    left = prefix[..., :-1, :]
    return left, prefix[..., -1:, :] - left


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
    left, right = _prefix_cuts(table, task)                 # cut after bin b
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
    subtraction (derive-leaf rows mapped to 0).  Sums in the stats'
    dtype.  The plain version of the `feat_hist` kernel, and the
    reference's jnp twin of its Pallas kernel with the tree axis written
    out.
    """
    T, n = slots.shape
    m = bin_of.shape[0]
    S = stats.shape[-1]
    W = num_slots + 1
    dev = bin_of.device
    inbag = (w > 0) & (slots > 0)
    contrib = torch.where(inbag[..., None], stats,
                          stats.new_zeros(()))                  # (T, n, S)
    base = (torch.arange(T * m, device=dev).reshape(T, m, 1) * W
            + slots.long()[:, None, :]) * num_bins            # (T, m, n)
    flat = (base + presort.bin_ids(bin_of).long()[None]).reshape(-1)
    table = torch.zeros((T * m * W * num_bins, S), dtype=stats.dtype,
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
    table per open leaf, one flat scatter per column, summed in the
    stats' dtype.
    """
    T, n = leaf_of.shape
    m = x.shape[0]
    S = stats.shape[-1]
    L1 = num_leaves + 1
    inbag = (w > 0) & (leaf_of > 0)
    contrib = torch.where(inbag[..., None], stats,
                          stats.new_zeros(())).reshape(T * n, S)
    tree_base = (torch.arange(T, device=x.device) * (L1 * arity))[:, None]
    out = torch.zeros((T, m, L1 * arity, S), dtype=stats.dtype,
                      device=x.device)
    for j in range(m):
        flat = tree_base + leaf_of.long() * arity + x[j].long()[None]
        tab = torch.zeros((T * L1 * arity, S), dtype=stats.dtype,
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
    tc = cnt(table)                                         # (..., L+1, V)
    col = -1 if task == "classification" else 1
    metric = table[..., col] / tc.clamp(min=1e-12)
    metric = torch.where(tc > 0, metric, float("inf"))
    order = torch.argsort(metric, dim=-1, stable=True)
    sorted_table = torch.gather(
        table, -2, order[..., None].expand(table.shape))
    left, right = _prefix_cuts(sorted_table, task)         # cut after pos v
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
