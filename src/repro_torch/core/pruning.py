"""Sprint-style record pruning (paper §3), ported from `repro.core.pruning`.

When the fraction of rows sitting in CLOSED leaves reaches
`TreeParams.prune_closed_frac`, the driver drops those rows
and filters every row-indexed array.  The presorted and leaf-ordered
layouts are FILTERED, not re-sorted (filtering keeps their order), so the
one-time cost is one pass, the trade-off rule the paper describes.
Dropping any subset of closed rows leaves the trees unchanged, since a
closed row never counts toward a split again; the batched driver drops
only rows closed in EVERY tree of the batch, so each tree's closed set
contains them and each tree's leaf-ordered blocks survive the filter.
Under a mesh engine the drop is rounded down to the row-shard width, so
that n stays divisible by it, and the first `drop` closed rows go.
"""
from __future__ import annotations

import torch


def plan_drop(n: int, closed: int, row_shards: int, frac: float) -> int:
    """How many closed rows to drop (0 = do not prune this level): once
    they reach `frac` of the n rows, all of them rounded down to a
    multiple of `row_shards` (1 on one device), and never all n rows."""
    if n <= 0 or closed <= 0 or closed / n < frac:
        return 0
    drop = closed - closed % row_shards
    return drop if 0 < drop < n else 0


def keep_mask(closed_mask: torch.Tensor, drop: int) -> torch.Tensor:
    """(n,) bool: every row but the first `drop` closed rows (row order)."""
    return ~closed_mask | (torch.cumsum(closed_mask, 0) > drop)


def compact_rows(*, keep: torch.Tensor, leaf_of, ord_idx, sorted_vals,
                 sorted_idx, bin_of, num_cols, cat_cols, stats, w, labels):
    """Filter every row-indexed array of the batched driver down to the
    kept rows.

    keep (n,) bool, the rows kept (`keep_mask`); leaf_of/w (T, n); stats
    (T, n, S); labels (n,); num_cols/cat_cols/bin_of (m, n) column-major
    (bin_of None outside hist mode); ord_idx (T, m, n) (None outside the
    leaf-ordered layout); sorted_vals/sorted_idx (m, n) (None where the
    driver does not read them).  Under the leaf-ordered layout every dropped row sits in each
    tree's leaf-0 prefix, so filtering each (tree, column) order keeps it
    (leaf, value)-sorted; likewise the filtered presort stays sorted.
    Row ids are renumbered to the kept rows.  Returns the filtered
    (leaf_of, ord_idx, sorted_vals, sorted_idx, bin_of, num_cols,
    cat_cols, stats, w, labels); the row count is `keep.sum()`, which the
    caller knows on the host.
    """
    keep_idx = torch.nonzero(keep)[:, 0]
    n_new = int(keep_idx.numel())
    remap = torch.cumsum(keep, 0) - 1

    def filter_order(order):
        """Drop the removed rows from each row of `order`, renumbered."""
        kept = torch.masked_select(order, keep[order.long()])
        return remap[kept.long()].to(order.dtype).reshape(
            order.shape[:-1] + (n_new,))

    if ord_idx is not None:
        ord_idx = filter_order(ord_idx)
    if sorted_idx is not None:
        sorted_vals = torch.masked_select(
            sorted_vals, keep[sorted_idx.long()]).reshape(-1, n_new)
        sorted_idx = filter_order(sorted_idx)
    if bin_of is not None:      # uint16 ids are gathered as their bits
        bits = bin_of.view(torch.int16) if bin_of.dtype == torch.uint16 \
            else bin_of
        bin_of = bits[:, keep_idx].view(bin_of.dtype)
    return (leaf_of[:, keep_idx], ord_idx, sorted_vals, sorted_idx, bin_of,
            num_cols[:, keep_idx], cat_cols[:, keep_idx], stats[:, keep_idx],
            w[:, keep_idx], labels[keep_idx])
