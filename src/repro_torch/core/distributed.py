"""DRF distribution over a `launch.mesh.Mesh` of processes, ported from
`repro.core.distributed`.

The mesh engines live in `repro_torch.core.level.sharded` as
`SplitEngine`s, which plug into the one level plan local training uses,
so sharded training keeps the tree batch, early finish and pruning of
`tree.build_forest`.  This module keeps the reference's factory entry
points (each returns an engine) and the two pieces that never were
engines: the 1-bit condition broadcast and the one-level step.

Topology, as the reference maps the paper's workers:

  * "model" axis = the splitters: columns sharded over it;
  * "data" axis  = row shards: ranges of the presorted order for the exact
    engine, plain row order for the histogram and categorical engines;
  * partial supersplit merge = the gains all_gather / the tables'
    all-reduce (the paper's tree builder comparing the splitters'
    answers);
  * condition evaluation = one bit per row summed over "model", where
    only the owner of the winning column contributes (the paper's "Dn
    bits in D allreduce" per tree).
"""
from __future__ import annotations

import torch

from repro_torch.core import splits
from repro_torch.core.level.sharded import (ShardedCategorical,
                                            ShardedExactNumeric,
                                            ShardedHistNumeric)

__all__ = ["ShardedCategorical", "ShardedExactNumeric", "ShardedHistNumeric",
           "drf_level_step_fn", "make_2d_sharded_supersplit",
           "make_categorical_sharded_supersplit",
           "make_column_sharded_supersplit", "make_hist_sharded_supersplit",
           "make_sharded_evaluate"]


def make_column_sharded_supersplit(mesh, feature_axis: str = "model"):
    """Exact engine, columns sharded over `feature_axis`, rows replicated:
    the paper's splitter memory layout."""
    return ShardedExactNumeric(mesh=mesh, feature_axis=feature_axis,
                               row_axis=None)


def make_2d_sharded_supersplit(mesh, feature_axis: str = "model",
                               row_axis: str = "data",
                               backend: str = "segment"):
    """Exact engine with both axes sharded: row shards resume the presorted
    scan from the earlier shards' all_gathered state
    (`level.sharded.ShardedExactNumeric`)."""
    return ShardedExactNumeric(mesh=mesh, feature_axis=feature_axis,
                               row_axis=row_axis, backend=backend)


def make_hist_sharded_supersplit(mesh, feature_axis: str = "model",
                                 row_axis="data"):
    """Histogram engine for `split_mode="hist"`: per-shard (bin × stat)
    tables merged by one all-reduce a level."""
    return ShardedHistNumeric(mesh=mesh, feature_axis=feature_axis,
                              row_axis=row_axis)


def make_categorical_sharded_supersplit(mesh, feature_axis: str = "model",
                                        row_axis="data"):
    """Categorical table engine under the mesh (order-free all-reduce
    merge); m_cat must be divisible by the feature-axis size."""
    return ShardedCategorical(mesh=mesh, feature_axis=feature_axis,
                              row_axis=row_axis)


def make_sharded_evaluate(mesh, feature_axis: str = "model"):
    """Winning-condition evaluation (Alg. 2 steps 5 and 7): the owner of
    each row's winning column computes its bit, and a sum over
    `feature_axis` spreads it to every rank (n bits a level, the paper's
    Table 1 network row for DRF).

    The returned fn(num_cols (m_num, n), leaf_of (n,), feat_of_leaf
    (L+1,), thr_of_leaf (L+1,), m_num) -> (n,) bool (True = left) reads
    only this rank's block of the columns."""

    def fn(num_cols, leaf_of, feat_of_leaf, thr_of_leaf, m_num):
        cs = mesh.shard(int(m_num), feature_axis, "m_num (numeric columns)")
        cols = num_cols[cs]
        lf = leaf_of.long()
        f = feat_of_leaf.long()[lf]                       # global column id
        mine = (f >= cs.start) & (f < cs.stop)
        j = (f - cs.start).clamp(0, cols.shape[0] - 1)
        x = cols.reshape(-1)[j * cols.shape[1]
                             + torch.arange(lf.shape[0], device=lf.device)]
        bit = (mine & (x <= thr_of_leaf[lf])).to(torch.uint8)
        return mesh.all_reduce(bit, feature_axis) > 0

    return fn


def drf_level_step_fn(mesh, *, num_leaves: int, num_classes: int,
                      impurity: str = "gini", backend: str = "segment",
                      feature_axis: str = "model", row_axis: str = "data"):
    """One depth level of DRF (Alg. 2 step 3) as one call.

    step(sorted_vals, sorted_idx (m, n), leaf_of, labels, w (n,), cand
    (m, L+1)) -> (best_feat (L+1,) int32, best_gain, best_thr): the 2-D
    sharded supersplit, then the winner per leaf."""
    sup = make_2d_sharded_supersplit(mesh, feature_axis, row_axis, backend)

    def step(sorted_vals, sorted_idx, leaf_of, labels, w, cand):
        stats = splits.row_stats(labels, w, num_classes, "classification")
        gains, thr = sup(sorted_vals, sorted_idx, leaf_of, w, stats, cand,
                         num_leaves, impurity, "classification", 1.0)
        best_feat = gains.argmax(0)                         # (L+1,)
        best_gain = gains.max(0).values
        best_thr = torch.gather(thr, 0, best_feat[None])[0]
        return best_feat.to(torch.int32), best_gain, best_thr

    return step
