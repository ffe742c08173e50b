"""The seed tree builder — the executable specification of Alg. 2, ported
from `repro.core.reference`.

One tree, one step per level piece, with host round-trips in between:
leaf totals → node values → candidate draw → per-column supersplits
(numeric: the `ExactNumeric` backend without the leaf-ordered layout, so
`segment` counting-sorts each presorted column by leaf; categorical:
`splits.best_categorical_split`, one column at a time) → the winner per
leaf on the host → condition evaluation and reassignment → Sprint
pruning by its own, plain row filter.  `tree.build_forest` must grow the
same trees (bit-equal for classification), which makes this builder an
independent check of the batched driver on any device.  Exact mode only:
hist mode has no midpoint-exhaustive specification to match.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import bagging, class_list, prng, splits
from repro_torch.core.level.engines import (ExactNumeric, LevelInputs,
                                            LevelStatics)
from repro_torch.core.level.plan import (INT_COUNTS, _eval_conditions_core,
                                         _leaf_totals, _pad_leaves,
                                         check_in_bag_weight)
from repro_torch.core.tree import (LevelStats, Tree, _assemble_tree,
                                   _NodeAccum, _num_candidates)


def build_tree_reference(
    *,
    num: torch.Tensor, cat: torch.Tensor, labels: torch.Tensor,
    sorted_vals: torch.Tensor, sorted_idx: torch.Tensor,
    arities: tuple[int, ...], num_classes: int,
    params, seed: int, tree_idx: int,
    collect_stats: bool = False,
) -> tuple[Tree, list[LevelStats]]:
    """Train one tree level by level, each piece its own step.

    Arguments are `tree.build_tree`'s (tensors on the device the build
    runs on).  Returns (tree, per-level stats).
    """
    if params.split_mode != "exact":
        raise ValueError("build_tree_reference is the exact-mode "
                         "specification (split_mode='exact')")
    n = int(labels.shape[0])
    m_num = int(sorted_vals.shape[0]) if sorted_vals.numel() else 0
    m_cat = len(arities)
    m = m_num + m_cat
    max_arity = max(arities) if arities else 1
    m_prime = _num_candidates(params, m)
    task = params.task
    dev = labels.device

    w = bagging.bag_counts(seed, tree_idx, n, params.bagging, dev)
    stats = splits.row_stats(labels, w, num_classes, task)
    if task == "classification":    # int32 totals and tables: exact to 2^31
        check_in_bag_weight([w.sum(dtype=torch.float64)], INT_COUNTS,
                            "build_tree_reference")
    cnt = splits.count_fn(task)
    fkey = prng.fold_in(prng.prng_key(seed ^ 0x5EED, dev), tree_idx)
    num_cols = num.t().contiguous() if m_num else torch.zeros(
        (0, n), dtype=torch.float32, device=dev)
    cat_cols = cat.t().contiguous() if m_cat else torch.zeros(
        (0, n), dtype=torch.int32, device=dev)
    sorted_idx = sorted_idx.to(torch.int32)
    engine = ExactNumeric(params.backend)
    statics = LevelStatics(
        m_num=m_num, m_cat=m_cat, max_arity=max_arity,
        num_classes=num_classes, impurity=params.impurity, task=task,
        min_records=params.min_records)

    acc = _NodeAccum(num_classes, task)
    open_nodes = [acc.new_node(0)]           # leaf id h (1-based) -> node id
    leaf_of = torch.ones((n,), dtype=torch.int32, device=dev)
    stats_log: list[LevelStats] = []

    for depth in range(params.max_depth + 1):
        L = len(open_nodes)
        if L == 0:
            break
        Lp = _pad_leaves(L, params.leaf_pad)
        t_level = time.perf_counter()

        # leaf totals -> node values & forced closes
        totals = _leaf_totals(leaf_of[None], stats[None], w[None], Lp,
                              task)[0]                          # (Lp+1, S)
        totals_np = totals.cpu().numpy()
        counts = cnt(totals).cpu().numpy()
        for h, node in enumerate(open_nodes, start=1):
            acc.set_value(node, totals_np[h], counts[h], task)
        at_max_depth = depth >= params.max_depth
        splittable = np.array(
            [counts[h] >= 2 * params.min_records and not at_max_depth
             for h in range(1, L + 1)] + [False] * (Lp - L))
        if not splittable.any():
            break

        # Alg. 2 step 3: query the splitters for the optimal supersplit
        cand = bagging.candidate_features(fkey, depth, Lp, m, m_prime,
                                          params.usb)          # (Lp, m)
        cand = cand & torch.as_tensor(splittable, device=dev)[:, None]
        cand_p = torch.cat([torch.zeros((1, m), dtype=torch.bool,
                                        device=dev), cand]).t()  # (m, Lp+1)
        all_gains = np.full((m, Lp + 1), -np.inf, np.float32)
        all_thr = np.zeros((m, Lp + 1), np.float32)
        all_masks = np.zeros((max(m_cat, 1), Lp + 1, max_arity), bool)
        if m_num:
            inp = LevelInputs(
                num_cols=num_cols, cat_cols=cat_cols, labels=labels,
                sorted_vals=sorted_vals, sorted_idx=sorted_idx,
                leaf_of=leaf_of[None], w=w[None], stats=stats[None],
                totals=totals[None])
            g, t, _ = engine.supersplits(inp, statics, Lp,
                                         cand_p[None, :m_num])
            all_gains[:m_num] = g[0].cpu().numpy()
            all_thr[:m_num] = t[0].cpu().numpy()
        cat_stats = stats.to(torch.int32) if task == "classification" \
            else stats
        for j in range(m_cat):
            g, mask = splits.best_categorical_split(
                cat_cols[j], leaf_of, w, cat_stats, cand_p[m_num + j], Lp,
                max_arity, params.impurity, task, params.min_records)
            all_gains[m_num + j] = g.cpu().numpy()
            all_masks[j] = mask.cpu().numpy()

        # the tree builder merges the partial supersplits (final argmax)
        best_feat = all_gains.argmax(axis=0)                 # (Lp+1,)
        best_gain = all_gains[best_feat, np.arange(Lp + 1)]

        # Alg. 2 step 8: close the leaves with no good condition
        feat_of_leaf = np.zeros(Lp + 1, np.int32)
        thr_of_leaf = np.zeros(Lp + 1, np.float32)
        iscat_of_leaf = np.zeros(Lp + 1, bool)
        mask_of_leaf = np.zeros((Lp + 1, max_arity), bool)
        new_left = np.zeros(Lp + 1, np.int32)
        new_right = np.zeros(Lp + 1, np.int32)
        next_open: list[int] = []
        for h in range(1, L + 1):
            node = open_nodes[h - 1]
            if not splittable[h - 1] or not np.isfinite(best_gain[h]) \
                    or best_gain[h] <= 1e-9:
                continue
            j = int(best_feat[h])
            acc.feature[node] = j
            acc.gain[node] = float(best_gain[h])
            feat_of_leaf[h] = j
            if j < m_num:
                acc.threshold[node] = float(all_thr[j, h])
                thr_of_leaf[h] = all_thr[j, h]
            else:
                acc.is_cat[node] = True
                iscat_of_leaf[h] = True
                acc.cat_mask[node] = all_masks[j - m_num, h].copy()
                mask_of_leaf[h] = all_masks[j - m_num, h]
            lc, rc = acc.new_node(depth + 1), acc.new_node(depth + 1)
            acc.children[node] = [lc, rc]
            next_open.extend([lc, rc])
            new_left[h] = len(next_open) - 1               # 1-based ids
            new_right[h] = len(next_open)

        if collect_stats:
            passes = int(min(m_prime * (1 if params.usb else L), m))
            stats_log.append(LevelStats(
                depth=depth, open_leaves=L,
                network_bits_bitmap=int(counts[1:L + 1].sum()),
                network_bits_supersplit=int(m * (Lp + 1) * 64),
                class_list_bits=class_list.storage_bits(n, L),
                feature_passes=passes, rows_scanned=n * passes,
                wall_seconds=time.perf_counter() - t_level))
        if not next_open:
            break

        # Alg. 2 steps 5-7: evaluate the conditions (1 bit per row) and
        # reassign each row to its child (0 where the leaf closed)
        def dev_t(a):
            return torch.as_tensor(a, device=dev)[None]
        bits = _eval_conditions_core(
            num_cols, cat_cols, leaf_of[None], dev_t(feat_of_leaf),
            dev_t(thr_of_leaf), dev_t(iscat_of_leaf), dev_t(mask_of_leaf),
            m_num)[0]
        lf = leaf_of.long()
        leaf_of = torch.where(
            leaf_of > 0,
            torch.where(bits, dev_t(new_left)[0][lf], dev_t(new_right)[0][lf]),
            0).to(torch.int32)
        open_nodes = next_open

        # Sprint pruning (paper §3): once the closed rows reach the
        # threshold, drop them and FILTER the presort (no re-sort)
        if params.prune_closed_frac < 1.0 and n > 0:
            keep = leaf_of > 0
            n_keep = int(keep.sum())
            if 1.0 - n_keep / n >= params.prune_closed_frac \
                    and 0 < n_keep < n:
                remap = torch.cumsum(keep, 0) - 1
                kept_cols = keep[sorted_idx.long()]           # (m_num, n)
                sorted_idx = remap[sorted_idx.long()[kept_cols]].reshape(
                    m_num, n_keep).to(torch.int32)
                sorted_vals = sorted_vals[kept_cols].reshape(m_num, n_keep)
                num_cols, cat_cols = num_cols[:, keep], cat_cols[:, keep]
                stats, w, labels = stats[keep], w[keep], labels[keep]
                leaf_of = leaf_of[keep]
                n = n_keep

    return _assemble_tree(acc, max_arity, m_num, task), stats_log
