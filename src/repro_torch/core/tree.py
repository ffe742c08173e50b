"""Level-by-level decision tree builders (paper Alg. 2) + flat tree arrays,
ported from `repro.core.tree` (exact mode, in memory).

The tree builder is the control plane (host Python, like the paper's tree
builder workers, which never touch the dataset); the per-level supersplit
search and condition evaluation are the data plane
(`repro_torch.core.level`).  All nodes of a depth are split together, so
the dataset is scanned once per candidate feature per LEVEL.

  * `build_forest` — a whole batch of trees per level step (explicit tree
    axis), one small per-leaf struct fetched per level;
  * `build_tree` — a one-tree `build_forest` (the reference asserts the
    two are bit-identical, so the port defines one by the other).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import bagging, class_list, prng, splits
from repro_torch.core.level.engines import LevelInputs, SplitEngine
from repro_torch.core.level.plan import (_fused_level_step_batched,
                                         _leaf_totals, _pad_leaves, make_plan)


# ---------------------------------------------------------------------------
# Hyper-parameters & flat tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeParams:
    """The reference's fields and defaults.  This slice of the port
    trains `split_mode="exact"` with `backend="kernel"` or `"scan"` (or
    `"segment"` when there are no numeric columns); the rest raises
    NotImplementedError naming its ROADMAP item."""
    max_depth: int = 20
    min_records: float = 1.0        # paper: "minimum number of records in a leaf"
    num_candidates: Optional[int] = None  # m' (None = ceil(sqrt(m)))
    impurity: str = "gini"          # gini | entropy | variance
    task: str = "classification"
    backend: str = "segment"        # segment | scan | kernel
    split_mode: str = "exact"       # exact | hist
    num_bins: int = 255             # histogram-mode bucket budget per column
    hist_subtract: bool = True
    usb: bool = False               # unique set of bagged features per depth (§3.2)
    bagging: str = "poisson"        # poisson | multinomial | none
    leaf_pad: int = 8               # pad open-leaf count (power of two >= this)
    prune_closed_frac: float = 1.0  # Sprint pruning; 1.0 disables it


@dataclasses.dataclass
class Tree:
    """Flat-array decision tree (numpy, host-side)."""
    feature: np.ndarray        # (N,) int32; -1 = leaf
    threshold: np.ndarray      # (N,) float32 (numeric nodes)
    is_cat: np.ndarray         # (N,) bool
    cat_mask: np.ndarray       # (N, max_arity) bool; True -> go LEFT
    children: np.ndarray       # (N, 2) int32 [left, right]
    value: np.ndarray          # (N, C) class distribution / (N, 1) mean
    n_node: np.ndarray         # (N,) in-bag weight reaching the node
    gain: np.ndarray           # (N,) split gain (0 for leaves)
    depth: np.ndarray          # (N,) int32
    m_num: int
    task: str

    @property
    def num_nodes(self) -> int:
        return len(self.feature)

    @property
    def num_leaves(self) -> int:
        return int((self.feature < 0).sum())

    @property
    def max_depth_reached(self) -> int:
        return int(self.depth.max()) if self.num_nodes else 0

    def predict_raw(self, num, cat, device=None) -> torch.Tensor:
        """(B, C) distributions / (B, 1) means."""
        from repro_torch.core.forest import pack_trees
        return pack_trees([self], device=device).predict_proba(num, cat)


@dataclasses.dataclass
class LevelStats:
    """Per-level complexity counters (paper Table 1)."""
    depth: int
    open_leaves: int
    network_bits_bitmap: int     # the 1-bit-per-sample broadcast
    network_bits_supersplit: int  # partial supersplit payloads (tiny)
    class_list_bits: int         # n * ceil(log2(l+1))
    feature_passes: int          # sequential passes over candidate columns
    rows_scanned: int
    wall_seconds: float          # the batched level step, host fetch included


# ---------------------------------------------------------------------------
# Host-side flat-tree bookkeeping (Alg. 2 step 8)
# ---------------------------------------------------------------------------

class _NodeAccum:
    """Host-side flat-tree accumulator: `build_forest` appends nodes level by
    level and `_assemble_tree` freezes the lists into numpy arrays."""

    def __init__(self, num_classes: int, task: str):
        self.feature: list = []
        self.threshold: list = []
        self.is_cat: list = []
        self.cat_mask: list = []
        self.children: list = []
        self.value: list = []
        self.n_node: list = []
        self.gain: list = []
        self.depth: list = []
        self._C = max(num_classes, 2) if task == "classification" else 1

    def new_node(self, depth: int) -> int:
        self.feature.append(-1)
        self.threshold.append(0.0)
        self.is_cat.append(False)
        self.cat_mask.append(None)
        self.children.append([-1, -1])
        self.value.append(np.zeros(self._C, np.float32))
        self.n_node.append(0.0)
        self.gain.append(0.0)
        self.depth.append(depth)
        return len(self.feature) - 1

    def set_value(self, node: int, totals_row: np.ndarray, count: float,
                  task: str) -> None:
        """Node value from its leaf-totals row (distribution / mean)."""
        self.n_node[node] = float(count)
        if task == "classification":
            tot = max(count, 1e-12)
            self.value[node] = (totals_row / tot).astype(np.float32)
        else:
            wsum = max(totals_row[0], 1e-12)
            self.value[node] = np.array([totals_row[1] / wsum], np.float32)


def _grow_level(acc: _NodeAccum, open_nodes: list, host: dict, L: int,
                m_num: int, depth: int) -> tuple[list, bool]:
    """Alg. 2 step 8 for ONE tree: grow the flat tree from a level struct.

    `host` holds the fetched per-leaf arrays of one tree (best_feat /
    best_gain / thr / mask / will_split, each (Lp+1,)-indexed by leaf id).
    Returns (next level's open node ids, whether any leaf split).
    """
    bf, bg = host["best_feat"], host["best_gain"]
    thr, mask, ws = host["thr"], host["mask"], host["will_split"]
    next_open: list[int] = []
    any_split = False
    for h in range(1, L + 1):
        if not ws[h]:
            continue
        node = open_nodes[h - 1]
        j = int(bf[h])
        any_split = True
        acc.feature[node] = j
        acc.gain[node] = float(bg[h])
        if j < m_num:
            acc.threshold[node] = float(thr[h])
        else:
            acc.is_cat[node] = True
            acc.cat_mask[node] = mask[h].copy()
        lc, rc = acc.new_node(depth + 1), acc.new_node(depth + 1)
        acc.children[node] = [lc, rc]
        next_open.extend([lc, rc])
    return next_open, any_split


def _assemble_tree(acc: _NodeAccum, max_arity, m_num, task) -> Tree:
    N = len(acc.feature)
    cat_mask_arr = np.zeros((N, max_arity), bool)
    for i, cm in enumerate(acc.cat_mask):
        if cm is not None:
            cat_mask_arr[i, :len(cm)] = cm
    return Tree(
        feature=np.asarray(acc.feature, np.int32),
        threshold=np.asarray(acc.threshold, np.float32),
        is_cat=np.asarray(acc.is_cat, bool),
        cat_mask=cat_mask_arr,
        children=np.asarray(acc.children, np.int32),
        value=np.stack(acc.value).astype(np.float32),
        n_node=np.asarray(acc.n_node, np.float32),
        gain=np.asarray(acc.gain, np.float32),
        depth=np.asarray(acc.depth, np.int32),
        m_num=m_num, task=task)


# ---------------------------------------------------------------------------
# The batched forest build
# ---------------------------------------------------------------------------

def _num_candidates(params, m: int) -> int:
    return params.num_candidates or max(
        1, math.isqrt(m) + (0 if math.isqrt(m) ** 2 == m else 1))


def build_forest(
    *,
    num: torch.Tensor, cat: torch.Tensor, labels: torch.Tensor,
    sorted_vals: torch.Tensor, sorted_idx: torch.Tensor,
    arities: tuple[int, ...], num_classes: int,
    params: TreeParams, seed: int, tree_indices,
    collect_stats: bool = False,
    engine: Optional[SplitEngine] = None,
    cat_engine: Optional[SplitEngine] = None,
) -> tuple[list[Tree], list[list[LevelStats]]]:
    """Train a BATCH of trees, one batched level step per depth.

    Args (shapes), all tensors on the device the fit runs on:
      num / cat:     (n, m_num) float32 / (n, m_cat) int32 raw columns (a
                     transposed view of column-major storage is taken as
                     is, without a copy).
      labels:        (n,) int32 class ids or float32 regression targets.
      sorted_vals / sorted_idx: (m_num, n) presorted values / row ids.
      arities:       per categorical column arity, padded to the maximum.
      num_classes:   stat width C for classification; regression uses S = 3.
      params:        TreeParams.  seed/tree_indices: all randomness is a
                     pure function of (seed, tree index) (paper §2.2).
    Per-tree bootstrap weights, PRNG keys and leaf frontiers are stacked on
    a leading tree axis; the frontier is padded to the batch maximum `Lp`
    and trees that finish early are masked through `splittable`.  Each
    tree equals the one `build_tree(..., tree_idx=t)` grows.

    Returns (trees, stats_logs), parallel lists over `tree_indices`.
    """
    if params.prune_closed_frac < 1.0:
        raise NotImplementedError(
            "Sprint pruning (prune_closed_frac < 1) is not ported (ROADMAP)")
    n = int(labels.shape[0])
    m_num = int(sorted_vals.shape[0]) if sorted_vals.numel() else 0
    m_cat = len(arities)
    m = m_num + m_cat
    max_arity = max(arities) if arities else 1
    m_prime = _num_candidates(params, m)
    plan = make_plan(params, m_num=m_num, m_cat=m_cat, max_arity=max_arity,
                     num_classes=num_classes, m_prime=m_prime, engine=engine,
                     cat_engine=cat_engine)
    task = params.task
    dev = labels.device
    tidx = [int(t) for t in tree_indices]
    T = len(tidx)
    assert T >= 1

    num_cols = num.t().contiguous() if m_num else torch.zeros(
        (0, n), dtype=torch.float32, device=dev)
    cat_cols = cat.t().contiguous() if m_cat else torch.zeros(
        (0, n), dtype=torch.int32, device=dev)
    sorted_idx = sorted_idx.to(torch.int32).contiguous()

    # per-tree stacked state: bootstrap weights, stats, PRNG keys
    with record_function("fit.bagging"):
        w = bagging.bag_counts_forest(seed, tidx, n, params.bagging, dev)
        stats = splits.row_stats(labels, w, num_classes, task)   # (T, n, S)
    fkeys = prng.fold_in(prng.prng_key(seed ^ 0x5EED, dev)[None, :],
                         torch.as_tensor(tidx, dtype=torch.int64, device=dev))

    def cnt_np(t):
        return t.sum(-1) if task == "classification" else t[..., 0]

    accs = [_NodeAccum(num_classes, task) for _ in range(T)]
    open_nodes = [[a.new_node(0)] for a in accs]  # per tree: leaf h -> node
    leaf_of = torch.ones((T, n), dtype=torch.int32, device=dev)
    stats_logs: list[list[LevelStats]] = [[] for _ in range(T)]

    totals_np = None                      # (T, width, S), host
    Ls = [1] * T                          # current frontier size per tree
    for depth in range(params.max_depth + 1):
        if max(Ls) == 0:
            break
        Lp = _pad_leaves(max(Ls), params.leaf_pad)   # batch-max frontier

        # carry the leaf totals into the new padding (root: compute once)
        if totals_np is None:
            totals_np = _leaf_totals(leaf_of, stats, w, Lp).cpu().numpy()
        else:
            cur = np.zeros((T, Lp + 1, totals_np.shape[-1]), np.float32)
            k = min(Lp + 1, totals_np.shape[1])
            cur[:, :k] = totals_np[:, :k]
            totals_np = cur
        counts = cnt_np(totals_np)                   # (T, Lp+1)
        for t in range(T):                           # node values
            for h in range(1, Ls[t] + 1):
                accs[t].set_value(open_nodes[t][h - 1], totals_np[t, h],
                                  counts[t, h], task)

        at_max_depth = depth >= params.max_depth
        splittable_p = np.zeros((T, Lp + 1), bool)
        participate = [False] * T
        if not at_max_depth:
            for t in range(T):
                if Ls[t] == 0:
                    continue
                sp = counts[t, 1:Ls[t] + 1] >= 2 * params.min_records
                if sp.any():
                    splittable_p[t, 1:Ls[t] + 1] = sp
                    participate[t] = True
        if not splittable_p.any():
            break

        t_level = time.perf_counter()
        inp = LevelInputs(num_cols=num_cols, cat_cols=cat_cols,
                          labels=labels, sorted_vals=sorted_vals,
                          sorted_idx=sorted_idx, leaf_of=leaf_of, w=w,
                          stats=stats,
                          totals=torch.as_tensor(totals_np, device=dev))
        struct, leaf_of, next_totals = _fused_level_step_batched(
            inp, torch.as_tensor(splittable_p, device=dev), fkeys, depth,
            plan=plan, Lp=Lp)
        with record_function("level.host_fetch"):
            host = {k: v.cpu().numpy() for k, v in struct.items()}
            totals_np = next_totals.cpu().numpy()
        wall = time.perf_counter() - t_level

        ws = host["will_split"]
        Ls_next = [0] * T
        for t in range(T):
            if not participate[t]:
                continue
            L = Ls[t]
            host_t = {k: host[k][t] for k in host}
            next_open, any_split = _grow_level(
                accs[t], open_nodes[t], host_t, L, m_num, depth)
            if collect_stats:
                Lp_t = _pad_leaves(L, params.leaf_pad)
                passes = int(min(m_prime * (1 if params.usb else L), m))
                stats_logs[t].append(LevelStats(
                    depth=depth, open_leaves=L,
                    network_bits_bitmap=int(counts[t, 1:L + 1].sum()),
                    network_bits_supersplit=int(m * (Lp_t + 1) * 64),
                    class_list_bits=class_list.storage_bits(n, L),
                    feature_passes=passes, rows_scanned=n * passes,
                    wall_seconds=wall))
            if any_split:
                open_nodes[t] = next_open
            Ls_next[t] = 2 * int(ws[t, 1:L + 1].sum())
        Ls = Ls_next

    return ([_assemble_tree(a, max_arity, m_num, task) for a in accs],
            stats_logs)


def build_tree(*, tree_idx: int, **kw) -> tuple[Tree, list[LevelStats]]:
    """Train ONE tree: a one-tree `build_forest` (same arguments, with
    `tree_idx` in place of `tree_indices`)."""
    trees, logs = build_forest(tree_indices=[tree_idx], **kw)
    return trees[0], logs[0]
