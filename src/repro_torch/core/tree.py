"""Level-by-level decision tree builders (paper Alg. 2) + flat tree arrays,
ported from `repro.core.tree` (exact and hist mode in memory, hist mode out
of core).

The tree builder is the control plane (host Python, like the paper's tree
builder workers, which never touch the dataset); the per-level supersplit
search and condition evaluation are the data plane
(`repro_torch.core.level`).  All nodes of a depth are split together, so
the dataset is scanned once per candidate feature per LEVEL.

  * `build_forest` — a whole batch of trees per level step (explicit tree
    axis), one small per-leaf struct fetched per level, the host's book of
    level d−1 overlapping the device's level d;
  * `build_tree` — a one-tree `build_forest` (the reference asserts the
    two are bit-identical, so the port defines one by the other);
  * `build_forest_streamed` — a batch of hist-mode trees from a
    `dataset.RowSource`, one row chunk at a time, with level checkpoints.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import (bagging, checkpoint as checkpoint_lib,
                              class_list, dataset as dataset_lib, presort,
                              prng, pruning, splits)
from repro_torch.core.level.engines import (LegacyFn, LevelInputs,
                                            SplitEngine, resolve_engine)
from repro_torch.core.level.plan import (_fused_level_step_batched,
                                         _leaf_totals, _pad_leaves,
                                         _stream_chunk_step,
                                         _stream_finalize_step,
                                         _stream_score_step, make_plan)
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Hyper-parameters & flat tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeParams:
    """The reference's fields and defaults, all of them trained in memory
    on one device: `split_mode="exact"` with the `segment` (default),
    `scan` or `kernel` backend, and `split_mode="hist"` with any backend,
    with or without `hist_subtract`; Sprint pruning; every bagging mode.
    Bin and category tables always come from the `feat_hist` and
    `cat_hist` kernels (their plain versions on the CPU), whatever the
    backend."""
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
    n_node: np.ndarray         # (N,) float64 in-bag weight reaching the node
                               # (exact: integer class counts past 2^24)
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

    def node_density(self) -> float:
        """Paper §5: #leaves / 2^D for the deepest depth D."""
        d = self.max_depth_reached
        return self.num_leaves / float(2 ** d) if d else 1.0

    def sample_density(self) -> float:
        """Paper §5: the share of in-bag weight reaching depth-D leaves
        (summed in float32, as the reference sums its float32 weights)."""
        d = self.max_depth_reached
        leaves = self.feature < 0
        bottom = leaves & (self.depth == d)
        n_node = self.n_node.astype(np.float32)
        tot = n_node[leaves].sum()
        return float(n_node[bottom].sum() / tot) if tot > 0 else 0.0

    def predict_raw(self, num, cat, device=None) -> torch.Tensor:
        """(B, C) distributions / (B, 1) means."""
        from repro_torch.core.forest import pack_trees
        return pack_trees([self], device=device).predict_proba(num, cat)


@dataclasses.dataclass
class LevelStats:
    """Per-level complexity counters (paper Table 1).

    `wall_seconds` is host time.  In `build_forest` it runs from the
    level's dispatch to its struct being on the host, so it includes the
    previous level's deferred book, which runs while the device works on
    this level; in `build_forest_streamed`, the level's chunk passes,
    score step and struct fetch.
    """
    depth: int
    open_leaves: int
    network_bits_bitmap: int     # the 1-bit-per-sample broadcast
    network_bits_supersplit: int  # partial supersplit payloads (tiny)
    class_list_bits: int         # n * ceil(log2(l+1))
    feature_passes: int          # sequential passes over candidate columns
    rows_scanned: int
    wall_seconds: float          # see the class docstring
    # hist mode: bytes of the level's table payload, m_num·width·B·S f32;
    # under subtraction only the packed build slots (width Lp//2+1 instead
    # of Lp+1) are built
    hist_table_bytes: int = 0
    # classification: the largest class weight of one open leaf of the
    # level (at the root, the largest class's in-bag weight), read from the
    # totals the host already holds: how far past 2^24 (float32's exact
    # integers) the level's counts ran
    max_class_weight: int = 0


# ---------------------------------------------------------------------------
# Host-side flat-tree bookkeeping (Alg. 2 step 8)
# ---------------------------------------------------------------------------

class _NodeAccum:
    """Host-side flat-tree accumulator: `build_forest` appends nodes level by
    level and `_assemble_tree` freezes the lists into numpy arrays."""

    def __init__(self, num_classes: int, task: str):
        (self.feature, self.threshold, self.is_cat, self.cat_mask,
         self.children, self.value, self.n_node, self.gain,
         self.depth) = ([] for _ in range(9))
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
                m_num: int, depth: int, edges_np=None) -> tuple[list, bool]:
    """Alg. 2 step 8 for ONE tree: grow the flat tree from a level struct.

    `host` holds the fetched per-leaf arrays of one tree (best_feat /
    best_gain / thr / will_split, and mask where a categorical split can
    win, each (Lp+1,)-indexed by leaf id).
    `edges_np` ((m_num, B) numpy) is hist mode's threshold decode table:
    the level step reports the winning BIN INDEX, and the node records
    `edges[col, cut]`.  Returns (next level's open node ids, whether any
    leaf split).
    """
    bf, bg = host["best_feat"], host["best_gain"]
    thr, mask, ws = host["thr"], host.get("mask"), host["will_split"]
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
            acc.threshold[node] = float(
                thr[h] if edges_np is None else edges_np[j, int(thr[h])])
        else:
            acc.is_cat[node] = True
            acc.cat_mask[node] = mask[h].copy()
        lc, rc = acc.new_node(depth + 1), acc.new_node(depth + 1)
        acc.children[node] = [lc, rc]
        next_open.extend([lc, rc])
    return next_open, any_split


def _child_maps(ws, kc, L, Lp_next):
    """The next level's subtraction maps from this level's split bitmap.

    ws (Lp+1,) bool: which leaves split; kc (2·Lp+1,) int: row counts of
    the new child leaves (the level struct's key_counts).  Returns
    (parent_of, sib_of, slot_of), each (Lp_next+1,) int32 indexed by the
    NEW leaf ids: parent and sibling per child, and the packed build slot
    — given to the SMALLER child of each split (ties: left), 0 for the
    derive sibling.  Build slots stay <= Lp_next // 2, the packed table
    width the engines scatter into.
    """
    parent = np.zeros(Lp_next + 1, np.int32)
    sib = np.zeros(Lp_next + 1, np.int32)
    slot = np.zeros(Lp_next + 1, np.int32)
    k = 0
    for h in range(1, L + 1):
        if not ws[h]:
            continue
        k += 1
        lc, rc = 2 * k - 1, 2 * k
        parent[lc] = parent[rc] = h
        sib[lc], sib[rc] = rc, lc
        slot[lc if kc[lc] <= kc[rc] else rc] = k
    return parent, sib, slot


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
        n_node=np.asarray(acc.n_node, np.float64),
        gain=np.asarray(acc.gain, np.float32),
        depth=np.asarray(acc.depth, np.int32),
        m_num=m_num, task=task)


class _Book:
    """The host's book of one tree batch, kept by both forest drivers: per
    tree the flat-tree accumulator, the node of each open leaf (leaf h ->
    node id), the frontier size and the `LevelStats` log (`FIELDS`, what a
    streamed checkpoint stores).  `edges_np`: hist mode's threshold decode
    table, or None where thresholds are floats."""

    FIELDS = ("Ls", "accs", "open_nodes", "stats_logs")

    def __init__(self, T: int, plan, params, edges_np, collect_stats: bool):
        self.plan, self.params, self.edges_np = plan, params, edges_np
        self.collect_stats = collect_stats
        self.accs = [_NodeAccum(plan.num_classes, plan.task) for _ in range(T)]
        self.open_nodes = [[a.new_node(0)] for a in self.accs]
        self.Ls, self.stats_logs = [1] * T, [[] for _ in range(T)]

    def fields(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}

    def restore(self, state: dict) -> None:
        vars(self).update((k, state[k]) for k in self.FIELDS)

    def splittable(self, totals: np.ndarray, at_max_depth: bool):
        """A level's per-leaf in-bag weight (T, Lp+1) from its leaf totals
        (T, Lp+1, S), its splittable mask over the current frontier, and
        per tree whether any of its leaves is splittable."""
        counts = (totals.sum(-1) if self.plan.task == "classification"
                  else totals[..., 0])
        sp = np.zeros(counts.shape, bool)
        if not at_max_depth:
            least = 2 * self.params.min_records
            for t, L in enumerate(self.Ls):
                sp[t, 1:L + 1] = counts[t, 1:L + 1] >= least
        return counts, sp, sp.any(1).tolist()

    def write_values(self, Ls, counts, totals) -> None:
        """Node values of one level's open nodes from its leaf totals."""
        task = self.plan.task
        for acc, nodes, L, cnt, tot in zip(self.accs, self.open_nodes, Ls,
                                           counts, totals):
            for h in range(1, L + 1):
                acc.set_value(nodes[h - 1], tot[h], cnt[h], task)

    def grow(self, depth, Ls, counts, totals, host, gate, n, wall) -> None:
        """Level `depth`'s splits in each tree t with `gate[t]`:
        `_grow_level`, the level's `LevelStats` record (with
        `collect_stats`) and the next level's open nodes."""
        p, params = self.plan, self.params
        m = p.m_num + p.m_cat
        keys = [k for k in ("best_feat", "best_gain", "thr", "mask",
                            "will_split") if k in host]
        for t, L in enumerate(Ls):
            if not gate[t]:
                continue
            next_open, any_split = _grow_level(
                self.accs[t], self.open_nodes[t],
                {k: host[k][t] for k in keys}, L, p.m_num, depth,
                edges_np=self.edges_np)
            if self.collect_stats:
                Lp = _pad_leaves(L, params.leaf_pad)
                passes = int(min(p.m_prime * (1 if p.usb else L), m))
                # under subtraction only the packed build slots are built
                width = Lp // 2 + 1 if p.carries_tables and depth else Lp + 1
                self.stats_logs[t].append(LevelStats(
                    depth=depth, open_leaves=L,
                    network_bits_bitmap=int(counts[t, 1:L + 1].sum()),
                    network_bits_supersplit=int(m * (Lp + 1) * 64),
                    class_list_bits=class_list.storage_bits(n, L),
                    feature_passes=passes, rows_scanned=n * passes,
                    wall_seconds=wall,
                    hist_table_bytes=(p.m_num * width * p.num_bins
                                      * totals.shape[-1] * 4
                                      if params.split_mode == "hist" else 0),
                    max_class_weight=(int(totals[t, 1:L + 1].max())
                                      if p.task == "classification" else 0)))
            if any_split:
                self.open_nodes[t] = next_open

    def next_sizes(self, will_split, participate) -> None:
        """The next frontier per tree: two children per split leaf."""
        self.Ls = [2 * int(will_split[t, 1:L + 1].sum()) if participate[t]
                   else 0 for t, L in enumerate(self.Ls)]


# ---------------------------------------------------------------------------
# The batched forest build
# ---------------------------------------------------------------------------

def _num_candidates(params, m: int) -> int:
    return params.num_candidates or max(
        1, math.isqrt(m) + (0 if math.isqrt(m) ** 2 == m else 1))


def _forest_keys(seed: int, tidx: list, dev) -> torch.Tensor:
    """The per-tree candidate-draw keys (T, 2): fold_in(PRNGKey(seed ^
    0x5EED), t), as the reference draws them."""
    return prng.fold_in(prng.prng_key(seed ^ 0x5EED, dev)[None, :],
                        torch.as_tensor(tidx, dtype=torch.int64, device=dev))


def _fetch_to_host(tensors: dict):
    """Start copying `tensors` to the host; returns a function that waits
    for the copies and gives them as numpy arrays.

    On CUDA each tensor goes into a pinned buffer through a non-blocking
    copy on the current stream, followed by an event, and the waiting
    function synchronizes on that event alone.  On the CPU the tensors are
    on the host already (and pinned memory needs CUDA): the waiting
    function hands them over, in the same order of operations.
    """
    if next(iter(tensors.values())).device.type != "cuda":
        return lambda: {k: v.numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in tensors.items()}
    for k, v in tensors.items():
        host[k].copy_(v, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait():
        copied.synchronize()
        return {k: v.numpy() for k, v in host.items()}
    return wait


def _check_params(params) -> None:
    if params.split_mode not in ("exact", "hist"):
        raise ValueError(f"unknown split_mode {params.split_mode!r} "
                         "(expected 'exact' or 'hist')")
    if params.split_mode == "hist" and params.num_bins < 2:
        raise ValueError("hist mode needs num_bins >= 2")


def _hist_state(num, sorted_vals, params, m_num, bin_of, bin_edges, dev):
    """The hist-mode bucket state on `dev` (None in exact mode).

    Without pre-quantized state, quantize here from the presort, once per
    tree batch.  Pre-quantized state (numpy or tensors, e.g. the output of
    `TabularDataset.quantize`) is validated against `params`: a bin-count
    or shape disagreement raises.
    """
    if params.split_mode != "hist" or not m_num:
        return None, None
    if bin_of is None:
        return presort.quantize(num, sorted_vals, params.num_bins)
    if bin_edges is None:
        raise ValueError("pre-quantized bin_of needs its bin_edges")
    if tuple(bin_edges.shape) != (m_num, params.num_bins):
        raise ValueError(
            f"pre-quantized bucket state disagrees with TreeParams: "
            f"bin_edges shape {tuple(bin_edges.shape)} but the fit has "
            f"m_num={m_num} numeric columns and num_bins="
            f"{params.num_bins} — re-quantize the dataset (e.g. "
            f"TabularDataset.quantize(num_bins={params.num_bins})) or "
            f"set TreeParams(num_bins={bin_edges.shape[-1]})")
    if tuple(bin_of.shape)[0] != m_num or bin_of.shape[-1] != num.shape[0]:
        raise ValueError(
            f"pre-quantized bin_of shape {tuple(bin_of.shape)} does not "
            f"match the dataset ((m_num, n) = ({m_num}, {num.shape[0]}))")
    dt = np.dtype(str(bin_of.dtype).removeprefix("torch."))
    if dt not in (np.uint8, np.uint16):
        raise ValueError(f"bin_of must be packed bucket ids (uint8 or "
                         f"uint16, presort.bin_dtype), got {bin_of.dtype}")
    if np.iinfo(dt).max < params.num_bins - 1:
        raise ValueError(
            f"bin_of dtype {bin_of.dtype} cannot hold num_bins="
            f"{params.num_bins} bucket ids (expected "
            f"{str(presort.bin_dtype(params.num_bins)).removeprefix('torch.')})")
    if not isinstance(bin_of, torch.Tensor):
        bin_of = torch.as_tensor(np.array(bin_of))     # own, writable
    edges = (bin_edges if isinstance(bin_edges, torch.Tensor)
             else torch.as_tensor(np.array(bin_edges, np.float32)))
    return bin_of.to(dev).contiguous(), edges.to(dev, torch.float32)


# level steps `build_forest` has dispatched (the reference's counter)
_BATCH_STEP_CALLS = [0]
# level steps of trees built one at a time with a legacy closure
# (`build_tree(supersplit_fn=...)`), the reference's per-tree builder count
_STEP_CALLS = [0]


def build_forest(
    *,
    num: torch.Tensor, cat: torch.Tensor, labels: torch.Tensor,
    sorted_vals: torch.Tensor, sorted_idx: torch.Tensor,
    arities: tuple[int, ...], num_classes: int,
    params: TreeParams, seed: int, tree_indices,
    collect_stats: bool = False,
    engine: Optional[SplitEngine] = None,
    cat_engine: Optional[SplitEngine] = None,
    bin_of=None, bin_edges=None, _per_tree: bool = False,
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
      bin_of / bin_edges: hist mode's pre-quantized bucket state, (m_num, n)
                     packed ids and (m_num, num_bins) float32 edges (numpy or
                     tensors, e.g. `TabularDataset.quantize`); None quantizes
                     from the presort.
    Per-tree bootstrap weights, PRNG keys and leaf frontiers are stacked on
    a leading tree axis; the frontier is padded to the batch maximum `Lp`
    and trees that finish early are masked through `splittable`.  Each
    tree equals the one `build_tree(..., tree_idx=t)` grows.  Under the
    `segment` backend each (tree, column) keeps its rows in (leaf, value)
    order from level to level (`plan.use_ord`), starting from the presort.
    In hist mode with subtraction (classification), each level's tables
    stay on the device for the next level, which builds only the smaller
    child of every split and derives its sibling as parent − sibling.
    With `prune_closed_frac` < 1, once the rows closed in every tree of
    the batch reach that fraction, they are dropped from every
    row-indexed array before the next level (Sprint pruning, paper §3);
    the trees do not change.

    The host loop is pipelined, as the reference's: once level d is
    dispatched, its struct and next totals start for the host (pinned
    buffers and an event on CUDA, `_fetch_to_host`), level d−1's deferred
    book (node values, `_grow_level`, `LevelStats`; the `level.book`
    range) runs while the device works, and only then does the host wait
    (the `level.host_fetch` range).  Each tree's bookkeeping runs in the
    unpipelined order, so the trees are the same.  A regression level
    step reads its fixed-point scales on the host, so the book overlaps
    only what that step queues after its last read.

    A legacy closure engine (`level.LegacyFn`) is refused: it scores one
    tree at a time, through `build_tree(supersplit_fn=...)`.

    Returns (trees, stats_logs), parallel lists over `tree_indices`.
    """
    _check_params(params)
    n = int(labels.shape[0])
    m_num = int(sorted_vals.shape[0]) if sorted_vals.numel() else 0
    m_cat = len(arities)
    max_arity = max(arities) if arities else 1
    plan = make_plan(params, m_num=m_num, m_cat=m_cat, max_arity=max_arity,
                     num_classes=num_classes,
                     m_prime=_num_candidates(params, m_num + m_cat),
                     engine=engine, cat_engine=cat_engine)
    legacy = isinstance(plan.numeric, LegacyFn)
    if legacy and not _per_tree:
        raise ValueError(
            "legacy supersplit_fn closures are per-tree only; pass a "
            "level.SplitEngine (engine=...) or use build_tree")
    step_calls = _STEP_CALLS if legacy else _BATCH_STEP_CALLS
    task = params.task
    dev = labels.device
    tidx = [int(t) for t in tree_indices]
    T = len(tidx)
    assert T >= 1

    # the bucket state is tree-independent: shared read-only level input
    bin_of, bin_edges = _hist_state(num, sorted_vals, params, m_num, bin_of,
                                    bin_edges, dev)
    edges_np = bin_edges.cpu().numpy() if plan.use_bin_cuts else None
    carries = plan.carries_tables
    use_ord = plan.use_ord
    num_cols = num.t().contiguous() if m_num and not plan.use_bin_cuts \
        else torch.zeros((0, n), dtype=torch.float32, device=dev)
    cat_cols = cat.t().contiguous() if m_cat else torch.zeros(
        (0, n), dtype=torch.int32, device=dev)
    sorted_idx = sorted_idx.to(torch.int32).contiguous()
    # every tree starts at the root, where value order is (leaf, value)
    # order: the leaf-ordered layout starts as the presort, which the
    # level step then reads in its place
    ord_idx = sorted_idx[None].expand(T, m_num, n) if use_ord else None
    if use_ord or params.split_mode == "hist":
        sorted_vals = sorted_idx = None

    # per-tree stacked state: bootstrap weights, stats, PRNG keys
    with record_function("fit.bagging"):
        with record_function("fit.bag_draw"):
            w = bagging.bag_counts_forest(seed, tidx, n, params.bagging, dev)
        stats = splits.row_stats(labels, w, num_classes, task)   # (T, n, S)
    fkeys = _forest_keys(seed, tidx, dev)
    leaf_of = torch.ones((T, n), dtype=torch.int32, device=dev)
    book = _Book(T, plan, params, edges_np, collect_stats)

    def drain(pending):
        """Level d's book, run once level d+1 has been dispatched (each
        tree's order is the unpipelined loop's, so its nodes are too)."""
        with record_function("level.book"):
            book.write_values(*pending[1:4])
            book.grow(*pending)

    totals_np = None                      # (T, width, S), host
    row_counts_np = None                  # (T, width), host (ord layout)
    closed_np = 0                         # rows closed in EVERY tree
    tables = None                         # carried hist tables (device)
    pending = None                        # the previous level's book args
    for depth in range(params.max_depth + 1):
        if max(book.Ls) == 0:
            break
        Lp = _pad_leaves(max(book.Ls), params.leaf_pad)  # batch-max frontier

        # carry the leaf totals into the new padding (root: compute once,
        # and refuse a tree whose in-bag weight the counts cannot hold)
        if totals_np is None:
            totals_np = _leaf_totals(leaf_of, stats, w, Lp,
                                     task).cpu().numpy()
            if task == "classification":
                # integer weights: a float64 sum is exact to 2^53
                plan.check_counts(w.sum(1, dtype=torch.float64).tolist())
            row_counts_np = np.zeros((T, Lp + 1), np.int64)
            row_counts_np[:, 1] = n
        else:
            cur = np.zeros((T, Lp + 1, totals_np.shape[-1]), totals_np.dtype)
            k = min(Lp + 1, totals_np.shape[1])
            cur[:, :k] = totals_np[:, :k]
            totals_np = cur
            cur_rc = np.zeros((T, Lp + 1), np.int64)
            k = min(Lp + 1, row_counts_np.shape[1])
            cur_rc[:, :k] = row_counts_np[:, :k]
            row_counts_np = cur_rc
        # the splittable mask needs this level's totals only; the node
        # values wait for the deferred book
        counts, splittable_p, participate = book.splittable(
            totals_np, depth >= params.max_depth)
        if not splittable_p.any():
            break       # nothing to dispatch: the frontier's values below

        # Sprint pruning (paper §3): drop the rows closed in EVERY tree once
        # they reach the threshold.  It runs before this level's step, so
        # the leaf order is current (the step before max_depth, which skips
        # its partition, never reaches here: the loop breaks above), and
        # its trigger rode home in the previous level's struct.
        drop = pruning.plan_drop(n, closed_np, plan.row_shards,
                                 params.prune_closed_frac)
        if drop:
            with record_function("fit.prune"):
                (leaf_of, ord_idx, sorted_vals, sorted_idx, bin_of, num_cols,
                 cat_cols, stats, w, labels) = pruning.compact_rows(
                    keep=pruning.keep_mask(~(leaf_of > 0).any(0), drop),
                    leaf_of=leaf_of, ord_idx=ord_idx,
                    sorted_vals=sorted_vals, sorted_idx=sorted_idx,
                    bin_of=bin_of, num_cols=num_cols, cat_cols=cat_cols,
                    stats=stats, w=w, labels=labels)
            n -= drop
            row_counts_np[:, 0] -= drop          # dropped rows were leaf 0
            closed_np -= drop

        t_level = time.perf_counter()
        # histogram subtraction: per-tree maps from the previous level's
        # split bitmap + child row counts (smaller child = build slot)
        subtract = bool(carries and tables is not None
                        and pending is not None)
        maps = {}
        if subtract:
            _, Ls_prev, _, _, prev = pending[:5]
            mp = np.zeros((3, T, Lp + 1), np.int32)
            for t in range(T):
                if Ls_prev[t]:
                    mp[:, t] = _child_maps(prev["will_split"][t],
                                           prev["key_counts"][t],
                                           Ls_prev[t], Lp)
            mp = torch.as_tensor(mp, device=dev)
            maps = dict(prev_tables=tables, parent_of=mp[0], sib_of=mp[1],
                        slot_of=mp[2])
        if use_ord:
            maps.update(ord_idx=ord_idx, row_counts=torch.as_tensor(
                row_counts_np, device=dev))
        inp = LevelInputs(num_cols=num_cols, cat_cols=cat_cols,
                          labels=labels, sorted_vals=sorted_vals,
                          sorted_idx=sorted_idx, leaf_of=leaf_of, w=w,
                          stats=stats,
                          totals=torch.as_tensor(totals_np, device=dev),
                          bin_of=bin_of,
                          bin_edges=bin_edges if plan.pass_edges else None,
                          **maps)
        step_calls[0] += 1
        struct, leaf_of, next_totals, tables, ord_idx = \
            _fused_level_step_batched(
                inp, torch.as_tensor(splittable_p, device=dev), fkeys, depth,
                plan=plan, Lp=Lp, subtract=subtract,
                need_partition=depth + 1 < params.max_depth)
        # the pipeline: start the struct's copy to the host, run the
        # PREVIOUS level's book while the device runs this level, and only
        # then wait for the copy
        wait = _fetch_to_host(dict(struct, next_totals=next_totals))
        if pending is not None:
            drain(pending)
        with record_function("level.host_fetch"):
            host = wait()
        wall = time.perf_counter() - t_level
        totals_cur, totals_np = totals_np, host.pop("next_totals")
        closed_np = int(host["closed_rows"])
        if use_ord or carries:
            row_counts_np = host["key_counts"]
        pending = (depth, book.Ls, counts, totals_cur, host, participate, n,
                   wall)
        # the next frontier needs the split bitmap alone
        book.next_sizes(host["will_split"], participate)

    if pending is not None:
        drain(pending)
    if max(book.Ls):        # the loop left through an unsplittable frontier
        with record_function("level.book"):
            book.write_values(book.Ls, counts, totals_np)
    with record_function("fit.assemble"):
        trees = [_assemble_tree(a, max_arity, m_num, task) for a in book.accs]
    return trees, book.stats_logs


def build_tree(*, tree_idx: int, supersplit_fn=None, engine=None,
               **kw) -> tuple[Tree, list[LevelStats]]:
    """Train ONE tree: a one-tree `build_forest` (same arguments, with
    `tree_idx` in place of `tree_indices`).

    `supersplit_fn` is the reference's legacy closure API
    (`level.engines.resolve_engine`); a closure's level steps count in
    `_STEP_CALLS`."""
    engine = resolve_engine(engine, supersplit_fn,
                            hist=kw["params"].split_mode == "hist")
    trees, logs = build_forest(tree_indices=[tree_idx], engine=engine,
                               _per_tree=True, **kw)
    return trees[0], logs[0]


# ---------------------------------------------------------------------------
# The out-of-core streamed forest driver
# ---------------------------------------------------------------------------

class _ChunkStage:
    """One level's staging buffer for row chunks of T trees.

    A chunk's labels, bag weights, leaf ids and bins are packed into one
    host buffer, pinned when the fit runs on CUDA, and go to the device in
    one non-blocking copy; the buffer is refilled only once that copy's
    event has completed.  On the CPU the buffer itself is the chunk the
    steps read.  Rows past a short last chunk are zero: leaf 0 and w = 0,
    so they add nothing.  uint16 bins travel as their int16 bits.
    """

    def __init__(self, T: int, m: int, C: int, num_bins: int, dev):
        self.cuda = dev.type == "cuda"
        wide = num_bins > 256
        sizes = (C * 4, T * C * 4, T * C * 4, m * C * (2 if wide else 1))
        offs = np.cumsum((0,) + sizes).tolist()
        self.host = torch.empty(offs[-1], dtype=torch.uint8,
                                pin_memory=self.cuda)
        self.buf = (torch.empty(offs[-1], dtype=torch.uint8, device=dev)
                    if self.cuda else self.host)

        def views(b):
            bins = b[offs[3]:offs[4]]
            bins = (bins.view(torch.int16).view(m, C) if wide
                    else bins.view(m, C))
            return (bins, b[offs[0]:offs[1]].view(torch.int32),
                    b[offs[1]:offs[2]].view(torch.float32).view(T, C),
                    b[offs[2]:offs[3]].view(torch.int32).view(T, C))

        # host numpy views (filled), device views (read by the steps)
        self.np = [t.numpy() for t in views(self.host)]
        if wide:
            self.np[0] = self.np[0].view(np.uint16)
        bins, *rest = views(self.buf)
        self.dev = (bins.view(torch.uint16) if wide else bins, *rest)
        self.leaf_back = torch.empty((T, C), dtype=torch.int32,
                                     pin_memory=self.cuda)
        self.copied = None

    def load(self, bins, labels, w, leaf) -> tuple:
        """Stage one chunk (bins (m, c); labels (c,); w / leaf (T, c)) and
        start its copy; returns the device tensors (bins, labels, w,
        leaf), each C rows wide."""
        if self.copied is not None:
            self.copied.synchronize()
        c = bins.shape[1]
        for dst, src in zip(self.np, (bins, labels, w, leaf)):
            dst[..., :c] = src
            dst[..., c:] = 0
        if self.cuda:
            self.buf.copy_(self.host, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record()
        return self.dev

    def fetch(self, leaf_c: torch.Tensor, c: int) -> np.ndarray:
        """The chunk's first c leaf ids (T, c) on the host, once the
        device has computed them."""
        if not self.cuda:
            return leaf_c.numpy()[:, :c]
        self.leaf_back.copy_(leaf_c, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return self.leaf_back.numpy()[:, :c]


def _check_streamable(source, params) -> None:
    """The reference's restrictions on a streamed fit, with its errors."""
    if not isinstance(source, dataset_lib.RowSource):
        raise TypeError(
            f"build_forest_streamed needs a dataset.RowSource, got "
            f"{type(source).__name__}: wrap the data with "
            f"ArrayRowSource.from_dataset / MemmapRowSource.build")
    if params.split_mode != "hist":
        raise ValueError(
            "streaming training requires split_mode='hist': exact mode "
            "needs the full presorted order, which cannot be built from a "
            "disk-backed source (exact needs the presort; only hist "
            "streams)")
    if params.task != "classification" or source.task != "classification":
        raise ValueError(
            "streaming training is classification-only: its chunked table "
            "accumulation is exact because classification tables hold "
            "integer-valued counts; regression y-sums could drift")
    if source.m_num < 1:
        raise ValueError("streaming training needs >= 1 numeric column")
    if source.num_bins != params.num_bins:
        raise ValueError(
            f"RowSource was quantized with num_bins={source.num_bins} but "
            f"TreeParams has num_bins={params.num_bins}: rebuild the "
            f"source or match the params")


def build_forest_streamed(
    *,
    source,
    params: TreeParams, seed: int, tree_indices,
    collect_stats: bool = False,
    engine: Optional[SplitEngine] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    device=None,
    _checkpointer=None,
) -> tuple[list[Tree], list[list[LevelStats]]]:
    """Train a batch of hist-mode trees from a `dataset.RowSource`.

    The dataset never exists on the device (nor, from a `MemmapRowSource`,
    in host memory).  Each depth level streams fixed-shape row chunks of
    the bin cache through `_stream_chunk_step`, which replays the previous
    level's winning conditions on the chunk and adds its tables into the
    engine's accumulator (the `feat_hist` kernel on the card); then one
    `_stream_finalize_step` and one `_stream_score_step` pick the level's
    splits from the tables alone.  Leaf ids, labels and bag weights live in
    host (T, n) arrays; each chunk goes to the device through one staging
    buffer (`_ChunkStage`) and its new leaf ids come back before the next
    chunk (one sync per chunk).  Device memory is bounded by the chunk
    size and the table width, not by n: the one n-sized device transient
    is the Poisson or multinomial draw of one tree's bag weights, and with
    `bagging="none"` there is none.

    Restrictions (as the reference's, with its errors): hist mode,
    classification, numeric columns only, and `params.num_bins` equal to
    the source's.  The plan always builds plain tables (no subtraction:
    every chunk is read anyway).  A mesh engine
    (`level.sharded.ShardedHistNumeric`) takes its row shard of every
    chunk, whose width is padded to a multiple of the row-shard count
    (pad rows ride with w = 0 and leaf 0), and merges its accumulator
    once a level.

    The trees equal `build_forest`'s on the same quantized rows, node for
    node, at any chunk size.

    Fault tolerance: with `checkpoint_dir=` the driver writes an atomic
    snapshot of its host state every `checkpoint_every` completed levels
    (`core.checkpoint`), and `resume=True` restarts from the last snapshot
    (or returns a batch that already completed) and grows the trees an
    uninterrupted fit grows.  Chunk reads are retried with backoff on
    transient `OSError`s; a read that keeps failing writes the held
    snapshot and raises `dataset.StreamReadError`.

    Returns (trees, stats_logs), parallel lists over `tree_indices`.
    """
    _check_streamable(source, params)
    dev = resolve_device(device)
    ck = _checkpointer
    if ck is None and checkpoint_dir is not None:
        ck = checkpoint_lib.StreamCheckpointer(checkpoint_dir,
                                               every=checkpoint_every)
        ck.prepare(source=source, params=params, seed=seed, resume=resume)
    if ck is not None and resume:
        done = ck.load_batch(tree_indices)
        if done is not None:            # committed by an earlier run
            return done

    m_num = source.m_num
    plan = make_plan(dataclasses.replace(params, hist_subtract=False),
                     m_num=m_num, m_cat=0, max_arity=1,
                     num_classes=source.num_classes,
                     m_prime=_num_candidates(params, m_num), engine=engine)
    if not plan.numeric.supports_stream:
        raise ValueError(f"engine {plan.numeric!r} does not support chunked "
                         f"accumulation (supports_stream)")
    n = source.n
    tidx = [int(t) for t in tree_indices]
    T = len(tidx)
    if T < 1:
        raise ValueError("build_forest_streamed needs at least one tree")

    # host per-row state: labels, bag weights, leaf ids
    labels_np = np.ascontiguousarray(source.labels, np.int32)
    if params.bagging == "none":
        w_np = np.ones((T, n), np.float32)
    else:
        # one tree's draw on the device at a time, equal to
        # bag_counts_forest's row: the one n-sized device transient
        w_np = np.empty((T, n), np.float32)
        with record_function("fit.bagging"):
            for i, t in enumerate(tidx):
                with record_function("fit.bag_draw"):
                    w_t = bagging.bag_counts(seed, t, n, params.bagging, dev)
                w_np[i] = w_t.cpu().numpy()
                del w_t             # freed before the levels run
    plan.check_counts(w_np.sum(1, dtype=np.float64))
    fkeys = _forest_keys(seed, tidx, dev)

    book = _Book(T, plan, params, source.edges, collect_stats)
    leaf_np = np.ones((T, n), np.int32)
    active = None                   # original row ids of the active rows
    n_act = n
    start_depth = 0
    chunk = max(1, int(source.chunk_size))
    rs = plan.row_shards
    # the previous level's decisions, which the chunk steps replay
    dec = tuple(torch.zeros((T, 1), dtype=dt, device=dev) for dt in
                (torch.int32, torch.float32, torch.int32, torch.int32))

    if ck is not None and resume:
        snap = ck.load_snapshot(tidx)
        if snap is not None:
            # the end-of-level state; labels and bag weights were not
            # stored: they come from the source and the seeded draws as a
            # fresh fit makes them, compacted by the stored row map
            st = checkpoint_lib.unpack_stream_state(
                snap, num_classes=plan.num_classes, task=plan.task)
            start_depth = st["next_depth"]
            book.restore(st)
            leaf_np, active = st["leaf"], st["active"]
            n_act = leaf_np.shape[1]
            if active is not None:
                labels_np = np.ascontiguousarray(labels_np[active])
                w_np = np.ascontiguousarray(w_np[:, active])
            dec = tuple(torch.as_tensor(d, device=dev) for d in st["dec"])

    retry_kw = dict(attempts=source.retry_attempts,
                    base_delay=source.retry_base_delay,
                    max_delay=source.retry_max_delay,
                    sleep=source.retry_sleep)

    for depth in range(start_depth, params.max_depth + 1):
        if max(book.Ls) == 0:
            break
        t_level = time.perf_counter()
        Lp = _pad_leaves(max(book.Ls), params.leaf_pad)
        need_tables = depth < params.max_depth

        # --- chunk pass: reassign, then accumulate ---------------------
        if need_tables:
            acc = plan.numeric.stream_init(T, plan.statics, Lp, dev)
        else:           # the last level: per-leaf stat totals only
            acc = torch.zeros((T, Lp + 1, plan.num_classes),
                              dtype=torch.float32, device=dev)
        # fixed-shape chunks, padded to a row-shard multiple
        C = max(rs, -(-min(chunk, max(n_act, 1)) // rs) * rs)
        stage = _ChunkStage(T, m_num, C, params.num_bins, dev)
        for lo in range(0, n_act, C):
            hi = min(lo + C, n_act)
            try:
                with record_function("stream.read"):
                    block = dataset_lib.read_with_retry(
                        *((source.bins_block, lo, hi) if active is None
                          else (source.bins_take, active[lo:hi])),
                        **retry_kw)
            except dataset_lib.StreamReadError:
                if ck is not None:      # keep the last completed level, so
                    ck.flush()          # that a resume loses only this one
                raise
            with record_function("stream.stage"):
                bins_c, labels_c, w_c, leaf_prev_c = stage.load(
                    block, labels_np[lo:hi], w_np[:, lo:hi],
                    leaf_np[:, lo:hi])
            leaf_c, acc = _stream_chunk_step(
                bins_c, labels_c, w_c, leaf_prev_c, dec, acc, plan=plan,
                Lp=Lp, root=depth == 0, need_tables=need_tables)
            with record_function("stream.fetch"):
                leaf_np[:, lo:hi] = stage.fetch(leaf_c, hi - lo)
        del stage

        # --- finalize: merged tables and per-leaf totals -----------------
        merged, totals_dev = (_stream_finalize_step(acc, plan=plan)
                              if need_tables else (None, acc))
        totals_np = totals_dev.cpu().numpy()
        del acc
        counts, splittable_p, participate = book.splittable(
            totals_np, not need_tables)
        with record_function("level.book"):
            book.write_values(book.Ls, counts, totals_np)
        if not splittable_p.any():
            break                       # the node values are written

        # --- score: one step on the tables alone -------------------------
        res = _stream_score_step(merged, torch.as_tensor(splittable_p,
                                                         device=dev),
                                 fkeys, depth, plan=plan, Lp=Lp)
        del merged
        with record_function("level.host_fetch"):
            host = {k: res[k].cpu().numpy() for k in
                    ("best_feat", "best_gain", "thr", "will_split")}
        dec = (res["feat_of_leaf"], res["thr"], res["new_left"],
               res["new_right"])
        wall = time.perf_counter() - t_level

        with record_function("level.book"):
            # every tree with open leaves logs the level, as the
            # reference's streamed driver does
            book.grow(depth, book.Ls, counts, totals_np, host,
                      [L > 0 for L in book.Ls], n_act, wall)
            book.next_sizes(host["will_split"], participate)

        # --- Sprint pruning on the host: drop rows closed in every tree --
        if params.prune_closed_frac < 1.0 and n_act > 0 and max(book.Ls) > 0:
            open_any = (leaf_np > 0).any(axis=0)
            closed = n_act - int(open_any.sum())
            if closed > 0 and closed / n_act >= params.prune_closed_frac:
                keep = np.flatnonzero(open_any)
                active = keep if active is None else active[keep]
                leaf_np = np.ascontiguousarray(leaf_np[:, keep])
                w_np = np.ascontiguousarray(w_np[:, keep])
                labels_np = np.ascontiguousarray(labels_np[keep])
                n_act = len(keep)

        # the end-of-level state.  The last level's is never written:
        # finish_batch commits the trees right after the loop, and a crash
        # in between resumes from the previous snapshot
        if ck is not None and depth < params.max_depth:
            ck.save_snapshot(tidx, depth, checkpoint_lib.pack_stream_state(
                tidx=tidx, depth=depth, leaf_np=leaf_np, active=active,
                dec=dec, Lpp=Lp, **book.fields()))

    with record_function("fit.assemble"):
        trees = [_assemble_tree(a, 1, m_num, plan.task) for a in book.accs]
    if ck is not None:
        ck.finish_batch(tidx, trees, book.stats_logs)
    return trees, book.stats_logs
