"""LevelPlan: one depth level of Alg. 2 for a whole tree batch, ported
from `repro.core.level.plan`.

A `LevelPlan` composes a numeric and a categorical `SplitEngine` with the
static level config.  `_fused_level_step_batched` runs one level of every
tree in the batch:

    candidate draw → engine supersplits → cross-feature winner argmax →
    condition evaluation (step 5) → leaf reassignment (step 6) → next totals
    (+ the incremental leaf-order partition of the `segment` backend, and
    the carried histogram tables under hist-mode subtraction)

The reference vmapped a per-tree core over the tree axis; here the tree
axis T is written out in every tensor, and the next level's totals are
reduced on the flat (tree, segment) index space in one scatter.  Only the
small per-leaf struct goes back to the host.

Out of core, `tree.build_forest_streamed` runs a level as three steps
instead (`_stream_chunk_step` once per row chunk, then
`_stream_finalize_step` and `_stream_score_step` once), built from the
same candidate draw, condition evaluation, winner and child-id code.

Each part of a level runs inside a `record_function` range named
`level.<part>`, so a `torch.profiler` trace (`chip_smoke.py --profile`)
attributes the level's device time to its parts; outside a profiler the
ranges cost a few microseconds per level.  The forest driver names its
own steps the same way: `fit.forest` around each fit, with `fit.copy_in`,
`fit.presort`, `fit.quantize`, `fit.bagging`, `fit.prune`, `fit.assemble`
and `fit.pack` inside it (`core/forest.py`, `core/tree.py`); the streamed
driver's chunk pass runs in `stream.read`, `stream.stage` and
`stream.fetch`, and its host bookkeeping in `level.book`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core import bagging, presort, splits
from repro_torch.core.level.engines import (CategoricalTable, ExactNumeric,
                                            HistNumeric, LevelInputs,
                                            LevelStatics, SplitEngine)
from repro_torch.kernels.cat_hist import power_of_two_scales

FLOAT_COUNTS = 1 << 24     # float32 holds every integer below this
INT_COUNTS = 1 << 31       # int32 counts hold every integer below this


def check_in_bag_weight(weights, limit: int, what: str) -> None:
    """Raise ValueError where a tree's in-bag weight (`weights`, one number
    a tree) reaches `limit`, the count below which `what`'s class counts
    are exact: a larger tree would get rounded counts and no error."""
    big = max((float(x) for x in weights), default=0.0)
    if big < limit:
        return
    if limit <= FLOAT_COUNTS:
        raise ValueError(
            f"{what} counts classes in float32, exact only below 2^24, but "
            f"a tree of this fit holds an in-bag weight of {big:.0f}: use "
            f"split_mode='exact' with the local engines, which count in "
            f"int32 (ROADMAP.md, Queue N1), or fewer rows a fit")
    raise ValueError(
        f"{what} counts classes in int32, exact only below 2^31, but a tree "
        f"of this fit holds an in-bag weight of {big:.0f}: use fewer rows a "
        f"fit")


def _pad_leaves(L: int, pad: int) -> int:
    """Pad to a power of two (at least `pad`)."""
    return max(pad, 1 << (L - 1).bit_length())


def _leaf_totals(leaf_of, stats, w, Lp, task="classification"):
    """Per-tree per-leaf in-bag stat totals (T, Lp+1, S), one flat scatter.

    Classification stats are integer bag counts: they are summed as int32,
    exact in any order up to 2^31 (a tree's in-bag weight; float32 would
    be exact only below 2^24), and the totals stay int32 for the scorers,
    which convert them to float only where they compute gains.
    Regression stats are floats, and CUDA's atomic order changes their
    sums from run to run; they are summed in 64-bit fixed point instead
    (one power-of-two scale per stat channel, as `cat_hist` does), which
    is exact and associative, so the totals are the same bits on every run
    and on every device.
    """
    T, n = leaf_of.shape
    L1 = Lp + 1
    S = stats.shape[-1]
    inb = (w > 0) & (leaf_of > 0)
    flat = (leaf_of.long()
            + torch.arange(T, device=leaf_of.device)[:, None] * L1
            ).reshape(-1)
    if task == "classification":
        contrib = stats.to(torch.int32).masked_fill_(~inb[..., None], 0)
        out = torch.zeros((T * L1, S), dtype=torch.int32,
                          device=stats.device)
        out.index_add_(0, flat, contrib.reshape(T * n, S))
        return out.reshape(T, L1, S)
    contrib = torch.where(inb[..., None], stats, 0.0).reshape(T * n, S)
    scale = torch.tensor(power_of_two_scales(
        contrib.abs().amax(0).tolist(), n), dtype=torch.float64,
        device=stats.device)
    acc = torch.zeros((T * L1, S), dtype=torch.int64, device=stats.device)
    acc.index_add_(0, flat, torch.round(contrib.double() * scale).long())
    return (acc.double() / scale).to(torch.float32).reshape(T, L1, S)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Engines + static config."""
    numeric: Optional[SplitEngine]
    categorical: Optional[SplitEngine]
    m_num: int
    m_cat: int
    max_arity: int
    num_classes: int
    m_prime: int
    usb: bool
    impurity: str
    task: str
    min_records: float
    num_bins: int = 255
    hist_subtract: bool = True

    @property
    def statics(self) -> LevelStatics:
        return LevelStatics(
            m_num=self.m_num, m_cat=self.m_cat, max_arity=self.max_arity,
            num_classes=self.num_classes, impurity=self.impurity,
            task=self.task, min_records=self.min_records,
            num_bins=self.num_bins)

    @property
    def use_ord(self) -> bool:
        """The driver keeps the incremental (leaf, value) row order for
        this plan (the exact `segment` backend)."""
        return bool(self.m_num) and self.numeric is not None \
            and self.numeric.uses_ord

    @property
    def use_bin_cuts(self) -> bool:
        """The numeric engine reports BIN INDICES, not float thresholds:
        conditions are evaluated on the bit-packed bin cache and the host
        decodes thresholds from the float edges, which never reach the
        level step."""
        return bool(self.m_num) and self.numeric is not None \
            and self.numeric.bin_cut_thresholds

    @property
    def pass_edges(self) -> bool:
        """The level step hands the float bucket edges to the engine
        (`LevelInputs.bin_edges`): only legacy hist closures (`LegacyFn`),
        which score and return float thresholds themselves."""
        return bool(self.m_num) and self.numeric is not None \
            and self.numeric.needs_bins and not self.use_bin_cuts

    @property
    def carries_tables(self) -> bool:
        """Histogram subtraction is on: the level loop carries each
        level's per-leaf tables and every level builds only the smaller
        child of each split, deriving its sibling as parent − sibling.
        Classification only: its table entries are integer-valued bag
        counts (float32, exact below 2^24: `count_limit`), so the
        subtraction is exact (bit-equal to a plain
        rebuild); regression tables hold float sums, so regression always
        rebuilds."""
        return self.use_bin_cuts and self.numeric.carries_tables \
            and self.hist_subtract and self.task == "classification"

    @property
    def count_limit(self) -> int:
        """The in-bag weight below which a tree's classification counts are
        exact: 2^31 where every engine sums them as integers (the level's
        int32 totals, `exact_counts`), else 2^24 (float32 tables)."""
        engines = [e for e in (self.numeric, self.categorical)
                   if e is not None]
        return (INT_COUNTS if all(e.exact_counts for e in engines)
                else FLOAT_COUNTS)

    def check_counts(self, weights) -> None:
        """`check_in_bag_weight` for this plan (classification only)."""
        if self.task != "classification":
            return
        inexact = [type(e).__name__ for e in (self.numeric, self.categorical)
                   if e is not None and not e.exact_counts]
        check_in_bag_weight(weights, self.count_limit,
                            " and ".join(inexact) or "the level step")

    @property
    def row_shards(self) -> int:
        """The row-shard count n must stay divisible by (pruning rounds
        its drop down to it, the streamed driver pads its chunks to it).
        A sharded categorical engine can ride a local numeric one, so the
        bound is the lcm of both engines'."""
        return math.lcm(*(e.row_shards() for e in
                          (self.numeric, self.categorical) if e is not None))


def make_plan(params, *, m_num: int, m_cat: int, max_arity: int,
              num_classes: int, m_prime: int,
              engine: Optional[SplitEngine] = None,
              cat_engine: Optional[SplitEngine] = None) -> LevelPlan:
    """Resolve a LevelPlan from TreeParams + optional engine overrides.

    Defaults: the engine for `params.split_mode` on `params.backend`, and
    the categorical tables.  A numeric `engine` must match the split mode
    (a hist engine scores bucket boundaries, an exact engine needs the
    presort).
    """
    hist = params.split_mode == "hist"
    if engine is None:
        engine = (HistNumeric(params.backend) if hist
                  else ExactNumeric(params.backend))
    elif engine.kind != "numeric":
        raise ValueError(f"numeric engine expected, got {engine!r}")
    elif hist and not engine.needs_bins:
        raise ValueError(
            f"split_mode='hist' needs a histogram engine, got {engine!r}")
    elif not hist and engine.needs_bins:
        raise ValueError(
            f"split_mode='exact' cannot use histogram engine {engine!r}")
    if cat_engine is None:
        cat_engine = CategoricalTable(params.backend)
    elif cat_engine.kind != "categorical":
        raise ValueError(f"categorical engine expected, got {cat_engine!r}")
    return LevelPlan(
        numeric=engine if m_num else None,
        categorical=cat_engine if m_cat else None,
        m_num=m_num, m_cat=m_cat, max_arity=max_arity,
        num_classes=num_classes, m_prime=m_prime, usb=params.usb,
        impurity=params.impurity, task=params.task,
        min_records=params.min_records, num_bins=params.num_bins,
        hist_subtract=params.hist_subtract)


def _candidates(fkeys, depth, splittable_p, Lp, plan):
    """Per-leaf candidate masks (T, m, L+1); leaf 0 and unsplittable leaves
    are False.  Deterministic in (fkey, depth, leaf row)."""
    m = plan.m_num + plan.m_cat
    cand = bagging.candidate_features(fkeys, depth, Lp, m, plan.m_prime,
                                      plan.usb)                # (T, Lp, m)
    cand = cand & splittable_p[:, 1:, None]
    closed = torch.zeros((cand.shape[0], 1, m), dtype=torch.bool,
                         device=cand.device)
    return torch.cat([closed, cand], 1).transpose(1, 2)        # (T, m, L+1)


def _partition_leaf_order(ord_idx, lf_pos, bits, new_left, new_right,
                          row_counts, key_counts):
    """Advance the per-column (leaf, value)-sorted row order to the next
    level.

    ord_idx (T, m, n) row ids; lf_pos (T, n) the current leaf id at each
    position (the same for every column); bits (T, n) row-indexed, True =
    the row went LEFT; new_left/new_right (T, L+1) child ids (0 = the
    leaf closed); row_counts (T, L+1) rows per current leaf and
    key_counts (T, 2L+1) rows per next leaf, closed rows included.

    Children take consecutive ids in parent order (left < right, closed =
    0), so the stable counting sort by the NEW leaf id reduces to: closed
    rows to the front in their block order, then a stable left/right
    partition inside each parent's contiguous block.  Rows keep their
    relative (value-ascending) order inside every child, exactly what a
    stable sort would give, so the scorer's prefix sums run in the
    reference's order.  One cumsum and one scatter whose targets are a
    permutation of each row of `ord_idx`: deterministic on any device.
    Returns the new ord_idx (T, m, n), same dtype.
    """
    T, m, n = ord_idx.shape
    dev = ord_idx.device
    lf = lf_pos.long()
    rc = row_counts.long()
    kc = key_counts.long()
    # parents either split wholly or close wholly, so a block is all
    # closed or all left/right; closed rows keep their block order,
    # after the closed rows of earlier parents
    parent_closed = new_left == 0                           # (T, L+1)
    closed_sizes = torch.where(parent_closed, rc, 0)
    closed_before = closed_sizes.cumsum(1) - closed_sizes
    offs = kc.cumsum(1) - kc                                # per new leaf
    start = torch.gather(rc.cumsum(1) - rc, 1, lf)          # block starts
    in_block = torch.arange(n, device=dev) - start          # rank in block
    closed_here = torch.gather(parent_closed, 1, lf)
    pos_closed = torch.gather(closed_before, 1, lf) + in_block
    offs_l = torch.gather(offs, 1, torch.gather(new_left.long(), 1, lf))
    offs_r = torch.gather(offs, 1, torch.gather(new_right.long(), 1, lf))

    oi = ord_idx.long()
    went_left = torch.gather(bits, 1, oi.reshape(T, m * n)).reshape(T, m, n)
    del oi
    # left rows before each position: one 1-D prefix count over all rows
    # (a 1-D scan is one CUB pass on the card), differenced at the block
    # start, which lies in the same (tree, column) row
    cl = torch.cumsum(went_left.reshape(-1), 0).view(T, m, n) \
        - went_left.long()
    left_rank = cl - torch.gather(cl, 2, start[:, None, :].expand(T, m, n))
    del cl
    pos = torch.where(
        closed_here[:, None], pos_closed[:, None],
        torch.where(went_left, offs_l[:, None] + left_rank,
                    offs_r[:, None] + in_block[:, None] - left_rank))
    del left_rank, went_left
    return torch.empty_like(ord_idx).scatter_(2, pos, ord_idx)


def _eval_conditions_core(num_cols, cat_cols, leaf_of, feat_of_leaf,
                          thr_of_leaf, iscat_of_leaf, mask_of_leaf, m_num,
                          bin_of=None):
    """Alg. 2 step 5: the winning condition of each row's leaf.

    leaf_of (T, n); the per-leaf decisions are (T, L+1) (mask (T, L+1, V)).
    With `bin_of` (hist mode, `plan.use_bin_cuts`) the numeric condition
    is evaluated on the bin cache: `thr_of_leaf` then holds the winning
    BIN INDEX, and `bin <= cut` picks the rows `x <= edges[cut]` does.
    Returns bits (T, n) bool — True = LEFT.
    """
    T, n = leaf_of.shape
    lf = leaf_of.long()
    rows = torch.arange(n, device=leaf_of.device)[None, :]
    f = torch.gather(feat_of_leaf, 1, lf).long()
    thr = torch.gather(thr_of_leaf, 1, lf)
    if m_num and bin_of is not None:
        jn = f.clamp(0, m_num - 1)
        bins = bin_of.view(torch.int16) if bin_of.dtype == torch.uint16 \
            else bin_of                 # gather the bits, widen after
        xbin = presort.bin_ids(bins.reshape(-1)[jn * n + rows].view(
            bin_of.dtype))
        num_bit = xbin <= thr.to(torch.int32)
    elif m_num:
        jn = f.clamp(0, m_num - 1)
        num_bit = num_cols.reshape(-1)[jn * n + rows] <= thr
    else:
        num_bit = torch.zeros((T, n), dtype=torch.float32,
                              device=lf.device) <= thr
    m_cat = cat_cols.shape[0]
    if not m_cat:
        return num_bit
    jc = (f - m_num).clamp(0, m_cat - 1)
    xcat = cat_cols.reshape(-1)[jc * n + rows].long()
    V = mask_of_leaf.shape[-1]
    cat_bit = torch.gather(mask_of_leaf.reshape(T, -1), 1, lf * V + xcat)
    return torch.where(torch.gather(iscat_of_leaf, 1, lf), cat_bit, num_bit)


def _level_step_core(inp: LevelInputs, splittable_p, fkeys, depth, *,
                     plan: LevelPlan, Lp: int, subtract: bool = False):
    """One whole depth level of Alg. 2 for the tree batch.

    Candidate feature draw, numeric + categorical engine supersplits,
    cross-feature argmax, condition evaluation and leaf reassignment.
    `subtract` says the inputs carry a valid previous level of histogram
    tables (not at the root).  Returns (struct of per-leaf (T, L+1)
    decisions, new leaf_of (T, n), the level's carried tables or None,
    the (bits, new_left, new_right) the leaf-order partition reads).
    """
    m_num, m_cat = plan.m_num, plan.m_cat
    T = inp.leaf_of.shape[0]
    L1 = Lp + 1
    dev = inp.leaf_of.device
    st = plan.statics._replace(subtract=subtract)

    # Alg. 2 step 3: seeded per-leaf candidate features (paper §2.2/§2.4)
    with record_function("level.candidates"):
        cand = _candidates(fkeys, depth, splittable_p, Lp, plan)  # (T, m, L1)

    gains_parts, masks, tables = [], None, None
    thr_num = torch.zeros((T, max(m_num, 1), L1), dtype=torch.float32,
                          device=dev)
    if m_num:
        with record_function("level.numeric"):
            g, thr_num, tables = plan.numeric.supersplits(
                inp, st, Lp, cand[:, :m_num])
        if not plan.carries_tables:
            tables = None           # the next level rebuilds its own
        gains_parts.append(g)
    if m_cat:
        with record_function("level.categorical"):
            g, masks = plan.categorical.supersplits(inp, st, Lp,
                                                    cand[:, m_num:])
        gains_parts.append(g)
    with record_function("level.reassign"):
        struct, new_leaf_of, part = _merge_and_reassign(
            inp, plan, splittable_p, gains_parts, thr_num, masks)
    return struct, new_leaf_of, tables, part


def _merge_and_reassign(inp, plan, splittable_p, gains_parts, thr_num,
                        masks):
    """Cross-feature winner per leaf, child ids, condition evaluation and
    leaf reassignment (Alg. 2 steps 3-6).  Returns (struct, new leaf_of,
    (bits, new_left, new_right))."""
    dec = _winners(torch.cat(gains_parts, 1), thr_num, masks, splittable_p,
                   plan)
    # Alg. 2 steps 5-6: 1-bit condition per row, reassign to the children
    bits = _eval_conditions_core(inp.num_cols, inp.cat_cols, inp.leaf_of,
                                 dec["feat_of_leaf"], dec["thr"],
                                 dec["iscat_of_leaf"], dec["mask"],
                                 plan.m_num,
                                 bin_of=inp.bin_of if plan.use_bin_cuts
                                 else None)
    new_leaf_of = _reassign(inp.leaf_of, bits, dec["new_left"],
                            dec["new_right"])
    struct = {k: dec[k] for k in ("best_feat", "best_gain", "thr", "mask",
                                  "will_split")}
    return struct, new_leaf_of, (bits, dec["new_left"], dec["new_right"])


def _reassign(leaf_of, bits, new_left, new_right):
    """Alg. 2 step 6: each open row moves to its leaf's left or right
    child (`bits` True = left); closed rows stay at 0.  (T, n) int32."""
    lf = leaf_of.long()
    return torch.where(
        leaf_of > 0,
        torch.where(bits, torch.gather(new_left, 1, lf),
                    torch.gather(new_right, 1, lf)), 0).to(torch.int32)


def _winners(all_gains, thr_num, masks, splittable_p, plan):
    """Cross-feature winner per leaf and the child ids (Alg. 2 steps 3-4).

    all_gains (T, m, L+1) numeric then categorical gains; thr_num (T,
    max(m_num, 1), L+1); masks (T, m_cat, L+1, V) or None.  Returns the
    per-leaf (T, L+1) decisions: best_feat / best_gain, will_split,
    new_left / new_right (consecutive 1-based child ids, 0 = closed),
    feat_of_leaf, thr (the winning threshold, or bin index in hist mode),
    iscat_of_leaf and mask (T, L+1, V).
    """
    m_num, m_cat = plan.m_num, plan.m_cat
    T, _, L1 = all_gains.shape
    dev = all_gains.device

    # the tree builder merges partial supersplits: first feature wins ties
    best_feat = all_gains.argmax(1)                            # (T, L1)
    best_gain = torch.gather(all_gains, 1, best_feat[:, None])[:, 0]
    will_split = splittable_p & torch.isfinite(best_gain) & (best_gain > 1e-9)

    # children get consecutive 1-based ids in leaf order (Alg. 2 step 6)
    ks = torch.cumsum(will_split.to(torch.int32), 1)
    new_left = torch.where(will_split, 2 * ks - 1, 0).to(torch.int32)
    new_right = torch.where(will_split, 2 * ks, 0).to(torch.int32)

    feat_of_leaf = torch.where(will_split, best_feat, 0).to(torch.int32)
    if m_cat:
        iscat_of_leaf = will_split & (best_feat >= m_num)
    else:
        iscat_of_leaf = torch.zeros((T, L1), dtype=torch.bool, device=dev)
    thr_sel = torch.gather(thr_num, 1,
                           best_feat.clamp(0, max(m_num - 1, 0))[:, None])[:, 0]
    thr_of_leaf = torch.where(will_split & ~iscat_of_leaf, thr_sel, 0.0)
    if m_cat:
        jc = (best_feat - m_num).clamp(0, m_cat - 1)
        mask_sel = masks[torch.arange(T, device=dev)[:, None], jc,
                         torch.arange(L1, device=dev)[None, :]]  # (T, L1, V)
        mask_of_leaf = mask_sel & iscat_of_leaf[..., None]
    else:
        mask_of_leaf = torch.zeros((T, L1, plan.max_arity), dtype=torch.bool,
                                   device=dev)
    return {"best_feat": best_feat.to(torch.int32), "best_gain": best_gain,
            "thr": thr_of_leaf, "mask": mask_of_leaf,
            "will_split": will_split, "new_left": new_left,
            "new_right": new_right, "feat_of_leaf": feat_of_leaf,
            "iscat_of_leaf": iscat_of_leaf}


def _fused_level_step_batched(inp: LevelInputs, splittable_p, fkeys, depth,
                              *, plan: LevelPlan, Lp: int,
                              subtract: bool = False,
                              need_partition: bool = False):
    """One depth level of EVERY tree in the batch.

    `Lp` is the batch-wide padded frontier width; trees with fewer open
    leaves — or none, having finished early — are masked through
    `splittable_p`, which empties their candidate sets so no leaf splits.
    Because the candidate draw is padding-independent, every tree equals
    its own one-tree build.  Returns (struct, new leaf_of (T, n), next
    totals (T, 2·Lp+1, S), the level's tables (T, m_num, Lp+1, B, S) when
    the plan carries them, else None, the next level's ord_idx).

    The struct always holds `closed_rows`, the number of rows closed in
    EVERY tree (the pruning trigger, fetched with the struct at no extra
    sync).  A plan that carries tables or keeps the leaf order also puts
    the next level's per-child row counts (`key_counts`, (T, 2·Lp+1)
    int64, closed rows included) into it: the host picks each split's
    smaller child as the next build leaf from them, and they are the ord
    layout's next `row_counts`.  Under the ord layout (`plan.use_ord`)
    and `need_partition` the per-column leaf order advances to the next
    level (`_partition_leaf_order`); on the last level that can split it
    stays as it is, since no level reads it again.
    """
    struct, new_leaf_of, tables, part = _level_step_core(
        inp, splittable_p, fkeys, depth, plan=plan, Lp=Lp, subtract=subtract)
    struct["closed_rows"] = (~(new_leaf_of > 0).any(0)).sum()
    # next-level totals on the flat (tree, segment) index space
    with record_function("level.next_totals"):
        next_totals = _leaf_totals(new_leaf_of, inp.stats, inp.w, 2 * Lp,
                                   plan.task)
        if plan.carries_tables or plan.use_ord:
            T = new_leaf_of.shape[0]
            L2 = 2 * Lp + 1
            flat = (new_leaf_of.long() + torch.arange(
                T, device=new_leaf_of.device)[:, None] * L2).reshape(-1)
            struct["key_counts"] = torch.bincount(
                flat, minlength=T * L2).reshape(T, L2)
    ord_idx = inp.ord_idx
    if plan.use_ord and need_partition:
        with record_function("level.partition"):
            lf_pos = torch.gather(inp.leaf_of, 1, ord_idx[:, 0].long())
            ord_idx = _partition_leaf_order(
                ord_idx, lf_pos, *part, inp.row_counts, struct["key_counts"])
    return struct, new_leaf_of, next_totals, tables, ord_idx


# ---------------------------------------------------------------------------
# Out-of-core streaming level steps
# ---------------------------------------------------------------------------
#
# `tree.build_forest_streamed` splits a level into three steps, so that no
# n-sized state has to exist on the device:
#
#   _stream_chunk_step     per row chunk: replay the PREVIOUS level's
#                          winning conditions on the chunk's bins (the
#                          `_eval_conditions_core` bin path and
#                          `_reassign`) and add the chunk into the
#                          engine's table accumulator (at the last level,
#                          into the per-leaf totals only);
#   _stream_finalize_step  per level: the merged tables and the per-leaf
#                          totals the host reads for node values;
#   _stream_score_step     per level: candidate draw, histogram scoring,
#                          and the in-memory level's `_winners`, on the
#                          (T, m, L+1, B, S) tables alone.
#
# Classification tables are integer-valued float32 counts, exact while a
# tree's in-bag weight stays below 2^24 (the driver refuses a larger one),
# so the chunked sum equals the one-pass table, and everything after the
# tables is the in-memory path's own code: streamed fits grow the
# in-memory trees.

# chunk steps run (both kinds: table chunks and last-level totals chunks)
_STREAM_CHUNK_CALLS = [0]


def _stream_chunk_step(bins_c, labels_c, w_c, leaf_prev_c, dec, acc, *,
                       plan: LevelPlan, Lp: int, root: bool,
                       need_tables: bool):
    """Add one row chunk into the level's accumulator.

    bins_c (m_num, c) packed; labels_c (c,); w_c / leaf_prev_c (T, c) the
    bag weights and the previous level's leaf ids; dec = (feat_of_leaf,
    cut_of_leaf, new_left, new_right), each (T, Lpp+1), the previous
    level's decisions (unused at the root).  acc is the engine's table
    accumulator, or (T, Lp+1, S) per-leaf totals without `need_tables`
    (the last level).  Returns (leaf_c (T, c) int32, the chunk's
    current-level leaf ids, and acc, updated in place).  Pad rows ride
    with w = 0 and leaf 0: they stay closed and add nothing.
    """
    _STREAM_CHUNK_CALLS[0] += 1
    if root:
        leaf_c = leaf_prev_c
    else:
        with record_function("level.reassign"):
            feat_of_leaf, cut_of_leaf, new_left, new_right = dec
            no_cat = torch.zeros((0, leaf_prev_c.shape[1]), dtype=torch.int32,
                                 device=leaf_prev_c.device)
            bits = _eval_conditions_core(None, no_cat, leaf_prev_c,
                                         feat_of_leaf, cut_of_leaf, None,
                                         None, plan.m_num, bin_of=bins_c)
            leaf_c = _reassign(leaf_prev_c, bits, new_left, new_right)
    if need_tables:
        return leaf_c, plan.numeric.stream_accumulate(
            acc, bins_c, leaf_c, w_c, labels_c, plan.statics, Lp)
    with record_function("level.next_totals"):
        stats_c = splits.row_stats(labels_c, w_c, plan.num_classes,
                                   plan.task)
        acc.add_(_leaf_totals(leaf_c, stats_c, w_c, Lp, plan.task))
    return leaf_c, acc


def _stream_finalize_step(acc, *, plan: LevelPlan):
    """(merged (T, m, L+1, B, S) tables, totals (T, L+1, S)).  The totals
    are column 0's table summed over its bins: every in-bag row lands in
    exactly one bin, so for integer-valued classification counts (exact
    below 2^24, where the driver holds a tree) this is the per-row sum
    bit for bit (under a mesh engine, the first of the
    rank's own columns, which gives the same sums)."""
    merged = plan.numeric.stream_finalize(acc)
    return merged, merged[:, 0].sum(2)


def _stream_score_step(tables, splittable_p, fkeys, depth, *,
                       plan: LevelPlan, Lp: int):
    """Score one level from merged tables: the candidate draw, histogram
    scoring and the in-memory level's winner and child ids, with no row
    state (numeric hist columns only).  Returns `_winners`' decisions:
    `thr` holds winning BIN INDICES, and feat_of_leaf / thr / new_left /
    new_right are what the next level's chunk steps replay."""
    with record_function("level.candidates"):
        cand = _candidates(fkeys, depth, splittable_p, Lp, plan)
    g, cuts = plan.numeric.score_tables(tables, cand[:, :plan.m_num],
                                        plan.statics)
    return _winners(g, cuts, None, splittable_p, plan)
