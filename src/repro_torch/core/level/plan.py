"""LevelPlan: one depth level of Alg. 2 for a whole tree batch, ported
from `repro.core.level.plan`.

A `LevelPlan` composes a numeric and a categorical `SplitEngine` with the
static level config.  `_fused_level_step_batched` runs one level of every
tree in the batch:

    candidate draw → engine supersplits → cross-feature winner argmax →
    condition evaluation (step 5) → leaf reassignment (step 6) → next totals

The reference vmapped a per-tree core over the tree axis; here the tree
axis T is written out in every tensor, and the next level's totals are
reduced on the flat (tree, segment) index space in one scatter.  Only the
small per-leaf struct goes back to the host.

Each part of a level runs inside a `record_function` range named
`level.<part>`, so a `torch.profiler` trace (`chip_smoke.py --profile`)
attributes the level's device time to its parts; outside a profiler the
ranges cost a few microseconds per level.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.core import bagging
from repro_torch.core.level.engines import (CategoricalTable, ExactNumeric,
                                            LevelInputs, LevelStatics,
                                            SplitEngine)

def _pad_leaves(L: int, pad: int) -> int:
    """Pad to a power of two (at least `pad`)."""
    return max(pad, 1 << (L - 1).bit_length())


def _leaf_totals(leaf_of, stats, w, Lp):
    """Per-tree per-leaf in-bag stat totals (T, Lp+1, S), one flat scatter."""
    T, n = leaf_of.shape
    L1 = Lp + 1
    inb = (w > 0) & (leaf_of > 0)
    flat = leaf_of.long() + torch.arange(T, device=leaf_of.device)[:, None] * L1
    out = torch.zeros((T * L1, stats.shape[-1]), dtype=torch.float32,
                      device=stats.device)
    out.index_add_(0, flat.reshape(-1),
                   torch.where(inb[..., None], stats, 0.0).reshape(T * n, -1))
    return out.reshape(T, L1, -1)


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

    @property
    def statics(self) -> LevelStatics:
        return LevelStatics(
            m_num=self.m_num, m_cat=self.m_cat, max_arity=self.max_arity,
            num_classes=self.num_classes, impurity=self.impurity,
            task=self.task, min_records=self.min_records)


def make_plan(params, *, m_num: int, m_cat: int, max_arity: int,
              num_classes: int, m_prime: int,
              engine: Optional[SplitEngine] = None,
              cat_engine: Optional[SplitEngine] = None) -> LevelPlan:
    """Resolve a LevelPlan from TreeParams + optional engine overrides.

    Raises NotImplementedError, naming the ROADMAP item, for what this
    slice of the port does not carry: hist mode and the numeric
    `segment` backend.
    """
    if params.split_mode != "exact":
        raise NotImplementedError(
            f"split_mode={params.split_mode!r} is not ported (ROADMAP: hist "
            f"mode and the feat_hist kernel)")
    if engine is None:
        engine = ExactNumeric(params.backend)
    elif engine.kind != "numeric":
        raise ValueError(f"numeric engine expected, got {engine!r}")
    if m_num and getattr(engine, "backend", None) == "segment":
        raise NotImplementedError(
            "the numeric 'segment' backend is not ported (ROADMAP: numeric "
            "segment backend); use backend='kernel' or 'scan'")
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
        min_records=params.min_records)


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


def _eval_conditions_core(num_cols, cat_cols, leaf_of, feat_of_leaf,
                          thr_of_leaf, iscat_of_leaf, mask_of_leaf, m_num):
    """Alg. 2 step 5: the winning condition of each row's leaf.

    leaf_of (T, n); the per-leaf decisions are (T, L+1) (mask (T, L+1, V)).
    Returns bits (T, n) bool — True = LEFT.
    """
    T, n = leaf_of.shape
    lf = leaf_of.long()
    rows = torch.arange(n, device=leaf_of.device)[None, :]
    f = torch.gather(feat_of_leaf, 1, lf).long()
    if m_num:
        jn = f.clamp(0, m_num - 1)
        xnum = num_cols.reshape(-1)[jn * n + rows]
    else:
        xnum = torch.zeros((T, n), dtype=torch.float32, device=lf.device)
    num_bit = xnum <= torch.gather(thr_of_leaf, 1, lf)
    m_cat = cat_cols.shape[0]
    if not m_cat:
        return num_bit
    jc = (f - m_num).clamp(0, m_cat - 1)
    xcat = cat_cols.reshape(-1)[jc * n + rows].long()
    V = mask_of_leaf.shape[-1]
    cat_bit = torch.gather(mask_of_leaf.reshape(T, -1), 1, lf * V + xcat)
    return torch.where(torch.gather(iscat_of_leaf, 1, lf), cat_bit, num_bit)


def _level_step_core(inp: LevelInputs, splittable_p, fkeys, depth, *,
                     plan: LevelPlan, Lp: int):
    """One whole depth level of Alg. 2 for the tree batch.

    Candidate feature draw, numeric + categorical engine supersplits,
    cross-feature argmax, condition evaluation and leaf reassignment.
    Returns (struct of per-leaf (T, L+1) decisions, new leaf_of (T, n)).
    """
    m_num, m_cat = plan.m_num, plan.m_cat
    T = inp.leaf_of.shape[0]
    L1 = Lp + 1
    dev = inp.leaf_of.device
    st = plan.statics

    # Alg. 2 step 3: seeded per-leaf candidate features (paper §2.2/§2.4)
    with record_function("level.candidates"):
        cand = _candidates(fkeys, depth, splittable_p, Lp, plan)  # (T, m, L1)

    gains_parts, masks = [], None
    thr_num = torch.zeros((T, max(m_num, 1), L1), dtype=torch.float32,
                          device=dev)
    if m_num:
        with record_function("level.numeric"):
            g, thr_num = plan.numeric.supersplits(inp, st, Lp,
                                                  cand[:, :m_num])
        gains_parts.append(g)
    if m_cat:
        with record_function("level.categorical"):
            g, masks = plan.categorical.supersplits(inp, st, Lp,
                                                    cand[:, m_num:])
        gains_parts.append(g)
    with record_function("level.reassign"):
        struct, new_leaf_of = _merge_and_reassign(
            inp, plan, splittable_p, gains_parts, thr_num, masks, Lp)
    return struct, new_leaf_of


def _merge_and_reassign(inp, plan, splittable_p, gains_parts, thr_num, masks,
                        Lp):
    """Cross-feature winner per leaf, child ids, condition evaluation and
    leaf reassignment (Alg. 2 steps 3-6)."""
    m_num, m_cat = plan.m_num, plan.m_cat
    T = inp.leaf_of.shape[0]
    L1 = Lp + 1
    dev = inp.leaf_of.device
    all_gains = torch.cat(gains_parts, 1)                      # (T, m, L1)

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

    # Alg. 2 steps 5-6: 1-bit condition per row, reassign to the children
    bits = _eval_conditions_core(inp.num_cols, inp.cat_cols, inp.leaf_of,
                                 feat_of_leaf, thr_of_leaf, iscat_of_leaf,
                                 mask_of_leaf, m_num)
    lf = inp.leaf_of.long()
    new_leaf_of = torch.where(
        inp.leaf_of > 0,
        torch.where(bits, torch.gather(new_left, 1, lf),
                    torch.gather(new_right, 1, lf)), 0).to(torch.int32)
    struct = {"best_feat": best_feat.to(torch.int32), "best_gain": best_gain,
              "thr": thr_of_leaf, "mask": mask_of_leaf,
              "will_split": will_split}
    return struct, new_leaf_of


def _fused_level_step_batched(inp: LevelInputs, splittable_p, fkeys, depth,
                              *, plan: LevelPlan, Lp: int):
    """One depth level of EVERY tree in the batch.

    `Lp` is the batch-wide padded frontier width; trees with fewer open
    leaves — or none, having finished early — are masked through
    `splittable_p`, which empties their candidate sets so no leaf splits.
    Because the candidate draw is padding-independent, every tree equals
    its own one-tree build.  Returns (struct, new leaf_of (T, n), next
    totals (T, 2·Lp+1, S)).
    """
    struct, new_leaf_of = _level_step_core(inp, splittable_p, fkeys, depth,
                                           plan=plan, Lp=Lp)
    # next-level totals on the flat (tree, segment) index space
    with record_function("level.next_totals"):
        next_totals = _leaf_totals(new_leaf_of, inp.stats, inp.w, 2 * Lp)
    return struct, new_leaf_of, next_totals
