"""Gradient Boosted Trees on the DRF substrate (paper §1, §2), ported from
`repro.core.gbt`.

"While this paper mainly focuses on Random Forests, the proposed algorithm
can be applied to other DF models, notably Gradient Boosted Trees (Ye et
al., 2009).  In this case, while trees cannot be trained in parallel, the
training of each individual tree is still distributed."

Each boosting round fits a regression tree (variance impurity) to the
current pseudo-residuals with the same level-by-level trainer as
`RandomForest` (`tree.build_tree`, a one-tree `build_forest`, so through
its pipelined level loop): the presort, the seeded candidate draws and
the one-step-per-level structure are shared, `split_mode="hist"`
included.
Losses: squared error (regression) and logistic (binary classification).

Inference stacks the fitted rounds into one `forest.PackedForest`:
`predict_raw` is one descent over every round at once, then the scaled
sum and the base score.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core import presort, tree as tree_lib
from repro_torch.core.dataset import TabularDataset
from repro_torch.device import resolve_device


@dataclasses.dataclass
class GBTParams:
    """The reference's fields and defaults."""
    num_rounds: int = 20
    learning_rate: float = 0.1
    max_depth: int = 4
    min_records: float = 1.0
    num_candidates: Optional[int] = None   # None = all features (GBT default)
    loss: str = "squared"                  # squared | logistic
    backend: str = "segment"
    split_mode: str = "exact"              # exact | hist (PLANET baseline)
    num_bins: int = 255                    # hist-mode bucket budget per column
    seed: int = 0


@dataclasses.dataclass
class GBTModel:
    """Gradient Boosted Trees on the DRF level-wise trainer (paper §1).

    Each boosting round fits one regression tree (variance impurity,
    `bagging="none"`, every feature a candidate by default) to the current
    pseudo-residuals through `tree.build_tree`.  Rounds are sequential
    (tree t+1 needs tree t's predictions), so GBT uses the one-tree build,
    not a tree batch.  `split_mode="hist"` quantizes the numeric columns
    once before the first round.  Losses: `"squared"` (regression;
    `predict` returns the raw score) and `"logistic"` (binary
    classification with 0/1 labels; `predict` thresholds at 0,
    `predict_proba` returns (B, 2) probabilities).

    The prior, the residuals and the running score `f` are float64, as in
    the reference; the labels each round trains on are the residuals cast
    to float32.  `f` stays on the fit's device, and the logistic
    `1/(1+exp(−f))` is computed there: float64 `exp` on CUDA, on the CPU
    in torch and in numpy may differ in the last ulp, so the tests hold
    GBT to a tolerance against the reference.

      device: where the fit and the predictions run; None means CUDA and
              raises without a GPU.  Pass "cpu" for the plain PyTorch path.
    """

    params: GBTParams
    device: Optional[str] = None
    trees: list = dataclasses.field(default_factory=list)
    base_score: float = 0.0
    m: int = 0
    packed: Optional[forest_lib.PackedForest] = None

    def fit(self, ds: TabularDataset, engine=None,
            cat_engine=None) -> "GBTModel":
        """Fit the boosted rounds: presort once (and in hist mode quantize
        once), then one `tree.build_tree` a round.  `engine`/`cat_engine`
        take the engines `build_forest` takes: the local
        `repro_torch.core.level` engines or the mesh engines of
        `repro_torch.core.distributed`."""
        p = self.params
        dev = resolve_device(self.device)
        ds.validate()
        self.m = ds.m
        y_np = np.asarray(ds.labels, np.float64)
        if p.loss == "logistic":
            pbar = np.clip(y_np.mean(), 1e-6, 1 - 1e-6)
            self.base_score = float(np.log(pbar / (1 - pbar)))
        else:
            self.base_score = float(y_np.mean())
        y = torch.as_tensor(y_np, device=dev)
        f = torch.full_like(y, self.base_score)

        num_cols = torch.as_tensor(ds.num, device=dev).t().contiguous()
        cat_cols = torch.as_tensor(ds.cat, device=dev).t().contiguous()
        num, cat = num_cols.t(), cat_cols.t()
        if ds.m_num:
            sorted_idx = presort.presort_columns(num)
            sorted_vals = presort.gather_sorted(num, sorted_idx)
        else:
            sorted_idx = torch.zeros((0, ds.n), dtype=torch.int32, device=dev)
            sorted_vals = torch.zeros((0, ds.n), dtype=torch.float32,
                                      device=dev)
        tparams = tree_lib.TreeParams(
            max_depth=p.max_depth, min_records=p.min_records,
            num_candidates=p.num_candidates or ds.m, impurity="variance",
            task="regression", backend=p.backend, bagging="none",
            split_mode=p.split_mode, num_bins=p.num_bins)
        # hist mode: quantize once, before the first round (the buckets
        # depend on the columns alone, not on the residuals)
        bin_of = bin_edges = None
        if p.split_mode == "hist" and ds.m_num:
            bin_of, bin_edges = presort.quantize(num, sorted_vals, p.num_bins)

        self.trees, self.packed = [], None
        for t in range(p.num_rounds):
            if p.loss == "logistic":
                resid = y - 1.0 / (1.0 + torch.exp(-f))   # negative gradient
            else:
                resid = y - f
            tr, _ = tree_lib.build_tree(
                num=num, cat=cat, labels=resid.to(torch.float32),
                sorted_vals=sorted_vals, sorted_idx=sorted_idx,
                arities=ds.arities, num_classes=2, params=tparams,
                seed=p.seed, tree_idx=t, bin_of=bin_of, bin_edges=bin_edges,
                engine=engine, cat_engine=cat_engine)
            self.trees.append(tr)
            step = tr.predict_raw(num, cat, device=dev)[:, 0]   # float32
            f = f + p.learning_rate * step
        if self.trees:                        # num_rounds=0: the prior only
            self.packed = forest_lib.pack_trees(self.trees, device=dev)
        return self

    def _packed(self) -> forest_lib.PackedForest:
        assert self.trees, "fit first"
        if self.packed is None or self.packed.num_trees != len(self.trees):
            self.packed = forest_lib.pack_trees(
                self.trees, device=resolve_device(self.device))
        return self.packed

    def predict_raw(self, num, cat) -> torch.Tensor:
        """Raw boosted score (B,) float32: one descent over every round
        (`forest._forest_predict`), the rounds summed in round order, then
        base + lr · sum in float32, so the card's answer is the CPU's bit
        for bit."""
        if not self.trees:                    # num_rounds=0: the prior
            B = num.shape[0] if np.prod(num.shape) else cat.shape[0]
            return torch.full((B,), self.base_score, dtype=torch.float32,
                              device=resolve_device(self.device))
        pk = self._packed()
        num = torch.as_tensor(num, device=pk.device).to(torch.float32)
        cat = torch.as_tensor(cat, device=pk.device).to(torch.int32)
        preds = forest_lib._forest_predict(pk, num, cat,
                                           reduce_mean=False)[..., 0]
        total = preds[0].clone()              # (B,), summed in round order
        for t in range(1, pk.num_trees):
            total += preds[t]
        f32 = dict(dtype=torch.float32, device=pk.device)
        return (torch.tensor(self.base_score, **f32)
                + torch.tensor(self.params.learning_rate, **f32) * total)

    def predict(self, num, cat) -> torch.Tensor:
        f = self.predict_raw(num, cat)
        if self.params.loss == "logistic":
            return (f > 0).to(torch.int32)
        return f

    def predict_proba(self, num, cat) -> torch.Tensor:
        """(B, 2) float64 class probabilities (logistic loss only)."""
        assert self.params.loss == "logistic"
        p1 = 1.0 / (1.0 + torch.exp(-self.predict_raw(num, cat).double()))
        return torch.stack([1 - p1, p1], -1)
