"""Random Forest manager (paper §2.5) + stacked forest inference, ported
from `repro.core.forest`.

`RandomForest.fit` presorts once, trains the trees in `tree_batch`-sized
groups through `tree.build_forest` (one batched level step per depth) and
packs them into one `PackedForest`, whose `predict_proba` descends every
tree over the whole query batch at once.  `RandomForest.fit_streamed`
trains the same hist-mode trees out of core from a `dataset.RowSource`
(`tree.build_forest_streamed`), with optional level checkpoints.

A `PackedForest` is also the forest's portable form: `save`/`load` use the
reference's `.npz` FORMAT_VERSION 1, so a forest trained by either package
loads in the other, and `from_arrays` turns the reference's packed arrays
into the port's.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import (atomicio, bagging, checkpoint as checkpoint_lib,
                              importance, presort, tree as tree_lib)
from repro_torch.core.dataset import RowSource, TabularDataset
from repro_torch.core.level.engines import LegacyFn, resolve_engine
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Stacked forest inference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedForest:
    """All trees of a forest in one set of padded flat tensors.

    Every tree is padded to the forest maxima — N nodes, V categories, C
    value width — and stacked on a leading tree axis.  Nodes past a tree's
    own count are unreachable padding leaves (feature −1, value 0).
    Feature ids < `m_num` are numeric (x <= thr goes left), the rest
    categorical (membership in `cat_mask` goes left).
    """
    feature: torch.Tensor     # (T, N) int32; -1 = leaf
    threshold: torch.Tensor   # (T, N) float32
    is_cat: torch.Tensor      # (T, N) bool
    cat_mask: torch.Tensor    # (T, N, V) bool
    children: torch.Tensor    # (T, N, 2) int32
    value: torch.Tensor       # (T, N, C) float32
    m_num: int
    iters: int                # max depth over trees + 1 (descent bound)

    FORMAT_VERSION = 1        # the reference's .npz layout
    _ARRAYS = ("feature", "threshold", "is_cat", "cat_mask", "children",
               "value")
    _DTYPES = {"feature": np.int32, "threshold": np.float32, "is_cat": bool,
               "cat_mask": bool, "children": np.int32, "value": np.float32}

    @property
    def num_trees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def device(self) -> torch.device:
        return self.feature.device

    @classmethod
    def from_arrays(cls, *, m_num, iters, device=None, **arrays):
        """A forest from numpy arrays in the reference's packed layout —
        how the reference's trained trees become the port's."""
        dev = resolve_device(device)
        return cls(m_num=int(m_num), iters=int(iters),
                   **{k: torch.as_tensor(
                       np.asarray(arrays[k], cls._DTYPES[k]), device=dev)
                      for k in cls._ARRAYS})

    def to_arrays(self) -> dict:
        return {k: getattr(self, k).cpu().numpy() for k in self._ARRAYS}

    def save(self, path) -> None:
        """One `.npz` with a format-version field, written atomically
        (`atomicio.atomic_replace`): a crash mid-save leaves the old file
        or the new one, never a torn one."""
        p = os.fspath(path)
        if not p.endswith(".npz"):
            p += ".npz"
        arrays = dict(format_version=np.int32(self.FORMAT_VERSION),
                      m_num=np.int32(self.m_num), iters=np.int32(self.iters),
                      **self.to_arrays())

        def write(tmp):
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **arrays)
        atomicio.atomic_replace(p, write)

    @classmethod
    def load(cls, path, device=None) -> "PackedForest":
        """Load an `.npz` written by either package's `save`."""
        p = os.fspath(path)
        if not os.path.exists(p) and not p.endswith(".npz"):
            p += ".npz"
        with np.load(p) as z:
            version = int(z["format_version"])
            if version != cls.FORMAT_VERSION:
                raise ValueError(
                    f"PackedForest format v{version} not supported "
                    f"(this build reads v{cls.FORMAT_VERSION})")
            return cls.from_arrays(m_num=int(z["m_num"]),
                                   iters=int(z["iters"]), device=device,
                                   **{k: z[k] for k in cls._ARRAYS})

    def predict_proba(self, num, cat, reduce_mean: bool = True):
        """(B, C) forest mean, or (T, B, C) with `reduce_mean=False`."""
        num = torch.as_tensor(num, device=self.device).to(torch.float32)
        cat = torch.as_tensor(cat, device=self.device).to(torch.int32)
        return _forest_predict(self, num, cat, reduce_mean)


def _forest_predict(pk: PackedForest, num, cat, reduce_mean):
    T, N = pk.feature.shape
    B = num.shape[0] if num.numel() else cat.shape[0]
    m_num, m_cat = pk.m_num, (cat.shape[1] if cat.dim() == 2 else 0)
    V = pk.cat_mask.shape[-1]
    dev = pk.device
    feature = pk.feature.long()
    node = torch.zeros((T, B), dtype=torch.int64, device=dev)
    num_t = num.t() if m_num else None          # (m_num, B)
    cat_t = cat.t().long() if m_cat else None   # (m_cat, B)
    cm = pk.cat_mask.reshape(T, N * V)
    left = pk.children[..., 0].long()
    right = pk.children[..., 1].long()
    for _ in range(pk.iters):
        f = torch.gather(feature, 1, node)
        leaf = f < 0
        if m_num:
            xnum = torch.gather(num_t, 0, f.clamp(0, m_num - 1))
        else:
            xnum = torch.zeros((T, B), dtype=torch.float32, device=dev)
        go_left = xnum <= torch.gather(pk.threshold, 1, node)
        if m_cat:
            xcat = torch.gather(cat_t, 0, (f - m_num).clamp(0, m_cat - 1))
            # jnp indexing: a negative id counts from the end, then clamps
            xcat = torch.where(xcat < 0, xcat + V, xcat).clamp(0, V - 1)
            cat_left = torch.gather(cm, 1, node * V + xcat)
            go_left = torch.where(torch.gather(pk.is_cat, 1, node), cat_left,
                                  go_left)
        nxt = torch.where(go_left, torch.gather(left, 1, node),
                          torch.gather(right, 1, node))
        node = torch.where(leaf, node, nxt)
    C = pk.value.shape[-1]
    preds = torch.gather(pk.value, 1, node[..., None].expand(T, B, C))
    if not reduce_mean:
        return preds
    # the reference's mean: a sum in tree order times the float32 1/T
    total = preds[0].clone()
    for t in range(1, T):
        total += preds[t]
    return total * torch.tensor(1.0 / T, dtype=torch.float32, device=dev)


def pack_trees(trees: list, device=None) -> PackedForest:
    """Pad each tree's flat arrays to the forest maximum and stack."""
    assert trees
    T = len(trees)
    N = max(t.num_nodes for t in trees)
    V = max(t.cat_mask.shape[1] for t in trees)
    C = max(t.value.shape[1] for t in trees)
    feature = np.full((T, N), -1, np.int32)
    threshold = np.zeros((T, N), np.float32)
    is_cat = np.zeros((T, N), bool)
    cat_mask = np.zeros((T, N, V), bool)
    children = np.full((T, N, 2), -1, np.int32)
    value = np.zeros((T, N, C), np.float32)
    for t, tr in enumerate(trees):
        k = tr.num_nodes
        feature[t, :k] = tr.feature
        threshold[t, :k] = tr.threshold
        is_cat[t, :k] = tr.is_cat
        cat_mask[t, :k, :tr.cat_mask.shape[1]] = tr.cat_mask
        children[t, :k] = tr.children
        value[t, :k, :tr.value.shape[1]] = tr.value
    iters = max(int(t.depth.max()) for t in trees) + 1
    return PackedForest.from_arrays(
        feature=feature, threshold=threshold, is_cat=is_cat,
        cat_mask=cat_mask, children=children, value=value,
        m_num=trees[0].m_num, iters=iters, device=device)


# ---------------------------------------------------------------------------
# The forest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RandomForest:
    """The paper's DRF: an exact Random Forest trained level by level.

      params:     `tree.TreeParams`.
      num_trees:  forest size T.
      seed:       forest seed; all randomness (bagging, candidate features)
                  is a pure function of (seed, tree index) (§2.2).
      tree_batch: trees per batched level step; None picks a
                  memory-bounded batch.  Trees are identical for any choice.
      device:     where the fit runs; None means CUDA and raises without a
                  GPU.  Pass "cpu" to run the plain PyTorch path.
    """

    params: tree_lib.TreeParams
    num_trees: int = 10
    seed: int = 0
    tree_batch: Optional[int] = None
    device: Optional[str] = None

    trees: list = dataclasses.field(default_factory=list)
    level_stats: list = dataclasses.field(default_factory=list)
    num_classes: int = 2
    m: int = 0
    m_num: int = 0
    packed: Optional[PackedForest] = None

    def _resolve_tree_batch(self, ds: TabularDataset) -> int:
        """Trees per batched level step: bounds the largest row-indexed
        intermediate (T·m_num·n elements) and caps at 16."""
        if self.tree_batch is not None:
            return max(1, min(int(self.tree_batch), self.num_trees))
        per_tree = max(1, max(ds.m_num, 1) * ds.n)
        return int(max(1, min(self.num_trees, 16, (1 << 26) // per_tree)))

    def fit(self, ds: TabularDataset, collect_stats: bool = False,
            supersplit_fn=None, engine=None,
            cat_engine=None) -> "RandomForest":
        """Train the forest: presort once (§2.1) — and in hist mode quantize
        once — then one batched level step per depth for each group of
        `tree_batch` trees.  `engine`/`cat_engine` replace the numeric and
        categorical split engines, e.g. the mesh engines of
        `repro_torch.core.distributed`, called in every rank of the mesh
        with the same arguments.

        `supersplit_fn` is the reference's legacy API
        (`level.engines.resolve_engine`): a `SplitEngine` passed there is
        taken as the engine; a bare closure (see `level.LegacyFn` for its
        two signatures), like a `LegacyFn` passed as `engine`, warns and
        builds the trees one at a time (`tree_batch = 1`,
        `tree.build_tree`), since it sees one tree's arrays.  The trees
        are the same either way.  Passing both `supersplit_fn` and `engine`
        raises ValueError.

        The fit runs inside the `record_function` range `fit.forest`, and
        its own steps in ranges nested there: `fit.copy_in` (the host
        columns onto the device), `fit.presort`, `fit.quantize` (hist
        mode), `fit.assemble` (the host trees of each tree batch, in
        `tree.build_forest`) and `fit.pack` (`pack_trees` and its copy to
        the device).  `fit_streamed` opens `fit.forest`, `fit.assemble`
        and `fit.pack` the same way."""
        if isinstance(ds, RowSource):
            raise TypeError(
                "fit() trains from a fully materialized TabularDataset; "
                "for a RowSource (out-of-core bin cache) use "
                "fit_streamed(source)")
        engine = resolve_engine(engine, supersplit_fn,
                                hist=self.params.split_mode == "hist")
        with record_function("fit.forest"):
            dev = resolve_device(self.device)
            ds.validate()
            self.num_classes = ds.num_classes
            self.m, self.m_num = ds.m, ds.m_num
            with record_function("fit.copy_in"):
                num_cols = torch.as_tensor(ds.num, device=dev).t().contiguous()
                cat_cols = torch.as_tensor(ds.cat, device=dev).t().contiguous()
                labels = torch.as_tensor(ds.labels, device=dev)
            with record_function("fit.presort"):
                if ds.m_num:
                    sorted_idx = presort.presort_columns(num_cols.t())
                    sorted_vals = presort.gather_sorted(num_cols.t(),
                                                        sorted_idx)
                else:
                    sorted_idx = torch.zeros((0, ds.n), dtype=torch.int32,
                                             device=dev)
                    sorted_vals = torch.zeros((0, ds.n), dtype=torch.float32,
                                              device=dev)
            kw = dict(num=num_cols.t(), cat=cat_cols.t(), labels=labels,
                      sorted_vals=sorted_vals, sorted_idx=sorted_idx,
                      arities=ds.arities, num_classes=ds.num_classes,
                      params=self.params, seed=self.seed,
                      collect_stats=collect_stats, engine=engine,
                      cat_engine=cat_engine)
            if self.params.split_mode == "hist" and ds.m_num:
                # hist mode: quantize once per forest (the PLANET-style
                # fixed bucket budget), shared by every tree and level like
                # the presort
                with record_function("fit.quantize"):
                    bin_of, bin_edges = presort.quantize(
                        num_cols.t(), sorted_vals, self.params.num_bins)
                kw.update(bin_of=bin_of, bin_edges=bin_edges)
            tb = self._resolve_tree_batch(ds)
            per_tree = isinstance(engine, LegacyFn)
            if per_tree:
                warnings.warn(
                    "legacy supersplit_fn closures force the per-tree "
                    "builder (tree_batch=1, one level step per depth PER "
                    "TREE); pass a repro_torch.core.level SplitEngine "
                    "(engine=...) to keep the batched one-step-per-depth "
                    "path", UserWarning, stacklevel=2)
                tb = 1                      # per-tree-only configuration
            self.trees, self.level_stats = [], []
            for lo in range(0, self.num_trees, tb):
                if per_tree:
                    tr, stats = tree_lib.build_tree(tree_idx=lo, **kw)
                    trees, stats = [tr], [stats]
                else:
                    trees, stats = tree_lib.build_forest(
                        tree_indices=range(lo, min(lo + tb, self.num_trees)),
                        **kw)
                self.trees.extend(trees)
                self.level_stats.extend(stats)
            with record_function("fit.pack"):
                self.packed = pack_trees(self.trees, device=dev)
        return self

    def fit_streamed(self, source, collect_stats: bool = False,
                     engine=None, checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 1,
                     resume: bool = False) -> "RandomForest":
        """Train the forest out of core from a `dataset.RowSource`.

        The trees equal `fit`'s on the same quantized rows, node for node,
        but the per-row state stays on the host: the device sees fixed-
        shape chunks of the bin cache, so its memory is bounded by
        `source.chunk_size`, not n.  Hist mode, classification and numeric
        columns only (`tree.build_forest_streamed`).

        `checkpoint_dir=` snapshots the tree batch in flight every
        `checkpoint_every` levels and commits each finished batch, all
        atomically; `resume=True` skips committed batches, restarts the
        one in flight at its last snapshot, and finishes the forest as an
        uninterrupted fit would.  Resuming against another source, params
        or seed raises `checkpoint.CheckpointMismatchError`.
        """
        if isinstance(source, TabularDataset):
            raise TypeError(
                "fit_streamed() trains from a RowSource; wrap the dataset "
                "with ArrayRowSource.from_dataset(ds, num_bins) (or use "
                "plain fit(ds))")
        if not isinstance(source, RowSource):
            raise TypeError(f"expected a dataset.RowSource, got "
                            f"{type(source).__name__}")
        with record_function("fit.forest"):
            dev = resolve_device(self.device)
            self.num_classes = source.num_classes
            self.m = self.m_num = source.m_num
            ck = None
            if checkpoint_dir is not None:
                ck = checkpoint_lib.StreamCheckpointer(checkpoint_dir,
                                                       every=checkpoint_every)
                ck.prepare(source=source, params=self.params, seed=self.seed,
                           resume=resume)
            tb = (max(1, min(int(self.tree_batch), self.num_trees))
                  if self.tree_batch is not None else min(self.num_trees, 16))
            self.trees, self.level_stats = [], []
            for lo in range(0, self.num_trees, tb):
                trees, stats = tree_lib.build_forest_streamed(
                    source=source,
                    tree_indices=range(lo, min(lo + tb, self.num_trees)),
                    params=self.params, seed=self.seed,
                    collect_stats=collect_stats, engine=engine, resume=resume,
                    device=dev, _checkpointer=ck)
                self.trees.extend(trees)
                self.level_stats.extend(stats)
            with record_function("fit.pack"):
                self.packed = pack_trees(self.trees, device=dev)
        return self

    def _packed_forest(self, up_to: Optional[int] = None) -> PackedForest:
        """The packed forest, or its first `up_to` trees."""
        assert self.trees, "fit first"
        if self.packed is None or self.packed.num_trees != len(self.trees):
            self.packed = pack_trees(self.trees,
                                     device=resolve_device(self.device))
        pk = self.packed
        if up_to is not None and up_to < pk.num_trees:
            pk = dataclasses.replace(
                pk, **{k: getattr(pk, k)[:up_to] for k in pk._ARRAYS})
        return pk

    def predict_proba(self, num, cat, up_to: Optional[int] = None
                      ) -> torch.Tensor:
        """Forest-averaged distributions (B, C), over the first `up_to`
        trees when it is given."""
        return self._packed_forest(up_to).predict_proba(num, cat)

    def predict_proba_per_tree(self, num, cat) -> torch.Tensor:
        """(T, B, C) per-tree predictions."""
        return self._packed_forest().predict_proba(num, cat,
                                                   reduce_mean=False)

    def predict(self, num, cat) -> torch.Tensor:
        p = self.predict_proba(num, cat)
        if self.params.task == "classification":
            return p.argmax(-1)
        return p[:, 0]

    def oob_score(self, ds: TabularDataset) -> float:
        """Out-of-bag accuracy from the seeded bagging (no extra state)."""
        n = ds.n
        dev = resolve_device(self.device)
        w = bagging.bag_counts_forest(self.seed, range(len(self.trees)), n,
                                      self.params.bagging, dev)
        oob = (w == 0).cpu().numpy()
        if not oob.any():                       # e.g. bagging == "none"
            return float("nan")
        preds = self.predict_proba_per_tree(ds.num, ds.cat).argmax(-1)
        preds = preds.cpu().numpy()
        labels = np.asarray(ds.labels)
        correct = ((preds == labels[None]) & oob).sum(0)
        counted = oob.sum(0)
        mask = counted > 0
        return float((correct[mask] / counted[mask]).mean())

    def feature_importances(self) -> np.ndarray:
        """Mean decrease in impurity per feature, normalized to sum 1 —
        the paper's distributed feature importance (per-splitter partial
        sums merged, `importance.mdi_importance`)."""
        return importance.mdi_importance(self.trees, self.m)

    def auc(self, ds: TabularDataset) -> float:
        """Binary AUC (the paper's headline metric on Leo / Fig. 1)."""
        assert self.num_classes == 2
        scores = self.predict_proba(ds.num, ds.cat)[:, 1].cpu().numpy()
        return binary_auc(scores, np.asarray(ds.labels))


def binary_auc(scores: np.ndarray, y: np.ndarray) -> float:
    """Mann-Whitney AUC with ties given their average rank."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    s_sorted = scores[order]
    _, inv, cnts = np.unique(s_sorted, return_inverse=True,
                             return_counts=True)
    start = np.concatenate([[0], np.cumsum(cnts)[:-1]])
    ranks[order] = (start + (cnts + 1) / 2.0)[inv]
    n1 = (y == 1).sum()
    n0 = (y == 0).sum()
    if n1 == 0 or n0 == 0:
        return float("nan")
    u = ranks[y == 1].sum() - n1 * (n1 + 1) / 2.0
    return float(u / (n1 * n0))
