"""Sprint pruning (paper §3) in the port vs the reference.

Pruned fits must equal the reference's pruned fits (exact `segment`; the
port's `kernel` backend against the reference's segment, whose backends
all grow the same trees; hist mode with subtraction) and the port's own
unpruned fits: dropping rows closed in every tree of the batch changes no
tree.  The data is chosen so that rows really drop (asserted from the
per-level row counts).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pruning, tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.kernels import ops as kops
from test_torch_forest import (EXACT_KEYS, STRUCT_KEYS, assert_trees_equal,
                               fit_both, port_ds)
from test_torch_harness import reference

PRUNE = dict(max_depth=10, min_records=30, prune_closed_frac=0.1)


def prune_data(n=2400, seed=5, task="classification"):
    """numpy rows whose leaves close unevenly from depth 5 on: 3 numeric
    columns (one with ties), 2 categorical, 10% label noise."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    num[:, 1] = np.round(num[:, 1], 1)
    cat = np.stack([rng.integers(0, a, n) for a in (4, 9)], 1).astype(
        np.int32)
    if task == "regression":
        y = (num[:, 0] + (cat[:, 0] == 2) + 0.2 * rng.normal(size=n)
             ).astype(np.float32)
    else:
        y = ((num[:, 0] > 0) ^ (num[:, 1] > 0.3) ^ (cat[:, 1] < 3))
        y = (y ^ (rng.random(n) < 0.1)).astype(np.int32)
    return num, cat, y


def rows_per_level(rf):
    """Rows each level of the first tree batch scanned (LevelStats)."""
    return [s.rows_scanned // s.feature_passes for s in rf.level_stats[0]]


@pytest.mark.parametrize("n,closed,frac", [
    (100, 0, 0.5), (100, 49, 0.5), (100, 50, 0.5), (100, 100, 0.5),
    (100, 57, 0.3), (100, 5, 0.3), (0, 0, 0.1)])
def test_plan_drop_matches_reference(n, closed, frac):
    """One device: the reference's rule with a row-shard width of 1."""
    from repro.core import pruning as ref_pruning
    reference()
    assert pruning.plan_drop(n, closed, 1, frac) == \
        ref_pruning.plan_drop(n, closed, 1, frac)


def test_compact_rows_matches_reference():
    """The batched driver's filter: leaf-ordered layout, presort, bins and
    row state, against the reference's `compact_rows`."""
    ref = reference()
    jnp = ref.jnp
    from repro.core import pruning as ref_pruning
    rng = np.random.default_rng(3)
    T, m, n = 2, 3, 200
    num = np.round(rng.normal(size=(n, m)), 1).astype(np.float32)
    cat = rng.integers(0, 5, (n, 2)).astype(np.int32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    leaf = rng.integers(0, 4, (T, n)).astype(np.int32)
    leaf[:, :40] = 0                              # closed in both trees
    sidx = np.argsort(num, axis=0, kind="stable").T.astype(np.int32)
    svals = np.take_along_axis(num.T, sidx, 1)
    ords = np.stack([[np.lexsort((np.argsort(np.argsort(num[:, j],
                                                        kind="stable")),
                                  leaf[t])) for j in range(m)]
                     for t in range(T)]).astype(np.int32)
    w = rng.poisson(1.0, (T, n)).astype(np.float32)
    stats = np.stack([w * (labels == c) for c in (0, 1)], -1)
    bins = rng.integers(0, 255, (m, n)).astype(np.uint8)
    closed = ~(leaf > 0).any(0)
    drop = pruning.plan_drop(n, int(closed.sum()), 1, 0.1)
    assert drop == closed.sum() > 0
    keep = torch.as_tensor(~closed)
    got = pruning.compact_rows(
        keep=keep, leaf_of=torch.as_tensor(leaf),
        ord_idx=torch.as_tensor(ords), sorted_vals=torch.as_tensor(svals),
        sorted_idx=torch.as_tensor(sidx), bin_of=torch.as_tensor(bins),
        num_cols=torch.as_tensor(num.T.copy()),
        cat_cols=torch.as_tensor(cat.T.copy()), stats=torch.as_tensor(stats),
        w=torch.as_tensor(w), labels=torch.as_tensor(labels))
    kw = dict(keep=jnp.asarray(keep.numpy()), drop=drop,
              leaf_of=jnp.asarray(leaf), sorted_vals=jnp.asarray(svals),
              sorted_idx=jnp.asarray(sidx), bin_of=jnp.asarray(bins),
              num=jnp.asarray(num), cat=jnp.asarray(cat),
              stats=jnp.asarray(stats), w=jnp.asarray(w),
              labels=jnp.asarray(labels), m_num=m)
    ord_r = ref_pruning.compact_rows(ord_idx=jnp.asarray(ords), use_ord=True,
                                     hist=False, **kw)
    sorted_r = ref_pruning.compact_rows(ord_idx=jnp.asarray(ords),
                                        use_ord=False, hist=False, **kw)
    bins_r = ref_pruning.compact_rows(ord_idx=jnp.asarray(ords),
                                      use_ord=False, hist=True, **kw)
    (leaf_g, ord_g, svals_g, sidx_g, bins_g, num_g, cat_g, stats_g, w_g,
     labels_g) = (x.numpy() for x in got)
    n_new = n - drop
    assert ord_r[0] == n_new == leaf_g.shape[1]
    for a, b in ((leaf_g, ord_r[1]), (ord_g, ord_r[2]),
                 (svals_g, sorted_r[3]), (sidx_g, sorted_r[4]),
                 (bins_g, bins_r[5]), (num_g.T, ord_r[6]),
                 (cat_g.T, ord_r[7]), (stats_g, ord_r[8]), (w_g, ord_r[9]),
                 (labels_g, ord_r[10])):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert ord_g.dtype == np.int32 and sidx_g.dtype == np.int32


@pytest.mark.parametrize("case", ["segment", "kernel", "hist-subtract"])
def test_pruned_fit_matches_reference(case):
    ref = reference()
    num, cat, y = prune_data()
    rds = ref.dataset.from_numpy(num, cat, y)
    port = dict(PRUNE)
    if case == "kernel":
        port["backend"] = "kernel"
    if case == "hist-subtract":
        port.update(split_mode="hist", num_bins=32)
    r, p = fit_both(rds, dict(port, backend="segment"), port, 2, 1, 2, 2)
    assert_trees_equal(r.trees, p.trees)
    p2 = RandomForest(tree_lib.TreeParams(**port), num_trees=2, seed=1,
                      tree_batch=2, device="cpu").fit(port_ds(rds),
                                                      collect_stats=True)
    rows = rows_per_level(p2)
    assert rows[-1] < rows[0], rows               # rows really dropped


@pytest.mark.parametrize("case", [
    dict(), dict(backend="kernel"), dict(backend="scan"),
    dict(split_mode="hist", num_bins=32),
    dict(split_mode="hist", num_bins=300, hist_subtract=False),
    dict(task="regression", impurity="variance")],
    ids=["segment", "kernel", "scan", "hist-subtract", "hist-uint16",
         "regression"])
def test_pruning_leaves_trees_unchanged(case):
    """Pruned == unpruned, bit for bit (regression too: a dropped row
    adds nothing to any sum that is taken)."""
    task = case.get("task", "classification")
    num, cat, y = prune_data(task=task)
    ds = from_numpy(num, cat, y, task=task)
    fits = []
    for frac in (1.0, PRUNE["prune_closed_frac"]):
        params = tree_lib.TreeParams(**dict(PRUNE, prune_closed_frac=frac,
                                            **case))
        fits.append(RandomForest(params, num_trees=3, seed=2, tree_batch=3,
                                 device="cpu").fit(ds, collect_stats=True))
    keys = EXACT_KEYS if task == "classification" else STRUCT_KEYS
    assert_trees_equal(fits[0].trees, fits[1].trees, keys)
    if task == "regression":
        for a, b in zip(fits[0].trees, fits[1].trees):
            np.testing.assert_array_equal(a.threshold, b.threshold)
            np.testing.assert_allclose(a.value, b.value, rtol=1e-6)
    rows = rows_per_level(fits[1])
    assert rows_per_level(fits[0]) == [ds.n] * len(rows)
    assert rows[-1] < rows[0] and rows == sorted(rows, reverse=True), rows


def test_pruned_fit_hands_compacted_rows_to_the_kernels(monkeypatch):
    """After a prune the kernel adapters get the compacted row count:
    feat_hist and cat_hist take any n, level after level."""
    seen = {"feat": [], "cat": []}
    feat, catf = kops.feature_tables, kops.categorical_tables

    def rec_feat(bin_of, slots, *a, **k):
        seen["feat"].append(int(slots.shape[1]))
        return feat(bin_of, slots, *a, **k)

    def rec_cat(cat_cols, leaf_of, *a, **k):
        seen["cat"].append(int(leaf_of.shape[1]))
        return catf(cat_cols, leaf_of, *a, **k)
    monkeypatch.setattr(kops, "feature_tables", rec_feat)
    monkeypatch.setattr(kops, "categorical_tables", rec_cat)
    num, cat, y = prune_data()
    RandomForest(tree_lib.TreeParams(split_mode="hist", num_bins=32,
                                     **PRUNE), num_trees=2, seed=1,
                 tree_batch=2, device="cpu").fit(from_numpy(num, cat, y))
    for name, ns in seen.items():
        assert ns[0] == len(y) and ns[-1] < ns[0], (name, ns)
        assert ns == sorted(ns, reverse=True), (name, ns)
    assert seen["feat"] == seen["cat"]
