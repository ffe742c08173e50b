"""The port's forest training vs the reference's `RandomForest.fit`.

The port trains with `backend="kernel"` (its plain kernel versions here on
the CPU); the reference with its fast `segment` backend — every exact
backend of the reference grows the same trees — plus one tiny case
against its Pallas `kernel` backend in interpret mode.  Binary gini trees
must be bit-equal node for node; 3-class gini and regression trees must
have the same structure, with node values within a stated tolerance.
"""
import numpy as np
import pytest

from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.data import synthetic
from test_torch_harness import reference

EXACT_KEYS = ("feature", "threshold", "is_cat", "cat_mask", "children",
              "value", "depth", "n_node")
STRUCT_KEYS = ("feature", "is_cat", "cat_mask", "children", "depth")


def port_ds(rds):
    return from_numpy(np.asarray(rds.num), np.asarray(rds.cat),
                      np.asarray(rds.labels), rds.arities, rds.task)


def assert_trees_equal(ref_trees, port_trees, keys=EXACT_KEYS):
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        assert a.num_nodes == b.num_nodes, (i, a.num_nodes, b.num_nodes)
        for k in keys:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"tree {i} {k}")


def fit_both(rds, ref_params, port_params, num_trees, seed, ref_tb, port_tb):
    ref = reference()
    r = ref.forest.RandomForest(ref.tree.TreeParams(**ref_params),
                                num_trees=num_trees, seed=seed,
                                tree_batch=ref_tb).fit(rds)
    p = RandomForest(tree_lib.TreeParams(**port_params), num_trees=num_trees,
                     seed=seed, tree_batch=port_tb, device="cpu").fit(
        port_ds(rds))
    return r, p


def test_synthetic_data_matches_reference():
    ref = reference()
    a = ref.synthetic.make_tabular("xor", 500, 3, 2, 4, seed=3)
    b = synthetic.make_tabular("xor", 500, 3, 2, 4, seed=3)
    for k in ("num", "cat", "labels"):
        np.testing.assert_array_equal(getattr(b, k), np.asarray(getattr(a, k)))
    assert a.arities == b.arities
    ta, _ = ref.synthetic.train_test_split(a)
    tb, _ = synthetic.train_test_split(b)
    np.testing.assert_array_equal(tb.num, np.asarray(ta.num))


@pytest.mark.parametrize("port_tb", [1, 3])
def test_binary_gini_forest_bit_equal(port_tb):
    rds = reference().synthetic.make_tabular(
        "xor", n=2500, num_informative=3, num_useless=1, num_categorical=4,
        seed=0)
    r, p = fit_both(rds, dict(max_depth=6, backend="segment"),
                    dict(max_depth=6, backend="kernel"), 3, 1, 3, port_tb)
    assert_trees_equal(r.trees, p.trees)
    assert any(t.is_cat.any() for t in p.trees)     # categorical splits used
    np.testing.assert_array_equal(
        p.predict_proba(rds.num, rds.cat).numpy(),
        np.asarray(r.predict_proba(rds.num, rds.cat)))


def test_uneven_finish_depths_bit_equal():
    """Trees of one batch finish at different depths (early-finish
    masking through `splittable`)."""
    rds = reference().synthetic.make_tabular(
        "majority", n=700, num_informative=2, num_useless=2,
        num_categorical=2, seed=4)
    r, p = fit_both(rds, dict(max_depth=9, min_records=6, backend="segment"),
                    dict(max_depth=9, min_records=6, backend="kernel"), 4, 2,
                    4, 4)
    assert_trees_equal(r.trees, p.trees)
    assert len({t.max_depth_reached for t in p.trees}) > 1


def test_multiclass_gini_forest():
    """3 classes: class sums of three terms may round in another order
    than XLA's, so the structure must match exactly and node values and
    thresholds to float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(5)
    n = 1500
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 6, size=(n, 2)).astype(np.int32)
    y = np.digitize(num[:, 0] + 0.5 * (cat[:, 0] % 3), [-0.3, 0.8])
    ref = reference()
    rds = ref.dataset.from_numpy(num, cat, y.astype(np.int32))
    r, p = fit_both(rds, dict(max_depth=5, backend="segment"),
                    dict(max_depth=5, backend="kernel"), 2, 3, 2, 2)
    assert_trees_equal(r.trees, p.trees, STRUCT_KEYS)
    for a, b in zip(r.trees, p.trees):
        np.testing.assert_allclose(b.value, a.value, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-6)


def test_regression_variance_forest():
    """Regression sums floats in another order than the reference: the
    same structure, node values within rtol 1e-5."""
    rng = np.random.default_rng(6)
    n = 1200
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 5, size=(n, 1)).astype(np.int32)
    y = (2 * num[:, 0] + num[:, 1] ** 2 + cat[:, 0]
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    ref = reference()
    rds = ref.dataset.from_numpy(num, cat, y, task="regression")
    kw = dict(max_depth=4, min_records=4, impurity="variance",
              task="regression", bagging="none")
    r, p = fit_both(rds, dict(kw, backend="segment"),
                    dict(kw, backend="kernel"), 2, 4, 2, 2)
    assert_trees_equal(r.trees, p.trees, STRUCT_KEYS)
    for a, b in zip(r.trees, p.trees):
        np.testing.assert_allclose(b.value, a.value, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-5,
                                   atol=1e-6)


def test_tiny_case_against_reference_kernel_backend():
    """The reference's Pallas kernels (interpret mode) grow the same
    trees as the port's kernel backend."""
    rds = reference().synthetic.make_tabular(
        "xor", n=300, num_informative=2, num_useless=1, num_categorical=2,
        seed=7)
    r, p = fit_both(rds, dict(max_depth=3, backend="kernel"),
                    dict(max_depth=3, backend="kernel"), 1, 0, 1, 1)
    assert_trees_equal(r.trees, p.trees)


def test_scan_backend_and_build_tree_agree():
    """backend='scan' (the plain path) grows the kernel backend's trees,
    and build_tree is a one-tree build_forest."""
    ds = synthetic.make_tabular("xor", 900, 3, 1, 2, seed=8)
    a = RandomForest(tree_lib.TreeParams(max_depth=5, backend="kernel"),
                     num_trees=3, seed=2, tree_batch=3, device="cpu").fit(ds)
    b = RandomForest(tree_lib.TreeParams(max_depth=5, backend="scan"),
                     num_trees=3, seed=2, tree_batch=2, device="cpu").fit(ds)
    assert_trees_equal(a.trees, b.trees)
    import torch
    from repro_torch.core import presort
    num = torch.as_tensor(ds.num)
    si = presort.presort_columns(num)
    t, _ = tree_lib.build_tree(
        num=num, cat=torch.as_tensor(ds.cat), labels=torch.as_tensor(ds.labels),
        sorted_vals=presort.gather_sorted(num, si), sorted_idx=si,
        arities=ds.arities, num_classes=2,
        params=tree_lib.TreeParams(max_depth=5, backend="kernel"), seed=2,
        tree_idx=1)
    assert_trees_equal([a.trees[1]], [t])


@pytest.mark.parametrize("params,match", [
    # hist mode trains; what it meets of the unported options still raises
    pytest.param(dict(split_mode="hist", prune_closed_frac=0.5), "pruning",
                 id="params0-hist"),
    (dict(backend="segment"), "segment"),
    (dict(backend="kernel", prune_closed_frac=0.5), "pruning"),
    (dict(backend="kernel", bagging="multinomial"), "multinomial"),
])
def test_unported_options_raise(params, match):
    ds = synthetic.make_tabular("xor", 200, 2, 0, seed=1)
    rf = RandomForest(tree_lib.TreeParams(max_depth=2, **params),
                      num_trees=1, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        rf.fit(ds)


def test_categorical_only_segment_backend_trains():
    """Without numeric columns the reference default (segment) is the
    plain categorical table path, which the port carries."""
    ref = reference()
    rng = np.random.default_rng(9)
    cat = rng.integers(0, 7, size=(800, 3)).astype(np.int32)
    y = ((cat[:, 0] % 2) ^ (cat[:, 1] > 3)).astype(np.int32)
    rds = ref.dataset.from_numpy(None, cat, y)
    r, p = fit_both(rds, dict(max_depth=4), dict(max_depth=4), 2, 5, 2, 2)
    assert_trees_equal(r.trees, p.trees)
