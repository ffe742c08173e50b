"""The port's seed builder (`core/reference.py`, `build_tree_reference`)
against the reference's, and the port's batched `build_forest` against
the port's seed builder: the independent per-tree specification the
batched driver is held to on any device.  Classification trees bit-equal
node for node; regression the same structure with values within rtol
1e-5, atol 1e-5.  Entropy is held at the scorer level
(`test_torch_segment.py`): a split that leaves the class mix unchanged
has gain 0 in exact arithmetic, and whether its float32 entropy gain
lands above the 1e-9 split threshold depends on how the log rounds.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import presort, tree as tree_lib
from repro_torch.core.reference import build_tree_reference
from test_torch_forest import EXACT_KEYS, STRUCT_KEYS, assert_trees_equal
from test_torch_harness import reference


def data(task="classification", n=900, seed=4):
    """3 numeric columns (one with ties), 2 categorical, noisy labels."""
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    num[:, 2] = np.round(num[:, 2], 1)
    cat = np.stack([rng.integers(0, a, n) for a in (3, 6)], 1).astype(
        np.int32)
    if task == "regression":
        y = (num[:, 0] + 0.5 * cat[:, 1] + 0.2 * rng.normal(size=n)
             ).astype(np.float32)
    else:
        y = ((num[:, 0] > 0) ^ (cat[:, 1] % 2 == 0)
             ^ (rng.random(n) < 0.1)).astype(np.int32)
    return num, cat, y, (3, 6)


def port_kw(num, cat, y, arities, params, seed):
    num_t = torch.as_tensor(num)
    si = presort.presort_columns(num_t)
    return dict(num=num_t, cat=torch.as_tensor(cat), labels=torch.as_tensor(y),
                sorted_vals=presort.gather_sorted(num_t, si), sorted_idx=si,
                arities=arities, num_classes=2, params=params, seed=seed)


CASES = {
    "segment": dict(max_depth=7),
    "scan": dict(max_depth=7, backend="scan"),
    "pruned": dict(max_depth=9, min_records=25, prune_closed_frac=0.2),
    "multinomial": dict(max_depth=6, bagging="multinomial", min_records=3),
    "regression": dict(max_depth=6, min_records=10, task="regression",
                       impurity="variance"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_seed_builder_matches_reference(case):
    ref = reference()
    jnp = ref.jnp
    from repro.core.reference import build_tree_reference as ref_build
    kw = CASES[case]
    task = kw.get("task", "classification")
    num, cat, y, arities = data(task)
    si = ref.presort.presort_columns(jnp.asarray(num))
    for tree_idx in (0, 3):
        want, _ = ref_build(
            num=jnp.asarray(num), cat=jnp.asarray(cat), labels=jnp.asarray(y),
            sorted_vals=ref.presort.gather_sorted(jnp.asarray(num), si),
            sorted_idx=si, arities=arities, num_classes=2,
            params=ref.tree.TreeParams(**kw), seed=6, tree_idx=tree_idx)
        got, log = build_tree_reference(
            **port_kw(num, cat, y, arities, tree_lib.TreeParams(**kw), 6),
            tree_idx=tree_idx, collect_stats=True)
        if task == "classification":
            assert_trees_equal([want], [got])
        else:
            assert_trees_equal([want], [got], STRUCT_KEYS)
            np.testing.assert_allclose(got.value, want.value, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.threshold, want.threshold,
                                       rtol=1e-5, atol=1e-5)
        assert [s.depth for s in log] == list(range(len(log)))
    if case == "pruned":                         # rows really dropped
        rows = [s.rows_scanned // s.feature_passes for s in log]
        assert rows[-1] < rows[0], rows


@pytest.mark.parametrize("case,backend", [
    ("segment", "segment"), ("segment", "kernel"), ("scan", "scan"),
    ("pruned", "segment"), ("pruned", "kernel"),
    ("multinomial", "segment"), ("regression", "segment")])
def test_build_forest_matches_seed_builder(case, backend):
    """Every tree of one batched `build_forest` equals the seed builder's
    tree of the same index, whatever backend the batch uses."""
    kw = dict(CASES[case], backend=backend)
    task = kw.get("task", "classification")
    num, cat, y, arities = data(task, seed=9)
    params = tree_lib.TreeParams(**kw)
    trees, _ = tree_lib.build_forest(
        **port_kw(num, cat, y, arities, params, 2),
        tree_indices=[0, 1, 5])
    for tree_idx, tr in zip((0, 1, 5), trees):
        spec, _ = build_tree_reference(
            **port_kw(num, cat, y, arities,
                      tree_lib.TreeParams(**CASES[case]), 2),
            tree_idx=tree_idx)
        if task == "classification":
            assert_trees_equal([spec], [tr], EXACT_KEYS)
        else:
            assert_trees_equal([spec], [tr], STRUCT_KEYS)
            np.testing.assert_allclose(tr.value, spec.value, rtol=1e-5,
                                       atol=1e-5)


def test_seed_builder_refuses_hist_mode():
    num, cat, y, arities = data()
    with pytest.raises(ValueError, match="exact"):
        build_tree_reference(**port_kw(
            num, cat, y, arities, tree_lib.TreeParams(split_mode="hist"), 0),
            tree_idx=0)
