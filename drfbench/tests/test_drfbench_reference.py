"""The reference against the port's CPU fits at a tiny size: it re-derives
the same bag counts, candidates and trees, reads zero on the port's trees
and fails each kind of mutated tree."""
import dataclasses

import numpy as np
import pytest
import torch

from drfbench import harness
from drfbench.reference import forest as ref
from drfbench.tests.tiny import make_root

LIMITS = {"weight_gap": 0.0, "structure_faults": 0, "split_shortfall": 1e-4,
          "value_gap": 1e-5}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"), rows=2500)


@pytest.fixture(scope="module", params=["leo.exact-kernel", "majority.hist"])
def fitted(request, root):
    cell = harness.load_cell(request.param, root)
    rows = harness.make_rows(cell, 17, torch.device("cpu"))
    fs = harness.forest_seed(17, 0)
    trees = harness.fit_trees(cell, rows, fs, 2, "cpu")
    return harness.problem(cell, *rows, "cpu"), fs, trees


def test_generator_draws_equal_the_programs():
    from repro_torch.core import bagging
    from repro_torch.core.tree import _forest_keys
    w = bagging.bag_counts_forest(123, [0, 3], 5000)
    for k, t in enumerate((0, 3)):
        assert torch.equal(ref.bag_counts(123, t, 5000, "cpu"), w[k])
    keys = _forest_keys(123, [3], "cpu")
    want = bagging.candidate_features(keys, 2, 6, 82, 10)[0]
    assert torch.equal(ref.candidates(123, 3, 2, 6, 82, 10, "cpu"), want)


def test_reference_reads_zero_on_the_programs_trees(fitted):
    P, fs, trees = fitted
    for t, tree in enumerate(trees):
        r = ref.check_tree(P, tree, fs, t)
        assert r["weight_gap"] == 0 and r["structure_faults"] == 0
        assert r["split_shortfall"] <= 1e-12 and r["value_gap"] < 1e-7
        assert tree.num_nodes > 7               # the trees did split


def test_reference_grows_the_programs_trees_in_float64(fitted):
    P, fs, trees = fitted
    for t, tree in enumerate(trees):
        mine = ref.grow(P, fs, t, dtype=torch.float64)
        for k in ("feature", "children", "is_cat"):
            np.testing.assert_array_equal(getattr(mine, k), getattr(tree, k))
        np.testing.assert_array_equal(mine.threshold, tree.threshold)
        V = mine.cat_mask.shape[1]
        np.testing.assert_array_equal(mine.cat_mask, tree.cat_mask[:, :V])


def _failed(P, tree, fs, t):
    r = ref.check_tree(P, tree, fs, t)
    return [k for k, lim in LIMITS.items() if r[k] > lim]


def _root_child(tree):
    return int(tree.children[0, 0])


def test_reference_fails_mutated_trees(fitted):
    P, fs, trees = fitted
    tree = trees[0]
    mut = lambda **kw: dataclasses.replace(tree, **{
        k: v for k, v in kw.items()})
    split = np.flatnonzero(tree.feature >= 0)
    num = split[tree.feature[split] < P.m_num]
    cases = {}
    if len(num):                     # a numeric threshold moved
        th = tree.threshold.copy()
        th[num[0]] = np.float32(th[num[0]] + 0.5)
        cases["threshold"] = mut(threshold=th)
    cat = split[tree.is_cat[split]]
    if len(cat):                     # a populated category sent the other way
        cm = tree.cat_mask.copy()
        cm[cat[0]] = ~cm[cat[0]]
        cm[cat[0], P.arities[tree.feature[cat[0]] - P.m_num]:] = False
        cases["mask"] = mut(cat_mask=cm)
    v = tree.value.copy()
    v[-1] += np.float32(1e-3)
    cases["value"] = mut(value=v)
    nn = tree.n_node.copy()
    nn[_root_child(tree)] += 1
    cases["weight"] = mut(n_node=nn)
    ch = tree.children.copy()
    ch[0] = ch[0, ::-1]
    cases["children"] = mut(children=ch)
    f = tree.feature.copy()
    cand = ref.candidates(fs, 0, 0, 1, P.m, P.m_prime, "cpu")[0].numpy()
    f[0] = int(np.flatnonzero(~cand)[0])
    cases["candidate"] = mut(feature=f)
    lf = tree.feature.copy()
    lf[0] = -1
    cases["stump"] = mut(feature=lf)
    for name, bad in cases.items():
        assert _failed(P, bad, fs, 0), name
