"""The reference's legacy closure API in the port: `RandomForest.fit(ds,
supersplit_fn=closure)` wraps a bare closure in `level.LegacyFn`, warns
and builds the trees one at a time through `tree.build_tree`, for the
sorted (presort) and the hist (bin cache + float edges) signature.  The
trees must equal the plain fit's and the reference's closure fit's node
for node (binary gini: integer bag counts, so bit-equal).  The mesh
engines taken through `supersplit_fn=` (the reference's
`examples/distributed_forest.py`) are held in `test_torch_distributed.py`,
on its gloo world.
"""
import pytest
import torch

from repro_torch.core import splits, tree as tree_lib
from repro_torch.core.forest import RandomForest
from repro_torch.core.level import ExactNumeric, LegacyFn
from repro_torch.kernels import ops as kops
from test_torch_forest import assert_trees_equal, port_ds
from test_torch_harness import reference

SEED, TREES = 4, 2


@pytest.fixture(scope="module")
def data():
    ref = reference()
    rds = ref.synthetic.make_tabular("majority", 400, 3, 1, 2, seed=5)
    return ref, rds, port_ds(rds)


def port_sorted_fn(sorted_vals, sorted_idx, leaf_of, w, stats, cand, Lp,
                   impurity, task, min_records):
    """Each presorted column counting-sorted by leaf and scored alone."""
    out = [splits.best_numeric_split_segment(
        sorted_vals[j:j + 1], leaf_of[s], w[s], stats[s], cand[j:j + 1], Lp,
        impurity, task, min_records)
        for j, s in enumerate(sorted_idx.long())]
    return torch.cat([g for g, _ in out]), torch.cat([t for _, t in out])


def port_hist_fn(bin_of, bin_edges, leaf_of, w, stats, cand, Lp, impurity,
                 task, min_records):
    """Per-leaf bin tables, the bucket scorer, and the winning cut's float
    edge as the threshold."""
    tables = splits.feature_count_tables(
        bin_of, leaf_of[None], w[None], stats[None], Lp, bin_edges.shape[1])
    g, cut = splits.best_numeric_split_histogram(
        tables[0], cand, impurity, task, min_records)
    return g, torch.gather(bin_edges, 1, cut.long())


def ref_closures(ref):
    jax, jnp, rs = ref.jax, ref.jnp, ref.splits

    def sorted_fn(sorted_vals, sorted_idx, leaf_of, w, stats, cand, Lp,
                  impurity, task, min_records):
        def per_col(v, s, c):
            return rs.best_numeric_split_segment(
                v, leaf_of[s], w[s], stats[s], c, Lp, impurity, task,
                min_records)
        return jax.vmap(per_col)(sorted_vals, sorted_idx, cand)

    def hist_fn(bin_of, bin_edges, leaf_of, w, stats, cand, Lp, impurity,
                task, min_records):
        tables = rs.feature_count_tables(bin_of, leaf_of, w, stats, Lp,
                                         bin_edges.shape[1])
        g, cut = jax.vmap(lambda tb, c: rs.best_numeric_split_histogram(
            tb, c, impurity, task, min_records))(tables, cand)
        return g, jnp.take_along_axis(bin_edges, cut.astype(jnp.int32), 1)

    return sorted_fn, hist_fn


PARAMS = {"sorted": dict(max_depth=3),
          "hist": dict(max_depth=3, split_mode="hist", num_bins=16)}


@pytest.mark.parametrize("mode", ["sorted", "hist"])
def test_closure_fit_equals_plain_and_reference(data, mode):
    ref, rds, ds = data
    p = tree_lib.TreeParams(**PARAMS[mode])
    plain = RandomForest(p, num_trees=TREES, seed=SEED, device="cpu").fit(ds)
    batch0 = tree_lib._BATCH_STEP_CALLS[0]
    steps0 = tree_lib._STEP_CALLS[0]
    fn = port_sorted_fn if mode == "sorted" else port_hist_fn
    with pytest.warns(UserWarning, match="per-tree builder"):
        legacy = RandomForest(p, num_trees=TREES, seed=SEED,
                              device="cpu").fit(ds, supersplit_fn=fn)
    assert tree_lib._BATCH_STEP_CALLS[0] == batch0   # no batched step
    assert tree_lib._STEP_CALLS[0] > steps0          # per-tree steps
    assert_trees_equal(plain.trees, legacy.trees)

    rfn = ref_closures(ref)[0 if mode == "sorted" else 1]
    with pytest.warns(UserWarning, match="per-tree builder"):
        rlegacy = ref.forest.RandomForest(
            ref.tree.TreeParams(**PARAMS[mode]), num_trees=TREES,
            seed=SEED).fit(rds, supersplit_fn=rfn)
    assert_trees_equal(rlegacy.trees, legacy.trees)


@pytest.mark.parametrize("route", ["fit", "build_tree"])
def test_engine_and_closure_together_raise(data, route):
    _, _, ds = data
    p = tree_lib.TreeParams(max_depth=2)
    both = dict(engine=ExactNumeric(), supersplit_fn=port_sorted_fn)
    with pytest.raises(ValueError, match="not both"):
        if route == "fit":
            RandomForest(p, num_trees=1, device="cpu").fit(ds, **both)
        else:
            tree_lib.build_tree(tree_idx=0, params=p, **both)


def test_engine_as_supersplit_fn_keeps_tree_batching(data, recwarn):
    _, _, ds = data
    p = tree_lib.TreeParams(max_depth=3)
    plain = RandomForest(p, num_trees=TREES, seed=SEED, device="cpu").fit(ds)
    batch0 = tree_lib._BATCH_STEP_CALLS[0]
    steps0 = tree_lib._STEP_CALLS[0]
    rf = RandomForest(p, num_trees=TREES, seed=SEED, device="cpu").fit(
        ds, supersplit_fn=ExactNumeric("kernel"))
    assert not [w for w in recwarn if "per-tree" in str(w.message)]
    assert tree_lib._STEP_CALLS[0] == steps0
    # both trees in one batch: one batched step per level of the batch
    assert 0 < tree_lib._BATCH_STEP_CALLS[0] - batch0 <= p.max_depth
    assert_trees_equal(plain.trees, rf.trees)


def test_build_forest_refuses_a_closure(data):
    _, _, ds = data
    num = torch.as_tensor(ds.num)
    si = torch.argsort(num.t(), dim=1, stable=True).to(torch.int32)
    with pytest.raises(ValueError, match="per-tree only"):
        tree_lib.build_forest(
            num=num, cat=torch.as_tensor(ds.cat),
            labels=torch.as_tensor(ds.labels),
            sorted_vals=torch.gather(num.t(), 1, si.long()), sorted_idx=si,
            arities=ds.arities, num_classes=ds.num_classes,
            params=tree_lib.TreeParams(max_depth=2), seed=0,
            tree_indices=[0], engine=LegacyFn(fn=port_sorted_fn))


def test_closure_sees_one_tree(data):
    """The closure gets (n,) leaf ids and weights and (n, S) stats, as
    the reference's per-tree builder passes them."""
    _, _, ds = data
    shapes = []

    def spy(sorted_vals, sorted_idx, leaf_of, w, stats, cand, Lp, *rest):
        shapes.append((tuple(leaf_of.shape), tuple(w.shape),
                       tuple(stats.shape), tuple(cand.shape), Lp))
        return port_sorted_fn(sorted_vals, sorted_idx, leaf_of, w, stats,
                              cand, Lp, *rest)

    with pytest.warns(UserWarning):
        RandomForest(tree_lib.TreeParams(max_depth=1), num_trees=1,
                     device="cpu").fit(ds, supersplit_fn=spy)
    n, m = ds.n, ds.m_num
    Lp = shapes[0][-1]
    assert shapes == [((n,), (n,), (n, kops.stat_dim(2, "classification")),
                       (m, Lp + 1), Lp)]
