"""Carrying trained forests between the reference and the port: `.npz`
cross-loading both ways, `PackedForest.from_arrays`, and the evaluation
utilities (`predict`, `auc`, `oob_score`) on equal trees."""
import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.forest import PackedForest, RandomForest, pack_trees
from test_torch_forest import port_ds
from test_torch_harness import reference


@pytest.fixture(scope="module")
def fitted():
    ref = reference()
    rds = ref.synthetic.make_tabular("xor", n=1500, num_informative=2,
                                     num_useless=2, num_categorical=3,
                                     seed=11)
    train, test = ref.synthetic.train_test_split(rds)
    r = ref.forest.RandomForest(ref.tree.TreeParams(max_depth=5),
                                num_trees=4, seed=3, tree_batch=4).fit(train)
    p = RandomForest(tree_lib.TreeParams(max_depth=5, backend="kernel"),
                     num_trees=4, seed=3, tree_batch=2, device="cpu").fit(
        port_ds(train))
    return ref, r, p, train, test


def test_reference_saved_forest_loads_in_port(fitted, tmp_path):
    ref, r, _, _, test = fitted
    path = tmp_path / "ref_forest.npz"
    r.packed.save(path)
    pk = PackedForest.load(path, device="cpu")
    np.testing.assert_array_equal(
        pk.predict_proba(test.num, test.cat).numpy(),
        np.asarray(r.packed.predict_proba(test.num, test.cat)))
    np.testing.assert_array_equal(
        pk.predict_proba(test.num, test.cat, reduce_mean=False).numpy(),
        np.asarray(r.packed.predict_proba(test.num, test.cat,
                                          reduce_mean=False)))


def test_port_saved_forest_loads_in_reference(fitted, tmp_path):
    ref, r, p, _, test = fitted
    path = tmp_path / "port_forest"          # suffix-less, as numpy allows
    p.packed.save(path)
    rk = ref.forest.PackedForest.load(path)
    np.testing.assert_array_equal(
        np.asarray(rk.predict_proba(test.num, test.cat)),
        p.predict_proba(test.num, test.cat).numpy())
    for k in PackedForest._ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(rk, k)),
                                      np.asarray(getattr(r.packed, k)))
    again = PackedForest.load(path, device="cpu")
    for k in PackedForest._ARRAYS:
        assert torch.equal(getattr(again, k), getattr(p.packed, k))


def test_load_rejects_other_format_versions(fitted, tmp_path):
    _, _, p, _, _ = fitted
    path = tmp_path / "f.npz"
    p.packed.save(path)
    with np.load(path) as z:
        arrays = dict(z)
    arrays["format_version"] = np.int32(2)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="format v2"):
        PackedForest.load(path, device="cpu")


def test_from_arrays_turns_reference_trees_into_port_forest(fitted):
    ref, r, _, _, test = fitted
    pk = PackedForest.from_arrays(
        m_num=r.packed.m_num, iters=r.packed.iters, device="cpu",
        **{k: np.asarray(getattr(r.packed, k)) for k in PackedForest._ARRAYS})
    np.testing.assert_array_equal(
        pk.predict_proba(test.num, test.cat).numpy(),
        np.asarray(r.predict_proba(test.num, test.cat)))
    # and pack_trees over the reference's Tree objects packs the same
    pk2 = pack_trees(r.trees, device="cpu")
    for k in PackedForest._ARRAYS:
        np.testing.assert_array_equal(getattr(pk2, k).numpy(),
                                      np.asarray(getattr(r.packed, k)))


def test_predict_auc_oob_match_reference(fitted):
    ref, r, p, train, test = fitted
    np.testing.assert_array_equal(p.predict(test.num, test.cat).numpy(),
                                  np.asarray(r.predict(test.num, test.cat)))
    assert p.auc(port_ds(test)) == r.auc(test)
    assert p.oob_score(port_ds(train)) == r.oob_score(train)
    np.testing.assert_array_equal(
        p.predict_proba_per_tree(test.num, test.cat).numpy(),
        np.asarray(r.predict_proba_per_tree(test.num, test.cat)))


def test_tree_predict_raw_matches_reference(fitted):
    _, r, p, _, test = fitted
    for a, b in zip(r.trees, p.trees):
        np.testing.assert_array_equal(
            b.predict_raw(test.num, test.cat, device="cpu").numpy(),
            np.asarray(a.predict_raw(test.num, test.cat)))


@pytest.mark.parametrize("which", ["-1", "-V", "V", "-V-1"])
def test_out_of_range_category_ids_route_as_reference(fitted, which):
    """Every categorical id set to -1, -V, V or -V-1 (V = the forest's
    widest arity): the reference's jnp indexing counts a negative id from
    the end (-1 reads category V-1, -V category 0) and clamps the rest,
    and the port's predictions follow it."""
    _, r, p, _, test = fitted
    assert any(t.is_cat.any() for t in p.trees)
    V = p.packed.cat_mask.shape[-1]
    cat = np.full_like(np.asarray(test.cat),
                       {"-1": -1, "-V": -V, "V": V, "-V-1": -V - 1}[which])
    num = np.asarray(test.num)
    np.testing.assert_array_equal(p.predict_proba(num, cat).numpy(),
                                  np.asarray(r.predict_proba(num, cat)))
    for a, b in zip(r.trees, p.trees):
        np.testing.assert_array_equal(
            b.predict_raw(num, cat, device="cpu").numpy(),
            np.asarray(a.predict_raw(num, cat)))


def test_depth_metrics_match_reference(fitted):
    """Paper §5's node and sample densities of each tree."""
    _, r, p, _, _ = fitted
    for a, b in zip(r.trees, p.trees):
        assert b.node_density() == a.node_density()
        assert b.sample_density() == a.sample_density()
        assert 0.0 < b.sample_density() <= 1.0


@pytest.mark.parametrize("up_to", [1, 3, 4, 9])
def test_predict_proba_up_to_matches_reference(fitted, up_to):
    _, r, p, _, test = fitted
    np.testing.assert_array_equal(
        p.predict_proba(test.num, test.cat, up_to=up_to).numpy(),
        np.asarray(r.predict_proba(test.num, test.cat, up_to=up_to)))
    assert p._packed_forest(up_to).num_trees == min(up_to, 4)
