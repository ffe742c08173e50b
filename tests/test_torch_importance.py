"""Feature importances in the port vs the reference: mean decrease in
impurity (`mdi_importance`), its per-splitter parts (`mdi_partial`, whose
sum over a split of the columns is the unnormalized total: the paper's
distributed feature importance) and `permutation_importance`, on the same
trees.  Binary gini trees and their gains are bit-equal between the
packages, so are the importances.
"""
import numpy as np
import pytest

from repro_torch.core import importance
from test_torch_forest import fit_both, port_ds
from test_torch_harness import reference


def forests(seed=3, **kw):
    ref = reference()
    rds = ref.synthetic.make_tabular("majority", n=1200, num_informative=3,
                                     num_useless=3, num_categorical=2,
                                     seed=seed)
    kw = dict(dict(max_depth=6), **kw)
    r, p = fit_both(rds, kw, kw, 4, seed, 2, 4)
    return rds, r, p


def test_mdi_matches_reference():
    from repro.core import importance as ref_imp
    rds, r, p = forests()
    m = rds.m
    got = importance.mdi_importance(p.trees, m)
    np.testing.assert_array_equal(got, ref_imp.mdi_importance(r.trees, m))
    np.testing.assert_array_equal(p.feature_importances(),
                                  r.feature_importances())
    assert got.dtype == np.float32 and abs(float(got.sum()) - 1) < 1e-6
    assert got[:3].sum() > got[3:].sum()        # the informative columns


@pytest.mark.parametrize("bounds", [(0, 8), (0, 3, 8), (0, 1, 2, 5, 6, 8)])
def test_mdi_partial_sums_to_the_total(bounds):
    from repro.core import importance as ref_imp
    _, r, p = forests()
    m = 8
    parts = [importance.mdi_partial(p.trees, m, lo, hi)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    for part, (lo, hi) in zip(parts, zip(bounds[:-1], bounds[1:])):
        np.testing.assert_array_equal(
            part, ref_imp.mdi_partial(r.trees, m, lo, hi))
        assert not part[:lo].any() and not part[hi:].any()
    total = np.sum(parts, 0)
    np.testing.assert_allclose((total / total.sum()).astype(np.float32),
                               importance.mdi_importance(p.trees, m),
                               rtol=1e-6)


def test_mdi_of_a_forest_without_splits_is_zero():
    _, _, p = forests(max_depth=0)
    assert not importance.mdi_importance(p.trees, 8).any()


def test_permutation_importance_matches_reference():
    from repro.core import importance as ref_imp
    rds, r, p = forests()
    got = importance.permutation_importance(p, port_ds(rds), seed=7,
                                            max_rows=600)
    want = ref_imp.permutation_importance(r, rds, seed=7, max_rows=600)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (rds.m,) and got[:3].max() > 0.05
    with pytest.raises(ValueError, match="metric"):
        importance.permutation_importance(p, port_ds(rds), metric="auc")
