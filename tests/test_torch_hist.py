"""Hist mode of the port against the reference's `split_mode="hist"`.

Inputs are made from a seed with numpy and given to both packages.  The
port runs on the CPU (the `feat_hist` kernel's plain version); the
reference through `reference()`, with its `HistNumeric(backend="segment")`
path, since its Pallas `feat_hist` does not run on the installed jax
(ROADMAP fault C2) — its jnp twin `splits.feature_count_tables` stands in
for the kernel.  Classification is held bit for bit (integer-valued
tables); regression to the tolerances the slice-1 regression tests state.
Reference fits are cached per test process, made inside test bodies.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import presort, splits
from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.core.level import plan as plan_lib
from repro_torch.kernels import feat_hist
from test_torch_forest import EXACT_KEYS, STRUCT_KEYS, assert_trees_equal
from test_torch_harness import reference

_REF_FITS = {}


def _num_with_ties(n=700, seed=0):
    """Normal, heavily tied, constant and small-integer columns."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(size=n),
                     np.round(rng.normal(size=n) * 2) / 2,
                     np.full(n, 1.5),
                     rng.integers(0, 4, n)], 1).astype(np.float32)


@pytest.mark.parametrize("num_bins", [2, 64, 255, 256, 300])
def test_quantizer_bit_equal(num_bins):
    ref = reference()
    jnp = ref.jnp
    num = _num_with_ties()
    r_si = ref.presort.presort_columns(jnp.asarray(num))
    r_bins, r_edges = ref.presort.quantize(
        jnp.asarray(num), ref.presort.gather_sorted(jnp.asarray(num), r_si),
        num_bins)
    t = torch.as_tensor(num)
    sv = presort.gather_sorted(t, presort.presort_columns(t))
    edges = presort.quantize_edges(sv, num_bins)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(r_edges))
    bins = presort.bin_columns(t, edges)
    assert bins.dtype == presort.bin_dtype(num_bins)
    assert bins.numpy().dtype == np.asarray(r_bins).dtype
    np.testing.assert_array_equal(bins.numpy(), np.asarray(r_bins))
    b2, e2 = presort.quantize(t, sv, num_bins)
    assert torch.equal(b2, bins) and torch.equal(e2, edges)
    # the dataset's own quantizer, numpy out, as the reference's
    p_bins, p_edges = from_numpy(num, None, np.zeros(len(num), np.int32)
                                 ).quantize(num_bins)
    rd_bins, rd_edges = ref.dataset.from_numpy(
        num, None, np.zeros(len(num), np.int32)).quantize(num_bins)
    np.testing.assert_array_equal(p_bins, np.asarray(rd_bins))
    np.testing.assert_array_equal(p_edges, np.asarray(rd_edges))


def _table_case(B, task, T=2, n=900, m=3, W=6, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, B, (m, n)).astype(np.uint8 if B <= 256
                                          else np.uint16)
    slot = rng.integers(0, W, (T, n)).astype(np.int32)     # ~1/W zeros
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = (rng.integers(0, 3, n).astype(np.float32) if task == "classification"
         else (rng.normal(size=n) * 2 + 1).astype(np.float32))
    return x, slot, w, y


@pytest.mark.parametrize("B", [255, 300])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_feature_tables_match_reference(B, task):
    """`feature_count_tables` and `feat_hist_plain` (tree axis written
    out) against the reference's per-tree twin; slot-0 rows must not
    leak into any cell."""
    ref = reference()
    jnp = ref.jnp
    S = 3
    W = 6
    x, slot, w, y = _table_case(B, task, W=W)
    t = torch.as_tensor
    stats = splits.row_stats(t(y), t(w), S, task)
    tab = splits.feature_count_tables(t(x), t(slot), t(w), stats, W - 1, B)
    plain = feat_hist.feat_hist(t(x), t(slot), t(w), t(y), W=W, B=B,
                                num_stats=S, task=task)
    assert tab.shape == (2, 3, W, B, S)
    np.testing.assert_array_equal(plain.numpy(), tab.numpy())
    assert float(tab[:, :, 0].abs().sum()) == 0.0
    for k in range(2):
        labels = y.astype(np.int32) if task == "classification" else y
        r_stats = ref.splits.row_stats(jnp.asarray(labels), jnp.asarray(w[k]),
                                       S, task)
        want = np.asarray(ref.splits.feature_count_tables(
            jnp.asarray(x), jnp.asarray(slot[k]), jnp.asarray(w[k]), r_stats,
            W - 1, B))
        if task == "classification":
            np.testing.assert_array_equal(tab[k].numpy(), want)
        else:
            mag = splits.feature_count_tables(
                t(x), t(slot[k:k + 1]), t(w[k:k + 1]), stats[k:k + 1].abs(),
                W - 1, B)[0].numpy()                      # Σ|stat| per cell
            assert (np.abs(tab[k].numpy() - want) <= 1e-4 * mag + 1e-6).all()


@pytest.mark.parametrize("impurity,task", [("gini", "classification"),
                                           ("entropy", "classification"),
                                           ("variance", "regression")])
def test_best_numeric_split_histogram_matches_reference(impurity, task):
    ref = reference()
    jnp = ref.jnp
    rng = np.random.default_rng(7)
    L1, B = 6, 20
    if task == "classification":
        table = rng.integers(0, 4, (L1, B, 2)).astype(np.float32)
        table[:, 5:8] = 0                               # empty buckets
    else:
        w = rng.integers(0, 4, (L1, B)).astype(np.float32)
        yv = rng.normal(size=(L1, B)).astype(np.float32)
        table = np.stack([w, w * yv, w * yv * yv], -1)
    cand = np.array([False, True, True, False, True, True])
    table[4] = 0                                        # an empty leaf
    g, c = splits.best_numeric_split_histogram(
        torch.as_tensor(table), torch.as_tensor(cand), impurity, task, 2.0)
    g_r, c_r = ref.splits.best_numeric_split_histogram(
        jnp.asarray(table), jnp.asarray(cand), impurity, task, 2.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
    g_r = np.asarray(g_r)
    np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(g_r))
    fin = np.isfinite(g_r)
    if impurity == "gini":
        np.testing.assert_array_equal(g.numpy(), g_r)
    else:
        np.testing.assert_allclose(g.numpy()[fin], g_r[fin], rtol=1e-6)
    # a batch axis in front scores each table on its own
    g2, c2 = splits.best_numeric_split_histogram(
        torch.as_tensor(np.stack([table, table[::-1].copy()])),
        torch.as_tensor(np.stack([cand, cand[::-1].copy()])), impurity,
        task, 2.0)
    np.testing.assert_array_equal(g2[0].numpy(), g.numpy())
    np.testing.assert_array_equal(c2[0].numpy(), c.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_child_maps_match_reference(seed):
    ref = reference()
    rng = np.random.default_rng(seed)
    L, Lp = 7, 8
    ws = np.concatenate([[False], rng.random(L) < 0.6,
                         np.zeros(Lp - L, bool)])
    n_split = int(ws.sum())
    kc = np.zeros(2 * Lp + 1, np.int64)
    kc[1:2 * n_split + 1] = rng.integers(0, 5, 2 * n_split)
    Lp_next = max(8, 1 << max(0, (2 * n_split - 1).bit_length()))
    got = tree_lib._child_maps(ws, kc, L, Lp_next)
    want = ref.tree._child_maps(ws, kc, L, Lp_next)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Forest fits
# ---------------------------------------------------------------------------

def _ref_dataset(task):
    ref = reference()
    if task == "classification":
        return ref.synthetic.make_tabular("xor", n=1500, num_informative=3,
                                          num_useless=2, num_categorical=3,
                                          seed=1)
    rng = np.random.default_rng(6)
    n = 1200
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 5, size=(n, 1)).astype(np.int32)
    y = (2 * num[:, 0] + num[:, 1] ** 2 + cat[:, 0]
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return ref.dataset.from_numpy(num, cat, y, task="regression")


def _port_ds(rds):
    return from_numpy(np.asarray(rds.num), np.asarray(rds.cat),
                      np.asarray(rds.labels), rds.arities, rds.task)


def _params(task, num_bins):
    kw = dict(max_depth=5, split_mode="hist", num_bins=num_bins)
    if task == "regression":
        kw.update(max_depth=4, min_records=4, impurity="variance",
                  task="regression", bagging="none")
    return kw


def _ref_fit(task, num_bins):
    """The reference's hist forest (segment backend, subtraction on)."""
    key = (task, num_bins)
    if key not in _REF_FITS:
        ref = reference()
        _REF_FITS[key] = ref.forest.RandomForest(
            ref.tree.TreeParams(**_params(task, num_bins)), num_trees=3,
            seed=2, tree_batch=3).fit(_ref_dataset(task))
    return _REF_FITS[key]


def _port_fit(task, num_bins, tree_batch, **kw):
    params = tree_lib.TreeParams(**dict(_params(task, num_bins), **kw))
    return RandomForest(params, num_trees=3, seed=2, tree_batch=tree_batch,
                        device="cpu").fit(_port_ds(_ref_dataset(task)),
                                          collect_stats=True)


@pytest.mark.parametrize("subtract,tree_batch,backend", [
    (True, 1, "kernel"), (True, 3, "kernel"), (False, 1, "kernel"),
    (False, 3, "segment")])
def test_hist_classification_forest_bit_equal(subtract, tree_batch, backend):
    """Numeric + categorical columns, uint8 bins; the reference's trees
    do not depend on its own subtraction switch, so one reference fit
    holds every port variant."""
    r = _ref_fit("classification", 32)
    p = _port_fit("classification", 32, tree_batch, backend=backend,
                  hist_subtract=subtract)
    assert_trees_equal(r.trees, p.trees)
    assert any(t.is_cat.any() for t in p.trees)
    assert any((~t.is_cat & (t.feature >= 0)).any() for t in p.trees)
    rds = _ref_dataset("classification")
    num, cat = np.asarray(rds.num), np.asarray(rds.cat)
    np.testing.assert_array_equal(p.predict_proba(num, cat).numpy(),
                                  np.asarray(r.predict_proba(num, cat)))


def test_hist_uint16_bins_bit_equal():
    """num_bins = 300: the bin cache is uint16."""
    r = _ref_fit("classification", 300)
    p = _port_fit("classification", 300, 3, backend="kernel")
    assert_trees_equal(r.trees, p.trees)


def test_hist_regression_forest():
    """Regression rebuilds every level (no subtraction) and sums floats in
    another order: the same structure, node values and thresholds within
    the slice-1 regression tolerance."""
    r = _ref_fit("regression", 32)
    p = _port_fit("regression", 32, 3, backend="kernel")
    assert_trees_equal(r.trees, p.trees, STRUCT_KEYS)
    for a, b in zip(r.trees, p.trees):
        np.testing.assert_allclose(b.value, a.value, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-5,
                                   atol=1e-6)


def test_subtraction_equals_plain_rebuild():
    """Parent − sibling tables give the trees a full rebuild gives, while
    building narrower tables below the root."""
    a = _port_fit("classification", 16, 3, backend="kernel",
                  hist_subtract=True)
    b = _port_fit("classification", 16, 3, backend="kernel",
                  hist_subtract=False)
    assert_trees_equal(a.trees, b.trees, EXACT_KEYS)
    deep_a = [s.hist_table_bytes for s in a.level_stats[0][1:]]
    deep_b = [s.hist_table_bytes for s in b.level_stats[0][1:]]
    assert deep_a and all(x < y for x, y in zip(deep_a, deep_b))
    assert a.level_stats[0][0].hist_table_bytes == \
        b.level_stats[0][0].hist_table_bytes


def _build_kw(ds, params):
    t = torch.as_tensor
    num = t(ds.num)
    si = presort.presort_columns(num)
    return dict(num=num, cat=t(ds.cat), labels=t(ds.labels),
                sorted_vals=presort.gather_sorted(num, si), sorted_idx=si,
                arities=ds.arities, num_classes=ds.num_classes,
                params=params, seed=2, tree_indices=range(3))


def test_prequantized_reference_state_trains_same_trees():
    """The reference's `TabularDataset.quantize` output, as numpy, trains
    the reference's trees in the port."""
    rds = _ref_dataset("classification")
    r = _ref_fit("classification", 32)
    bin_of, edges = rds.quantize(32)
    params = tree_lib.TreeParams(backend="kernel",
                                 **_params("classification", 32))
    trees, _ = tree_lib.build_forest(bin_of=np.asarray(bin_of),
                                     bin_edges=np.asarray(edges),
                                     **_build_kw(_port_ds(rds), params))
    assert_trees_equal(r.trees, trees)


@pytest.mark.parametrize("bad,match", [
    ("edges", "disagrees with TreeParams"),
    ("dtype", "cannot hold"),
])
def test_prequantized_mismatch_raises_as_reference(bad, match):
    ref = reference()
    rds = _ref_dataset("classification")
    if bad == "edges":          # quantized at 16 bins, trained at 32
        bin_of, edges = rds.quantize(16)
        nb = 32
    else:                       # uint8 ids cannot hold 300 bins
        bin_of, edges = rds.quantize(64)
        edges = np.zeros((bin_of.shape[0], 300), np.float32)
        nb = 300
    kw = _params("classification", nb)
    with pytest.raises(ValueError, match=match):
        ref.tree.build_forest(
            num=rds.num, cat=rds.cat, labels=rds.labels,
            sorted_vals=ref.presort.gather_sorted(
                rds.num, ref.presort.presort_columns(rds.num)),
            sorted_idx=ref.presort.presort_columns(rds.num),
            arities=rds.arities, num_classes=2,
            params=ref.tree.TreeParams(**kw), seed=2, tree_indices=[0],
            bin_of=bin_of, bin_edges=edges)
    with pytest.raises(ValueError, match=match):
        tree_lib.build_forest(
            bin_of=np.asarray(bin_of), bin_edges=np.asarray(edges),
            **_build_kw(_port_ds(rds), tree_lib.TreeParams(**kw)))


@pytest.mark.parametrize("backend", ["segment", "scan", "kernel"])
def test_hist_tables_go_through_kernel_wrappers(backend, monkeypatch):
    """Whatever the backend label, hist mode builds its numeric and
    categorical tables through the `feat_hist` and `cat_hist` wrappers
    (which take their plain versions only for CPU tensors), so no hist
    fit on the card can bypass a kernel; the trees do not change."""
    from repro_torch.kernels import ops as kops
    calls = {"feature_tables": 0, "categorical_tables": 0}
    for name in calls:
        def counted(*a, _f=getattr(kops, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(kops, name, counted)
    p = _port_fit("classification", 32, 3, backend=backend)
    assert calls["feature_tables"] > 0 and calls["categorical_tables"] > 0
    assert_trees_equal(_ref_fit("classification", 32).trees, p.trees)


def test_make_plan_hist_and_exact_segment():
    """Hist mode resolves a plan on any backend; the exact numeric
    `segment` backend still raises, naming its ROADMAP item."""
    kw = dict(m_num=3, m_cat=1, max_arity=4, num_classes=2, m_prime=2)
    for backend in ("segment", "kernel", "scan"):
        plan = plan_lib.make_plan(
            tree_lib.TreeParams(split_mode="hist", backend=backend), **kw)
        assert plan.use_bin_cuts and plan.carries_tables
        assert plan.numeric.backend == backend
    reg = plan_lib.make_plan(tree_lib.TreeParams(
        split_mode="hist", task="regression", impurity="variance"), **kw)
    assert reg.use_bin_cuts and not reg.carries_tables
    with pytest.raises(NotImplementedError, match="segment"):
        plan_lib.make_plan(tree_lib.TreeParams(backend="segment"), **kw)
    with pytest.raises(ValueError, match="histogram engine"):
        plan_lib.make_plan(tree_lib.TreeParams(split_mode="hist"),
                           engine=plan_lib.ExactNumeric("kernel"), **kw)
