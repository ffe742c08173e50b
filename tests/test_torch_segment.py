"""The port's `segment` backend — the reference's default exact path — vs
the reference.

The two segment scorers (`best_numeric_split_segment`, the counting sort
per column, and `best_numeric_split_leaf_ordered`, all columns over rows
already in leaf order), the incremental leaf-order partition
(`plan._partition_leaf_order`) and whole default-`TreeParams` forests are
run on the same numpy inputs through both packages.  Inputs have value
ties, empty leaves, out-of-bag rows, `min_records` > 1 and gini, entropy
and variance.  Binary gini gains and every threshold are bit-equal (the
stats are integer counts and every impurity keeps the reference's
operation order); entropy and variance gains within 1e-5 relative.
Forests: classification trees bit-equal node for node; regression trees
the same structure with values within rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import splits, tree as tree_lib
from repro_torch.core.level import engines, plan as plan_lib
from repro_torch.core.forest import RandomForest
from repro_torch.data import synthetic
from repro_torch.kernels import ops as kops
from test_torch_forest import (EXACT_KEYS, STRUCT_KEYS, assert_trees_equal,
                               fit_both, port_ds)
from test_torch_harness import reference

CASES = [("classification", "gini", 2, 1.0),
         ("classification", "gini", 2, 3.0),
         ("classification", "entropy", 3, 1.0),
         ("classification", "gini", 4, 2.0),
         ("regression", "variance", 0, 1.0),
         ("regression", "variance", 0, 4.0)]


def _rows(rng, n, L, task, C):
    """Leaf ids with leaf 3 left empty, Poisson bag weights, row stats."""
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    leaf[leaf == 3] = 2
    w = rng.poisson(1.0, n).astype(np.float32)
    if task == "classification":
        y = rng.integers(0, C, n)
        stats = (np.eye(C)[y] * w[:, None]).astype(np.float32)
    else:
        y = rng.normal(size=n).astype(np.float32)
        stats = np.stack([w, w * y, w * y * y], 1).astype(np.float32)
    return leaf, w, stats


def _check(impurity, got, want):
    (g, t), (g_r, t_r) = got, want
    g_r, t_r = np.asarray(g_r), np.asarray(t_r)
    if impurity == "gini":
        np.testing.assert_array_equal(g.numpy(), g_r)
    else:
        np.testing.assert_allclose(g.numpy(), g_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.numpy(), t_r)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("task,impurity,C,min_records", CASES)
def test_segment_scorer_matches_reference(task, impurity, C, min_records,
                                          seed):
    ref = reference()
    jnp = ref.jnp
    rng = np.random.default_rng(seed)
    n, L = 400, 6
    vals = np.sort(np.round(rng.normal(size=n), 1)).astype(np.float32)
    leaf, w, stats = _rows(rng, n, L, task, C)
    cand = rng.random(L + 1) < 0.8
    cand[0] = False
    want = ref.splits.best_numeric_split_segment(
        jnp.asarray(vals), jnp.asarray(leaf), jnp.asarray(w),
        jnp.asarray(stats), jnp.asarray(cand), L, impurity, task,
        min_records)
    got = splits.best_numeric_split_segment(
        torch.as_tensor(vals), torch.as_tensor(leaf), torch.as_tensor(w),
        torch.as_tensor(stats), torch.as_tensor(cand), L, impurity, task,
        min_records)
    _check(impurity, got, want)
    # leading dimensions batch: every column equals its own call
    cols = np.stack([vals, vals[::-1].copy() * -1.0])
    g2, t2 = splits.best_numeric_split_segment(
        torch.as_tensor(cols), torch.as_tensor(np.stack([leaf, leaf])),
        torch.as_tensor(np.stack([w, w])),
        torch.as_tensor(np.stack([stats, stats])),
        torch.as_tensor(np.stack([cand, cand])), L, impurity, task,
        min_records)
    np.testing.assert_array_equal(g2[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(t2[0].numpy(), got[1].numpy())


def _leaf_order(vals, leaf):
    """Each column's rows sorted by (leaf, value), stable."""
    return np.stack([np.lexsort((np.argsort(np.argsort(v, kind="stable")),
                                 leaf)) for v in vals]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("task,impurity,C,min_records", CASES)
def test_leaf_ordered_scorer_matches_reference(task, impurity, C,
                                               min_records, seed):
    ref = reference()
    jnp = ref.jnp
    rng = np.random.default_rng(seed + 10)
    n, L, m = 350, 7, 3
    vals = np.round(rng.normal(size=(m, n)), 1).astype(np.float32)
    leaf, w, stats = _rows(rng, n, L, task, C)
    ords = _leaf_order(vals, leaf)
    lf_pos = leaf[ords[0]]
    ord_vals = np.take_along_axis(vals, ords, 1)
    inbag = (w[ords] > 0) & (lf_pos > 0)[None]
    cand = rng.random((m, L + 1)) < 0.8
    cand[:, 0] = False
    rc = np.bincount(leaf, minlength=L + 1).astype(np.int32)
    tot = np.zeros((L + 1, stats.shape[1]), np.float32)
    np.add.at(tot, leaf, np.where(((w > 0) & (leaf > 0))[:, None], stats, 0))
    # classification scores against the shared level totals, regression
    # reduces each column's own (what the engines pass)
    shared = task == "classification"
    want = ref.splits.best_numeric_split_leaf_ordered(
        jnp.asarray(ord_vals), jnp.asarray(lf_pos), jnp.asarray(inbag),
        jnp.asarray(stats[ords]), jnp.asarray(cand), L, impurity, task,
        min_records, totals=jnp.asarray(tot) if shared else None,
        row_counts=jnp.asarray(rc))
    for row_counts in (torch.as_tensor(rc), None):
        got = splits.best_numeric_split_leaf_ordered(
            torch.as_tensor(ord_vals), torch.as_tensor(lf_pos),
            torch.as_tensor(inbag), torch.as_tensor(stats[ords]),
            torch.as_tensor(cand), L, impurity, task, min_records,
            totals=torch.as_tensor(tot) if shared else None,
            row_counts=row_counts)
        _check(impurity, got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_leaf_order_matches_reference(seed):
    """One level of the incremental layout: the same permutation as the
    reference's, and the stable (leaf, value) order of the new leaves."""
    ref = reference()
    jnp = ref.jnp
    from repro.core.level import plan as ref_plan
    rng = np.random.default_rng(seed)
    T, m, n, L = 2, 3, 300, 6
    vals = np.round(rng.normal(size=(m, n)), 1).astype(np.float32)
    args = {k: [] for k in ("ord", "lf_pos", "bits", "nl", "nr", "rc", "kc")}
    new_leaf = []
    for t in range(T):
        leaf = rng.integers(0, L + 1, n).astype(np.int32)
        ords = _leaf_order(vals, leaf)
        split = rng.random(L + 1) < 0.7
        split[0] = False
        k = np.cumsum(split)
        nl = np.where(split, 2 * k - 1, 0).astype(np.int32)
        nr = np.where(split, 2 * k, 0).astype(np.int32)
        bits = rng.random(n) < 0.5
        nxt = np.where(leaf > 0, np.where(bits, nl[leaf], nr[leaf]), 0)
        new_leaf.append(nxt)
        for key, v in zip(args, (ords, leaf[ords[0]], bits, nl, nr,
                                 np.bincount(leaf, minlength=L + 1),
                                 np.bincount(nxt, minlength=2 * L + 1))):
            args[key].append(v)
    a = {k: np.stack(v) for k, v in args.items()}
    want = np.asarray(ref_plan._partition_leaf_order(
        *(jnp.asarray(a[k].astype(np.int32) if a[k].dtype != bool else a[k])
          for k in args)))
    got = plan_lib._partition_leaf_order(
        *(torch.as_tensor(a[k]) for k in args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for t in range(T):       # closed rows first, in their parents' order,
        closed = int((new_leaf[t] == 0).sum())   # then the open leaves
        for j in range(m):
            o = got[t, j].numpy()
            np.testing.assert_array_equal(np.sort(o), np.arange(n))
            assert (new_leaf[t][o[:closed]] == 0).all()
            np.testing.assert_array_equal(o[closed:], _leaf_order(
                vals[j:j + 1], new_leaf[t])[0][closed:])


def mixed(task, C, seed, n=700):
    """Reference dataset of 3 numeric (one with ties) and 2 categorical
    columns: C-class labels with 10% noise, or a noisy regression target."""
    ref = reference()
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    num[:, 2] = np.round(num[:, 2], 1)
    cat = np.stack([rng.integers(0, a, n) for a in (3, 7)], 1).astype(
        np.int32)
    if task == "regression":
        y = (2 * num[:, 0] + cat[:, 1] % 3
             + 0.3 * rng.normal(size=n)).astype(np.float32)
    else:
        y = ((num[:, 0] > 0).astype(int) + (num[:, 1] > 0.5)
             + (cat[:, 0] == 1)) % C
        noise = rng.random(n) < 0.1
        y = np.where(noise, rng.integers(0, C, n), y).astype(np.int32)
    return ref.dataset.from_numpy(num, cat, y, None, task)


@pytest.mark.parametrize("case", ["binary", "multiclass", "regression"])
def test_default_params_forest_matches_reference(case):
    """`TreeParams()` defaults (segment backend, max_depth 20) with numeric
    and categorical columns, against the reference's default fit.

    Regression keeps `min_records=10`: a leaf of a few rows often has
    exact gain ties between columns that cut its rows the same way, and
    their float32 values depend on the summation order, so there even the
    reference's own segment and scan backends pick different columns."""
    task = "regression" if case == "regression" else "classification"
    extra = dict(task=task, impurity="variance", min_records=10) \
        if task == "regression" else {}
    rds = mixed(task, 4 if case == "multiclass" else 2, 3)
    r, p = fit_both(rds, extra, extra, 3, 1, None, None)
    if task == "classification":
        assert_trees_equal(r.trees, p.trees)
        return
    assert_trees_equal(r.trees, p.trees, STRUCT_KEYS)
    for a, b in zip(r.trees, p.trees):
        for k in ("value", "threshold", "n_node"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impurity,min_records", [("gini", 1.0),
                                                  ("entropy", 10.0)])
def test_segment_options_match_reference(impurity, min_records):
    """Three classes, usb, tree batches of 3.  Entropy keeps
    `min_records=10`: the reference evaluates its log at other shapes in
    its numeric and categorical engines, which can break an exact gain tie
    between them in small leaves either way."""
    rds = mixed("classification", 3, 7)
    kw = dict(max_depth=7, impurity=impurity, min_records=min_records,
              usb=impurity == "entropy")
    r, p = fit_both(rds, kw, kw, 4, 2, 3, 3)
    assert_trees_equal(r.trees, p.trees)


def test_segment_scan_kernel_grow_the_same_trees(monkeypatch):
    """The three exact backends of the port grow the same trees; the
    segment fits never call the split_scan adapter, and a column-chunked
    segment scorer changes nothing."""
    ds = synthetic.make_tabular("xor", 900, 3, 2, 3, seed=8)
    fits = {b: RandomForest(tree_lib.TreeParams(max_depth=6, backend=b),
                            num_trees=3, seed=2, tree_batch=3,
                            device="cpu").fit(ds)
            for b in ("kernel", "scan")}

    def no_split_scan(*a, **k):
        raise AssertionError("the segment backend called split_scan")
    monkeypatch.setattr(kops, "split_scan_supersplit", no_split_scan)
    fits["segment"] = RandomForest(tree_lib.TreeParams(max_depth=6),
                                   num_trees=3, seed=2, tree_batch=2,
                                   device="cpu").fit(ds)
    monkeypatch.setattr(engines, "_SEGMENT_CHUNK_ELEMS", 900 * 3)
    fits["chunked"] = RandomForest(tree_lib.TreeParams(max_depth=6),
                                   num_trees=3, seed=2, tree_batch=3,
                                   device="cpu").fit(ds)
    for b in ("scan", "segment", "chunked"):
        assert_trees_equal(fits["kernel"].trees, fits[b].trees, EXACT_KEYS)


def test_readme_quickstart_runs_on_cpu():
    """The README quickstart, `TreeParams(max_depth=12, backend="segment")`
    on its xor data, trains through the port on the CPU."""
    train, test = synthetic.train_test_split(synthetic.make_tabular(
        "xor", n=6000, num_informative=2, num_useless=8, seed=0))
    rf = RandomForest(tree_lib.TreeParams(max_depth=12, backend="segment"),
                      num_trees=10, seed=42, device="cpu").fit(train)
    assert rf.auc(test) > 0.9
    assert 0.5 < rf.oob_score(train) <= 1.0
    imp = rf.feature_importances()
    assert imp.shape == (train.m,) and abs(float(imp.sum()) - 1) < 1e-5
    assert imp[:2].sum() > 0.5          # the two informative columns


# ---------------------------------------------------------------------------
# Card legs: the same code on CUDA tensors against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment path's CUDA scans and "
                    "segment reductions run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("task,impurity,C,min_records", CASES)
def test_segment_scorers_on_card_equal_cpu(cuda, task, impurity, C,
                                           min_records):
    """Both scorers on the card: gini gains bit-equal to the CPU's;
    entropy and variance gains, whose log and division round otherwise on
    the card, within 1e-6 of the impurities' scale (the total weight),
    since a gain is a difference of impurities that large; thresholds
    equal."""
    rng = np.random.default_rng(5)
    n, L, m = 20000, 9, 3
    vals = np.round(rng.normal(size=(m, n)), 2).astype(np.float32)
    leaf, w, stats = _rows(rng, n, L, task, C)
    ords = _leaf_order(vals, leaf)
    lf_pos = leaf[ords[0]]
    cand = rng.random((m, L + 1)) < 0.8
    cand[:, 0] = False
    args = [np.take_along_axis(vals, ords, 1), lf_pos,
            (w[ords] > 0) & (lf_pos > 0)[None], stats[ords], cand]
    for fn, ins in (
            (splits.best_numeric_split_leaf_ordered, args),
            (splits.best_numeric_split_segment,
             [np.sort(vals, 1), leaf[None].repeat(m, 0),
              w[None].repeat(m, 0), stats[None].repeat(m, 0), cand])):
        cpu = fn(*(torch.as_tensor(a) for a in ins), L, impurity, task,
                 min_records)
        got = fn(*(torch.as_tensor(a).to(cuda) for a in ins), L, impurity,
                 task, min_records)
        if impurity == "gini":
            np.testing.assert_array_equal(got[0].cpu().numpy(),
                                          cpu[0].numpy())
        else:       # a gain is a difference of impurities of the order
            np.testing.assert_allclose(   # of the leaf's weight: float32
                got[0].cpu().numpy(), cpu[0].numpy(), rtol=1e-5,
                atol=1e-6 * float(np.abs(stats).sum()))
        np.testing.assert_array_equal(got[1].cpu().numpy(), cpu[1].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("params", [
    dict(), dict(bagging="multinomial"),
    dict(min_records=40, prune_closed_frac=0.05),
    dict(split_mode="hist", num_bins=64, min_records=40,
         prune_closed_frac=0.05),
    dict(task="regression", impurity="variance", min_records=10),
    dict(impurity="entropy", min_records=10)],
    ids=["default", "multinomial", "pruned", "hist-pruned", "regression",
         "entropy"])
def test_segment_forest_on_card_equals_cpu_fit(cuda, params):
    """Default-backend fits on the card grow the CPU fit's trees (bit for
    bit; regression: the structure, values within 1e-5) and repeat
    identically."""
    task = params.get("task", "classification")
    rds = mixed(task, 2, 11, n=6000)
    ds = port_ds(rds)
    p = tree_lib.TreeParams(max_depth=8, **params)
    gpu = RandomForest(p, num_trees=3, seed=1, tree_batch=3).fit(ds)
    again = RandomForest(p, num_trees=3, seed=1, tree_batch=3).fit(ds)
    cpu = RandomForest(p, num_trees=3, seed=1, tree_batch=3,
                       device="cpu").fit(ds)
    assert_trees_equal(gpu.trees, again.trees)
    if task == "classification":
        assert_trees_equal(cpu.trees, gpu.trees)
        return
    assert_trees_equal(cpu.trees, gpu.trees, STRUCT_KEYS)
    for a, b in zip(cpu.trees, gpu.trees):
        np.testing.assert_allclose(b.value, a.value, rtol=1e-5, atol=1e-5)
