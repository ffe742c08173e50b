"""Class counts past 2^24: the accumulators that sum them as int32, and the
float32 paths that refuse such a tree.

float32 holds every integer only below 2^24, so a class count summed in
float32 past that rounds at each odd addition, with no error.  The level's
totals, the `cat_hist` tables, the `split_scan` prefixes and the `breiman`
count sums are int32 (exact to 2^31), converted to float32 once each where
a gain or a metric is computed; the host tree keeps its node weights in
float64.  No case here needs 2^24 rows: a hundred rows carry bag weights
near 2^22 each, so the sums pass 2^25.  Each plain version is held against
a numpy oracle that sums in int64 and converts each sum once; the `-m gpu`
legs hold the kernels to their plain versions at the same sums.

The paths that still count in float32 (hist mode's tables, the streamed
driver, the mesh engines, legacy closures) raise `ValueError` once a
tree's in-bag weight reaches 2^24.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bagging, splits
from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import ArrayRowSource, from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.core.level import engines, plan as plan_lib, sharded
from repro_torch.kernels import breiman, cat_hist, ops, split_scan

BIG = 1 << 22            # a bag weight near 2^22: 8 rows pass 2^25


def _case(seed=0, T=2, n=96, m=3, V=3, L=2, C=2, base=BIG, held=None):
    """Rows whose integer bag weights lie in [base, base + 4096), a tenth
    of them out of the bag (weight 0); their categories are the first
    `held` of V (all by default)."""
    rng = np.random.default_rng(seed)
    w = (base + rng.integers(0, 4096, (T, n))).astype(np.float32)
    w[rng.random((T, n)) < 0.1] = 0
    return dict(
        w=w, leaf=rng.integers(0, L + 1, (T, n)).astype(np.int32),
        y=rng.integers(0, C, n).astype(np.int32),
        x=rng.integers(0, held or V, (m, n)).astype(np.int32),
        num=rng.permutation(n * m).reshape(n, m).astype(np.float32),
        T=T, n=n, m=m, V=V, L=L, C=C)


def _past_float32(exact):
    """The exact int64 counts reach past 2^25 and hold values past 2^24
    that float32 cannot hold (so no float32 sum could have given them)."""
    exact = np.asarray(exact, np.int64)
    big = exact[exact > 1 << 24]
    assert big.size and big.max() > 1 << 25
    assert (big.astype(np.float32).astype(np.int64) != big).any()


def _exact_totals(c):
    """(T, L+1, C) int64 per-leaf class weights of the in-bag rows."""
    out = np.zeros((c["T"], c["L"] + 1, c["C"]), np.int64)
    for t in range(c["T"]):
        for r in range(c["n"]):
            if c["w"][t, r] > 0 and c["leaf"][t, r] > 0:
                out[t, c["leaf"][t, r], c["y"][r]] += int(c["w"][t, r])
    return out


def _exact_tables(c):
    """(T, m, L+1, V, C) int64 category tables of the in-bag rows."""
    out = np.zeros((c["T"], c["m"], c["L"] + 1, c["V"], c["C"]), np.int64)
    for t in range(c["T"]):
        for r in range(c["n"]):
            if c["w"][t, r] > 0 and c["leaf"][t, r] > 0:
                for j in range(c["m"]):
                    out[t, j, c["leaf"][t, r], c["x"][j, r], c["y"][r]] += \
                        int(c["w"][t, r])
    return out


def _gain(left, right, impurity="gini"):
    """The scorers' float32 gain of exact int64 (left, right) counts."""
    return splits.split_gain(torch.as_tensor(np.asarray(left, np.int64)),
                             torch.as_tensor(np.asarray(right, np.int64)),
                             impurity)


def _oracle_scan(c, cand, min_records=1.0):
    """Alg. 1 over each (tree, column, leaf) in presorted order with int64
    prefixes: (gain, threshold) (T, m, L+1), the first best row winning."""
    T, m, L1 = c["T"], c["m"], c["L"] + 1
    gain = np.full((T, m, L1), -np.inf, np.float32)
    thr = np.zeros((T, m, L1), np.float32)
    tot = _exact_totals(c)
    for t in range(T):
        for j in range(m):
            order = np.argsort(c["num"][:, j], kind="stable")
            for h in range(1, L1):
                if not cand[t, j, h]:
                    continue
                rows = [r for r in order if c["leaf"][t, r] == h
                        and c["w"][t, r] > 0]
                left = np.zeros(c["C"], np.int64)
                prev = None
                for r in rows:
                    a = c["num"][r, j]
                    if prev is not None and a > prev:
                        right = tot[t, h] - left
                        if left.sum() >= min_records \
                                and right.sum() >= min_records:
                            g = float(_gain(left, right))
                            if g > gain[t, j, h]:
                                gain[t, j, h] = g
                                thr[t, j, h] = (np.float32(a)
                                                + np.float32(prev)) \
                                    * np.float32(0.5)
                    left[c["y"][r]] += int(c["w"][t, r])
                    prev = a
    return gain, thr


def _oracle_breiman(tables, cand, min_records=1.0):
    """Breiman's ordering and prefix cuts of int64 tables (T, m, L1, V, C):
    the metric and the gains from float32 conversions of exact sums.
    Returns (gains, masks) where a cut is valid."""
    T, m, L1, V, C = tables.shape
    gains = np.full((T, m, L1), -np.inf, np.float32)
    masks = np.zeros((T, m, L1, V), bool)
    for t, j, h in np.ndindex(T, m, L1):
        tab = tables[t, j, h]
        tc = tab.sum(-1)
        metric = np.where(tc > 0, tab[:, -1].astype(np.float32)
                          / np.maximum(tc.astype(np.float32), 1e-12),
                          np.float32(np.inf))
        order = np.argsort(metric, kind="stable")
        prefix = np.cumsum(tab[order], 0)
        for p in range(V - 1):
            left, right = prefix[p], prefix[-1] - prefix[p]
            if not (cand[t, j, h] and left.sum() >= min_records
                    and right.sum() >= min_records):
                continue
            g = float(_gain(left, right))
            if g > gains[t, j, h]:
                gains[t, j, h] = g
                masks[t, j, h] = False
                masks[t, j, h, order[:p + 1]] = True
    return gains, masks


def _cand(c, seed=1):
    rng = np.random.default_rng(seed)
    cand = rng.random((c["T"], c["m"], c["L"] + 1)) < 0.8
    cand[..., 0] = False
    return cand


def _scan_inputs(c, device="cpu"):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    si = np.argsort(c["num"].T, axis=-1, kind="stable").astype(np.int32)
    sv = np.take_along_axis(c["num"].T, si, -1)
    return (t(sv), t(si), t(c["leaf"]), t(c["w"]),
            t(c["y"].astype(np.float32)), t(_cand(c)),
            t(_exact_totals(c).astype(np.int32)))


ACCUMULATORS = ["leaf_totals", "cat_hist", "split_scan", "breiman"]


@pytest.mark.parametrize("accumulator", ACCUMULATORS)
def test_plain_accumulators_are_exact_past_2_24(accumulator):
    """Each widened accumulator's plain version gives the int64 oracle's
    sums (and the gains of their float32 conversions) past 2^25."""
    c = _case()
    t = torch.as_tensor
    if accumulator == "leaf_totals":
        stats = splits.row_stats(t(c["y"]), t(c["w"]), c["C"],
                                 "classification")
        got = plan_lib._leaf_totals(t(c["leaf"]), stats, t(c["w"]), c["L"])
        want = _exact_totals(c)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        _past_float32(want)
    elif accumulator == "cat_hist":
        want = _exact_tables(c)
        for got in (cat_hist.cat_hist(
                t(c["x"]), t(c["leaf"]), t(c["w"]), t(c["y"]).float(),
                L1=c["L"] + 1, V=c["V"], num_stats=c["C"]),
                ops.categorical_tables(t(c["x"]), t(c["leaf"]), t(c["w"]),
                                       t(c["y"]), V=c["V"], Lp=c["L"],
                                       num_classes=c["C"])):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        _past_float32(want)
    elif accumulator == "split_scan":
        g, thr = split_scan.split_scan(*_scan_inputs(c))
        want_g, want_t = _oracle_scan(c, _cand(c))
        np.testing.assert_array_equal(g.numpy(), want_g)
        np.testing.assert_array_equal(thr.numpy(), want_t)
        assert np.isfinite(want_g).sum() > 5
        _past_float32(_exact_totals(c))
    else:       # the categorical engine's tables, then its scorer
        tables = _exact_tables(c)
        cand = _cand(c)
        st = engines.LevelStatics(m_num=0, m_cat=c["m"], max_arity=c["V"],
                                  num_classes=c["C"], impurity="gini",
                                  task="classification", min_records=1.0)
        g, mk = engines._score_tables(ops.categorical_tables(
            t(c["x"]), t(c["leaf"]), t(c["w"]), t(c["y"]), V=c["V"],
            Lp=c["L"], num_classes=c["C"]), t(cand), st)
        want_g, want_m = _oracle_breiman(tables, cand)
        fin = np.isfinite(want_g)
        assert fin.sum() > 5
        np.testing.assert_array_equal(g.numpy(), want_g)
        np.testing.assert_array_equal(mk.numpy()[fin], want_m[fin])
        _past_float32(tables.sum(-2))


def _big_bagging(monkeypatch, base=BIG):
    """Bag weights near `base` for every tree of a fit (in memory and
    streamed), drawn from the tree index."""
    def forest(seed, tree_indices, n, mode="poisson", device=None):
        rows = [np.random.default_rng(int(t) + 17).integers(0, 4096, n)
                + base for t in tree_indices]
        return torch.as_tensor(np.stack(rows).astype(np.float32),
                               device=device)
    monkeypatch.setattr(bagging, "bag_counts_forest", forest)
    monkeypatch.setattr(
        bagging, "bag_counts",
        lambda seed, t, n, mode="poisson", device=None: forest(
            seed, [t], n, mode, device)[0])
    return forest


def _rows(n=64, seed=3):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 2)).astype(np.float32)
    cat = rng.integers(0, 4, (n, 1)).astype(np.int32)
    y = ((num[:, 0] > 0) ^ (cat[:, 0] == 1)).astype(np.int32)
    return num, cat, y


@pytest.mark.parametrize("backend", ["kernel", "scan", "segment"])
def test_host_tree_node_weights_are_exact_past_2_24(monkeypatch, backend):
    """Through `RandomForest.fit` on every exact backend: each node's
    `n_node` is its in-bag weight exactly (float64), its children's add up
    to it, and `LevelStats.max_class_weight` reads the root's largest
    class weight."""
    forest = _big_bagging(monkeypatch)
    num, cat, y = _rows()
    rf = RandomForest(tree_lib.TreeParams(max_depth=3, backend=backend),
                      num_trees=2, seed=5, tree_batch=2, device="cpu").fit(
        from_numpy(num, cat, y, [4]), collect_stats=True)
    w = forest(5, [0, 1], len(y)).numpy().astype(np.int64)
    for k, tr in enumerate(rf.trees):
        root = np.array([w[k][y == c].sum() for c in range(2)], np.int64)
        assert tr.n_node.dtype == np.float64
        assert tr.n_node[0] == root.sum() and root.sum() > 1 << 26
        assert rf.level_stats[k][0].max_class_weight == root.max()
        _past_float32(root)
        np.testing.assert_array_equal(
            tr.value[0], (root / root.sum()).astype(np.float32))
        split = tr.feature >= 0
        kids = tr.children[split]
        np.testing.assert_array_equal(
            tr.n_node[kids[:, 0]] + tr.n_node[kids[:, 1]], tr.n_node[split])
        assert split.sum() >= 3


def test_exact_backends_give_the_same_trees_past_2_24(monkeypatch):
    """`segment`, `scan` and `kernel` grow the same trees past 2^24: each
    rounds the exact left and right counts to float32 once, so their
    gains, and the splits they pick, agree bit for bit."""
    _big_bagging(monkeypatch)
    num, cat, y = _rows(n=256, seed=11)
    fits = [RandomForest(tree_lib.TreeParams(max_depth=5, backend=b),
                         num_trees=3, seed=9, tree_batch=3,
                         device="cpu").fit(from_numpy(num, cat, y, [4])).trees
            for b in ("segment", "scan", "kernel")]
    assert fits[0][0].n_node[0] > 1 << 26
    assert sum(int((tr.feature >= 0).sum()) for tr in fits[0]) >= 12
    for other in fits[1:]:
        for a, b in zip(fits[0], other):
            for f in ("feature", "threshold", "is_cat", "cat_mask",
                      "children", "value", "n_node", "gain"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f)


def _legacy_fit(ds):
    with pytest.warns(UserWarning, match="legacy"):
        RandomForest(tree_lib.TreeParams(max_depth=2), num_trees=1,
                     device="cpu").fit(ds, supersplit_fn=lambda *a: None)


FLOAT_PATHS = ["hist", "streamed", "legacy", "ShardedExactNumeric",
               "ShardedHistNumeric", "ShardedCategorical"]


@pytest.mark.parametrize("path", FLOAT_PATHS)
def test_float_count_paths_refuse_trees_past_2_24(monkeypatch, path):
    """The paths that count classes in float32 raise ValueError naming the
    limit once a tree's in-bag weight reaches 2^24, and take one below."""
    num, cat, y = _rows()
    if path.startswith("Sharded"):
        eng = getattr(sharded, path)(mesh=object())
        kind = "cat_engine" if eng.kind == "categorical" else "engine"
        hist = path == "ShardedHistNumeric"
        plan = plan_lib.make_plan(
            tree_lib.TreeParams(split_mode="hist" if hist else "exact"),
            m_num=2, m_cat=1, max_arity=4, num_classes=2, m_prime=2,
            **{kind: eng})
        assert plan.count_limit == 1 << 24
        plan.check_counts([(1 << 24) - 1, 5.0])
        with pytest.raises(ValueError, match=r"float32.*2\^24.*N1"):
            plan.check_counts([1.0, float(1 << 24)])
        return
    _big_bagging(monkeypatch, base=1 << 19)          # 64 rows: past 2^24
    with pytest.raises(ValueError, match=r"float32, exact only below 2\^24"):
        if path == "hist":
            RandomForest(tree_lib.TreeParams(split_mode="hist", num_bins=8,
                                             max_depth=2), num_trees=2,
                         device="cpu").fit(from_numpy(num, cat, y, [4]))
        elif path == "streamed":
            src = ArrayRowSource.from_dataset(from_numpy(num, None, y), 8)
            RandomForest(tree_lib.TreeParams(split_mode="hist", num_bins=8,
                                             max_depth=2), num_trees=2,
                         device="cpu").fit_streamed(src)
        else:
            _legacy_fit(from_numpy(num, None, y))


def test_exact_plans_count_to_2_31():
    """The local exact engines hold int32 counts: a tree past 2^24 trains,
    one at 2^31 is refused."""
    plan = plan_lib.make_plan(tree_lib.TreeParams(backend="kernel"), m_num=2,
                              m_cat=1, max_arity=4, num_classes=2, m_prime=2)
    assert isinstance(plan.numeric, engines.ExactNumeric)
    assert plan.count_limit == 1 << 31
    plan.check_counts([float(1 << 30)])
    with pytest.raises(ValueError, match=r"int32, exact only below 2\^31"):
        plan.check_counts([float(1 << 31)])


# ---------------------------------------------------------------------------
# The kernels at the same sums (a CUDA card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only on the GPU")
    return torch.device("cuda")


# (n, base weight, V, categories that hold rows, L): a hundred rows near
# 2^22 in one table tile; 600 near 2^21 in tiles of a table too wide for one
# block, so bucketed by leaf; 10^5 rows near 2^13 whose leaves split over
# several blocks (cat_hist's device atomics).  All pass 2^25.
CARD_CASES = [(96, BIG, 3, 3, 2), (600, 1 << 21, 10000, 2, 4),
              (100_000, 1 << 13, 7, 4, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("accumulator", ["cat_hist", "split_scan", "breiman"])
@pytest.mark.parametrize("n,base,V,held,L", CARD_CASES)
def test_kernels_are_exact_past_2_24(cuda, accumulator, n, base, V, held, L):
    """cat_hist's int32 tables equal the exact ones; split_scan's and
    breiman's gains (and masks, thresholds) equal their plain versions'
    bit for bit, all past 2^25."""
    c = _case(seed=n + V, n=n, V=V, L=L, base=base, held=held)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    if accumulator == "cat_hist":
        args = (t(c["x"]), t(c["leaf"]), t(c["w"]), t(c["y"]).float())
        kw = dict(L1=L + 1, V=V, num_stats=c["C"])
        got = cat_hist.cat_hist(*[a.to(cuda) for a in args], **kw)
        want = cat_hist.cat_hist_plain(*args, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
        _past_float32(want.numpy())
    elif accumulator == "split_scan":
        ins = _scan_inputs(c)
        g, thr = split_scan.split_scan(*[a.to(cuda) for a in ins])
        g_p, thr_p = split_scan.split_scan_plain(*ins)
        np.testing.assert_array_equal(g.cpu().numpy(), g_p.numpy())
        np.testing.assert_array_equal(thr.cpu().numpy(), thr_p.numpy())
        assert torch.isfinite(g_p).sum() > 5
        _past_float32(ins[-1].numpy())
    else:
        tables = cat_hist.cat_hist_plain(
            t(c["x"]), t(c["leaf"]), t(c["w"]), t(c["y"]).float(), L1=L + 1,
            V=V, num_stats=c["C"])
        cand = t(_cand(c))
        g, mk = breiman.breiman(tables.to(cuda), cand.to(cuda))
        g_p, mk_p = breiman.breiman_plain(tables, cand)
        fin = torch.isfinite(g_p)
        assert int(fin.sum()) > 5
        np.testing.assert_array_equal(g.cpu().numpy(), g_p.numpy())
        np.testing.assert_array_equal(mk.cpu()[fin].numpy(),
                                      mk_p[fin].numpy())
        _past_float32(tables.sum(-2).numpy())
