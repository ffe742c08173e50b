"""The port's split scorers vs `repro.core.splits` and a brute-force numpy
oracle.

Impurities and gains are bit-equal for binary gini (integer counts, the
reference's operation order) and within rtol 1e-6 for entropy and
variance (`log` and the variance quotient may differ by an ulp between
XLA and PyTorch).  The oracle cases (ties, a constant column, a
single-class leaf, bagged-out rows, closed rows) are those of
tests/test_split_oracle.py, whose few numpy helpers are copied here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import class_list, presort, splits
from repro_torch.kernels import split_scan
from test_torch_harness import reference


# ---------------------------------------------------------------------------
# The numpy oracle (copied from tests/test_split_oracle.py)
# ---------------------------------------------------------------------------

def _imp(h, impurity):
    h = np.asarray(h, np.float64)
    n = h.sum(-1)
    if impurity == "gini":
        return n - np.divide((h * h).sum(-1), n, out=np.zeros_like(n),
                             where=n > 0)
    if impurity == "entropy":
        p = np.divide(h, n[..., None], out=np.zeros_like(h),
                      where=n[..., None] > 0)
        plogp = np.where(h > 0, p * np.log(np.maximum(p, 1e-300)), 0.0)
        return -(n * plogp.sum(-1))
    w, wy, wy2 = h[..., 0], h[..., 1], h[..., 2]
    return np.maximum(wy2 - np.divide(wy * wy, w, out=np.zeros_like(w),
                                      where=w > 0), 0.0)


def _row_stats_np(y, w, C, task):
    if task == "classification":
        s = np.zeros((len(y), C), np.float64)
        s[np.arange(len(y)), y] = w
        return s
    y = np.asarray(y, np.float64)
    return np.stack([w, w * y, w * y * y], -1)


def oracle_numeric(vals, y, w, C, impurity="gini", task="classification",
                   min_records=1.0):
    inb = w > 0
    vals, y, w = vals[inb], y[inb], w[inb]
    if len(vals) < 2:
        return -np.inf, 0.0
    order = np.argsort(vals, kind="stable")
    vals, stats = vals[order], _row_stats_np(y[order], w[order], C, task)
    total = stats.sum(0)
    prefix = np.cumsum(stats, 0)
    cnt = (lambda h: h.sum(-1)) if task == "classification" \
        else (lambda h: h[..., 0])
    best_g, best_t = -np.inf, 0.0
    for k in range(len(vals) - 1):
        if vals[k + 1] <= vals[k]:
            continue
        left, right = prefix[k], total - prefix[k]
        if cnt(left) < min_records or cnt(right) < min_records:
            continue
        g = (_imp(total, impurity) - _imp(left, impurity)
             - _imp(right, impurity))
        if g > best_g:
            best_g = g
            best_t = (float(vals[k]) + float(vals[k + 1])) / 2.0
    return best_g, best_t


def oracle_gain_at(vals, y, w, C, thr, impurity="gini",
                   task="classification"):
    inb = w > 0
    vals, y, w = vals[inb], y[inb], w[inb]
    stats = _row_stats_np(y, w, C, task)
    left = stats[vals <= thr].sum(0)
    right = stats[vals > thr].sum(0)
    return (_imp(left + right, impurity) - _imp(left, impurity)
            - _imp(right, impurity))


def make_case(seed, n=260, L=4, C=3, m=3):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, m)).astype(np.float32)
    num[:, 0] = np.round(num[:, 0] * 2) / 2        # heavy ties
    num[:, 1] = 1.5                                # constant column
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)   # zero-weight rows
    y = rng.integers(0, C, n).astype(np.int32)
    y[leaf == 1] = C - 1                           # single-class leaf
    w[leaf == 2] = 0.0                             # fully bagged-out leaf
    return num, leaf, w, y


def port_supersplit(num, leaf, w, y, C, L, impurity, min_records,
                    task="classification"):
    """The port's plain split_scan over all columns, one tree."""
    t = torch.as_tensor
    numt = t(num)
    si = presort.presort_columns(numt)
    sv = presort.gather_sorted(numt, si)
    labels = t(y.astype(np.float32))
    S = C if task == "classification" else 3
    lf, ww = t(leaf)[None], t(w)[None]
    stats = splits.row_stats(labels, ww, S, task)
    totals = torch.zeros((1, L + 1, S))
    totals[0].index_add_(0, lf[0].long(),
                         torch.where((ww[0] > 0)[:, None], stats[0], 0.0))
    cand = torch.ones((1, num.shape[1], L + 1), dtype=torch.bool)
    cand[..., 0] = False
    g, thr = split_scan.split_scan(sv, si, lf, ww, labels, cand, totals,
                                   impurity=impurity, task=task,
                                   min_records=min_records)
    return g[0].numpy(), thr[0].numpy()


def check_against_oracle(seed, impurity="gini", min_records=1.0):
    num, leaf, w, y = make_case(seed)
    L, C = int(leaf.max()), int(y.max()) + 1
    g, t = port_supersplit(num, leaf, w, y, C, L, impurity, min_records)
    for j in range(num.shape[1]):
        for h in range(1, L + 1):
            sel = leaf == h
            bg, _ = oracle_numeric(num[sel, j], y[sel], w[sel], C,
                                   impurity, min_records=min_records)
            ctx = f"seed{seed}/col{j}/leaf{h}"
            if not np.isfinite(bg):
                assert not np.isfinite(g[j, h]), ctx
                continue
            np.testing.assert_allclose(g[j, h], bg, rtol=1e-4, atol=1e-4,
                                       err_msg=ctx)
            ga = oracle_gain_at(num[sel, j], y[sel], w[sel], C, t[j, h],
                                impurity)
            np.testing.assert_allclose(ga, bg, rtol=1e-4, atol=1e-4,
                                       err_msg=ctx + "/thr")
            iv = num[sel & (w > 0), j]
            assert iv.min() <= t[j, h] < iv.max(), ctx


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numeric_scan_matches_oracle(seed):
    check_against_oracle(seed)


def test_numeric_scan_matches_oracle_entropy_min_records():
    check_against_oracle(7, impurity="entropy", min_records=5.0)


def test_regression_scan_matches_oracle():
    rng = np.random.default_rng(11)
    n, L = 220, 3
    num = rng.normal(size=(n, 2)).astype(np.float32)
    num[:, 0] = np.round(num[:, 0] * 2) / 2
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    y = (num[:, 0] * 2 + rng.normal(size=n) * 0.3).astype(np.float32)
    g, t = port_supersplit(num, leaf, w, y, 2, L, "variance", 1.0,
                           task="regression")
    for j in range(2):
        for h in range(1, L + 1):
            sel = leaf == h
            bg, _ = oracle_numeric(num[sel, j], y[sel], w[sel], 2,
                                   "variance", "regression")
            if not np.isfinite(bg):
                assert not np.isfinite(g[j, h])
                continue
            np.testing.assert_allclose(g[j, h], bg, rtol=1e-3, atol=1e-3)
            ga = oracle_gain_at(num[sel, j], y[sel], w[sel], 2, t[j, h],
                                "variance", "regression")
            np.testing.assert_allclose(ga, bg, rtol=1e-3, atol=1e-3)


def test_degenerate_leaves_never_split():
    """Constant column / all-zero weights -> -inf."""
    num = np.full((40, 1), 2.5, np.float32)
    leaf = np.ones(40, np.int32)
    y = np.arange(40, dtype=np.int32) % 2
    for w in (np.ones(40, np.float32), np.zeros(40, np.float32)):
        g, _ = port_supersplit(num, leaf, w, y, 2, 1, "gini", 1.0)
        assert not np.isfinite(g[0, 1])


def test_categorical_scorer_binary_exhaustive():
    """Breiman-ordered prefix cuts find the best of all 2^(V-1) subsets."""
    for seed in (0, 3):
        rng = np.random.default_rng(seed)
        n, L, V = 300, 3, 5
        x = rng.integers(0, V, n).astype(np.int32)
        leaf = rng.integers(0, L + 1, n).astype(np.int32)
        w = rng.integers(0, 3, n).astype(np.float32)
        y = rng.integers(0, 2, n).astype(np.int32)
        y[leaf == 1] = 1
        stats = splits.row_stats(torch.as_tensor(y), torch.as_tensor(w), 2,
                                 "classification")
        table = splits.categorical_count_table(
            torch.as_tensor(x), torch.as_tensor(leaf), torch.as_tensor(w),
            stats, L, V)
        cand = torch.tensor([False] + [True] * L)
        g, mask = splits.best_categorical_split_from_table(table, cand)
        g, mask, tb = g.numpy(), mask.numpy(), table.numpy().astype(np.float64)
        for h in range(1, L + 1):
            total = tb[h].sum(0)
            best = -np.inf
            for subset in range(1, 2 ** V - 1):
                in_s = np.array([(subset >> v) & 1 for v in range(V)], bool)
                hl = tb[h][in_s].sum(0)
                if hl.sum() < 1 or (total - hl).sum() < 1:
                    continue
                best = max(best, _imp(total, "gini") - _imp(hl, "gini")
                           - _imp(total - hl, "gini"))
            if not np.isfinite(best):
                assert not np.isfinite(g[h])
                continue
            np.testing.assert_allclose(g[h], best, rtol=1e-4, atol=1e-4)
            hl = tb[h][mask[h]].sum(0)
            gm = (_imp(total, "gini") - _imp(hl, "gini")
                  - _imp(total - hl, "gini"))
            np.testing.assert_allclose(gm, best, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Against the reference's own functions
# ---------------------------------------------------------------------------

def _hist(rng, shape, S, task):
    if task == "classification":
        return rng.integers(0, 40, size=shape + (S,)).astype(np.float32)
    w = rng.integers(0, 30, size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    return np.stack([w, w * y, w * y * y * 1.3], -1).astype(np.float32)


@pytest.mark.parametrize("impurity,S,task", [
    ("gini", 2, "classification"), ("gini", 3, "classification"),
    ("entropy", 2, "classification"), ("entropy", 4, "classification"),
    ("variance", 3, "regression")])
def test_impurity_and_gain_match_reference(impurity, S, task):
    ref = reference()
    rng = np.random.default_rng(S)
    left, right = _hist(rng, (500,), S, task), _hist(rng, (500,), S, task)
    left[:7] = 0.0                                   # empty sides
    got_i = splits.weighted_impurity(torch.as_tensor(left), impurity).numpy()
    want_i = np.asarray(ref.splits.weighted_impurity(jnp.asarray(left),
                                                     impurity))
    got_g = splits.split_gain(torch.as_tensor(left), torch.as_tensor(right),
                              impurity).numpy()
    want_g = np.asarray(ref.splits.split_gain(
        jnp.asarray(left), jnp.asarray(right), impurity))
    if impurity == "gini" and S == 2:
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got_i, want_i, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6,
                                   atol=1e-6 * np.abs(want_i).max())


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_row_stats_match_reference(task):
    ref = reference()
    rng = np.random.default_rng(0)
    w = rng.integers(0, 4, 300).astype(np.float32)
    y = (rng.integers(0, 3, 300).astype(np.int32) if task == "classification"
         else rng.normal(size=300).astype(np.float32))
    np.testing.assert_array_equal(
        splits.row_stats(torch.as_tensor(y), torch.as_tensor(w), 3,
                         task).numpy(),
        np.asarray(ref.splits.row_stats(jnp.asarray(y), jnp.asarray(w), 3,
                                        task)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("L", [1, 6])
def test_numeric_scan_bit_equal_binary_gini(seed, L):
    """The plain scan equals the reference's sequential scan bit for bit."""
    ref = reference()
    rng = np.random.default_rng(seed)
    n = 700
    vals = np.sort(np.round(rng.normal(size=n) * 3) / 3).astype(np.float32)
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    cand = np.ones(L + 1, bool)
    cand[0] = False
    cand[1::3] = False if L > 2 else cand[1::3]
    rs = ref.splits.row_stats(jnp.asarray(y), jnp.asarray(w), 2,
                              "classification")
    g_r, t_r = ref.splits.best_numeric_split_scan(
        jnp.asarray(vals), jnp.asarray(leaf), jnp.asarray(w), rs,
        jnp.asarray(cand), L, "gini", "classification", 2.0)
    ts = splits.row_stats(torch.as_tensor(y), torch.as_tensor(w), 2,
                          "classification")
    for block in (None, 64, 1):
        g, t = splits.scan_supersplit(
            torch.as_tensor(vals), torch.as_tensor(leaf), torch.as_tensor(w),
            ts, torch.as_tensor(cand),
            _totals(leaf, w, ts, L), "gini", "classification", 2.0,
            block=block)
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_r))
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_r))
    g, t = splits.best_numeric_split_scan(
        torch.as_tensor(vals), torch.as_tensor(leaf), torch.as_tensor(w), ts,
        torch.as_tensor(cand), L, "gini", "classification", 2.0)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_r))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_r))


def _totals(leaf, w, stats, L):
    tot = torch.zeros((L + 1, stats.shape[-1]))
    tot.index_add_(0, torch.as_tensor(leaf).long(),
                   torch.where(torch.as_tensor(w > 0)[:, None], stats, 0.0))
    return tot


@pytest.mark.parametrize("task,impurity,C", [
    ("classification", "gini", 2), ("classification", "gini", 3),
    ("classification", "entropy", 2), ("regression", "variance", 3)])
def test_categorical_tables_and_breiman_match_reference(task, impurity, C):
    """Count tables and Breiman scoring on tie-heavy metrics (few
    categories with equal class ratios) give equal masks and gains."""
    ref = reference()
    rng = np.random.default_rng(C)
    n, L, V = 900, 5, 12
    x = rng.integers(0, V - 2, n).astype(np.int32)      # 2 empty categories
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    if task == "classification":
        y = (x % C).astype(np.int32)                    # ties in P(c | v)
        y[rng.random(n) < 0.1] = 0
    else:
        y = np.round(rng.normal(size=n) + (x % 3)).astype(np.float32)
    S = C if task == "classification" else 3
    rs = ref.splits.row_stats(jnp.asarray(y), jnp.asarray(w), S, task)
    want_tb = np.asarray(ref.splits.categorical_count_table(
        jnp.asarray(x), jnp.asarray(leaf), jnp.asarray(w), rs, L, V))
    ts = splits.row_stats(torch.as_tensor(y), torch.as_tensor(w), S, task)
    tb = splits.categorical_count_table(
        torch.as_tensor(x), torch.as_tensor(leaf), torch.as_tensor(w), ts, L,
        V)
    if task == "classification":
        np.testing.assert_array_equal(tb.numpy(), want_tb)
    else:
        np.testing.assert_allclose(tb.numpy(), want_tb, rtol=1e-6, atol=1e-5)
    cand = np.ones(L + 1, bool)
    cand[[0, 3]] = False
    g_r, m_r = ref.splits.best_categorical_split_from_table(
        jnp.asarray(want_tb), jnp.asarray(cand), impurity, task, 1.0)
    g, mk = splits.best_categorical_split_from_table(
        torch.as_tensor(want_tb), torch.as_tensor(cand), impurity, task, 1.0)
    np.testing.assert_array_equal(mk.numpy(), np.asarray(m_r))
    if impurity == "gini" and C == 2:
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_r))
    else:
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-6)
    # the one-column entry point builds the same table and scores it
    g1, mk1 = splits.best_categorical_split(
        torch.as_tensor(x), torch.as_tensor(leaf), torch.as_tensor(w), ts,
        torch.as_tensor(cand), L, V, impurity, task, 1.0)
    g1_r, m1_r = ref.splits.best_categorical_split(
        jnp.asarray(x), jnp.asarray(leaf), jnp.asarray(w), rs,
        jnp.asarray(cand), L, V, impurity, task, 1.0)
    np.testing.assert_array_equal(mk1.numpy(), np.asarray(m1_r))
    np.testing.assert_allclose(g1.numpy(), np.asarray(g1_r), rtol=1e-6)


def test_presort_stable_like_reference():
    ref = reference()
    rng = np.random.default_rng(0)
    num = np.round(rng.normal(size=(500, 3)) * 2).astype(np.float32)
    want = np.asarray(ref.presort.presort_columns(jnp.asarray(num)))
    got = presort.presort_columns(torch.as_tensor(num))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        presort.gather_sorted(torch.as_tensor(num), got).numpy(),
        np.asarray(ref.presort.gather_sorted(jnp.asarray(num),
                                             jnp.asarray(want))))


@pytest.mark.parametrize("L", [1, 3, 7, 100, 70_000])
def test_class_list_round_trip(L):
    rng = np.random.default_rng(L)
    ids = torch.as_tensor(rng.integers(0, L + 1, 1001).astype(np.int32))
    bits = class_list.bits_needed(L)
    words = class_list.pack(ids, bits)
    assert words.shape[0] == class_list.packed_words(1001, bits)
    assert int(words.max()) < 2 ** 32
    np.testing.assert_array_equal(class_list.unpack(words, bits, 1001).numpy(),
                                  ids.numpy())
    assert class_list.storage_bits(1001, L) == 1001 * bits
