"""The Breiman scorer of categorical count tables: the op the categorical
engine calls, the design of its CUDA kernel played out on the CPU, the
contract the kernel relies on, and — on a CUDA card — the kernel against
its plain version.

`ops.breiman_splits` takes `splits.best_categorical_split_from_table`
(in column chunks) for CPU tensors and launches `csrc/breiman.cu` for CUDA
ones.  The kernel sorts only the categories that hold rows, scores only the
cuts up to the one after the last of them (the empty tail's cuts all score
alike), and gives a segment with no valid cut gain −inf and an all-False
mask, where the plain version flags its first category.  The level plan
never reads a mask whose gain is −inf, so the trees are the same.

`PYTHONPATH=src python -m pytest -m gpu tests/test_torch_breiman.py` runs
the card legs.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from drfbench import counts
from repro_torch.core import splits
from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.core.level import engines
from repro_torch.kernels import breiman, ops

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/breiman.cu"
IMPURITIES = ("gini", "entropy")
# (name, V, classes, min_records): the tables of `_case`
CASES = [
    ("sparse", 12, 2, 1.0),
    ("arity_one", 1, 2, 1.0),
    ("arity_two", 2, 2, 1.0),
    ("empty_leaf", 9, 2, 1.0),
    ("empty_leaf_no_min", 9, 2, 0.0),
    ("tied_metrics", 10, 2, 1.0),
    ("min_records_rejects", 12, 2, 6.0),
    ("empty_tail_cut", 12, 2, 0.0),
    ("every_category_held", 7, 2, 1.0),
    ("three_classes", 11, 3, 2.0),
    ("five_classes", 11, 5, 1.0),
    ("twenty_classes", 9, 20, 1.0),
]


def _case(name, V, C, seed=0, T=2, m=3, L1=6):
    """Integer class counts (T, m, L1, V, C) with many empty categories,
    and candidate flags with leaf 0 and some other leaves off."""
    rng = np.random.default_rng(seed + V + 100 * C)
    counts_ = rng.integers(0, 4, size=(T, m, L1, V, C))
    counts_ *= rng.random((T, m, L1, V, 1)) < 0.5          # empty categories
    if name.startswith("empty_leaf"):
        counts_[:, :, 2] = 0
    if name == "tied_metrics":                            # metric 1/2 or 1
        counts_[..., 0] = counts_[..., 1] * rng.integers(0, 2, (T, m, L1, V))
    if name == "every_category_held":
        counts_[..., 1] += 1
    cand = rng.random((T, m, L1)) < 0.7
    cand[..., 0] = False
    cand[..., 2] = True
    return (torch.tensor(counts_, dtype=torch.float32),
            torch.tensor(cand))


def _emulate_kernel(tables, cand, impurity, min_records):
    """`csrc/breiman.cu` segment by segment in torch: the categories that
    hold rows sorted by (metric, category), the first max(k, 1) cuts scored
    (never past V − 1), the first best kept; −inf and an all-False mask
    where no cut is valid."""
    T, m, L1, V, S = tables.shape
    gains = torch.full((T, m, L1), splits.NEG)
    masks = torch.zeros((T, m, L1, V), dtype=torch.bool)
    for t, j, h in np.ndindex(T, m, L1):
        tab = tables[t, j, h]
        if not cand[t, j, h]:
            continue
        held = torch.nonzero(tab.sum(-1) > 0)[:, 0]       # category order
        metric = tab[held, -1] / tab[held].sum(-1).clamp(min=1e-12)
        order = held[torch.argsort(metric, stable=True)]
        k = len(order)
        ncut = min(max(k, 1), V - 1)
        if ncut < 1:
            continue
        rows = torch.zeros((ncut, S))
        rows[:min(k, ncut)] = tab[order[:ncut]]
        left = rows.cumsum(0)
        right = tab.sum(0) - left
        ok = ((left.sum(-1) >= min_records) & (right.sum(-1) >= min_records))
        g = torch.where(ok, splits.split_gain(left, right, impurity),
                        splits.NEG)
        best = int(g.argmax())
        if torch.isfinite(g[best]):
            gains[t, j, h] = g[best]
            masks[t, j, h, order[:best + 1] if k else 0] = True
    return gains, masks


@pytest.mark.parametrize("impurity", IMPURITIES)
@pytest.mark.parametrize("name,V,C,min_records", CASES)
def test_op_on_cpu_is_the_plain_scorer(monkeypatch, name, V, C, min_records,
                                       impurity):
    """The categorical engine's op returns the unchunked plain scorer's
    gains and masks bit for bit, one column a chunk or all at once."""
    tables, cand = _case(name, V, C)
    want = splits.best_categorical_split_from_table(
        tables, cand, impurity, "classification", min_records)
    for chunk in (tables[0, 0].numel() * 2, breiman.CHUNK_ELEMS):
        monkeypatch.setattr(breiman, "CHUNK_ELEMS", chunk)
        got = ops.breiman_splits(tables, cand, impurity, min_records)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("impurity", IMPURITIES)
@pytest.mark.parametrize("name,V,C,min_records", CASES)
def test_kernel_design_equals_plain_where_a_cut_is_valid(name, V, C,
                                                         min_records,
                                                         impurity):
    tables, cand = _case(name, V, C)
    g, mk = _emulate_kernel(tables, cand, impurity, min_records)
    want_g, want_mk = splits.best_categorical_split_from_table(
        tables, cand, impurity, "classification", min_records)
    assert torch.equal(g, want_g)
    fin = torch.isfinite(want_g)
    assert torch.equal(mk[fin], want_mk[fin])
    assert not mk[~fin].any()
    if name == "empty_leaf_no_min":     # no category holds rows: cut 0
        assert torch.equal(g[..., 2][cand[..., 2]],
                           torch.zeros(int(cand[..., 2].sum())))
        assert mk[..., 2, 0].all() and not mk[..., 2, 1:].any()
    if name == "empty_tail_cut":        # every category left, gain 0
        assert (g[fin] == 0).any()


def _leo_like(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    arities = (2, 5, 40, 300, 1000)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in arities], 1)
    effect = rng.normal(size=arities[3])
    y = (1.5 * num[:, 0] + effect[cat[:, 3]] > 0) ^ (rng.random(n) < 0.05)
    return from_numpy(num, cat.astype(np.int32), y.astype(np.int32), arities)


def test_masks_of_invalid_segments_never_reach_a_tree(monkeypatch):
    """The contract the kernel relies on: a fit whose categorical masks are
    all-False wherever the best gain is −inf grows the same forest."""
    ds = _leo_like()
    params = tree_lib.TreeParams(max_depth=6, min_records=5.0)

    def fit():
        return RandomForest(params, num_trees=3, seed=5, tree_batch=2,
                            device="cpu").fit(ds)

    want = fit()
    score = engines._score_tables
    zeroed = []

    def zero_invalid(tables, cand, st):
        g, mk = score(tables, cand, st)
        bad = ~torch.isfinite(g)
        zeroed.append(int(mk[bad].sum()))
        return g, mk & ~bad[..., None]

    monkeypatch.setattr(engines, "_score_tables", zero_invalid)
    got = fit()
    assert sum(zeroed) > 0              # the plain version flagged rows
    for k, v in want.packed.to_arrays().items():
        np.testing.assert_array_equal(got.packed.to_arrays()[k], v,
                                      err_msg=k)


def test_kernel_names_escape_the_benchmark_kernel_patterns():
    """`roofline.*` counts launches by name: the scorer's kernels must not
    pass for cat_hist's (`cat_`), split_scan's or feat_hist's."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", CSRC.read_text())
    assert names and all(n.startswith("brm_") for n in names)
    for n in names:
        for shown in (n, f"void {n}<2, false>(float const*)",
                      f"void (anonymous namespace)::{n}<0, true>("
                      f"float const*)"):
            assert not any(p.match(shown) for p in counts.KERNELS.values())


# ---------------------------------------------------------------------------
# CUDA legs: the kernel against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc and "
                    "runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("impurity", IMPURITIES)
@pytest.mark.parametrize("name,V,C,min_records", CASES)
def test_breiman_cuda_matches_plain(cuda, name, V, C, min_records, impurity):
    tables, cand = _case(name, V, C)
    before = breiman.launches
    scored = int(breiman.scored_counter(cuda).item())
    tables, cand = tables.to(cuda, torch.int32), cand.to(cuda)
    g, mk = breiman.breiman(tables, cand, impurity=impurity,
                            min_records=min_records)
    want_g, want_mk = breiman.breiman_plain(tables, cand, impurity=impurity,
                                            min_records=min_records)
    assert breiman.launches == before + 1
    assert int(breiman.scored_counter(cuda).item()) - scored == \
        int(cand.sum())
    fin = torch.isfinite(want_g)
    assert torch.equal(g, want_g)
    assert torch.equal(mk[fin], want_mk[fin])
    assert not mk[~fin].any()


@pytest.mark.gpu
def test_breiman_cuda_wide_tables_and_many_segments(cuda):
    """V = 10,000 (one sort of up to 10,000 keys a segment) and a frontier
    of 513 leaves, with segments walked several to a block."""
    rng = np.random.default_rng(7)
    T, m, L1, V = 2, 2, 513, 10000
    t = rng.integers(0, 3, size=(T, m, L1, V, 2)).astype(np.int32)
    t *= rng.random((T, m, L1, V, 1)) < 0.3
    tables = torch.tensor(t)
    cand = torch.tensor(rng.random((T, m, L1)) < 0.3)
    tables, cand = tables.to(cuda), cand.to(cuda)
    g, mk = breiman.breiman(tables, cand)
    want_g, want_mk = breiman.breiman_plain(tables, cand)
    fin = torch.isfinite(want_g)
    assert torch.equal(g, want_g)
    assert torch.equal(mk[fin], want_mk[fin]) and not mk[~fin].any()


def _torch_cuda_row_sum(x):
    """A row of S < 128 float32 values added in the order of torch's CUDA
    sum over a contiguous last dimension of 16 rows or more: lane i of bw
    = min(largest power of two <= S, 32) adds elements i + j·bw into
    accumulator j % 4, then the four in turn; lanes fold at distance
    bw / 2, bw / 4, ..., 1.  The order the kernel adds class terms in."""
    S = len(x)
    bw = min(1 << (S.bit_length() - 1), 32)
    f = np.float32
    lanes = []
    for i in range(bw):
        acc = [f(0)] * 4
        for j, e in enumerate(range(i, S, bw)):
            acc[j % 4] = f(acc[j % 4] + x[e])
        lanes.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
    w = bw // 2
    while w:
        for i in range(w):
            lanes[i] = f(lanes[i] + lanes[i + w])
        w //= 2
    return lanes[0]


@pytest.mark.gpu
@pytest.mark.parametrize("S", [3, 5, 8, 13, 16, 20, 33, 64, 100, 127])
def test_class_sum_order_is_torch_cuda_sum(cuda, S):
    """The order the kernel's `tsum` follows is the one torch's CUDA sum
    takes, on rows of squares whose float32 sums round by order."""
    rng = np.random.default_rng(S)
    x = (rng.integers(1, 1 << 20, size=(256, S)) ** 2).astype(np.float32)
    got = torch.tensor(x, device=cuda).sum(-1).cpu().numpy()
    want = np.array([_torch_cuda_row_sum(r) for r in x], dtype=np.float32)
    assert np.array_equal(got, want)


def _big_counts(V, S, seed, T=2, m=3, L1=9, top=4000):
    """Integer class counts up to `top` (squares and entropy terms that
    round by order; a segment's total below 2^24)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, top, size=(T, m, L1, V, S)).astype(np.int32)
    t *= rng.random((T, m, L1, V, 1)) < 0.6
    cand = rng.random((T, m, L1)) < 0.8
    return torch.tensor(t), torch.tensor(cand)


@pytest.mark.gpu
@pytest.mark.parametrize("impurity", IMPURITIES)
@pytest.mark.parametrize("S", [2, 3, 4, 7, 8, 15, 16, 17, 20, 40, 70])
def test_breiman_cuda_bit_equal_for_any_class_count(cuda, S, impurity):
    """Gains bit-equal to the plain version on the card for every class
    layout (2, up to 16 in registers, more in the workspace)."""
    tables, cand = _big_counts(30, S, seed=S)
    tables, cand = tables.to(cuda), cand.to(cuda)
    g, mk = breiman.breiman(tables, cand, impurity=impurity)
    want_g, want_mk = breiman.breiman_plain(tables, cand, impurity=impurity)
    fin = torch.isfinite(want_g)
    assert fin.any()
    assert torch.equal(g, want_g)
    assert torch.equal(mk[fin], want_mk[fin]) and not mk[~fin].any()


@pytest.mark.gpu
@pytest.mark.parametrize("V,S", [(20000, 2), (20000, 20), (40000, 2),
                                 (40000, 5)])
def test_breiman_cuda_wide_arity(cuda, V, S):
    """20,000 categories (keys and flags in shared memory) and 40,000
    (past it: keys in the workspace, flags set in the output row), with
    2, 5 and 20 classes."""
    rng = np.random.default_rng(V + S)
    T, m, L1 = 2, 2, 9
    t = rng.integers(0, 3, size=(T, m, L1, V, S)).astype(np.int32)
    t *= rng.random((T, m, L1, V, 1)) < 0.3
    tables = torch.tensor(t).to(cuda)
    cand = torch.tensor(rng.random((T, m, L1)) < 0.6).to(cuda)
    g, mk = breiman.breiman(tables, cand)
    want_g, want_mk = breiman.breiman_plain(tables, cand)
    fin = torch.isfinite(want_g)
    assert fin.any()
    assert torch.equal(g, want_g)
    assert torch.equal(mk[fin], want_mk[fin]) and not mk[~fin].any()


def _multiclass(classes, n=6000, seed=4, arities=(2, 7, 60, 500, 30000)):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 2)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in arities], 1)
    effect = rng.normal(size=arities[2])
    score = num[:, 0] + effect[cat[:, 2]] + 0.3 * rng.normal(size=n)
    cuts = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
    y = np.digitize(score, cuts)
    return from_numpy(num, cat.astype(np.int32), y.astype(np.int32), arities)


@pytest.mark.gpu
@pytest.mark.parametrize("impurity", IMPURITIES)
@pytest.mark.parametrize("classes", [4, 20])
def test_multiclass_forest_on_card_equals_plain_scorer(cuda, monkeypatch,
                                                       classes, impurity):
    """A forest of 4 or 20 classes with categorical columns (one 30,000
    categories wide) fitted on the card through the kernel grows the trees
    that the plain scorer grows on the card."""
    ds = _multiclass(classes)
    params = tree_lib.TreeParams(max_depth=6, min_records=2.0,
                                 impurity=impurity)

    def fit():
        return RandomForest(params, num_trees=4, seed=9, tree_batch=2,
                            device="cuda").fit(ds)

    before = breiman.launches
    got = fit()
    assert breiman.launches > before

    def plain(tables, cand, impurity="gini", min_records=1.0):
        return breiman.breiman_plain(tables, cand, impurity=impurity,
                                     min_records=min_records)

    monkeypatch.setattr(ops, "breiman_splits", plain)
    launched = breiman.launches
    want = fit()
    assert breiman.launches == launched
    for k, v in want.packed.to_arrays().items():
        np.testing.assert_array_equal(got.packed.to_arrays()[k], v,
                                      err_msg=k)
