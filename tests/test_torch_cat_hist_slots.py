"""The compact layout of the categorical count tables: a table only for
each candidate (tree, column, leaf).

`cat_hist.candidate_slots(cand)` numbers the candidates of the (T, m, L1)
mask in order (an exclusive prefix; -1 off the candidates);
`cat_hist.cat_hist(..., slot=, m_prime=)` writes each candidate's (V, S)
table at its slot of a (K, V, S) buffer, K = T·L1·min(m′, m), and the
Breiman scorer, given the same map, reads it there.  Without `slot` every
(tree, column, leaf) has a table, (T, m, L1, V, S), as before.  The CPU
cases hold the plain versions, the kernel's
tile rules played out in torch, and a whole fit; the `gpu` cases hold the
kernels against the plain versions on the card:
`PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cat_hist_slots.py`.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bagging
from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.kernels import breiman, cat_hist, ops

MASKS = ("random", "none", "all", "usb")


def _rows(arities, n, L1, T, task="classification", seed=0, big_leaf=False):
    """Category columns (m, n) of the given arities, leaf ids in [0, L1),
    bag weights 0..2 and labels (two classes, or a regression target)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, a, n) for a in arities]).astype(np.int32)
    leaf = rng.integers(0, L1, (T, n)).astype(np.int32)
    if big_leaf:                                  # half the rows in leaf 1
        leaf[:, : n // 2] = 1
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = (rng.integers(0, 2, n).astype(np.float32) if task == "classification"
         else (rng.normal(size=n) * 3 + 1).astype(np.float32))
    return [torch.as_tensor(a) for a in (x, leaf, w, y)]


def _cand(kind, T, m, L1, m_prime=2, m_num=3, seed=0):
    """A candidate mask (T, m, L1) of the categorical columns: drawn as the
    level plan draws it (`random`: m′ of m_num + m columns a leaf; `usb`:
    one draw a tree for every leaf), none, or every (tree, column, leaf)
    (leaf 0 included, which gives the full layout's order)."""
    if kind == "none":
        return torch.zeros((T, m, L1), dtype=torch.bool)
    if kind == "all":
        return torch.ones((T, m, L1), dtype=torch.bool)
    keys = tree_lib._forest_keys(seed, list(range(T)), torch.device("cpu"))
    drawn = bagging.candidate_features(keys, 2, L1 - 1, m_num + m, m_prime,
                                       usb=kind == "usb")   # (T, L1-1, m)
    cand = torch.cat([torch.zeros((T, 1, m_num + m), dtype=torch.bool),
                      drawn], 1).transpose(1, 2)[:, m_num:]
    return cand.contiguous()


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_compact_tables_are_the_full_tables_at_the_slots(kind, task):
    T, L1, arities = 3, 6, (2, 7, 11, 5)
    m = len(arities)
    x, leaf, w, y = _rows(arities, 800, L1, T, task, seed=1)
    S = 2 if task == "classification" else 3
    kw = dict(L1=L1, V=max(arities), num_stats=S, task=task)
    m_prime = m if kind == "all" else 2
    cand = _cand(kind, T, m, L1, m_prime)
    full = cat_hist.cat_hist(x, leaf, w, y, **kw)
    slot = cat_hist.candidate_slots(cand)
    got = cat_hist.cat_hist(x, leaf, w, y, slot=slot, m_prime=m_prime, **kw)
    assert got.shape == (T * L1 * min(m_prime, m), kw["V"], S)
    n_cand = int(cand.sum())
    assert torch.equal(got[slot[cand].long()], full[cand])
    assert not got[n_cand:].any()                 # zeros past the last one
    if kind == "all":                             # today's layout, bit for bit
        assert torch.equal(got.view(full.shape), full)
        assert torch.equal(slot, cat_hist.full_slots(T, m, L1))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("m_prime", [1, 3, 10])
def test_slot_map_numbers_the_candidates(kind, m_prime):
    T, m, L1 = 4, 6, 9
    cand = _cand(kind, T, m, L1, m_prime, seed=m_prime)
    slot = cat_hist.candidate_slots(cand)
    assert slot.dtype == torch.int32 and slot.shape == cand.shape
    assert bool((slot[~cand] == -1).all())
    on = slot[cand]
    n_cand = int(cand.sum())
    # unique, in (tree, column, leaf) order: 0, 1, ..., n_cand - 1
    assert torch.equal(on, torch.arange(n_cand, dtype=torch.int32))
    K = cat_hist.table_count(T, m, L1, None if kind == "all" else m_prime)
    assert n_cand <= K
    if kind != "all":
        assert K == T * L1 * min(m_prime, m)
        per_leaf = cand.sum(1)                    # (T, L1)
        assert int(per_leaf.max()) <= min(m_prime, m)


@pytest.mark.parametrize("task,impurity", [("classification", "gini"),
                                           ("classification", "entropy"),
                                           ("regression", "gini")])
@pytest.mark.parametrize("kind", ["random", "usb", "none"])
def test_breiman_plain_reads_compact_tables_as_full(task, impurity, kind):
    """Gains equal everywhere (−inf off the candidates) and masks equal at
    every candidate; a chunk size that cuts the columns into several
    chunks."""
    T, L1, arities = 2, 7, (3, 9, 14, 6, 2)
    m = len(arities)
    x, leaf, w, y = _rows(arities, 1500, L1, T, task, seed=4)
    S = 2 if task == "classification" else 3
    kw = dict(L1=L1, V=max(arities), num_stats=S, task=task)
    cand = _cand(kind, T, m, L1, 3, seed=2)
    full = cat_hist.cat_hist(x, leaf, w, y, **kw)
    slot = cat_hist.candidate_slots(cand)
    compact = cat_hist.cat_hist(x, leaf, w, y, slot=slot, m_prime=3, **kw)
    score = dict(impurity=impurity, task=task, min_records=2.0)
    chunk = breiman.CHUNK_ELEMS
    try:
        breiman.CHUNK_ELEMS = T * L1 * kw["V"] * S * 2    # two columns
        g_full, mk_full = breiman.breiman_plain(full, cand, **score)
        g, mk = breiman.breiman_plain(compact, cand, slot, **score)
    finally:
        breiman.CHUNK_ELEMS = chunk
    np.testing.assert_array_equal(g.numpy(), g_full.numpy())
    assert torch.equal(mk[cand], mk_full[cand])
    assert bool((g[~cand] == float("-inf")).all())
    if kind != "none":
        assert bool(torch.isfinite(g).any())


def test_cand_none_keeps_the_full_layout():
    """No slot map: the (T, m, L1, V, S) tables of the plain scatter,
    scored as before; the counters count every table as both full and
    held."""
    T, L1, arities = 2, 5, (4, 9, 3)
    x, leaf, w, y = _rows(arities, 600, L1, T, seed=7)
    full0, slot0 = cat_hist.full_tables, cat_hist.slot_tables
    got = ops.categorical_tables(x, leaf, w, y, V=9, Lp=L1 - 1,
                                 num_classes=2)
    assert cat_hist.full_tables - full0 == T * 3 * L1
    assert cat_hist.slot_tables - slot0 == T * 3 * L1
    want = cat_hist.cat_hist_plain(x, leaf, w, y, L1=L1, V=9, num_stats=2)
    assert got.shape == (T, 3, L1, 9, 2) and torch.equal(got, want)
    cand = _cand("random", T, 3, L1, 2)
    g, mk = ops.breiman_splits(got, cand)
    g_w, mk_w = breiman.breiman_plain(want, cand)
    assert torch.equal(g, g_w) and torch.equal(mk, mk_w)


def test_more_candidates_than_slots_are_refused():
    T, L1, arities = 1, 4, (3, 3, 3)
    x, leaf, w, y = _rows(arities, 100, L1, T)
    slot = cat_hist.candidate_slots(torch.ones((T, 3, L1), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="past the 4 tables"):
        cat_hist.cat_hist(x, leaf, w, y, L1=L1, V=3, num_stats=2,
                          slot=slot, m_prime=1)
    with pytest.raises(ValueError, match="slot must be int32"):
        cat_hist.cat_hist(x, leaf, w, y, L1=L1, V=3, num_stats=2,
                          slot=slot[:, :2], m_prime=1)


def test_gathered_rows_counts_the_candidate_leaves_rows():
    """`gathered_rows` (the categories a table counts, which
    `bound_bytes` reads once each) against a count row by row: in-bag
    rows of open leaves, once per candidate column of their leaf."""
    T, m, L1 = 3, 5, 7
    x, leaf, w, y = _rows((4,) * m, 400, L1, T, seed=3)
    cand = _cand("random", T, m, L1, 2, seed=4)
    slot = cat_hist.candidate_slots(cand)
    want = sum(int(cand[t, :, h].sum())
               for t in range(T) for r, h in enumerate(leaf[t].tolist())
               if h > 0 and w[t, r] > 0)
    got = cat_hist.gathered_rows(leaf, w, slot, L1)
    assert got == want > 0
    n_cand = int(cand.sum())
    assert cat_hist.bound_bytes(T, m, 400, L1, 4, 2, tables=n_cand,
                                gathered=got) == (
        got * 4 + T * 400 * 8 + 400 * 4 + n_cand * 4 * 2 * 4)
    assert cat_hist.bound_bytes(T, m, 400, L1, 4, 2) == (
        m * 400 * 4 + T * 400 * 8 + 400 * 4 + T * m * L1 * 4 * 2 * 4)


def _emulate_slot_tiles(x, leaf, w, y, L1, V, S, budget, min_piece, target,
                        cand, K):
    """The tile kernel's plan, work items, early exits and flush rules in
    torch over the compact layout: a block none of whose leaves has a
    table returns, the rows of a leaf without one are skipped, and each
    leaf's cells go to its slot (stored whole, or added into the tables
    `zero_split_tiles` cleared).  Cells never written stay -1."""
    T, n = leaf.shape
    m = x.shape[0]
    plan = cat_hist.tile_plan(L1, V, S, "classification", budget)
    slot = cat_hist.candidate_slots(cand)
    lstart = None
    if not plan.natural:
        rows, wl, _, lstart = cat_hist.leaf_buckets(leaf, w, y, L1)
    work = cat_hist.tile_work(lstart, plan, n, T, target=target,
                              min_piece=min_piece)
    out = torch.full((K, V, S), -1, dtype=torch.int32)
    cat_hist.zero_split_tiles(out, work, plan, slot)
    onehot = torch.nn.functional.one_hot(y.long(), S).to(torch.int32)
    seen = {"run": 0, "returned": 0, "mixed": 0}
    for t, lt, k0, k1, atomic in work.tolist():
        if t < 0:
            continue
        h0, h1 = lt * plan.LT, min(L1, (lt + 1) * plan.LT)
        if plan.natural:
            r = torch.arange(k0, k1)
            h = leaf[t, r].long()
            keep = (w[t, r] > 0) & (h > 0) & (h < L1)
            r, h = r[keep], h[keep]
            wr = w[t, r]
        else:
            k = torch.arange(k0, k1)
            r, wr = rows[t, k].long(), wl[t, k]
            h = torch.searchsorted(lstart[t].long(), k, right=True) - 1
        for j in range(m):
            sl = slot[t, j, h0:h1]
            if not bool((sl >= 0).any()):
                seen["returned"] += 1           # the block returns at once
                continue
            seen["run"] += 1
            seen["mixed"] += bool((sl < 0).any())
            on = sl[h - h0] >= 0                # rows of leaves with a table
            rj, hj, wj = r[on], h[on], wr[on]
            for ct in range(plan.nCT):
                c0, c1 = ct * plan.CT, min(V, (ct + 1) * plan.CT)
                v = x[j, rj].long()
                sel = (v >= c0) & (v < c1)
                tile = torch.zeros((h1 - h0, c1 - c0, S), dtype=torch.int32)
                tile.index_put_((hj[sel] - h0, v[sel] - c0),
                                onehot[rj[sel]] * wj[sel, None].int(),
                                accumulate=True)
                for hh, s in enumerate(sl.tolist()):
                    if s < 0:
                        continue
                    if atomic:
                        out[s, c0:c1] += tile[hh]
                    else:
                        out[s, c0:c1] = tile[hh]
    return out, plan, seen


@pytest.mark.parametrize("L1,V,budget,min_piece,target", [
    (9, 13, 100 * 1024, 64, 64),     # natural: the whole table a block
    (9, 13, 100 * 1024, 10**6, 64),  # ... one block a tree: stored whole
    (6, 300, 5000, 64, 64),          # leaf tiles of 2, bucketed, some split
    (5, 300, 1000, 100, 512),        # category tiles of one leaf
])
@pytest.mark.parametrize("kind", ["random", "usb"])
def test_tile_rules_build_the_compact_tables(L1, V, budget, min_piece,
                                             target, kind):
    """Played out in torch, the kernel's rules over the compact layout give
    the plain tables at every candidate's slot and leave the slots past
    the last candidate unwritten; blocks of a leaf that is no candidate
    return, and tiles of several leaves mix leaves with and without a
    table."""
    T, m = 2, 4
    x, leaf, w, y = _rows((V,) * m, 1500, L1, T, seed=L1 + V)
    cand = _cand(kind, T, m, L1, 2, seed=V)
    K = cat_hist.table_count(T, m, L1, 2)
    got, plan, seen = _emulate_slot_tiles(
        x, leaf, w, y, L1, V, 2, budget, min_piece, target, cand, K)
    want = cat_hist.cat_hist(x, leaf, w, y, L1=L1, V=V, num_stats=2,
                             slot=cat_hist.candidate_slots(cand), m_prime=2)
    n_cand = int(cand.sum())
    assert n_cand > 0 and torch.equal(got[:n_cand], want[:n_cand])
    assert bool((got[n_cand:] == -1).all())
    assert seen["run"] > 0
    if plan.LT == 1:
        assert seen["returned"] > 0 and seen["mixed"] == 0
    else:                                       # several leaves a tile
        assert seen["mixed"] > 0


def _leo_shaped(n=3000, seed=11):
    """3 numeric and 79 categorical columns (arities log-spaced 2..60),
    so a leaf draws m′ = 10 of 82 columns, about 9.6 categorical."""
    rng = np.random.default_rng(seed)
    arities = tuple(int(a) for a in np.geomspace(2, 60, 79).round())
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in arities], 1)
    effect = rng.normal(size=arities[-1])
    y = (1.5 * num[:, 0] + effect[cat[:, -1]] > 0) ^ (rng.random(n) < 0.05)
    return from_numpy(num, cat.astype(np.int32), y.astype(np.int32), arities)


def _fit_both(monkeypatch, device):
    """A Leo-shaped exact kernel-backend fit with the compact tables, and
    the same fit with a table for every (tree, column, leaf), forced
    through the adapters' `slot=None` path; the counters' ratio over the
    compact fit."""
    ds = _leo_shaped()
    params = tree_lib.TreeParams(max_depth=5, min_records=3.0,
                                 backend="kernel")

    def fit():
        return RandomForest(params, num_trees=3, seed=2, tree_batch=2,
                            device=device).fit(ds)

    full0, slot0 = cat_hist.full_tables, cat_hist.slot_tables
    compact = fit()
    ratio = ((cat_hist.slot_tables - slot0)
             / (cat_hist.full_tables - full0))
    tables, scorer = ops.categorical_tables, ops.breiman_splits

    def every_table(*a, slot=None, m_prime=None, **kw):
        return tables(*a, **kw)

    def one_per_segment(*a, slot=None, **kw):
        return scorer(*a, **kw)
    monkeypatch.setattr(ops, "categorical_tables", every_table)
    monkeypatch.setattr(ops, "breiman_splits", one_per_segment)
    return compact, fit(), ratio


def test_compact_fit_grows_the_full_layouts_trees(monkeypatch):
    compact, full, ratio = _fit_both(monkeypatch, "cpu")
    for k, v in full.packed.to_arrays().items():
        np.testing.assert_array_equal(compact.packed.to_arrays()[k], v,
                                      err_msg=k)
    m_prime = tree_lib._num_candidates(tree_lib.TreeParams(), 82)
    assert m_prime == 10 and ratio == pytest.approx(10 / 79)


# ---------------------------------------------------------------------------
# CUDA legs: the kernels over the compact layout against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arities,n,L1,T,task,big_leaf,kind", [
    ((2, 700, 10000), 200000, 2, 2, "classification", True, "random"),
    ((2, 700, 10000), 100000, 65, 2, "classification", False, "random"),
    ((2, 700, 10000), 100000, 513, 2, "classification", True, "random"),
    ((2, 700, 10000), 60000, 513, 2, "classification", False, "usb"),
    ((37,) * 4, 60000, 65, 2, "classification", False, "random"),  # LT > 1
    ((9, 13), 30000, 9, 2, "classification", False, "random"),   # natural
    ((9, 31), 30000, 9, 10, "classification", False, "random"),  # T > 8
    ((3, 10000), 60000, 65, 2, "regression", True, "random"),
    ((5, 37), 60000, 65, 10, "regression", False, "usb"),
    ((2, 700, 10000), 60000, 65, 2, "classification", False, "all"),
])
def test_cat_hist_cuda_compact_equals_plain(cuda, arities, n, L1, T, task,
                                            big_leaf, kind):
    """The kernel's compact tables equal the plain version's at every
    candidate slot, bit for bit (regression: the same fixed point); with
    every (tree, column, leaf) a candidate they are the full layout."""
    args = _rows(arities, n, L1, T, task, seed=n + L1, big_leaf=big_leaf)
    m = len(arities)
    S = 2 if task == "classification" else 3
    cand = _cand(kind, T, m, L1, 2, m_num=10, seed=L1)
    m_prime = m if kind == "all" else 2
    kw = dict(L1=L1, V=max(arities), num_stats=S, task=task)
    dev = [a.to(cuda) for a in args]
    slot = cat_hist.candidate_slots(cand.to(cuda))
    got = cat_hist.cat_hist(*dev, slot=slot, m_prime=m_prime, **kw)
    want = cat_hist.cat_hist_plain(*dev, **kw)
    n_cand = int(cand.sum())
    assert torch.equal(got[:n_cand], cat_hist.compact_tables(
        want, slot, got.shape[0])[:n_cand])
    if kind == "all":
        assert torch.equal(got.view(want.shape), want)
        assert torch.equal(cat_hist.cat_hist(*dev, **kw), want)


@pytest.mark.gpu
@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_breiman_cuda_reads_compact_tables(cuda, impurity):
    """The scorer over compact tables gives the full tables' gains bit for
    bit and their masks, and the plain version's over the same tables."""
    T, L1, arities = 2, 65, (2, 40, 700, 10000, 300)
    args = [a.to(cuda) for a in _rows(arities, 100000, L1, T, seed=5)]
    cand = _cand("random", T, len(arities), L1, 2, m_num=6).to(cuda)
    kw = dict(L1=L1, V=10000, num_stats=2)
    full = cat_hist.cat_hist(*args, **kw)
    slot = cat_hist.candidate_slots(cand)
    compact = cat_hist.cat_hist(*args, slot=slot, m_prime=2, **kw)
    g, mk = breiman.breiman(compact, cand, slot, impurity=impurity)
    g_f, mk_f = breiman.breiman(full, cand, impurity=impurity)
    g_p, mk_p = breiman.breiman_plain(compact, cand, slot, impurity=impurity)
    assert torch.equal(g, g_f) and torch.equal(mk, mk_f)
    fin = torch.isfinite(g_p)
    assert bool(fin.any()) and torch.equal(g, g_p)
    assert torch.equal(mk[fin], mk_p[fin])


@pytest.mark.gpu
def test_compact_fit_on_the_card_grows_the_full_layouts_trees(monkeypatch,
                                                              cuda):
    compact, full, ratio = _fit_both(monkeypatch, "cuda")
    for k, v in full.packed.to_arrays().items():
        np.testing.assert_array_equal(compact.packed.to_arrays()[k], v,
                                      err_msg=k)
    assert ratio == pytest.approx(10 / 79)


@pytest.mark.gpu
def test_more_candidates_than_slots_are_refused_on_the_card(cuda):
    """The CPU case's slot map on the card: the wrapper's assert fails at
    the next sync.  A failed device assert leaves the process's CUDA
    context unusable, so the call runs in a process of its own."""
    code = textwrap.dedent("""
        import torch
        from repro_torch.kernels import cat_hist
        dev = torch.device("cuda")
        T, m, L1, n = 1, 3, 4, 100
        g = torch.Generator().manual_seed(0)
        x = torch.randint(0, 3, (m, n), generator=g, dtype=torch.int32)
        leaf = torch.randint(0, L1, (T, n), generator=g, dtype=torch.int32)
        w = torch.ones((T, n))
        y = torch.randint(0, 2, (n,), generator=g).float()
        slot = cat_hist.candidate_slots(
            torch.ones((T, m, L1), dtype=torch.bool, device=dev))
        cat_hist.cat_hist(x.to(dev), leaf.to(dev), w.to(dev), y.to(dev),
                          L1=L1, V=3, num_stats=2, slot=slot, m_prime=1)
        torch.cuda.synchronize()
        print("NOT REFUSED")
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (src, os.environ.get("PYTHONPATH")))))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert run.returncode != 0 and "NOT REFUSED" not in run.stdout
    assert "past the 4 tables" in run.stderr or "assert" in run.stderr
