"""Each kernel's plain version vs the Pallas kernel (interpret mode) and
its `repro.kernels.ref` oracle, and — on a CUDA card — the kernel vs its
plain version.

The shapes are tests/test_kernels.py's SWEEP: ties (`dup`), n not a
multiple of the Pallas row block, several leaf counts and class counts,
and the regression task.  The port's kernels take the level's shared
per-leaf totals where the reference recomputes them per column in sorted
order: equal for classification (integer counts), and the reason the
regression gains agree to rtol 1e-5 instead of bit for bit.

JAX comes in through `reference()` only, so the CUDA legs also run on a
card whose environment has no JAX:
`PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cat_hist, feat_hist, ops, split_scan
from test_torch_harness import reference

SWEEP = [
    # (n, m, L, C, bn, dup)
    (256, 2, 1, 2, 64, False),
    (500, 3, 5, 3, 128, False),
    (1000, 4, 7, 2, 256, True),
    (777, 2, 3, 4, 128, True),      # n not a multiple of bn
    (512, 1, 15, 2, 512, False),    # single block
]


def _mk(seed, n, m, L, C, dup=False, task="classification"):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, m)).astype(np.float32)
    if dup:
        num = np.round(num)                   # heavy ties
    if task == "classification":
        y = rng.integers(0, C, n).astype(np.int32)
    else:
        y = (num[:, 0] * 2 + rng.normal(size=n) * 0.1).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    si = np.argsort(num.T, axis=-1, kind="stable").astype(np.int32)
    sv = np.take_along_axis(num.T, si, -1)
    cand = np.ones((m, L + 1), bool)
    cand[:, 0] = False
    cand[:, 2::3] = False
    return sv, si, leaf, w, y, cand


def _port(sv, si, leaf, w, y, cand, L, C, impurity, task, device="cpu",
          min_records=1.0):
    """The port's split_scan on one tree (T = 1)."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    S = C if task == "classification" else 3
    from repro_torch.core import splits
    # totals summed on the CPU: the same bits for both versions (a CUDA
    # float index_add_ of regression stats changes from run to run)
    c = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    tot = torch.zeros((L + 1, S)).index_add_(
        0, c(leaf).long(),
        torch.where(((c(w) > 0) & (c(leaf) > 0))[:, None],
                    splits.row_stats(c(y), c(w), S, task), 0.0)).to(
        device, split_scan.totals_dtype(task))
    return split_scan.split_scan(
        t(sv), t(si), t(leaf)[None], t(w)[None], t(y.astype(np.float32)),
        t(cand)[None], tot[None], impurity=impurity, task=task,
        min_records=min_records)


def _reference_scan(ref, sv, si, leaf, w, y, cand, L, C, impurity, task):
    jax, jnp = ref.jax, ref.jnp
    leaf_g, w_g = leaf[si], w[si]
    y_g = y[si].astype(np.float32)
    S = C if task == "classification" else 3

    def tot(lf, ww, yy):
        st = ref.splits.row_stats(yy if task == "regression"
                                  else yy.astype(jnp.int32), ww, S, task)
        st = jnp.where(((ww > 0) & (lf > 0))[:, None], st, 0.0)
        return jax.ops.segment_sum(st, lf, num_segments=L + 1)

    totals = jax.vmap(tot)(jnp.asarray(leaf_g), jnp.asarray(w_g),
                           jnp.asarray(y_g))
    return ref.ref.split_scan_ref(
        jnp.asarray(sv), jnp.asarray(leaf_g), jnp.asarray(w_g),
        jnp.asarray(y_g), jnp.asarray(cand, np.float32), totals,
        L1=L + 1, s_dim=S, impurity=impurity, task=task)


def _assert_same(g, t, g_r, t_r, exact, rtol=1e-5):
    g, t = g[0].numpy(), t[0].numpy()
    g_r, t_r = np.asarray(g_r), np.asarray(t_r)
    fin = np.isfinite(g_r)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    if exact:
        np.testing.assert_array_equal(g, g_r)
        np.testing.assert_array_equal(t, t_r)
    else:
        np.testing.assert_allclose(g[fin], g_r[fin], rtol=rtol, atol=1e-4)
        np.testing.assert_allclose(t[fin], t_r[fin], atol=1e-6)


@pytest.mark.parametrize("n,m,L,C,bn,dup", SWEEP)
def test_split_scan_plain_matches_ref_and_pallas(n, m, L, C, bn, dup):
    ref = reference()
    jnp = ref.jnp
    sv, si, leaf, w, y, cand = _mk(n + m, n, m, L, C, dup)
    g, t = _port(sv, si, leaf, w, y, cand, L, C, "gini", "classification")
    g_r, t_r = _reference_scan(ref, sv, si, leaf, w, y, cand, L, C, "gini",
                               "classification")
    _assert_same(g, t, g_r, t_r, exact=C == 2)
    g_k, t_k = ref.ops.split_scan_supersplit(
        jnp.asarray(sv), jnp.asarray(si), jnp.asarray(leaf), jnp.asarray(w),
        jnp.asarray(y), jnp.asarray(cand), L, bn=bn, interpret=True,
        num_classes=C)
    # the Pallas kernel's in-block prefix is a float matmul: equal splits,
    # gains to its own tolerance against the sequential scan
    _assert_same(g, t, g_k, t_k, exact=False, rtol=1e-3)


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_split_scan_plain_impurities(impurity):
    ref = reference()
    sv, si, leaf, w, y, cand = _mk(11, 384, 2, 3, 2)
    g, t = _port(sv, si, leaf, w, y, cand, 3, 2, impurity, "classification")
    g_r, t_r = _reference_scan(ref, sv, si, leaf, w, y, cand, 3, 2,
                               impurity, "classification")
    _assert_same(g, t, g_r, t_r, exact=impurity == "gini")


def test_split_scan_plain_regression_task():
    ref = reference()
    jnp = ref.jnp
    sv, si, leaf, w, y, cand = _mk(0, 512, 2, 3, 2, task="regression")
    g, t = _port(sv, si, leaf, w, y, cand, 3, 2, "variance", "regression")
    g_r, t_r = _reference_scan(ref, sv, si, leaf, w, y, cand, 3, 2,
                               "variance", "regression")
    _assert_same(g, t, g_r, t_r, exact=False)
    g_k, _ = ref.ops.split_scan_supersplit(
        jnp.asarray(sv), jnp.asarray(si), jnp.asarray(leaf), jnp.asarray(w),
        jnp.asarray(y), jnp.asarray(cand), 3, impurity="variance",
        task="regression", bn=128, interpret=True)
    fin = np.isfinite(np.asarray(g_k))
    np.testing.assert_allclose(g[0].numpy()[fin], np.asarray(g_k)[fin],
                               rtol=1e-3, atol=1e-2)


def test_split_scan_tree_axis_is_per_tree():
    """One call over T trees equals T one-tree calls."""
    sv, si, leaf, w, y, cand = _mk(3, 600, 3, 6, 2, dup=True)
    rng = np.random.default_rng(1)
    leaves = np.stack([leaf, rng.integers(0, 7, 600).astype(np.int32)])
    ws = np.stack([w, rng.integers(0, 3, 600).astype(np.float32)])
    t = torch.as_tensor
    from repro_torch.core import splits
    yt = t(y.astype(np.float32))
    stats = splits.row_stats(yt, t(ws), 2, "classification")
    tot = torch.zeros((2, 7, 2))
    for k in range(2):
        tot[k].index_add_(0, t(leaves[k]).long(),
                          torch.where(t(ws[k] > 0)[:, None], stats[k], 0.0))
    cands = t(np.stack([cand, ~cand & (np.arange(7) > 0)]))
    g, thr = split_scan.split_scan(t(sv), t(si), t(leaves), t(ws), yt, cands,
                                   tot)
    for k in range(2):
        g1, t1 = split_scan.split_scan(t(sv), t(si), t(leaves[k:k + 1]),
                                       t(ws[k:k + 1]), yt, cands[k:k + 1],
                                       tot[k:k + 1])
        np.testing.assert_array_equal(g[k].numpy(), g1[0].numpy())
        np.testing.assert_array_equal(thr[k].numpy(), t1[0].numpy())


def _cat_case(V, n=512, m=3, L=4, C=3, T=1, task="classification", seed=None):
    rng = np.random.default_rng(V if seed is None else seed)
    x = rng.integers(0, V, size=(m, n)).astype(np.int32)
    leaf = rng.integers(0, L + 1, (T, n)).astype(np.int32)
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = (rng.integers(0, C, n).astype(np.float32) if task == "classification"
         else rng.normal(size=n).astype(np.float32))
    return x, leaf, w, y


@pytest.mark.parametrize("V,bv,bn", [(6, 6, 128), (16, 4, 64), (32, 8, 256),
                                     (13, 4, 128)])
def test_cat_hist_plain_matches_ref_and_pallas(V, bv, bn):
    ref = reference()
    jnp = ref.jnp
    n, m, L, C = 512, 3, 4, 3
    x, leaf, w, y = _cat_case(V, n, m, L, C)
    got = cat_hist.cat_hist(torch.as_tensor(x), torch.as_tensor(leaf),
                            torch.as_tensor(w), torch.as_tensor(y),
                            L1=L + 1, V=V, num_stats=C)[0].numpy()
    b = lambda a: jnp.asarray(np.broadcast_to(a, (m, n)))
    want = ref.ref.cat_hist_ref(jnp.asarray(x), b(leaf[0]), b(w[0]), b(y),
                                L1=L + 1, V=V, s_dim=C)
    np.testing.assert_array_equal(got, np.asarray(want))
    # V not a multiple of bv: the reference wrapper pads V and slices back
    pallas = ref.ops.categorical_tables(
        jnp.asarray(x), jnp.asarray(leaf[0]), jnp.asarray(w[0]),
        jnp.asarray(y.astype(np.int32)), V=V, Lp=L, bn=bn, bv=bv,
        interpret=True, num_classes=C)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_cat_hist_plain_regression_matches_ref():
    ref = reference()
    jnp = ref.jnp
    n, m, L, V = 600, 2, 3, 9
    x, leaf, w, y = _cat_case(V, n, m, L, task="regression")
    got = cat_hist.cat_hist(torch.as_tensor(x), torch.as_tensor(leaf),
                            torch.as_tensor(w), torch.as_tensor(y), L1=L + 1,
                            V=V, num_stats=3, task="regression")[0].numpy()
    b = lambda a: jnp.asarray(np.broadcast_to(a, (m, n)))
    want = ref.ref.cat_hist_ref(jnp.asarray(x), b(leaf[0]), b(w[0]), b(y),
                                L1=L + 1, V=V, s_dim=3, task="regression")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V", [2, 300])
def test_cat_hist_plain_regression_is_the_fixed_point_sum(V):
    """Regression tables sum in the kernel's 64-bit fixed point: within
    one float32 rounding (plus n rows' quantization of at most 0.5/scale
    each) of the exact float64 sums, even where a cell holds a hundred
    thousand rows and a float32 scatter drifts."""
    from repro_torch.core import splits
    n, m, L = 200_000, 2, 3
    x, leaf, w, y = (torch.as_tensor(a) for a in _cat_case(
        V, n, m, L, task="regression", T=2, seed=V))
    got = cat_hist.cat_hist_plain(x, leaf, w, y, L1=L + 1, V=V, num_stats=3,
                                  task="regression")
    stats = splits.row_stats(y, w, 3, "regression")
    exact = splits.categorical_count_tables(x, leaf, w, stats.double(), L, V)
    quant = torch.tensor([n * 0.5 / s for s in cat_hist.fixed_point_scales(
        leaf, w, y, L + 1)], dtype=torch.float64)
    assert bool(((got.double() - exact).abs()
                 <= 2.0 ** -24 * exact.abs() + quant).all())


def test_categorical_tables_tree_axis_and_ops():
    x, leaf, w, y = _cat_case(7, n=300, m=4, L=5, C=2, T=3, seed=2)
    t = torch.as_tensor
    tables = ops.categorical_tables(t(x), t(leaf), t(w), t(y.astype(np.int32)),
                                    V=7, Lp=5, num_classes=2)
    assert tables.shape == (3, 4, 6, 7, 2)
    for k in range(3):
        one = cat_hist.cat_hist(t(x), t(leaf[k:k + 1]), t(w[k:k + 1]), t(y),
                                L1=6, V=7, num_stats=2)
        np.testing.assert_array_equal(tables[k].numpy(), one[0].numpy())
    # closed rows and bagged-out rows contribute nothing
    assert float(tables[:, :, 0].abs().sum()) == 0.0
    assert float(tables.sum()) == float((w * (leaf > 0)).sum()) * 4


def test_fixed_point_scales_bound_the_sums():
    leaf = torch.ones((2, 1000), dtype=torch.int32)
    w = torch.full((2, 1000), 2.0)
    y = torch.linspace(-40, 40, 1000)
    scales = cat_hist.fixed_point_scales(leaf, w, y, 2)
    mags = [2.0, 80.0, 3200.0]
    for s, mag in zip(scales, mags):
        assert 1000 * mag * s < 2.0 ** 62
        assert 1000 * mag * s * 8 > 2.0 ** 62 / 1024    # not wastefully small


def _naive_buckets(leaf, w, L1):
    """Per tree: the in-bag open-leaf rows, leaf by leaf, rows ascending."""
    out = []
    for lf, ww in zip(leaf, w):
        out.append([r for h in range(1, L1) for r in range(len(lf))
                    if lf[r] == h and ww[r] > 0])
    return out


@pytest.mark.parametrize("L1", [2, 9, 40])
def test_leaf_buckets_plain_is_a_stable_sort_by_leaf(L1):
    rng = np.random.default_rng(L1)
    T, n = 3, 700
    leaf = rng.integers(0, L1 + 3, (T, n)).astype(np.int32)  # some >= L1
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    rows, wl, yl, lstart = cat_hist.leaf_buckets(
        torch.as_tensor(leaf), torch.as_tensor(w), torch.as_tensor(y), L1)
    for t, want in enumerate(_naive_buckets(leaf, w, L1)):
        k = int(lstart[t, -1])
        assert k == len(want)
        np.testing.assert_array_equal(rows[t, :k].numpy(), want)
        np.testing.assert_array_equal(wl[t, :k].numpy(), w[t, want])
        np.testing.assert_array_equal(yl[t, :k].numpy(), y[want])
        counts = np.bincount(leaf[t][w[t] > 0], minlength=L1 + 3)[:L1]
        counts[0] = 0
        np.testing.assert_array_equal(np.diff(lstart[t].numpy()), counts)


def test_leaf_buckets_plain_packs_row_and_class():
    """With `classes`, the row word is row · (C+1) + class, C for a label
    outside [0, C), and the lists are otherwise the unpacked ones."""
    rng = np.random.default_rng(4)
    leaf = torch.as_tensor(rng.integers(0, 6, (2, 500)).astype(np.int32))
    w = torch.as_tensor(rng.integers(0, 3, (2, 500)).astype(np.float32))
    y = torch.as_tensor(rng.integers(-1, 4, 500).astype(np.float32))
    plain = cat_hist.leaf_buckets(leaf, w, y, 5)
    packed = cat_hist.leaf_buckets(leaf, w, y, 5, classes=3)
    assert packed.y is None and torch.equal(packed.lstart, plain.lstart)
    assert torch.equal(packed.w, plain.w)
    np.testing.assert_array_equal(packed.rows // 4, plain.rows)
    cls = plain.y.to(torch.int32)
    want = torch.where((cls >= 0) & (cls < 3), cls, 3)
    np.testing.assert_array_equal(packed.rows % 4, want)


def test_bucket_chunks_cover_the_rows_within_the_count_bound():
    for n, T, L1 in [(1 << 23, 2, 513), (777, 1, 2), (30000, 2, 32769),
                     (1 << 20, 8, 16385)]:
        nb, rows = cat_hist.bucket_chunks(n, T, L1)
        assert rows % 32 == 0 and nb * rows >= n > (nb - 1) * rows
        assert nb == 1 or nb * T * L1 <= cat_hist.BUCKET_CELLS


@pytest.mark.parametrize("L1,V,S,task", [
    (513, 10000, 2, "classification"), (2, 10000, 2, "classification"),
    (65, 700, 2, "classification"), (9, 37, 3, "classification"),
    (513, 10000, 3, "regression"), (9, 10000, 16, "classification"),
    (16385, 2, 2, "classification")])
def test_tile_plan_fits_shared_memory_and_covers_the_table(L1, V, S, task):
    budget = cat_hist.SMEM_BUDGET
    plan = cat_hist.tile_plan(L1, V, S, task, budget)
    cell = S * 4 if task == "classification" else 24
    nh = min(plan.LT, L1)
    pad = lambda b: -(-b // 16) * 16            # csrc tile_smem_bytes
    assert (pad(nh * 8) + pad((nh + 1) * 4) + pad(nh * plan.CT * cell)
            <= budget)
    assert plan.nCT * plan.CT >= V > (plan.nCT - 1) * plan.CT
    assert plan.nLT * plan.LT >= L1 > (plan.nLT - 1) * plan.LT
    assert plan.LT == 1 or plan.nCT == 1


def _emulate_cat_tiles(x, leaf, w, y, L1, V, S, task, budget, min_piece,
                       target=64):
    """The tile kernel's plan, work items and flush rules in torch: every
    block builds its tile from its rows and stores it, or adds it into the
    region `zero_split_tiles` cleared.  Unwritten cells stay NaN."""
    T, n = leaf.shape
    m = x.shape[0]
    plan = cat_hist.tile_plan(L1, V, S, task, budget)
    lstart = None
    if not plan.natural:
        rows, wl, yl, lstart = cat_hist.leaf_buckets(leaf, w, y, L1)
    work = cat_hist.tile_work(lstart, plan, n, T, target=target,
                              min_piece=min_piece)
    out = torch.full((T, m, L1, V, S), float("nan"))
    cat_hist.zero_split_tiles(out.view(-1, V, S), work, plan,
                              cat_hist.full_slots(T, m, L1))
    stats = torch.from_numpy(np.asarray(
        [np.eye(S, dtype=np.float32)[int(c)] if 0 <= c < S else
         np.zeros(S, np.float32) for c in y.numpy()]))          # (n, S)
    for t, lt, k0, k1, atomic in work.tolist():
        if t < 0:                               # past the last item
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
            r = rows[t, k].long()
            wr = wl[t, k]
            h = torch.searchsorted(lstart[t].long(), k, right=True) - 1
        for ct in range(plan.nCT):
            c0, c1 = ct * plan.CT, min(V, (ct + 1) * plan.CT)
            for j in range(m):
                v = x[j, r].long()
                sel = (v >= c0) & (v < c1)
                tile = torch.zeros((h1 - h0, c1 - c0, S))
                tile.index_put_((h[sel] - h0, v[sel] - c0),
                                stats[r[sel]] * wr[sel, None], accumulate=True)
                if atomic:
                    out[t, j, h0:h1, c0:c1] += tile
                else:
                    out[t, j, h0:h1, c0:c1] = tile
    return out, work


@pytest.mark.parametrize("L1,V,budget,min_piece,target", [
    (9, 13, 100 * 1024, 64, 64),     # whole table per block, natural rows
    (9, 13, 100 * 1024, 10**6, 64),  # ... one block per tree: stored whole
    (6, 300, 5000, 64, 64),          # leaf tiles of 2, bucketed, some split
    (5, 300, 1000, 100, 512),        # category tiles of one leaf
])
def test_cat_tile_plan_and_work_rebuild_the_plain_tables(L1, V, budget,
                                                         min_piece, target):
    """Every cell is written by exactly one block or summed from the
    blocks of a split tile into a zeroed region: the emulated tiles equal
    the plain tables bit for bit."""
    x, leaf, w, y = _cat_case(V, n=1500, m=3, L=L1 - 1, C=2, T=2, seed=3)
    args = [torch.as_tensor(a) for a in (x, leaf, w, y)]
    got, work = _emulate_cat_tiles(*args, L1, V, 2, "classification",
                                   budget, min_piece, target)
    want = cat_hist.cat_hist_plain(*args, L1=L1, V=V, num_stats=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if min_piece < 10**6:
        assert bool((work[:, 4] == 1).any())    # some tile was split
    used = int((work[:, 0] >= 0).sum())
    assert bool((work[used:, 0] == -1).all())   # padding only at the end


@pytest.mark.parametrize("T,m,n,W,B,S,task,shared", [
    (2, 16, 1 << 23, 9, 255, 2, "classification", True),    # root
    (2, 16, 1 << 23, 5, 255, 2, "classification", True),    # depths 1-3
    (2, 16, 1 << 23, 33, 255, 2, "classification", True),
    (2, 16, 1 << 23, 65, 255, 2, "classification", True),   # one column
    (2, 16, 1 << 23, 129, 255, 2, "classification", False),  # too wide
    (2, 3, 1 << 23, 9, 255, 2, "classification", True),     # leo-hist
    (2, 3, 1 << 23, 17, 255, 2, "classification", False),   # wide, m = 3
    (8, 8, 1 << 20, 9, 1024, 2, "classification", True),    # uint16 bins
    (8, 3, 1 << 20, 9, 1024, 2, "classification", False),
    (2, 8, 1 << 20, 65, 1024, 2, "classification", False),
    (2, 16, 1 << 23, 9, 255, 3, "regression", True),
    (2, 16, 1 << 23, 17, 255, 3, "regression", True),
    (2, 16, 1 << 23, 65, 255, 3, "regression", False),
    (1, 4, 777, 1, 255, 2, "classification", True),         # no slots
    (3, 5, 777, 9, 255, 2, "classification", True),         # tiny n
])
def test_hist_plan_fits_shared_memory_and_covers_every_cell(T, m, n, W, B,
                                                            S, task, shared):
    """The path follows one column's table size, the table's width and
    the number of columns; a shared plan fits a block's shared memory,
    covers every (tree, column, row) once, has fewer than 2^16 cells a
    table (the packed row word's offset) and makes at most one wave of
    blocks (one per SM), each of at least MIN_ROWS rows unless n is
    smaller."""
    plan = feat_hist.hist_plan(T, m, n, W, B, S, task)
    col = feat_hist.column_bytes(W, B, S, task)
    assert plan.shared == shared
    if not shared:
        assert col > feat_hist.SMEM_OPTIN or (
            task == "classification" and m < feat_hist.MANY_COLUMNS
            and (W - 1) * B * S > feat_hist.CONTENDED_CELLS)
        return
    assert plan.smem % 16 == 0 and plan.G * col <= plan.smem
    assert plan.smem <= feat_hist.SMEM_OPTIN
    assert col // (4 if task == "classification" else 8) < 2**16
    assert plan.nG * plan.G >= m > (plan.nG - 1) * plan.G
    assert plan.nR * plan.R >= n > (plan.nR - 1) * plan.R
    assert plan.R % 32 == 0
    assert T * plan.nG * plan.nR <= max(T * plan.nG, feat_hist.SM_COUNT)
    assert plan.nR == 1 or plan.R >= feat_hist.MIN_ROWS - 32


def _feat_plain_case(seed, T, m, n, W, B, frac=False, root=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, B, size=(m, n)).astype(np.uint8 if B <= 256
                                                 else np.uint16)
    slot = (np.ones((T, n)) if root else rng.integers(0, W, (T, n)))
    w = rng.integers(0, 4, (T, n)).astype(np.float32)
    if frac:
        w = w * 0.5                                  # 0, .5, 1, 1.5
    y = rng.integers(-1, 3, n).astype(np.float32)    # some out of [0, 2)
    return [torch.as_tensor(a) for a in (x, slot.astype(np.int32), w, y)]


def _emulate_feat_hist(x, slot, w, y, W, B, S, plan):
    """The shared path's plan and flush in torch: every block (tree,
    column group, row range) builds its columns' tables from its own rows
    (integer counts when every weight is an integer no larger than
    count_wmax and 65535, else float32) and adds them into a zeroed
    output, slots 1..W-1 only."""
    T, n = slot.shape
    m = x.shape[0]
    wmax = min(cat_hist.count_wmax(n), 65535.0)
    counts = bool(((w <= 0) | ((w == w.round()) & (w <= wmax))).all())
    out = torch.zeros((T, m, W, B, S))
    for t in range(T):
        for g in range(plan.nG):
            for rr in range(plan.nR):
                r = torch.arange(rr * plan.R, min(n, (rr + 1) * plan.R))
                sl, wr, cls = slot[t, r].long(), w[t, r], y[r].long()
                keep = (sl > 0) & (sl < W) & (wr > 0) & (cls >= 0) & (cls < S)
                r, sl, wr, cls = r[keep], sl[keep], wr[keep], cls[keep]
                for j in range(g * plan.G, min(m, (g + 1) * plan.G)):
                    b = x[j, r].long()
                    tbl = torch.zeros((W - 1, B, S), dtype=torch.int64
                                      if counts else torch.float32)
                    tbl.index_put_((sl - 1, b, cls), wr.to(tbl.dtype),
                                   accumulate=True)
                    out[t, j, 1:] += tbl.to(torch.float32)
    return out


@pytest.mark.parametrize("T,m,n,W,B,budget,frac,root", [
    (2, 5, 3000, 5, 13, 900, False, False),   # groups of 2 and ranges
    (2, 5, 3000, 5, 13, 900, True, False),    # fractional: float tables
    (3, 4, 2500, 9, 7, 10**6, False, True),   # root: one slot, one group
    (1, 3, 1000, 3, 300, 5000, False, False),  # one column a block
])
def test_hist_plan_rebuilds_the_plain_tables(T, m, n, W, B, budget, frac,
                                             root):
    """Played out in torch, a shared plan's blocks rebuild
    `feat_hist_plain`'s tables bit for bit: slot 0, w = 0 rows and labels
    outside [0, S) add nothing, and every row reaches each of its
    columns' tables once."""
    args = _feat_plain_case(T + n, T, m, n, W, B, frac, root)
    plan = feat_hist.hist_plan(T, m, n, W, B, 2, budget=budget, sms=16,
                               min_rows=256)
    assert plan.shared and plan.nR > 1
    if budget < 10**6:
        assert plan.nG > 1
    got = _emulate_feat_hist(*args, W, B, 2, plan)
    want = feat_hist.feat_hist_plain(*args, W=W, B=B, num_stats=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# CUDA legs: the kernel against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and "
                    "run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,L,C,bn,dup", SWEEP)
def test_split_scan_cuda_matches_plain(cuda, n, m, L, C, bn, dup):
    sv, si, leaf, w, y, cand = _mk(n + m, n, m, L, C, dup)
    g, t = _port(sv, si, leaf, w, y, cand, L, C, "gini", "classification",
                 device=cuda)
    g_p, t_p = _port(sv, si, leaf, w, y, cand, L, C, "gini", "classification")
    if C == 2:
        np.testing.assert_array_equal(g.cpu().numpy(), g_p.numpy())
        np.testing.assert_array_equal(t.cpu().numpy(), t_p.numpy())
    else:
        np.testing.assert_allclose(g.cpu().numpy(), g_p.numpy(), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_cat_hist_cuda_matches_plain(cuda, task):
    x, leaf, w, y = _cat_case(37, n=5000, m=3, L=6, C=2, T=2, task=task)
    S = 2 if task == "classification" else 3
    args = [torch.as_tensor(a) for a in (x, leaf, w, y)]
    kw = dict(L1=7, V=37, num_stats=S, task=task)
    plain = cat_hist.cat_hist(*args, **kw)
    got = cat_hist.cat_hist(*[a.to(cuda) for a in args], **kw)
    # regression: both sum in the same 64-bit fixed point
    np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())
    if task == "regression":
        again = cat_hist.cat_hist(*[a.to(cuda) for a in args], **kw)
        assert torch.equal(got, again)


@pytest.mark.gpu
def test_cat_hist_cuda_splits_large_tree_batches(cuda):
    """More trees than one launch takes: the wrapper launches per group."""
    x, leaf, w, y = _cat_case(11, n=3000, m=2, L=3, C=2, T=10)
    args = [torch.as_tensor(a) for a in (x, leaf, w, y)]
    kw = dict(L1=4, V=11, num_stats=2)
    before = cat_hist.launches
    got = cat_hist.cat_hist(*[a.to(cuda) for a in args], **kw)
    assert cat_hist.launches - before == 2
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  cat_hist.cat_hist(*args, **kw).numpy())


def _small_forest_data(task):
    from repro_torch.core.dataset import from_numpy
    rng = np.random.default_rng(21)
    n = 6000
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in (4, 30, 700)], 1)
    if task == "classification":
        y = ((num[:, 0] > 0.2) ^ (cat[:, 1] % 3 == 0)).astype(np.int32)
    else:
        y = (3 * num[:, 0] + (cat[:, 1] % 4) + 0.05 * rng.normal(size=n))
    return from_numpy(num, cat, y, task=task)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_forest_on_card_equals_cpu_fit(cuda, backend):
    """A classification fit on the card (the kernels, or the plain numeric
    scan with `cat_hist` on CUDA tensors) grows the CPU fit's trees bit
    for bit."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    ds = _small_forest_data("classification")
    params = tree_lib.TreeParams(max_depth=6, backend=backend)
    gpu = RandomForest(params, num_trees=3, seed=1, tree_batch=3).fit(ds)
    cpu = RandomForest(params, num_trees=3, seed=1, tree_batch=3,
                       device="cpu").fit(ds)
    for a, b in zip(cpu.trees, gpu.trees):
        for k in ("feature", "threshold", "is_cat", "cat_mask", "children",
                  "value", "n_node"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


@pytest.mark.gpu
def test_regression_forest_on_card_matches_cpu(cuda):
    """Regression sums floats in other orders on the card: the same
    structure, node values within rtol 1e-5."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    ds = _small_forest_data("regression")
    params = tree_lib.TreeParams(max_depth=4, backend="kernel",
                                 impurity="variance", task="regression",
                                 min_records=5)
    gpu = RandomForest(params, num_trees=2, seed=2, tree_batch=2).fit(ds)
    cpu = RandomForest(params, num_trees=2, seed=2, tree_batch=2,
                       device="cpu").fit(ds)
    for a, b in zip(cpu.trees, gpu.trees):
        for k in ("feature", "is_cat", "cat_mask", "children"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.value, a.value, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-6)


def _feat_case(B, T, task, n=4000, m=3, W=9, seed=0, root=False,
               frac=False):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if B <= 256 else np.uint16
    x = rng.integers(0, B, size=(m, n)).astype(dt)
    slot = (np.ones((T, n)) if root else rng.integers(0, W, (T, n))).astype(
        np.int32)
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    if frac:
        w = (w * 0.5 + 0.5 * (w > 0)).astype(np.float32)   # 0, 1, 1.5
    y = (rng.integers(0, 2, n).astype(np.float32) if task == "classification"
         else (rng.normal(size=n) * 3 + 1).astype(np.float32))
    return [torch.as_tensor(a) for a in (x, slot, w, y)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,task,T,n,m,W,root,frac,shared", [
    (255, "classification", 10, 4000, 3, 9, False, False, True),
    (1024, "classification", 10, 4000, 3, 3, False, False, True),
    (1024, "classification", 10, 4000, 3, 9, False, False, False),
    (255, "classification", 2, 200000, 3, 33, False, False, False),
    (255, "regression", 10, 4000, 3, 9, False, False, True),
    (1024, "regression", 10, 4000, 3, 17, False, False, False),
    (255, "classification", 2, 300000, 16, 9, True, False, True),   # root
    (255, "classification", 2, 300000, 16, 257, False, False, False),
    (1024, "classification", 2, 200000, 8, 65, False, False, False),
    (255, "classification", 3, 200000, 16, 65, False, False, True),  # G = 1
    (255, "classification", 2, 200000, 5, 9, False, True, True),  # w = 1.5
    (255, "regression", 2, 300000, 16, 5, True, False, True),
    (255, "regression", 2, 200000, 4, 257, False, False, False),
])
def test_feat_hist_cuda_matches_plain(cuda, B, task, T, n, m, W, root, frac,
                                      shared):
    """Both paths: uint8 and uint16 bins (B = 1024), a root-like input
    (every row in slot 1), W past the shared-memory budget (one column a
    block) and past a block's shared memory or with wide tables and few
    columns (device path), fractional
    weights (float tables), more trees than one launch takes (T = 10, two
    tree groups).  Both tasks equal the plain tables bit for bit
    (regression: the same 64-bit fixed point), and regression repeats bit
    for bit."""
    S = 2 if task == "classification" else 3
    assert feat_hist.hist_plan(min(T, 8), m, n, W, B, S,
                               task).shared == shared
    args = _feat_case(B, T, task, n=n, m=m, W=W, seed=n + W, root=root,
                      frac=frac)
    kw = dict(W=W, B=B, num_stats=S, task=task)
    dev = [a.to(cuda) for a in args]
    plain = feat_hist.feat_hist_plain(*dev, **kw)
    before = feat_hist.launches
    got = feat_hist.feat_hist(*dev, **kw)
    assert feat_hist.launches - before == -(-T // 8)
    assert torch.equal(got, plain)
    if task == "regression":
        again = feat_hist.feat_hist(*dev, **kw)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_hist_forest_on_card_equals_cpu_fit(cuda, task):
    """Hist mode on the card (feat_hist + cat_hist; subtraction for
    classification) grows the CPU fit's trees: bit for bit for
    classification, the same structure with values within rtol 1e-5 for
    regression."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    ds = _small_forest_data(task)
    kw = dict(max_depth=5, backend="kernel", split_mode="hist", num_bins=64)
    if task == "regression":
        kw.update(task="regression", impurity="variance", min_records=5)
    params = tree_lib.TreeParams(**kw)
    gpu = RandomForest(params, num_trees=3, seed=4, tree_batch=3).fit(ds)
    cpu = RandomForest(params, num_trees=3, seed=4, tree_batch=3,
                       device="cpu").fit(ds)
    exact = task == "classification"
    for a, b in zip(cpu.trees, gpu.trees):
        for k in ("feature", "threshold", "is_cat", "cat_mask", "children"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        if exact:
            np.testing.assert_array_equal(b.value, a.value)
        else:
            np.testing.assert_allclose(b.value, a.value, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n,L,C,sums", [
    (20000, 16384, 2, "shared"),     # phase 3's state past shared memory
    (30000, 32768, 2, "global"),     # both phases' state in device memory
    (20000, 4096, 16, "global"),     # 16 classes: both, at a narrower L1
])
def test_split_scan_cuda_past_shared_memory(cuda, n, L, C, sums):
    """Past a block's shared memory the scan keeps its per-leaf state in
    device memory (phase 3 from L1 = 16,385 in binary, phase 1 as well
    from L1 = 32,769, both from L1 = 4,097 at 16 classes); binary gini
    stays bit-equal to the plain version, 16 classes within rtol 1e-5."""
    m = 2
    sv, si, leaf, w, y, cand = _mk(5, n, m, L, C, dup=True)
    assert split_scan.state_layout(L + 1, C) == {"sums": sums,
                                                 "best": "global"}
    g, t = _port(sv, si, leaf, w, y, cand, L, C, "gini", "classification",
                 device=cuda)
    g_p, t_p = _port(sv, si, leaf, w, y, cand, L, C, "gini",
                     "classification")
    assert np.isfinite(g_p.numpy()).sum() > 1000       # real splits scored
    if C == 2:
        np.testing.assert_array_equal(g.cpu().numpy(), g_p.numpy())
        np.testing.assert_array_equal(t.cpu().numpy(), t_p.numpy())
    else:
        np.testing.assert_allclose(g.cpu().numpy(), g_p.numpy(), rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["segment", "scan"])
def test_hist_fit_on_card_launches_kernels_on_any_backend(cuda, backend):
    """The backend is only a label in hist mode: a fit on the card with
    the default `backend="segment"` (or "scan") builds its tables with
    feat_hist and cat_hist and grows the CPU fit's trees."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    from repro_torch.kernels import feat_hist
    ds = _small_forest_data("classification")
    params = tree_lib.TreeParams(max_depth=4, backend=backend,
                                 split_mode="hist", num_bins=64)
    feat_hist.launches = cat_hist.launches = 0
    gpu = RandomForest(params, num_trees=2, seed=3, tree_batch=2).fit(ds)
    assert feat_hist.launches > 0 and cat_hist.launches > 0
    cpu = RandomForest(params, num_trees=2, seed=3, tree_batch=2,
                       device="cpu").fit(ds)
    for a, b in zip(cpu.trees, gpu.trees):
        for k in ("feature", "threshold", "is_cat", "cat_mask", "children",
                  "value"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))


def _warp_case(name):
    """Presorted inputs whose warp steps hold the named pattern (binary
    labels; one tree)."""
    rng = np.random.default_rng(7)
    n, L, min_records = 4000, 1, 1.0
    num = rng.normal(size=(n, 2)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    w = np.ones(n, np.float32)
    leaf = np.ones(n, np.int32)                # every row in one leaf
    if name == "ties":                          # equal values in a group
        num = np.round(num * 2) / 2
        w = rng.integers(0, 3, n).astype(np.float32)
    elif name == "equal_gains":                 # period-2 labels, 1 leaf
        num = np.stack([np.arange(n), np.arange(n)[::-1]], 1).astype(
            np.float32)
        y = (np.arange(n) % 2).astype(np.int32)
    elif name == "min_records":                 # crossing inside a step
        n = 150
        num, y, w, leaf = num[:n], y[:n], w[:n], leaf[:n]
        min_records = 45.0
    elif name == "alternating":                 # leaves alternate by row
        L = 2
    elif name in ("L2", "L513"):
        L = 1 if name == "L2" else 512
        n = 50000
        num = np.round(rng.normal(size=(n, 2)) * 8).astype(np.float32) / 8
        y = rng.integers(0, 2, n).astype(np.int32)
        w = rng.integers(0, 3, n).astype(np.float32)
        leaf = rng.integers(0, L + 1, n).astype(np.int32)
    si = np.argsort(num.T, axis=-1, kind="stable").astype(np.int32)
    sv = np.take_along_axis(num.T, si, -1)
    if name == "alternating":                   # in column 0's sorted order
        leaf[si[0]] = 1 + np.arange(n) % 2
    cand = np.ones((2, L + 1), bool)
    cand[:, 0] = False
    return sv, si, leaf, w, y, cand, L, min_records


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["one_leaf", "ties", "equal_gains",
                                  "min_records", "alternating", "L2",
                                  "L513"])
def test_split_scan_cuda_warp_groups(cuda, name):
    """The warp-parallel scan on the patterns its lane groups must get
    right: 32+ consecutive rows of one leaf, equal values inside a group
    (a threshold only on a strictly larger value), equal gains inside a
    group (the first row wins), min_records crossed inside a group,
    alternating leaves, and L1 = 2 and 513.  Binary gini: bit-equal to
    the plain version."""
    sv, si, leaf, w, y, cand, L, mr = _warp_case(name)
    args = (sv, si, leaf, w, y, cand, L, 2, "gini", "classification")
    g, t = _port(*args, device=cuda, min_records=mr)
    g_p, t_p = _port(*args, min_records=mr)
    assert np.isfinite(g_p.numpy()).any()
    np.testing.assert_array_equal(g.cpu().numpy(), g_p.numpy())
    np.testing.assert_array_equal(t.cpu().numpy(), t_p.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_split_scan_cuda_is_deterministic(cuda, task):
    """Two launches on the same inputs give the same bits (3 classes or
    regression, where the sums are floats taken in row order)."""
    C = 3
    sv, si, leaf, w, y, cand = _mk(9, 30000, 3, 40, C, dup=True, task=task)
    imp = "gini" if task == "classification" else "variance"
    args = (sv, si, leaf, w, y, cand, 40, C, imp, task)
    g1, t1 = _port(*args, device=cuda)
    g2, t2 = _port(*args, device=cuda)
    assert torch.equal(g1, g2) and torch.equal(t1, t2)
    g_p, _ = _port(*args)
    fin = np.isfinite(g_p.numpy())
    np.testing.assert_array_equal(np.isfinite(g1.cpu().numpy()), fin)
    from repro_torch.core import splits
    S = C if task == "classification" else 3
    stats = splits.row_stats(torch.as_tensor(y.astype(np.float32)),
                             torch.as_tensor(w), S, task)
    tot = torch.zeros((41, S)).index_add_(
        0, torch.as_tensor(leaf).long(),
        torch.where(torch.as_tensor(w > 0)[:, None], stats, 0.0))
    scale = tot.abs().max().item()          # as the kernel's docstring
    assert np.abs(g1.cpu().numpy()[fin] - g_p.numpy()[fin]).max() <= \
        1e-6 * scale


def _cat_card_case(arities, n, L1, T, task, seed, big_leaf=False):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, a, n) for a in arities]).astype(np.int32)
    leaf = rng.integers(0, L1, (T, n)).astype(np.int32)
    if big_leaf:                                  # half the rows in leaf 1
        leaf[:, : n // 2] = 1
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = (rng.integers(0, 2, n).astype(np.float32) if task == "classification"
         else (rng.normal(size=n) * 3 + 1).astype(np.float32))
    return [torch.as_tensor(a) for a in (x, leaf, w, y)]


@pytest.mark.gpu
@pytest.mark.parametrize("arities,n,L1,T,task,big_leaf", [
    ((2, 700, 10000), 60000, 65, 2, "classification", False),  # mixed
    ((2, 700, 10000), 200000, 2, 2, "classification", False),  # one leaf
    ((2, 700, 10000), 100000, 513, 2, "classification", True),  # split
    ((3, 10000), 60000, 3, 2, "regression", False),   # V % CT != 0
    ((5, 10000), 100000, 513, 2, "regression", True),  # split, regression
    ((9, 31), 30000, 9, 10, "classification", False),  # T > MAXT, natural
])
def test_cat_hist_cuda_tiles(cuda, arities, n, L1, T, task, big_leaf):
    """The tiled kernel at the edges of its plan: arities 2 to 10,000 in
    one call, L1 = 2 with every open row in one leaf, L1 = 513 with a
    leaf whose rows span several blocks, category tiles that do not
    divide V (regression), more trees than one launch takes.
    Classification equals the plain tables bit for bit; regression
    repeats bit for bit and is within 1e-4 of Σ|stat| per cell."""
    args = _cat_card_case(arities, n, L1, T, task, seed=n + L1,
                          big_leaf=big_leaf)
    V = max(arities)
    S = 2 if task == "classification" else 3
    kw = dict(L1=L1, V=V, num_stats=S, task=task)
    dev = [a.to(cuda) for a in args]
    got = cat_hist.cat_hist(*dev, **kw)
    plain = cat_hist.cat_hist_plain(*dev, **kw)
    if task == "classification":
        assert torch.equal(got, plain)
    else:
        again = cat_hist.cat_hist(*dev, **kw)
        assert torch.equal(got, again)
        mag = cat_hist.cat_hist_plain(dev[0], dev[1], dev[2], dev[3].abs(),
                                      **kw)
        assert bool(((got - plain).abs() <= 1e-4 * mag + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("L1,classes", [(2, 0), (513, 0), (16385, 0),
                                        (513, 2)])
def test_leaf_buckets_cuda_equal_plain(cuda, L1, classes):
    """The bucketing kernels write the plain version's lists (a stable
    sort by leaf) and offsets, in shared memory and past it, and with the
    class packed into the row word."""
    rng = np.random.default_rng(L1)
    T, n = 3, 100000
    leaf = torch.as_tensor(rng.integers(0, L1 + 2, (T, n)).astype(np.int32))
    w = torch.as_tensor(rng.integers(0, 3, (T, n)).astype(np.float32))
    y = torch.as_tensor((rng.normal(size=n) * 2).astype(np.float32))
    want = cat_hist.leaf_buckets_plain(leaf, w, y, L1, classes)
    got = cat_hist.leaf_buckets(leaf.to(cuda), w.to(cuda), y.to(cuda), L1,
                                classes)
    ls = want.lstart
    assert torch.equal(got.lstart.cpu(), ls)
    for t in range(T):
        k = int(ls[t, -1])
        for a, b in zip(got[:3], want[:3]):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a[t, :k].cpu(), b[t, :k])


@pytest.mark.gpu
@pytest.mark.parametrize("L1,V", [(9, 10000), (513, 10000), (65, 700),
                                  (9, 13)])
def test_cat_plan_cuda_equals_tile_work(cuda, L1, V):
    """The device planner writes `tile_work`'s items, padding included."""
    rng = np.random.default_rng(L1 + V)
    T, n = 2, 300000
    leaf = rng.integers(0, L1, (T, n)).astype(np.int32)
    leaf[:, : n // 3] = 1                        # one large leaf
    w = rng.integers(0, 3, (T, n)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    args = [torch.as_tensor(a) for a in (leaf, w, y)]
    plan = cat_hist.tile_plan(L1, V, 2)
    lstart = None
    if not plan.natural:
        lstart = cat_hist.leaf_buckets_plain(*args, L1).lstart
    kw = dict(min_piece=4096, device=cuda)
    want = cat_hist.tile_work(lstart, plan, n, T, **dict(kw, device=None))
    got = cat_hist.tile_work(None if lstart is None else lstart.to(cuda),
                             plan, n, T, **kw)
    assert bool((want[:, 4] == 1).any())
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cat_hist_cuda_fractional_weights(cuda):
    """Weights that are not integers (bag counts have none) lose their
    fraction in the kernel's int32 counts as in the plain version's: the
    tables are still bit-equal."""
    args = _cat_card_case((2, 700, 10000), 60000, 65, 2, "classification",
                          seed=5)
    args[2] = args[2] * 0.5 + 0.5 * (args[2] > 0)    # 0, 1, 1.5
    dev = [a.to(cuda) for a in args]
    kw = dict(L1=65, V=10000, num_stats=2)
    assert torch.equal(cat_hist.cat_hist(*dev, **kw),
                       cat_hist.cat_hist_plain(*dev, **kw))


# ---------------------------------------------------------------------------
# Row shards: explicit scales and the int64 sums (`scales=`, `fixed=True`)
# ---------------------------------------------------------------------------

def _shard_case(kernel, n=6000, T=2):
    """Regression inputs, the call that makes the tables from any rows,
    and the rows' leaf / slot (the table's L1 / W axis)."""
    if kernel == "cat_hist":
        x, leaf, w, y = [torch.as_tensor(a) for a in _cat_case(
            37, n=n, m=3, L=6, C=2, T=T, task="regression", seed=n)]
        y = y * 40 + 3
        return (x, leaf, w, y), 7, lambda fn, a, **kw: fn(
            *a, L1=7, V=37, num_stats=3, task="regression", **kw)
    x, slot, w, y = _feat_case(255, T, "regression", n=n, m=4, W=9, seed=n)
    return (x, slot, w, y), 9, lambda fn, a, **kw: fn(
        *a, W=9, B=255, num_stats=3, task="regression", **kw)


def _halves(args):
    """The two row shards of (cols, rows, w, y), split in plain row order
    as the hist and categorical engines split them."""
    h = args[1].shape[1] // 2
    return [(args[0][:, s], args[1][:, s].contiguous(),
             args[2][:, s].contiguous(), args[3][s].contiguous())
            for s in (slice(0, h), slice(h, None))]


def _global_scales(args, L1):
    """The scales every shard shares: the whole row set's n and the max of
    the shards' magnitudes (the engines' all-reduce max)."""
    mags = torch.stack([cat_hist.fixed_point_mags(a[1], a[2], a[3], L1)
                        for a in _halves(args)]).amax(0)
    return cat_hist.power_of_two_scales(mags.tolist(), args[1].shape[1])


@pytest.mark.parametrize("kernel", ["cat_hist", "feat_hist"])
def test_shard_fixed_sums_add_up_to_the_one_pass_table(kernel):
    """The shards' int64 sums under the global scales, added and converted
    once, are the one-pass table bit for bit; those scales are the ones a
    one-pass call picks from all the rows."""
    args, L1, call = _shard_case(kernel)
    fn = getattr(globals()[kernel], kernel)
    scales = _global_scales(args, L1)
    assert scales == cat_hist.fixed_point_scales(args[1], args[2], args[3],
                                                 L1)
    acc = sum(call(fn, [a.contiguous() for a in half], scales=scales,
                   fixed=True) for half in _halves(args))
    assert acc.dtype == torch.int64
    assert torch.equal(cat_hist.from_fixed_point(acc, scales),
                       call(fn, args))


@pytest.mark.gpu
@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("kernel", ["cat_hist", "feat_hist"])
def test_shard_scales_cuda_match_plain(cuda, kernel, fixed):
    """On the card, each shard's call with the global scales (int64 sums
    with `fixed=True`, float32 tables without) equals the plain version's
    on the same tensors bit for bit, and the shards' sums add up to the
    one-pass card table."""
    args, L1, call = _shard_case(kernel, n=200000)
    mod = globals()[kernel]
    fn, plain = getattr(mod, kernel), getattr(mod, f"{kernel}_plain")
    dev = [a.to(cuda) for a in args]
    scales = _global_scales(dev, L1)
    parts = []
    for half in _halves(dev):
        half = [a.contiguous() for a in half]
        before = mod.launches
        got = call(fn, half, scales=scales, fixed=fixed)
        assert mod.launches > before
        want = call(plain, half, scales=scales, fixed=fixed)
        assert got.dtype == want.dtype == (torch.int64 if fixed
                                           else torch.float32)
        assert torch.equal(got, want)
        parts.append(got)
    if fixed:
        assert torch.equal(cat_hist.from_fixed_point(sum(parts), scales),
                           call(fn, dev))
