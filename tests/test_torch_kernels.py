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

from repro_torch.kernels import cat_hist, ops, split_scan
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


def _port(sv, si, leaf, w, y, cand, L, C, impurity, task, device="cpu"):
    """The port's split_scan on one tree (T = 1)."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    S = C if task == "classification" else 3
    from repro_torch.core import splits
    stats = splits.row_stats(t(y), t(w), S, task)
    tot = torch.zeros((L + 1, S), device=device)
    tot.index_add_(0, t(leaf).long(),
                   torch.where(((t(w) > 0) & (t(leaf) > 0))[:, None], stats,
                               0.0))
    return split_scan.split_scan(
        t(sv), t(si), t(leaf)[None], t(w)[None], t(y.astype(np.float32)),
        t(cand)[None], tot[None], impurity=impurity, task=task,
        min_records=1.0)


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
    if task == "classification":
        np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())
    else:
        again = cat_hist.cat_hist(*[a.to(cuda) for a in args], **kw)
        assert torch.equal(got, again)
        np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                                   rtol=1e-4, atol=1e-4)


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
    """A classification fit on the card (kernels, or the plain scan on
    CUDA tensors) grows the CPU fit's trees bit for bit."""
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
