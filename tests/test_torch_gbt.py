"""The port's boosted trees (`repro_torch.core.gbt`) against the
reference's `repro.core.gbt`.

Each round is a regression tree, whose sums round in another order than
XLA's: a round fit to the reference's own residuals must have the
reference tree's structure exactly, with thresholds within rtol 1e-6 and
node values within rtol/atol 1e-5.  Whole models compound those last-bit
differences through the residuals of later rounds (and the logistic
`exp` rounds differently in torch and numpy), so they are held to the
same structure and `predict_raw` within atol 1e-5.  `min_records=10`
keeps exact gain ties in tiny leaves, which the two packages break
differently in float32, out of the comparison (as the regression forest
tests do).  The reference's hist GBT runs on `backend="segment"`: its
Pallas `feat_hist` does not run on jax 0.9.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core import presort, tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.gbt import GBTModel, GBTParams
from test_torch_harness import reference

STRUCT_KEYS = ("feature", "is_cat", "cat_mask", "children", "depth")
ROUNDS, DEPTH, MIN_RECORDS = 4, 3, 10
CASES = [("squared", {}), ("squared", dict(backend="kernel")),
         ("squared", dict(split_mode="hist", num_bins=32)),
         ("logistic", {}), ("logistic", dict(backend="kernel"))]
IDS = ["squared-segment", "squared-kernel", "squared-hist",
       "logistic-segment", "logistic-kernel"]


@pytest.fixture(scope="module")
def data():
    """1500 rows: 3 numeric + 2 categorical columns (arities 4 and 12), a
    regression target and binary labels, both from numpy's seed 7."""
    rng = np.random.default_rng(7)
    n = 1500
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, 4, n), rng.integers(0, 12, n)],
                   1).astype(np.int32)
    effect = rng.normal(size=12)
    y_reg = (2 * num[:, 0] + num[:, 1] ** 2 + effect[cat[:, 1]]
             + 0.1 * rng.normal(size=n)).astype(np.float32)
    y_bin = ((num[:, 0] + effect[cat[:, 1]] + 0.3 * rng.normal(size=n))
             > 0).astype(np.int32)
    return num, cat, {"squared": (y_reg, "regression"),
                      "logistic": (y_bin, "classification")}


def gbt_params(loss, extra, **kw):
    return {**dict(num_rounds=ROUNDS, max_depth=DEPTH,
                   min_records=MIN_RECORDS, loss=loss), **extra, **kw}


def fit_both(data, loss, extra, **kw):
    num, cat, ys = data
    y, task = ys[loss]
    ref = reference()
    p = gbt_params(loss, extra, **kw)
    # the reference's hist GBT on segment: its Pallas feat_hist is dead
    rp = dict(p, backend="segment") if p.get("split_mode") == "hist" else p
    r = ref.gbt.GBTModel(ref.gbt.GBTParams(**rp)).fit(
        ref.dataset.from_numpy(num, cat, y, task=task))
    q = GBTModel(GBTParams(**p), device="cpu").fit(
        from_numpy(num, cat, y, task=task))
    return ref, r, q


def assert_same_structure(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        assert a.num_nodes == b.num_nodes, (i, a.num_nodes, b.num_nodes)
        for k in STRUCT_KEYS:
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"round {i} {k}")


@pytest.mark.parametrize("loss,extra", CASES, ids=IDS)
def test_single_rounds_match_reference(data, loss, extra):
    """Round t of the port, fit by `tree.build_tree` to the reference's
    own residuals of round t, is the reference's tree t."""
    num, cat, ys = data
    ref, r, _ = fit_both(data, loss, extra)
    y = np.asarray(ys[loss][0], np.float64)
    p = r.params
    tparams = tree_lib.TreeParams(
        max_depth=p.max_depth, min_records=p.min_records,
        num_candidates=num.shape[1] + cat.shape[1], impurity="variance",
        task="regression", backend=extra.get("backend", "segment"),
        bagging="none", split_mode=p.split_mode, num_bins=p.num_bins)
    num_t = torch.as_tensor(num)
    sorted_idx = presort.presort_columns(num_t)
    sorted_vals = presort.gather_sorted(num_t, sorted_idx)
    f = np.full_like(y, r.base_score)
    for t, ref_tree in enumerate(r.trees):
        if loss == "logistic":
            resid = y - 1.0 / (1.0 + np.exp(-f))
        else:
            resid = y - f
        tr, _ = tree_lib.build_tree(
            num=num_t, cat=torch.as_tensor(cat),
            labels=torch.as_tensor(resid.astype(np.float32)),
            sorted_vals=sorted_vals, sorted_idx=sorted_idx,
            arities=(4, 12), num_classes=2, params=tparams, seed=p.seed,
            tree_idx=t)
        assert_same_structure([ref_tree], [tr])
        np.testing.assert_allclose(tr.threshold, ref_tree.threshold,
                                   rtol=1e-6)
        np.testing.assert_allclose(tr.value, ref_tree.value, rtol=1e-5,
                                   atol=1e-5)
        step = np.asarray(ref_tree.predict_raw(num, cat))[:, 0]
        f = f + p.learning_rate * step


@pytest.mark.parametrize("loss,extra", CASES, ids=IDS)
def test_whole_model_matches_reference(data, loss, extra):
    num, cat, _ = data
    _, r, q = fit_both(data, loss, extra)
    assert q.base_score == r.base_score
    assert_same_structure(r.trees, q.trees)
    assert q.packed is not None and q.packed.num_trees == ROUNDS
    np.testing.assert_allclose(q.predict_raw(num, cat).numpy(),
                               np.asarray(r.predict_raw(num, cat)),
                               atol=1e-5)


def test_zero_rounds_returns_the_prior(data):
    num, cat, _ = data
    _, r, q = fit_both(data, "squared", {}, num_rounds=0)
    assert q.trees == [] and q.packed is None
    f = q.predict_raw(num, cat)
    assert f.dtype == torch.float32 and tuple(f.shape) == (num.shape[0],)
    np.testing.assert_array_equal(f.numpy(),
                                  np.asarray(r.predict_raw(num, cat)))


def test_logistic_predict_and_proba_match_reference(data):
    num, cat, ys = data
    _, r, q = fit_both(data, "logistic", {})
    proba = q.predict_proba(num, cat)
    assert proba.dtype == torch.float64 and tuple(proba.shape) == (
        num.shape[0], 2)
    np.testing.assert_allclose(proba.numpy(), r.predict_proba(num, cat),
                               atol=1e-6)
    np.testing.assert_allclose(proba.sum(-1).numpy(), 1.0, atol=1e-12)
    pred = q.predict(num, cat)
    assert pred.dtype == torch.int32
    np.testing.assert_array_equal(pred.numpy(), r.predict(num, cat))
    assert float((pred.numpy() == ys["logistic"][0]).mean()) > 0.8


def test_squared_predict_is_the_raw_score(data):
    num, cat, _ = data
    _, _, q = fit_both(data, "squared", {})
    assert torch.equal(q.predict(num, cat), q.predict_raw(num, cat))


def test_predict_raw_single_call_no_tree_loop(data, monkeypatch):
    """One `_forest_predict` over the packed rounds: no per-round
    `Tree.predict_raw`, and the answer is the explicit per-round sum."""
    num, cat, _ = data
    _, _, q = fit_both(data, "squared", {})
    want = np.full(num.shape[0], q.base_score)
    for tr in q.trees:
        want = want + q.params.learning_rate * tr.predict_raw(
            num, cat, device="cpu").numpy()[:, 0]
    calls = []
    inner = forest_lib._forest_predict

    def counted(*a, **k):
        calls.append(k.get("reduce_mean"))
        return inner(*a, **k)

    def boom(*a, **k):
        raise AssertionError("per-round Tree.predict_raw in predict_raw")

    monkeypatch.setattr(forest_lib, "_forest_predict", counted)
    monkeypatch.setattr(tree_lib.Tree, "predict_raw", boom)
    f1 = q.predict_raw(num, cat)
    assert calls == [False]
    f2 = q.predict_raw(num, cat)
    assert len(calls) == 2
    assert torch.equal(f1, f2)
    np.testing.assert_allclose(f1.numpy(), want, atol=1e-5, rtol=1e-5)


def test_fit_without_device_needs_cuda(data, monkeypatch):
    num, cat, ys = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GBTModel(GBTParams(num_rounds=1)).fit(
            from_numpy(num, cat, ys["squared"][0], task="regression"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GBT fit's kernels (split_scan, "
                    "cat_hist, feat_hist) run only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("loss,extra", CASES, ids=IDS)
def test_gbt_on_card_equals_cpu_fit(cuda, data, loss, extra):
    """A GBT fit on the card grows the CPU fit's trees node for node, and
    its `predict_raw` equals the CPU's bit for bit."""
    num, cat, ys = data
    y, task = ys[loss]
    ds = from_numpy(num, cat, y, task=task)
    p = GBTParams(**gbt_params(loss, extra))
    gpu = GBTModel(p).fit(ds)
    cpu = GBTModel(p, device="cpu").fit(ds)
    assert_same_structure(cpu.trees, gpu.trees)
    for a, b in zip(cpu.trees, gpu.trees):
        for k in ("threshold", "value", "n_node"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    np.testing.assert_array_equal(gpu.predict_raw(num, cat).cpu().numpy(),
                                  cpu.predict_raw(num, cat).numpy())
