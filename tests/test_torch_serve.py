"""The port's `ForestServer` (`repro_torch.serve.engine`): every case of
the reference's `tests/test_server_robust.py` on the port, and the
reference's served answers.

Malformed requests (wrong feature count, non-finite numeric rows,
categorical ids outside the declared arity, wrong dtypes or shapes) must
raise the typed `InvalidRequest` before the descent and leave the server
serving: every test fires a bad request, catches the error, and asserts
that the next good request still answers correctly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import PackedForest, RandomForest
from repro_torch.serve.engine import ForestServer, InvalidRequest
from test_torch_harness import reference


def _rows(n=400, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 4, size=(n, 2)).astype(np.int32)
    y = ((num[:, 0] > 0) ^ (cat[:, 0] == 1)).astype(np.int32)
    return num, cat, y


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """A numeric-only forest and a mixed numeric+categorical one, trained
    by the port on the CPU and saved as .npz."""
    tmp = tmp_path_factory.mktemp("srv")
    num, cat, y = _rows()
    params = tree_lib.TreeParams(max_depth=4)
    out = {}
    for name, ds in (("num", from_numpy(num, None, y)),
                     ("mix", from_numpy(num, cat, y, arities=(4, 4)))):
        rf = RandomForest(params, num_trees=3, seed=0, device="cpu").fit(ds)
        out[name] = str(tmp / f"{name}.npz")
        rf._packed_forest().save(out[name])
    return out


@pytest.fixture(scope="module")
def servers(paths):
    srv_num = ForestServer.load(paths["num"], device="cpu")
    srv_mix = ForestServer.load(paths["mix"], m_cat=2, arities=(4, 4),
                                device="cpu")
    return srv_num, srv_mix


def _good_num():
    return np.zeros((2, 3), np.float32)


def _good_cat():
    return np.zeros((2, 2), np.int32)


def _assert_still_serving(srv, cat=None):
    """The recovery half of every test: a well-formed request after the
    rejected one gets a normal answer."""
    out = srv.predict(_good_num(), cat).numpy()
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)


def test_wrong_feature_count_rejected(servers):
    srv, _ = servers
    with pytest.raises(InvalidRequest, match=r"\(B, 3\)"):
        srv.predict(np.zeros((2, 5), np.float32))
    with pytest.raises(InvalidRequest, match=r"\(B, 3\)"):
        srv.predict(np.zeros((3,), np.float32))      # missing batch axis
    _assert_still_serving(srv)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_rows_rejected(servers, bad):
    srv, _ = servers
    x = _good_num()
    x[1, 2] = bad
    with pytest.raises(InvalidRequest, match="row 1, column 2"):
        srv.predict(x)
    _assert_still_serving(srv)


def test_categorical_out_of_arity_rejected(servers):
    _, srv = servers
    cat = _good_cat()
    cat[0, 1] = 4                                    # arity 4: ids 0..3
    with pytest.raises(InvalidRequest, match="column 1 has id 4"):
        srv.predict(_good_num(), cat)
    cat = _good_cat()
    cat[1, 0] = -1
    with pytest.raises(InvalidRequest, match=">= 0"):
        srv.predict(_good_num(), cat)
    _assert_still_serving(srv, _good_cat())


def test_categorical_shape_and_dtype_rejected(servers):
    _, srv = servers
    with pytest.raises(InvalidRequest, match=r"\(B, 2\)"):
        srv.predict(_good_num(), np.zeros((2, 3), np.int32))
    with pytest.raises(InvalidRequest, match="batch"):
        srv.predict(_good_num(), np.zeros((4, 2), np.int32))
    with pytest.raises(InvalidRequest, match="integer"):
        srv.predict(_good_num(), np.zeros((2, 2), np.float32))
    _assert_still_serving(srv, _good_cat())


def test_missing_categorical_row_rejected(servers):
    _, srv = servers
    with pytest.raises(InvalidRequest, match="m_cat=2"):
        srv.predict(_good_num())
    _assert_still_serving(srv, _good_cat())


def test_arities_length_validated_at_load(servers, tmp_path):
    _, srv = servers
    # reuse the mixed model file through the server's own packed forest
    path = str(tmp_path / "again.npz")
    srv.packed.save(path)
    with pytest.raises(ValueError, match="one arity per"):
        ForestServer.load(path, m_cat=2, arities=(4,), device="cpu")


def test_categorical_forest_needs_m_cat_at_load(paths):
    with pytest.raises(ValueError, match="m_cat=0"):
        ForestServer.load(paths["mix"], device="cpu")


def test_invalid_request_is_a_value_error(servers):
    """Back-compat: callers that caught ValueError keep working."""
    srv, _ = servers
    with pytest.raises(ValueError):
        srv.predict(np.zeros((2, 5), np.float32))


def test_answers_equal_the_packed_forest(servers, paths):
    """A valid request answers as `PackedForest.predict_proba` of the same
    file, for every warm size and one that was not warmed."""
    _, srv = servers
    pk = PackedForest.load(paths["mix"], device="cpu")
    num, cat, _ = _rows(n=300, seed=5)
    for b in (1, 7, 300):
        assert torch.equal(srv.predict(num[:b], cat[:b]),
                           pk.predict_proba(num[:b], cat[:b]))


def test_reference_saved_forest_serves_as_the_reference(tmp_path):
    """A .npz written by the reference's `PackedForest.save`, served by
    the port, answers bit for bit as the reference's `ForestServer`."""
    ref = reference()
    num, cat, y = _rows()
    rf = ref.forest.RandomForest(ref.tree.TreeParams(max_depth=4),
                                 num_trees=3, seed=0).fit(
        ref.dataset.from_numpy(num, cat, y, arities=(4, 4)))
    path = str(tmp_path / "ref.npz")
    rf._packed_forest().save(path)
    theirs = ref.serve_engine.ForestServer.load(path, m_cat=2,
                                                arities=(4, 4))
    ours = ForestServer.load(path, m_cat=2, arities=(4, 4), device="cpu")
    q_num, q_cat, _ = _rows(n=257, seed=9)
    for b in (1, 257):
        np.testing.assert_array_equal(
            ours.predict(q_num[:b], q_cat[:b]).numpy(),
            np.asarray(theirs.predict(q_num[:b], q_cat[:b])))
    bad = q_cat[:2].copy()
    bad[0, 0] = 4
    for srv in (ours, theirs):
        with pytest.raises(ValueError, match="column 0 has id 4"):
            srv.predict(q_num[:2], bad)


def test_load_without_device_needs_cuda(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ForestServer.load(paths["num"])


def test_readme_boosting_and_serving_lines_run_on_cpu(tmp_path):
    """The README's GBT and `ForestServer` lines, with `device="cpu"`."""
    from repro_torch.core.gbt import GBTModel, GBTParams
    from repro_torch.data import synthetic
    train, test = synthetic.train_test_split(synthetic.make_tabular(
        "xor", n=6000, num_informative=2, num_useless=8, seed=0))
    gbt = GBTModel(GBTParams(loss="logistic"), device="cpu").fit(train)
    scores = gbt.predict_raw(test.num, test.cat)
    assert tuple(scores.shape) == (test.n,)
    rf = RandomForest(tree_lib.TreeParams(max_depth=12, backend="segment"),
                      num_trees=3, seed=42, device="cpu").fit(train)
    path = str(tmp_path / "forest.npz")
    rf.packed.save(path)
    srv = ForestServer.load(path, m_cat=train.m_cat, arities=train.arities,
                            warm_batch_sizes=(1, 1024), device="cpu")
    probs = srv.predict(test.num[:1], test.cat[:1])
    assert tuple(probs.shape) == (1, 2)
    assert torch.equal(probs, rf.predict_proba(test.num[:1], test.cat[:1]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the server loads onto the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_answers_equal_cpu_answers(cuda, paths):
    srv_gpu = ForestServer.load(paths["mix"], m_cat=2, arities=(4, 4),
                                warm_batch_sizes=(1, 64))
    srv_cpu = ForestServer.load(paths["mix"], m_cat=2, arities=(4, 4),
                                device="cpu")
    assert srv_gpu.packed.device.type == "cuda"
    num, cat, _ = _rows(n=1000, seed=4)
    for b in (1, 64, 1000):
        got = srv_gpu.predict(num[:b], cat[:b])
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      srv_cpu.predict(num[:b],
                                                      cat[:b]).numpy())
    with pytest.raises(InvalidRequest):
        srv_gpu.predict(num[:2], cat[:2] + 4)
    np.testing.assert_array_equal(srv_gpu.predict(num[:2], cat[:2]).cpu()
                                  .numpy(),
                                  srv_cpu.predict(num[:2], cat[:2]).numpy())

