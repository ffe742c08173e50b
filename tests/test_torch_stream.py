"""Out-of-core streamed training of the port against the reference.

`RandomForest.fit_streamed(source)` trains hist-mode trees from a
`RowSource` one row chunk at a time.  Its trees must equal, node for node
and bit for bit (classification counts are integers, so the chunked
tables are exact), the port's in-memory hist fit with and without
subtraction and the reference's own `fit_streamed`, at every chunk size,
with pruning, from an in-memory source and from a memmap cache built by
either package.  Also here: the streaming quantizer against both
quantizers, the chunked table sum against one pass, the chunk-step
counters, the error paths, and (marked `gpu`) the card against the CPU.
The reference runs through `reference()`; its fits are made once per
module.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import presort, tree as tree_lib
from repro_torch.core.dataset import (ArrayRowSource, MemmapRowSource,
                                      from_numpy)
from repro_torch.core.forest import RandomForest
from repro_torch.core.level import engines, plan as plan_lib
from repro_torch.core.level.plan import make_plan
from repro_torch.kernels import feat_hist, ops as kops
from test_torch_forest import assert_trees_equal
from test_torch_harness import reference

FIELDS = ("feature", "threshold", "is_cat", "cat_mask", "children", "value",
          "n_node", "gain", "depth")
N, BINS, SEED, TREES = 900, 32, 7, 3


def _params(**kw):
    return tree_lib.TreeParams(**dict(dict(max_depth=6, split_mode="hist",
                                           num_bins=BINS), **kw))


def _ds(n=N, seed=3):
    """Numeric-only xor rows, made by the port's copy of the reference's
    generator (equal arrays, `test_synthetic_data_matches_reference`)."""
    from repro_torch.data import synthetic
    return synthetic.make_tabular("xor", n, 4, 2, 0, seed=seed)


def _port_stream(src, params, **kw):
    return RandomForest(params, num_trees=TREES, seed=SEED,
                        device="cpu").fit_streamed(src, **kw)


@pytest.fixture(scope="module")
def fits():
    """Per bagging mode: the reference's streamed fit and the port's
    in-memory fits with subtraction on and off."""
    ref = reference()
    ds = _ds()
    rds = ref.dataset.from_numpy(ds.num, None, ds.labels)
    out = {}
    for bagging in ("poisson", "none"):
        p = dict(max_depth=6, split_mode="hist", num_bins=BINS,
                 bagging=bagging)
        rsrc = ref.dataset.ArrayRowSource.from_dataset(rds, BINS,
                                                       chunk_size=250)
        r = ref.forest.RandomForest(ref.tree.TreeParams(**p),
                                    num_trees=TREES,
                                    seed=SEED).fit_streamed(rsrc)
        mem = {sub: RandomForest(_params(bagging=bagging, hist_subtract=sub),
                                 num_trees=TREES, seed=SEED,
                                 device="cpu").fit(ds)
               for sub in (True, False)}
        out[bagging] = (r, mem)
    return ds, out


@pytest.mark.parametrize("bagging", ["poisson", "none"])
@pytest.mark.parametrize("chunk", [37, 500, N + 1])
def test_streamed_fit_equals_in_memory_and_reference(fits, bagging, chunk):
    ds, out = fits
    r, mem = out[bagging]
    src = ArrayRowSource.from_dataset(ds, BINS, chunk_size=chunk)
    got = _port_stream(src, _params(bagging=bagging))
    assert_trees_equal(r.trees, got.trees, FIELDS)
    for sub in (True, False):
        assert_trees_equal(mem[sub].trees, got.trees, FIELDS)
    np.testing.assert_array_equal(
        got.predict_proba(ds.num, ds.cat).numpy(),
        np.asarray(r.predict_proba(ds.num, ds.cat)))


def test_streamed_fit_with_pruning(fits):
    """Host-side Sprint pruning drops rows mid-fit (twice here) and
    changes no tree: the pruned streamed fit equals the port's pruned and
    unpruned in-memory fits."""
    ds, _ = fits
    params = _params(prune_closed_frac=0.05, min_records=30, max_depth=8)
    src = ArrayRowSource.from_dataset(ds, BINS, chunk_size=97)
    got = RandomForest(params, num_trees=TREES, seed=SEED,
                       device="cpu").fit_streamed(src, collect_stats=True)
    rows = [s.rows_scanned // s.feature_passes for s in got.level_stats[0]]
    assert rows[-1] < rows[0] == N, rows
    mem = RandomForest(params, num_trees=TREES, seed=SEED,
                       device="cpu").fit(ds)
    assert_trees_equal(mem.trees, got.trees, FIELDS)
    unpruned = RandomForest(_params(min_records=30, max_depth=8),
                            num_trees=TREES, seed=SEED, device="cpu").fit(ds)
    assert_trees_equal(unpruned.trees, got.trees, FIELDS)


def test_streamed_fit_uint16_bins():
    """Past 256 bins the cache is uint16 and travels as its int16 bits."""
    ds = _ds(600, seed=5)
    params = _params(num_bins=300, max_depth=5)
    src = ArrayRowSource.from_dataset(ds, 300, chunk_size=113)
    assert src.bins_block(0, 3).dtype == np.uint16
    got = _port_stream(src, params)
    mem = RandomForest(params, num_trees=TREES, seed=SEED,
                       device="cpu").fit(ds)
    assert_trees_equal(mem.trees, got.trees, FIELDS)


def test_memmap_source_built_by_port(fits, tmp_path):
    """A cache the port builds (streaming quantizer, no float column in
    memory) has the in-memory edges and trains the reference's trees; the
    reference opens the same files."""
    ds, out = fits
    src = MemmapRowSource.from_numpy(ds.num, ds.labels, num_bins=BINS,
                                     path=tmp_path / "bins.npy",
                                     chunk_size=97)
    mem = ArrayRowSource.from_dataset(ds, BINS)
    np.testing.assert_array_equal(src.edges, mem.edges)
    np.testing.assert_array_equal(src.bins_block(0, N), mem.bins)
    got = _port_stream(src, _params())
    assert_trees_equal(out["poisson"][0].trees, got.trees, FIELDS)
    ref = reference()
    rsrc = ref.dataset.MemmapRowSource(str(tmp_path / "bins.npy"),
                                       src.edges, ds.labels, num_classes=2)
    np.testing.assert_array_equal(np.asarray(rsrc.bins_take(np.arange(N))),
                                  mem.bins)


def test_memmap_cache_built_by_reference_opens_in_port(fits, tmp_path):
    ds, out = fits
    ref = reference()
    path = str(tmp_path / "ref_bins.npy")
    rsrc = ref.dataset.MemmapRowSource.from_numpy(
        ds.num, ds.labels, num_bins=BINS, path=path, chunk_size=131)
    src = MemmapRowSource(path, np.asarray(rsrc.edges), ds.labels,
                          num_classes=2, chunk_size=131)
    got = _port_stream(src, _params())
    assert_trees_equal(out["poisson"][0].trees, got.trees, FIELDS)


def _edge_case(kind, n, m, rng):
    if kind == "ties":
        return (np.round(rng.normal(size=(n, m)) * 2) / 2).astype(np.float32)
    if kind == "constant":
        num = rng.normal(size=(n, m)).astype(np.float32)
        num[:, 1] = -2.5
        return num
    if kind == "skew":
        return (-np.abs(rng.normal(size=(n, m))) ** 3).astype(np.float32)
    return rng.normal(size=(n, m)).astype(np.float32)


@pytest.mark.parametrize("kind,n,m,B", [
    ("normal", 1000, 3, 16), ("ties", 64, 4, 64), ("constant", 977, 2, 255),
    ("skew", 5000, 1, 7), ("ties", 700, 2, 300)])
def test_streaming_quantile_edges_equal_both_quantizers(kind, n, m, B):
    """The radix-select edges equal the reference's and the port's torch
    `quantize_edges` on the presort, and `bin_block` its `bin_columns`."""
    ref = reference()
    num = _edge_case(kind, n, m, np.random.default_rng(len(kind) + n))

    def chunks():
        for lo in range(0, n, 173):
            yield num[lo:lo + 173]

    got = presort.streaming_quantile_edges(chunks, n, m, B)
    np.testing.assert_array_equal(
        got, ref.presort.streaming_quantile_edges(chunks, n, m, B))
    t = torch.as_tensor(num)
    want = presort.quantize_edges(
        presort.gather_sorted(t, presort.presort_columns(t)), B)
    np.testing.assert_array_equal(got, want.numpy())
    bins = presort.bin_block(num, got)
    assert bins.dtype == (np.uint8 if B <= 256 else np.uint16)
    np.testing.assert_array_equal(
        bins, presort.bin_columns(t, want).numpy().view(bins.dtype))
    np.testing.assert_array_equal(bins, ref.presort.bin_block(num, got))


@pytest.mark.parametrize("case", ["exact", "regression", "categorical",
                                  "num_bins", "dataset", "fit"])
def test_stream_error_paths_raise_as_reference(case):
    """Each restriction raises in both packages, with the same type (the
    reference asserts numeric-only sources; the port raises ValueError)
    and message."""
    ref = reference()
    ds = _ds(200)
    reg = from_numpy(ds.num, None, ds.num[:, 0], task="regression")
    cat = from_numpy(ds.num, ds.num[:, :1].astype(np.int32) % 3, ds.labels)
    kinds = {
        "exact": (ValueError, "only hist streams",
                  dict(split_mode="exact"), ds),
        "regression": (ValueError, "classification-only",
                       dict(task="regression", impurity="variance"), reg),
        "categorical": ((AssertionError, ValueError), "numeric-only", {},
                        cat),
        "num_bins": (ValueError, "num_bins", dict(num_bins=64), ds),
        "dataset": (TypeError, "RowSource", {}, ds),
        "fit": (TypeError, "fit_streamed", {}, ds),
    }
    exc, match, extra, data = kinds[case]
    for pkg in ("reference", "port"):
        if pkg == "reference":
            rf_cls, dsmod, tp = (ref.forest.RandomForest, ref.dataset,
                                 ref.tree.TreeParams)
            kw = {}
            d = ref.dataset.from_numpy(data.num, data.cat if data.m_cat
                                       else None, data.labels,
                                       task=data.task)
        else:
            rf_cls, tp, kw, d = RandomForest, tree_lib.TreeParams, dict(
                device="cpu"), data
            from repro_torch.core import dataset as dsmod
        params = tp(**dict(dict(max_depth=3, split_mode="hist",
                                num_bins=BINS), **extra))
        rf = rf_cls(params=params, num_trees=1, **kw)
        with pytest.raises(exc, match=match):
            if case == "dataset":
                rf.fit_streamed(d)
            else:
                src = dsmod.ArrayRowSource.from_dataset(d, BINS)
                rf.fit(src) if case == "fit" else rf.fit_streamed(src)


def _acc_case(seed, n=257, m=3, L=4, B=16, C=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, B, (m, n)).astype(np.uint8),
            rng.integers(0, L + 1, (2, n)).astype(np.int32),
            rng.integers(0, 3, (2, n)).astype(np.float32),
            rng.integers(0, C, n).astype(np.int32))


@pytest.mark.parametrize("seed,cuts", [(0, [100, 200]), (1, [1, 2, 250]),
                                       (2, [50, 50, 128]), (3, [])])
def test_chunked_accumulation_equals_one_pass(seed, cuts):
    """`HistNumeric.stream_accumulate` over any chunk cuts (single rows, an
    empty chunk, one chunk) equals the one-pass `feat_hist_plain` tables
    exactly."""
    n, m, L, B, C = 257, 3, 4, 16, 3
    bins, leaf, w, y = (torch.as_tensor(a) for a in _acc_case(seed))
    one_pass = feat_hist.feat_hist_plain(bins, leaf, w, y.float(), W=L + 1,
                                         B=B, num_stats=C)
    st = engines.LevelStatics(m_num=m, m_cat=0, max_arity=1, num_classes=C,
                              impurity="gini", task="classification",
                              min_records=1.0, num_bins=B)
    eng = engines.HistNumeric()
    acc = eng.stream_init(2, st, L, torch.device("cpu"))
    bounds = [0] + sorted(cuts) + [n]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        acc = eng.stream_accumulate(acc, bins[:, lo:hi].contiguous(),
                                    leaf[:, lo:hi].contiguous(),
                                    w[:, lo:hi].contiguous(), y[lo:hi], st,
                                    L)
    assert torch.equal(eng.stream_finalize(acc), one_pass)


def test_chunk_steps_and_table_builds_are_counted(fits, monkeypatch):
    """Every level above max_depth builds its tables once per chunk
    through the `feat_hist` wrapper; `_STREAM_CHUNK_CALLS` counts those
    chunk steps plus the last level's totals chunks."""
    ds, _ = fits
    builds = []
    adapter = kops.feature_tables

    def counted(*a, **k):
        builds.append(a[1].shape[1])
        return adapter(*a, **k)
    monkeypatch.setattr(kops, "feature_tables", counted)
    chunk = 123
    per_level = -(-N // chunk)
    plan_lib._STREAM_CHUNK_CALLS[0] = 0
    params = _params()
    got = _port_stream(ArrayRowSource.from_dataset(ds, BINS,
                                                   chunk_size=chunk),
                       params, collect_stats=True)
    deepest = max(t.max_depth_reached for t in got.trees)
    assert deepest == params.max_depth       # the last level sums totals
    assert len(builds) == deepest * per_level
    assert set(builds) == {chunk}            # fixed-shape, padded chunks
    assert plan_lib._STREAM_CHUNK_CALLS[0] == (deepest + 1) * per_level
    assert max(len(log) for log in got.level_stats) == deepest


def test_only_streaming_engines_stream():
    """The hist engine streams; an exact engine is refused."""
    plan = make_plan(_params(), m_num=3, m_cat=0, max_arity=1, num_classes=2,
                     m_prime=2)
    assert plan.numeric.supports_stream
    assert not engines.ExactNumeric().supports_stream
    with pytest.raises(ValueError, match="histogram engine"):
        _port_stream(ArrayRowSource.from_dataset(_ds(200), BINS), _params(),
                     engine=engines.ExactNumeric())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the streamed fit's chunks go through "
                    "the feat_hist kernel only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [250, 4096])
def test_streamed_fit_on_card_equals_cpu(cuda, chunk):
    """A streamed fit on the card (pinned staging, feat_hist per chunk)
    grows the CPU fit's trees and the card's in-memory trees."""
    ds = _ds(6000, seed=9)
    params = _params(max_depth=8, min_records=2)
    src = ArrayRowSource.from_dataset(ds, BINS, chunk_size=chunk)
    feat_hist.launches = 0
    gpu = RandomForest(params, num_trees=TREES, seed=SEED).fit_streamed(src)
    assert feat_hist.launches > 0
    cpu = _port_stream(src, params)
    assert_trees_equal(cpu.trees, gpu.trees, FIELDS)
    mem = RandomForest(params, num_trees=TREES, seed=SEED).fit(ds)
    assert_trees_equal(mem.trees, gpu.trees, FIELDS)
