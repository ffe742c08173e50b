"""The forest driver's `record_function` ranges on the CPU.

`RandomForest.fit` runs inside `fit.forest`, with its copy-in, presort,
quantizer (hist mode), bagging (the bag draw itself in `fit.bag_draw`),
tree assembly (one range per tree batch) and packing in ranges nested
there; `fit_streamed` opens `fit.forest`, `fit.bagging` (a `fit.bag_draw`
a tree), `fit.assemble` and `fit.pack` the same way, and runs its host
book under `level.book`: the node values after each chunk pass and the
tree growth after each scored level.  The ranges only annotate: a profiled fit grows
the trees an unprofiled one grows.
"""
import collections

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import ArrayRowSource
from repro_torch.core.forest import RandomForest
from repro_torch.data import synthetic

TREES, BATCH, BINS = 3, 2, 16
FIELDS = ("feature", "threshold", "is_cat", "cat_mask", "children", "value",
          "n_node", "gain", "depth")
PREFIXES = ("fit.", "level.", "stream.")


def _rf(**params):
    return RandomForest(tree_lib.TreeParams(max_depth=4, **params),
                        num_trees=TREES, seed=11, tree_batch=BATCH,
                        device="cpu")


def _ranges(fit):
    """The fit's result and its ranges as (start, end, name), in start
    order, from the raw events of a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rf = fit()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(PREFIXES))
    return rf, ranges


def _assert_same_forest(a, b):
    assert len(a.trees) == len(b.trees) == TREES
    for i, (x, y) in enumerate(zip(a.trees, b.trees)):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k),
                                          err_msg=f"tree {i} {k}")
    for k, v in a.packed.to_arrays().items():
        np.testing.assert_array_equal(v, b.packed.to_arrays()[k], err_msg=k)


def _assert_nested_in_one_forest(ranges):
    (lo, hi), = [(a, b) for a, b, nm in ranges if nm == "fit.forest"]
    for a, b, nm in ranges:
        assert lo <= a <= b <= hi, nm


def _assert_draws_inside_bagging(ranges, draws):
    """`draws` fit.bag_draw ranges, each inside a fit.bagging range."""
    outer = [(a, b) for a, b, nm in ranges if nm == "fit.bagging"]
    inner = [(a, b) for a, b, nm in ranges if nm == "fit.bag_draw"]
    assert len(inner) == draws
    for a, b in inner:
        assert any(lo <= a <= b <= hi for lo, hi in outer), (a, b)


@pytest.mark.parametrize("mode", ["exact", "hist"])
def test_fit_names_its_own_steps(mode):
    ds = synthetic.make_tabular("xor", 500, 3, 2, 2, seed=4)
    params = dict(split_mode=mode, num_bins=BINS) if mode == "hist" else {}
    rf, ranges = _ranges(lambda: _rf(**params).fit(ds))
    _assert_nested_in_one_forest(ranges)
    n = collections.Counter(nm for _, _, nm in ranges)
    batches = -(-TREES // BATCH)
    assert (n["fit.copy_in"], n["fit.presort"], n["fit.quantize"],
            n["fit.assemble"], n["fit.pack"]) == \
        (1, 1, int(mode == "hist"), batches, 1)
    assert n["fit.bagging"] == batches and n["level.book"] >= batches
    _assert_draws_inside_bagging(ranges, batches)
    _assert_same_forest(rf, _rf(**params).fit(ds))


def test_fit_streamed_names_its_host_book():
    ds = synthetic.make_tabular("xor", 600, 3, 2, 0, seed=5)
    src = ArrayRowSource.from_dataset(ds, BINS, chunk_size=250)
    params = dict(split_mode="hist", num_bins=BINS)
    rf, ranges = _ranges(lambda: _rf(**params).fit_streamed(src))
    _assert_nested_in_one_forest(ranges)
    n = collections.Counter(nm for _, _, nm in ranges)
    assert n["fit.copy_in"] == n["fit.presort"] == n["fit.quantize"] == 0
    assert (n["fit.assemble"], n["fit.pack"]) == (-(-TREES // BATCH), 1)
    assert n["fit.bagging"] == -(-TREES // BATCH)
    _assert_draws_inside_bagging(ranges, TREES)     # one draw a tree
    # in time order, each chunk pass (a run of stream.fetch) is followed
    # by the node values' level.book, and each scored level's host fetch
    # by the tree growth's level.book
    seq = [nm for _, _, nm in ranges
           if nm in ("stream.fetch", "level.host_fetch", "level.book",
                     "fit.assemble")]
    seq = [nm for i, nm in enumerate(seq)
           if not (nm == "stream.fetch" and i and seq[i - 1] == nm)]
    passes = seq.count("stream.fetch")
    fetches = seq.count("level.host_fetch")
    assert fetches >= 2 and passes > fetches
    for i, nm in enumerate(seq):
        if nm in ("stream.fetch", "level.host_fetch"):
            assert seq[i + 1] == "level.book", (i, seq)
    assert seq.count("level.book") == passes + fetches
    _assert_same_forest(rf, _rf(**params).fit_streamed(src))
