"""The pipelined host loop of `tree.build_forest`: level d−1's book (node
values, `_grow_level`, `LevelStats`) runs after level d's dispatch and
before the host waits for level d's struct, as in the reference's loop.
The trees it grows are held against the reference by the forest, hist,
segment and pruning parity tests, unchanged."""
import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.dataset import from_numpy
from repro_torch.core.forest import RandomForest
from repro_torch.core.reference import build_tree_reference


def small_ds(task="classification", n=1200, seed=3):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = rng.integers(0, 6, size=(n, 2)).astype(np.int32)
    if task == "classification":
        y = ((num[:, 0] > 0) ^ (cat[:, 0] % 2 == 0)).astype(np.int32)
    else:
        y = (2 * num[:, 0] + cat[:, 1] + 0.1 * rng.normal(size=n)).astype(
            np.float32)
    return from_numpy(num, cat, y, task=task)


def recorded_fit(monkeypatch, params, ds, num_trees=2):
    """Fit with the level step and `_grow_level` wrapped to log their
    calls in order: ("step", depth) and ("grow", depth)."""
    events = []
    step, grow = tree_lib._fused_level_step_batched, tree_lib._grow_level

    def rec_step(inp, splittable_p, fkeys, depth, **kw):
        events.append(("step", depth))
        return step(inp, splittable_p, fkeys, depth, **kw)

    def rec_grow(acc, open_nodes, host, L, m_num, depth, **kw):
        events.append(("grow", depth))
        return grow(acc, open_nodes, host, L, m_num, depth, **kw)

    monkeypatch.setattr(tree_lib, "_fused_level_step_batched", rec_step)
    monkeypatch.setattr(tree_lib, "_grow_level", rec_grow)
    rf = RandomForest(params, num_trees=num_trees, seed=1,
                      tree_batch=num_trees, device="cpu").fit(
        ds, collect_stats=True)
    return rf, events


@pytest.mark.parametrize("params", [
    dict(max_depth=5),
    dict(max_depth=5, backend="kernel"),
    dict(max_depth=5, split_mode="hist", num_bins=16),
    dict(max_depth=4, task="regression", impurity="variance",
         min_records=5)],
    ids=["segment", "kernel", "hist", "regression"])
def test_book_of_level_d_minus_1_runs_after_dispatch_of_level_d(
        monkeypatch, params):
    task = params.get("task", "classification")
    rf, events = recorded_fit(monkeypatch, tree_lib.TreeParams(**params),
                              small_ds(task))
    steps = [i for i, (kind, _) in enumerate(events) if kind == "step"]
    depths = [events[i][1] for i in steps]
    assert depths == list(range(len(steps))) and len(steps) >= 3
    for d, i in enumerate(steps):
        grows = [j for j, e in enumerate(events) if e == ("grow", d - 1)]
        if d == 0:
            assert not grows
            continue
        # every tree's grow of level d-1 lies between the dispatches of
        # level d and level d+1
        assert grows and min(grows) > i, (d, events)
        if d + 1 < len(steps):
            assert max(grows) < steps[d + 1], (d, events)
    # the last dispatched level's book is drained after its fetch
    last = len(steps) - 1
    assert ("grow", last) in events[steps[-1] + 1:]
    # every tree's LevelStats come from the deferred book, one a level
    for log in rf.level_stats:
        assert [s.depth for s in log] == list(range(len(log)))
        assert all(s.wall_seconds > 0 for s in log)


def test_pipelined_tree_equals_build_tree_reference():
    """`build_tree_reference` grows each tree level by level with no
    pipeline: the pipelined `build_forest` must give the same tree, node
    values (written by the deferred book) included."""
    ds = small_ds()
    num = torch.as_tensor(ds.num)
    from repro_torch.core import presort
    si = presort.presort_columns(num)
    kw = dict(num=num, cat=torch.as_tensor(ds.cat),
              labels=torch.as_tensor(ds.labels),
              sorted_vals=presort.gather_sorted(num, si), sorted_idx=si,
              arities=ds.arities, num_classes=2,
              params=tree_lib.TreeParams(max_depth=6), seed=2)
    spec, _ = build_tree_reference(tree_idx=1, **kw)
    (tree,), _ = tree_lib.build_forest(tree_indices=[1], **kw)
    for k in ("feature", "threshold", "is_cat", "cat_mask", "children",
              "value", "n_node", "depth"):
        np.testing.assert_array_equal(getattr(tree, k), getattr(spec, k))


def test_fetch_to_host_on_the_cpu_hands_the_tensors_over():
    t = {"a": torch.arange(6).reshape(2, 3), "b": torch.tensor([True, False])}
    got = tree_lib._fetch_to_host(t)()
    assert set(got) == {"a", "b"}
    np.testing.assert_array_equal(got["a"], t["a"].numpy())
    np.testing.assert_array_equal(got["b"], t["b"].numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned buffers and events exist "
                    "only with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fetch_to_host_on_the_card_copies_into_pinned_buffers(cuda):
    src = {"x": torch.arange(1 << 20, device=cuda, dtype=torch.int32),
           "y": torch.rand((3, 5), device=cuda)}
    wait = tree_lib._fetch_to_host(src)
    got = wait()
    for k, v in src.items():
        np.testing.assert_array_equal(got[k], v.cpu().numpy())
