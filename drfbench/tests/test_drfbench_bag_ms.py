"""The reader of the forest driver's bag draw, `bag_ms`: on a trace built
by hand and checked against hand arithmetic, silent where `fit.bag_draw`
did not run (a program without the range), and reported by a tiny traced
run of every cell that lists it."""
import json
import types

import pytest

from drfbench import harness, tracing
from drfbench.tests.tiny import CELLS, REPO, make_root


def _reader():
    return harness._load_module(REPO / "drfbench" / "metrics" / "bag_ms.py",
                                "drfbench_test_metric_bag_ms")


def _trace(host, device):
    return tracing.Trace(window=(0.0, 2000.0), busy=[], device_ops={},
                         device_spans=device, host_ranges=host,
                         idle_by_host={"bench.window": 300.0})


def _run(trace, trees=2):
    return types.SimpleNamespace(trace=trace, trees=trees)


# fit.bagging holds the draw and the row statistics; only the draw counts
HOST = {"fit.forest": [(0.0, 1900.0)],
        "fit.bagging": [(1000.0, 1200.0)],
        "fit.bag_draw": [(1000.0, 1040.0), (1100.0, 1110.0)]}
DEVICE = {"fit.bag_draw": [(1030.0, 1060.0), (1105.0, 1150.0)],
          "fit.bagging": [(1160.0, 1190.0)],
          "level.numeric": [(1200.0, 1500.0)]}


@pytest.mark.parametrize("trees", [1, 4])
def test_bag_ms_reads_the_hand_built_trace(trees):
    v = _reader().read(_run(_trace(HOST, DEVICE), trees))
    # [1000, 1060] + [1100, 1150]: host and device overlap, counted once
    assert v == pytest.approx((60.0 + 50.0) / 1e3 / trees)


@pytest.mark.parametrize("trace", [
    # the parent program's trace: fit.bagging with no fit.bag_draw inside
    _trace({"fit.bagging": [(20.0, 30.0)], "level.book": [(0.0, 10.0)]},
           {"fit.bagging": [(20.0, 40.0)], "level.numeric": [(0.0, 50.0)]}),
    None,
], ids=["parent", "untraced"])
def test_bag_ms_is_silent_where_the_draw_did_not_run(trace):
    assert _reader().read(_run(trace)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reports_bag_ms(root, cell):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (entry,) = [m for m in spec["per_layer"] if m["name"] == "bag_ms"]
    assert cell in entry["workloads"]
    out = harness.run_cell(cell, 2**31 + 7, 0.05, True, device="cpu",
                           root=root)
    assert out["correct"] is True
    assert out["metrics"]["bag_ms"]["value"] > 0
