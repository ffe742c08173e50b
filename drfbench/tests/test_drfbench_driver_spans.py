"""The readers of the forest driver's ranges: `copy_in_ms`, `presort_ms`,
`pack_ms` and `unnamed_idle_ms`, on a trace built by hand and checked
against hand arithmetic, silent where their ranges did not run, and
reported by a tiny traced run of every cell that lists them."""
import json
import types

import pytest

from drfbench import harness, tracing
from drfbench.tests.tiny import CELLS, REPO, make_root

METRICS = ("copy_in_ms", "presort_ms", "pack_ms", "unnamed_idle_ms")


def _reader(name):
    return harness._load_module(REPO / "drfbench" / "metrics" / f"{name}.py",
                                f"drfbench_test_metric_{name}")


def _trace(host, device, idle):
    return tracing.Trace(window=(0.0, 2000.0), busy=[], device_ops={},
                         device_spans=device, host_ranges=host,
                         idle_by_host=idle)


def _run(trace, trees=2):
    return types.SimpleNamespace(trace=trace, trees=trees)


HOST = {"fit.forest": [(0.0, 1900.0)],
        "fit.copy_in": [(0.0, 100.0)],
        "fit.presort": [(200.0, 230.0)],
        "fit.quantize": [(310.0, 320.0)],
        "fit.assemble": [(500.0, 600.0), (700.0, 760.0)],
        "fit.pack": [(800.0, 900.0)],
        "level.book": [(600.0, 700.0)]}
DEVICE = {"fit.copy_in": [(50.0, 180.0)],       # overlaps its host side
          "fit.presort": [(210.0, 300.0)],
          "fit.quantize": [(315.0, 400.0)],
          "fit.pack": [(850.0, 1000.0)],
          "level.numeric": [(1000.0, 1500.0)]}
IDLE = {"fit.forest": 40.0, "fit.forest / aten::copy_": 60.0,
        "fit.pack": 500.0, "fit.pack / aten::zeros": 70.0,
        "fit.forests / x": 900.0, "bench.window": 300.0}


@pytest.mark.parametrize("name, us", [
    ("copy_in_ms", 180.0),                      # [0, 180]
    ("presort_ms", 100.0 + 90.0),               # [200, 300] + [310, 400]
    ("pack_ms", 100.0 + 60.0 + 200.0),          # + [800, 1000]
    ("unnamed_idle_ms", 40.0 + 60.0),           # fit.forest, no narrower
])
def test_reader_reads_the_hand_built_trace(name, us):
    for trees in (1, 4):
        v = _reader(name).read(_run(_trace(HOST, DEVICE, IDLE), trees))
        assert v == pytest.approx(us / 1e3 / trees)


@pytest.mark.parametrize("name", METRICS)
def test_reader_is_silent_where_its_ranges_did_not_run(name):
    # the parent program's trace: level and bagging ranges, no fit.* of
    # the forest driver, idle under the bare window
    parent = _trace({"level.book": [(0.0, 10.0)],
                     "fit.bagging": [(20.0, 30.0)]},
                    {"level.numeric": [(0.0, 50.0)]},
                    {"bench.window": 1000.0, "level.book": 5.0})
    assert _reader(name).read(_run(parent)) is None
    assert _reader(name).read(_run(None)) is None


def test_unnamed_idle_reads_zero_where_the_fit_left_none():
    v = _reader("unnamed_idle_ms").read(
        _run(_trace(HOST, DEVICE, {"fit.pack": 5.0})))
    assert v == 0.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reports_the_driver_metrics(root, cell):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"]
              if m["name"] in METRICS and cell in m["workloads"]}
    out = harness.run_cell(cell, 2**31 + 7, 0.05, True, device="cpu",
                           root=root)
    assert out["correct"] is True
    assert listed <= set(out["metrics"]), listed - set(out["metrics"])
    for name in listed - {"unnamed_idle_ms"}:
        assert out["metrics"][name]["value"] > 0, name
    assert out["metrics"]["unnamed_idle_ms"]["value"] >= 0
    streamed = cell.endswith("streamed")
    assert ("copy_in_ms" in out["metrics"]) is not streamed
    assert ("presort_ms" in out["metrics"]) is not streamed
