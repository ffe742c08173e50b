"""The harness on the CPU at a tiny size: every cell runs and prints the
contract's line, a cell and a metric dropped in as files run with no code
edit, the command refuses a machine without CUDA, and nothing the
benchmark runs loads JAX or the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from drfbench import harness
from drfbench.tests.tiny import CELLS, REPO, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(root, cell):
    out = harness.run_cell(cell, 2**31 + 11, 0.05, False, device="cpu",
                           root=root)
    assert list(out) == KEYS                    # the check's key comes last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2 and out["attempted"] % 2 == 0
    spec = json.loads((root / "BENCHMARK.json").read_text())
    e2e = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    assert {"tree_s", "setup_s"} <= set(out["metrics"])
    for name, m in out["metrics"].items():
        assert m["unit"] == e2e[name] and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["check"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(out)


def test_traced_run_gives_per_layer_metrics_and_breakdown(root):
    out = harness.run_cell("majority.hist", 5, 0.05, True, device="cpu",
                           root=root)
    assert list(out) == KEYS[:5] + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # device metrics stay silent without a device trace
    assert "fit_mfu" in out["metrics"] and "idle_share" not in out["metrics"]


def test_a_cell_and_a_metric_dropped_in_run_without_code_edits(root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    d = root / "drfbench"
    (d / "traffic" / "hist-64.json").write_text(json.dumps(
        {"tree": {"split_mode": "hist", "backend": "kernel",
                  "num_bins": 64, "hist_subtract": False},
         "streamed": False, "warm_trees": 1}))
    (d / "limits" / "majority.hist-64.json").write_text(
        (d / "limits" / "majority.hist.json").read_text())
    (d / "metrics" / "levels_per_tree.py").write_text(
        "def read(run):\n    return len(run.levels()) / run.trees\n")
    spec["workloads"].append({"name": "majority.hist-64",
                              "config": "majority", "traffic": "hist-64",
                              "chips": 1, "why": "a cell dropped in"})
    spec["per_layer"].append({
        "name": "levels_per_tree", "unit": "levels", "better": "lower",
        "source": "program_counter", "layer": "tree driver",
        "moves": "tree_s", "workloads": ["majority.hist-64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.run_cell("majority.hist-64", 3, 0.05, True, device="cpu",
                           root=root)
    assert out["correct"] is True
    assert 1 <= out["metrics"]["levels_per_tree"]["value"] <= 4


def test_command_refuses_a_machine_without_cuda(tmp_path):
    for where in (REPO, make_root(tmp_path)):   # also with no program
        p = subprocess.run(
            [sys.executable, str(where / "drfbench" / "run.py"),
             "--workload", "majority.hist", "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout == ""


def test_nothing_the_benchmark_runs_loads_jax(root):
    code = (
        "import sys; from pathlib import Path; from drfbench import harness, "
        "control; harness.run_cell('majority.hist', 1, 0.01, True, "
        f"device='cpu', root=Path({str(root)!r})); "
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO,
                       env=dict(os.environ,
                                PYTHONPATH=f"{REPO}:{REPO / 'src'}"))
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = eval(p.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch.core.tree", "jaxtyping", "reproducible"]) == []
    assert harness.forbidden_modules(
        ["repro.core.tree", "jax.numpy", "flax"]) == ["flax", "jax", "repro"]


def test_forest_seeds_fit_the_generator_for_large_run_seeds():
    seeds = {harness.forest_seed(s, i) for s in (0, 2**31 + 5, 2**40)
             for i in range(-2, 8)}
    assert len(seeds) == 30 and all(0 <= s < 2**31 for s in seeds)
