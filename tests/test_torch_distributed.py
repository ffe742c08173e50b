"""The port's mesh engines on `torch.distributed` against the one-device
port and the reference's mesh engines.

One module-scoped fixture starts four gloo ranks on the CPU (a data=2 ×
model=2 mesh meeting through a FileStore under `tmp_path`) and, beside
them, one JAX subprocess with four forced host devices that runs the
reference's local forests and its mesh engines on a 2x2 host mesh
(`tests/torch_dist_worker.py` makes every input from numpy seeds: 1024
rows, 8 numeric + 4 categorical columns of arity 5, depth 4 or 5).  The
parametrized cases read what the processes wrote.

Tolerances: classification forests are bit-equal node for node (integer
counts); so are the regression hist forests, whose tables the row shards
sum in the kernels' shared 64-bit fixed point.  The regression exact
forest sums its shard prefixes in float64 in another order than one pass,
so it is held to the same structure with node values and thresholds
within rtol 1e-5 (the regression tolerance of `test_torch_forest.py`),
with `min_records=10` as ROADMAP's shared limits ask.  Engine outputs
against the reference's mesh engines: gini gains bit-equal, thresholds
within 1e-4 where the gain is finite, the finite masks equal.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import pruning, splits
from test_torch_forest import EXACT_KEYS, STRUCT_KEYS
from test_torch_harness import reference
from torch_dist_worker import FORESTS, TREES, TREE_KEYS, engine_inputs

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORKER = TESTS / "torch_dist_worker.py"
WORLD = 4
TIMEOUT = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks and the reference together; wait for all."""
    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # one intra-op thread a rank: four ranks of a core's worth of work
    # each, which otherwise oversubscribe the cores ten times over
    env["OMP_NUM_THREADS"] = "1"
    procs = {"reference": subprocess.Popen(
        [sys.executable, str(WORKER), "reference", str(tmp / "ref")],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    for r in range(WORLD):
        procs[r] = subprocess.Popen(
            [sys.executable, str(WORKER), "port", str(r), str(WORLD),
             str(tmp / "store"), str(tmp / f"rank{r}")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done = {}
    try:
        for key, p in procs.items():
            out, _ = p.communicate(timeout=TIMEOUT)
            done[key] = (p.returncode, out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return types.SimpleNamespace(tmp=tmp, done=done)


@pytest.fixture(scope="module")
def port(runs):
    for r in range(WORLD):
        rc, out = runs.done[r]
        assert rc == 0, f"rank {r} failed:\n{out[-4000:]}"
    return types.SimpleNamespace(
        ranks=[json.loads((runs.tmp / f"rank{r}.json").read_text())
               for r in range(WORLD)],
        arrays=np.load(runs.tmp / "rank0.npz"))


@pytest.fixture(scope="module")
def ref(runs):
    rc, out = runs.done["reference"]
    assert rc == 0, f"the reference failed:\n{out[-4000:]}"
    return np.load(runs.tmp / "ref.npz")


def trees_of(arrays, prefix):
    return [{k: arrays[f"{prefix}/{t}/{k}"] for k in TREE_KEYS}
            for t in range(TREES)]


def assert_forests(a, b, regression):
    for i, (x, y) in enumerate(zip(a, b)):
        for k in (STRUCT_KEYS if regression else EXACT_KEYS):
            np.testing.assert_array_equal(y[k], x[k], err_msg=f"tree {i} {k}")
        if regression:
            np.testing.assert_allclose(y["value"], x["value"], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(y["threshold"], x["threshold"],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(FORESTS))
def test_sharded_forest_equals_local(port, name):
    """Every mesh engine grows the one-device port's forest (the pruned
    one: the same fit unpruned)."""
    f = port.ranks[0]["forests"][name]
    if name == "regression_exact":
        assert_forests(trees_of(port.arrays, f"{name}/local"),
                       trees_of(port.arrays, f"{name}/sharded"), True)
    else:
        assert f["sharded"] == f["local"]


@pytest.mark.parametrize("name", list(FORESTS))
def test_sharded_forest_equals_reference(port, ref, name):
    """...and the reference's one-device forest."""
    assert_forests(trees_of(ref, f"{name}/reference"),
                   trees_of(port.arrays, f"{name}/sharded"),
                   name.startswith("regression"))


def test_every_rank_grows_the_same_forests(port):
    first = port.ranks[0]
    for other in port.ranks[1:]:
        for key in ("forests", "streamed", "gbt"):
            assert other[key] == first[key], key


def test_pruning_under_the_mesh_drops_whole_shard_widths(port):
    """Rows closed in a tree are dropped (a tree of 3 trains alone), in
    multiples of the 2 row shards, and the trees do not change (above)."""
    rows = port.ranks[0]["forests"]["pruned"]["rows"]
    flat = [r for tree in rows for r in tree]
    assert min(flat) < 1024, rows
    assert all(r % 2 == 0 for r in flat), rows


def test_streamed_sharded_hist_equals_in_memory(port, ref):
    """fit_streamed through the sharded hist engine: no collective in the
    chunk passes, one all-reduce over data a level (gathers over model
    for the scores), and the in-memory trees."""
    s = port.ranks[0]["streamed"]
    assert s["streamed"] == s["in_memory"]
    assert s["ops"] == [["all_gather", "model"], ["all_reduce_sum", "data"]]
    assert_forests(trees_of(ref, "streamed/reference"),
                   trees_of(port.arrays, "streamed/sharded"), False)


@pytest.mark.parametrize("mode", ["hist", "exact"])
def test_gbt_through_the_mesh_equals_local(port, mode):
    """GBTModel.fit(engine=...) with the sharded engines (squared loss):
    hist bit-equal (fixed-point tables), exact within the regression
    tolerance."""
    g = port.ranks[0]["gbt"][mode]
    if mode == "hist":
        assert g["sharded"] == g["local"]
    a = [{k: port.arrays[f"gbt_{mode}/local/{t}/{k}"] for k in TREE_KEYS}
         for t in range(3)]
    b = [{k: port.arrays[f"gbt_{mode}/sharded/{t}/{k}"] for k in TREE_KEYS}
         for t in range(3)]
    assert_forests(a, b, True)


def test_sharded_evaluate_equals_local(port, ref):
    e = engine_inputs()
    local = e["num"][np.arange(len(e["leaf"])), e["feat"][e["leaf"]]] \
        <= e["thr"][e["leaf"]]
    np.testing.assert_array_equal(port.arrays["engine/evaluate"], local)
    np.testing.assert_array_equal(ref["engine/evaluate"], local)


@pytest.mark.parametrize("key,what", [
    ("m_num", "m_num (numeric columns): 7"), ("n", "n (rows): 1023"),
    ("m_cat", "m_cat (categorical columns): 3")])
def test_indivisible_shapes_raise(port, key, what):
    assert what in port.ranks[0]["errors"][key]


def test_engine_without_a_mesh_raises(port):
    assert "needs a launch.mesh.Mesh" in port.ranks[0]["errors"]["no_mesh"]


@pytest.mark.parametrize("engine", ["exact_2d", "exact_columns", "hist",
                                    "categorical", "level_step"])
def test_engine_matches_reference_mesh_engine(port, ref, engine):
    """The port's engines in the gloo group against the reference's
    `make_*_sharded_supersplit` / `drf_level_step_fn` on its 2x2 host mesh,
    on the same level inputs."""
    got, want = port.arrays, ref
    key = "feat" if engine == "level_step" else None
    if key:
        np.testing.assert_array_equal(got[f"engine/{engine}/feat"],
                                      want[f"engine/{engine}/feat"])
    g, wg = got[f"engine/{engine}/gain"], want[f"engine/{engine}/gain"]
    fin = np.isfinite(wg)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    np.testing.assert_array_equal(g[fin], wg[fin])          # gini: bit-equal
    np.testing.assert_allclose(g[fin], wg[fin], atol=1e-3)
    if engine == "categorical":
        np.testing.assert_array_equal(got["engine/categorical/mask"][fin],
                                      want["engine/categorical/mask"][fin])
    else:
        np.testing.assert_allclose(got[f"engine/{engine}/thr"][fin],
                                   want[f"engine/{engine}/thr"][fin],
                                   atol=1e-4)


def test_mesh_collectives_and_their_log(port):
    """Row-major coordinates, the collectives' values over each axis, and
    one log entry per collective with its payload bytes (no seconds: the
    mesh is untimed); gloo on the CPU stages nothing."""
    for r, res in enumerate(port.ranks):
        d, f = divmod(r, 2)
        assert res["mesh"]["coords"] == {"data": d, "model": f}
        assert res["mesh"]["staged"] == []
        c = res["collectives"]
        assert c["gather_data"] == [float(f), float(2 + f)]
        assert c["gather_model"] == [float(2 * d), float(2 * d + 1)]
        assert c["sum_data"] == float(f + 2 + f)
        assert c["max_model"] == float(2 * d + 1)
        assert c["bools"] == [[True], [False]]
        assert c["log"] == [["all_gather", "data", 24],
                            ["all_gather", "model", 24],
                            ["all_reduce_sum", "data", 24],
                            ["all_reduce_max", "model", 24],
                            ["all_gather", "model", 1]]
        assert c["seconds"] == [None] * 5


def test_host_staged_collectives_equal_direct(port):
    """Collectives forced through host buffers give the direct values and
    are logged as staged."""
    for r, res in enumerate(port.ranks):
        d, f = divmod(r, 2)
        c = res["staged_collectives"]
        assert c["gather_data"] == [float(f), float(2 + f)]
        assert c["sum_data"] == float(f + 2 + f)
        assert c["max_model"] == float(2 * d + 1)
        assert c["bools"] == [[True], [False]]
        assert c["staged"] == [True] * 4


def test_make_mesh_needs_an_initialized_group():
    from repro_torch.launch.mesh import make_mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2, 2, backend="gloo", device="cpu")


# ---------------------------------------------------------------------------
# One process: the resumable scorers and the shard-aware pruning rule
# ---------------------------------------------------------------------------

def _column(task, seed=3, n=600, L=4):
    rng = np.random.default_rng(seed)
    v = np.sort(np.round(rng.normal(size=n), 1)).astype(np.float32)
    leaf = rng.integers(0, L + 1, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    if task == "classification":
        y = rng.integers(0, 3, n)
        stats = np.stack([w * (y == c) for c in range(3)], -1)
    else:
        y = rng.normal(size=n) * 2 + 1
        stats = np.stack([w, w * y, w * y * y], -1)
    cand = np.ones(L + 1, bool)
    cand[0] = False
    return [torch.as_tensor(a) for a in (v, leaf, w, stats.astype(np.float32),
                                         cand)], L


@pytest.mark.parametrize("backend", ["segment", "scan"])
@pytest.mark.parametrize("task", ["classification", "regression"])
@pytest.mark.parametrize("cut", [0.3, 0.5])
def test_resumed_scan_equals_one_pass(backend, task, cut):
    """A two-way split of the presorted column, the second part resumed
    from the first part's per-leaf prefix (`h_init`), last in-bag value
    (`v_init`, +inf = none) and the global totals, gives the one-pass
    gains and thresholds wherever the second part holds the leaf's best
    split; classification bit for bit, regression within float32
    rounding of the prefixes."""
    (v, leaf, w, stats, cand), L = _column(task)
    impurity = "gini" if task == "classification" else "variance"
    fn = (splits.best_numeric_split_segment if backend == "segment"
          else splits.best_numeric_split_scan)
    inbag = (w > 0) & (leaf > 0)
    contrib = torch.where(inbag[:, None], stats, 0.0)
    totals = torch.zeros((L + 1, stats.shape[1])).index_add_(
        0, leaf.long(), contrib)
    g1, t1 = fn(v, leaf, w, stats, cand, L, impurity, task, 1.0,
                totals=totals)
    k = int(len(v) * cut)
    h = torch.zeros_like(totals).index_add_(0, leaf[:k].long(), contrib[:k])
    last = torch.full((L + 1,), float("-inf")).scatter_reduce(
        0, leaf[:k].long(), torch.where(inbag[:k], v[:k], float("-inf")),
        "amax")
    v_init = torch.where(torch.isfinite(last), last, float("inf"))
    ga, ta = fn(v[:k], leaf[:k], w[:k], stats[:k], cand, L, impurity, task,
                1.0, totals=totals)
    gb, tb = fn(v[k:], leaf[k:], w[k:], stats[k:], cand, L, impurity, task,
                1.0, totals=totals, h_init=h, v_init=v_init)
    first = ga >= gb                       # ties to the earlier shard
    g = torch.where(first, ga, gb)
    t = torch.where(first, ta, tb)
    fin = torch.isfinite(g1)
    assert torch.equal(torch.isfinite(g), fin)
    if task == "classification":
        assert torch.equal(g[fin], g1[fin])
        assert torch.equal(t[fin], t1[fin])
    else:
        torch.testing.assert_close(g[fin], g1[fin], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(t[fin], t1[fin])


def test_row_sharded_scorer_needs_global_totals():
    (v, leaf, w, stats, cand), L = _column("classification")
    h = torch.zeros((L + 1, 3))
    for fn in (splits.best_numeric_split_segment,
               splits.best_numeric_split_scan):
        with pytest.raises(ValueError, match="GLOBAL totals"):
            fn(v, leaf, w, stats, cand, L, h_init=h)


@pytest.mark.parametrize("n,closed,shards,frac", [
    (100, 57, 1, 0.3), (100, 57, 2, 0.3), (100, 57, 4, 0.3),
    (100, 3, 4, 0.01), (100, 100, 2, 0.5), (100, 99, 2, 0.5),
    (64, 20, 8, 0.3), (0, 0, 2, 0.1)])
def test_plan_drop_matches_reference(n, closed, shards, frac):
    from repro.core import pruning as ref_pruning
    reference()
    assert pruning.plan_drop(n, closed, shards, frac) == \
        ref_pruning.plan_drop(n, closed, shards, frac)


@pytest.mark.parametrize("drop", [0, 1, 7, 20])
def test_keep_mask_matches_reference(drop):
    from repro.core import pruning as ref_pruning
    ref = reference()
    closed = np.random.default_rng(drop).random(50) < 0.5
    got = pruning.keep_mask(torch.as_tensor(closed), drop).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_pruning.keep_mask(ref.jnp.asarray(closed), drop)))
    assert (~got).sum() == min(drop, closed.sum())


@pytest.mark.parametrize("msg,refused", [
    ("ProcessGroupGloo::allgather: invalid argument: unsupported device "
     "type cuda", True),
    ("Unsupported device type: cuda", True),
    ("No backend type associated with device type cuda", True),
    ("Connection closed by peer [127.0.0.1]:29500", False),
    ("CUDA error: out of memory", False)])
def test_gloo_refusal_is_told_from_other_errors(msg, refused):
    """The mesh stages a collective only when gloo refuses the tensor's
    device; any other error of its probe is raised."""
    from repro_torch.launch import mesh
    assert bool(mesh._REFUSAL.search(msg)) == refused


def test_distributed_forest_example_through_supersplit_fn(port):
    """The port's run of `examples/distributed_forest.py`: `fit(ds,
    supersplit_fn=make_2d_sharded_supersplit(mesh))` on every rank of the
    (2, 2) mesh, and a bare closure around the engine's legacy signature
    (the per-tree builder), each equal to the local forest."""
    for r in port.ranks:
        ex = r["example"]
        assert ex["engine"] == ex["local"], r["rank"]
        assert ex["closure"] == ex["local"], r["rank"]
