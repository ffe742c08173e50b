"""The benchmark's driver: one cell of `BENCHMARK.json`, run from its seed.

A cell names a configuration (a JSON file of sizes and tree rules, with
the plain torch generator of its rows beside it) and a traffic mix (a JSON
file in `drfbench/traffic/` that says how the forests are trained).  The
harness finds both by name and knows nothing of either:

  set-up   make the rows on the device from `--seed` with the
           configuration's generator, hand them to the program as host
           arrays (and, for a streamed mix, as an on-disk bin cache in
           TMPDIR), and warm the program with a fit of `warm_trees` trees;
  window   train forests of `trees_per_fit` trees back to back, forest
           seed (seed, fit index), until `--seconds` have passed: the last
           fit is the last one that started before then;
  check    after the window, judge every tree of one fit drawn from the
           seed against the plain reference (`reference/forest.py`),
           number by number against `drfbench/limits/<cell>.json`;
  metrics  each metric of the cell is read by `drfbench/metrics/<name>.py`
           (`read(run)` -> number or None): with `trace` the per-layer
           ones, from a `torch.profiler` trace of the window, else the
           end-to-end ones.

`run_cell` runs on any device, so the tests drive it on the CPU; `run.py`
is the command, which insists on CUDA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks",
                       "chip_smoke"})


def forest_seed(seed: int, index: int) -> int:
    """The 31-bit forest seed of fit `index` of a run with `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # BENCHMARK.json metric entries of the cell
    per_layer: list
    root: Path

    def generator(self):
        return _load_module(self.root / self.config["generator"],
                            f"drfbench_config_{self.config['name']}")

    def reader(self, metric: str):
        safe = metric.replace(".", "_").replace("-", "_")
        return _load_module(self.root / "drfbench" / "metrics"
                            / f"{metric}.py", f"drfbench_metric_{safe}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    read = lambda p: json.loads(Path(p).read_text())
    return Cell(
        name=name, chips=int(wl["chips"]), root=root,
        config=read(root / cfg["file"]),
        traffic=read(root / "drfbench" / "traffic" / f"{wl['traffic']}.json"),
        limits=read(root / "drfbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


@dataclasses.dataclass
class Fit:
    index: int
    seed: int
    wall_s: float
    trees: list                 # the program's host trees
    packed: dict                # the program's PackedForest, host arrays


@dataclasses.dataclass
class Run:
    """What a run saw; the metric readers read it."""
    cell: Cell
    setup_s: float
    window_s: float
    fits: list
    peak_bytes: int
    problem: object = None      # reference.forest.Problem of the rows
    trace: object = None        # tracing.Trace (traced runs)
    _levels: list = None

    @property
    def trees(self) -> int:
        return sum(len(f.trees) for f in self.fits)

    def shape(self) -> dict:
        """The level shapes the frozen counts take."""
        P = self.problem
        return dict(m_num=P.m_num, arities=P.arities, mode=P.mode,
                    bins=P.bins, classes=P.classes)

    def levels(self) -> list:
        """Every traced tree's walked levels (`reference.forest.walk`)."""
        if self._levels is None:
            from drfbench.reference.forest import walk
            self._levels = [lv for f in self.fits
                            for t in range(len(f.trees))
                            for lv in walk(self.problem, tree_arrays(f, t),
                                           f.seed, t)]
        return self._levels


def tree_arrays(fit: Fit, t: int):
    """Tree t of a fit as the packed forest holds it, with its node
    weights from the program's tree."""
    from drfbench.reference.forest import TreeArrays
    N = fit.trees[t].num_nodes
    pk = fit.packed
    return TreeArrays(feature=pk["feature"][t, :N],
                      threshold=pk["threshold"][t, :N],
                      is_cat=pk["is_cat"][t, :N],
                      cat_mask=pk["cat_mask"][t, :N],
                      children=pk["children"][t, :N],
                      value=pk["value"][t, :N],
                      n_node=fit.trees[t].n_node)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tree_params(cell: Cell):
    from repro_torch.core.tree import TreeParams
    return TreeParams(**cell.config["tree"], **cell.traffic["tree"])


def problem(cell: Cell, num, cat, y, arities, device):
    """The reference's view of the rows, on `device`."""
    import torch
    from drfbench.reference.forest import Problem
    p = tree_params(cell)
    t = lambda a: torch.as_tensor(a, device=device)
    return Problem(num=t(num), cat=t(cat), y=t(y).long(),
                   arities=tuple(arities), classes=cell.config["classes"],
                   max_depth=p.max_depth, min_records=p.min_records,
                   mode=p.split_mode, bins=p.num_bins, impurity=p.impurity)


def make_rows(cell: Cell, seed: int, device):
    """The rows as host numpy arrays (num, cat, labels, arities), made on
    `device` by the configuration's generator."""
    num, cat, y, arities = cell.generator().make(cell.config, seed, device)
    return (num.cpu().numpy(), cat.cpu().numpy(),
            y.cpu().numpy().astype(np.int32), tuple(arities))


def _stream_source(cell, num_np, y_np, device, path: Path):
    """An on-disk bin cache of the rows: the program's quantizer on the
    device, written as the program's memmap format under TMPDIR."""
    import torch
    from repro_torch.core import atomicio, presort
    from repro_torch.core.dataset import MemmapRowSource
    num = torch.as_tensor(num_np, device=device)
    sv = presort.gather_sorted(num, presort.presort_columns(num))
    bins, edges = presort.quantize(num, sv, tree_params(cell).num_bins)
    del num, sv
    np.save(path, bins.t().contiguous().cpu().numpy())
    with open(path, "rb+") as f:        # on disk before the window opens
        os.fsync(f.fileno())
    src = MemmapRowSource(path, edges.cpu().numpy(), y_np,
                          num_classes=cell.config["classes"],
                          chunk_size=cell.traffic["chunk_size"])
    atomicio.atomic_write_json(MemmapRowSource.meta_path(path),
                               src._expected_meta())
    return src


def check(run: Run, seed: int) -> tuple[dict, int]:
    """Judge every tree of one fit of the window, drawn from the seed.
    Returns ({number: (worst reading, limit)}, trees that broke a limit)."""
    from drfbench.reference.forest import check_tree
    limits = run.cell.limits
    fit = run.fits[forest_seed(seed, -2) % len(run.fits)]
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    for t in range(len(fit.trees)):
        r = check_tree(run.problem, tree_arrays(fit, t), fit.seed, t)
        failed += any(r[k] > lim for k, lim in limits.items())
        for k in worst:
            worst[k] = max(worst[k], float(r[k]))
    return {k: (worst[k], limits[k]) for k in worst}, failed


@contextlib.contextmanager
def program(cell: Cell, rows, device):
    """The program, handed the rows as the cell's traffic says: yields
    `fit(forest_seed, trees) -> RandomForest` (synchronised).  A streamed
    mix's bin cache lives in a directory under TMPDIR for the duration."""
    import torch
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import RandomForest
    dev = torch.device(device)
    params = tree_params(cell)
    streamed = bool(cell.traffic.get("streamed", False))
    num_np, cat_np, y_np, arities = rows
    with tempfile.TemporaryDirectory(prefix="drfbench-") as tmp:
        data = (_stream_source(cell, num_np, y_np, dev,
                               Path(tmp) / "bins.npy") if streamed
                else from_numpy(num_np, cat_np, y_np, arities))

        def fit(seed: int, trees: int):
            rf = RandomForest(params, num_trees=trees, seed=seed,
                              tree_batch=cell.traffic.get("tree_batch"),
                              device=device)
            rf = rf.fit_streamed(data) if streamed else rf.fit(data)
            _sync(dev)
            return rf
        yield fit


def fit_trees(cell: Cell, rows, seed: int, trees: int, device) -> list:
    """One fit through the cell's path, as reference `TreeArrays`."""
    with program(cell, rows, device) as fit:
        rf = fit(seed, trees)
    f = Fit(0, seed, 0.0, rf.trees, rf.packed.to_arrays())
    return [tree_arrays(f, t) for t in range(trees)]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float | None = None) -> dict:
    """Run one cell and return the result line (a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    cell = load_cell(name, root)
    dev = torch.device(device)
    T = int(cell.config["trees_per_fit"])
    rows = make_rows(cell, seed, dev)

    with program(cell, rows, device) as fit:
        fit(forest_seed(seed, -1), int(cell.traffic["warm_trees"]))
        gc.collect()
        _sync(dev)
        setup_s = time.perf_counter() - t_start

        def window():
            fits = []
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while not fits or time.perf_counter() < deadline:
                i = len(fits)
                f0 = time.perf_counter()
                rf = fit(forest_seed(seed, i), T)
                wall = time.perf_counter() - f0
                fits.append(Fit(i, forest_seed(seed, i), wall, rf.trees,
                                rf.packed.to_arrays()))
                del rf
            return fits, time.perf_counter() - t0

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                with record_function("bench.window"):
                    fits, window_s = window()
        else:
            fits, window_s = window()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, fits=fits,
              peak_bytes=int(peak), problem=problem(cell, *rows, dev))
    clock = time.perf_counter()
    compared, failed = check(run, seed)
    seconds = dict(setup=setup_s, window=window_s,
                   check=time.perf_counter() - clock)

    metrics = {}
    entries = cell.per_layer if trace else cell.end_to_end
    clock = time.perf_counter()
    if trace:
        from drfbench import tracing
        run.trace = tracing.summarize(prof)
        seconds["trace"] = time.perf_counter() - clock
    for m in entries:
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    seconds["metrics"] = time.perf_counter() - clock - seconds.get("trace", 0)
    seconds["fits"] = [f.wall_s for f in fits]
    print("drfbench: seconds " + json.dumps(seconds), file=sys.stderr)

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": failed == 0, "attempted": run.trees, "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["check"] = {k: {"value": v, "limit": lim}
                    for k, (v, lim) in compared.items()}
    return out


def forbidden_modules(modules) -> list:
    """Top-level names of `modules` that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
