#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed S]

Phases, each fatal on failure:
  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build every CUDA kernel from `src/repro_torch/csrc/` (one nvcc per
     source, all in parallel) into `build/repro_torch/`;
  2. hold each kernel against its plain PyTorch version on the card:
     split_scan at n=2^20 (T=2, m=3, L1 in {2, 65, 513}; gini, entropy,
     variance; ties, ragged n) and cat_hist at n=2^20 (m=8, V in
     {2, 1000, 10000}, L1 in {2, 65}), then both at the main path's shapes
     with their times (CUDA events, median of several runs);
  3. train `RandomForest(TreeParams(max_depth=10, backend="kernel"),
     num_trees=4, tree_batch=2)` on 2^23 Leo-shaped rows (3 numeric + 79
     categorical columns, arities log-spaced 2..10,000) made with numpy
     from --seed, with the launch counters set to 0 just before and read
     just after; a second identical fit must grow identical trees;
  4. predict 2^20 held-out rows, print the AUC, check a save/load round
     trip, and check that a small fit on the card equals the same fit on
     the CPU.
Prints a JSON line with every kernel's numbers, the nvidia-smi line, and
last `{"ok": true, "device": {...}}`.  Exits non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12          # H100 SXM fp32, outside the tensor cores
TIMED_RUNS = 5
TREES, TREE_BATCH = 4, 2         # the phase-3 forest
TEST_ROWS = 1 << 20              # held-out rows for phase 4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of `fn()` on the card (CUDA events, 1 warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def split_scan_inputs(g, n, T, m, L1, C, task, dev, ties=True):
    import torch
    vals = torch.randn((n, m), generator=g, device=dev)
    if ties:
        vals = torch.round(vals * 4) / 4                    # heavy ties
    sidx = torch.argsort(vals.t(), dim=-1, stable=True).to(
        torch.int32).contiguous()
    svals = torch.gather(vals.t(), 1, sidx.long()).contiguous()
    leaf = torch.randint(0, L1, (T, n), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.randint(0, 3, (T, n), generator=g, device=dev).float()
    if task == "classification":
        y = torch.randint(0, C, (n,), generator=g, device=dev).float()
    else:
        y = vals[:, 0] * 2 + torch.randn((n,), generator=g, device=dev)
    cand = torch.rand((T, m, L1), generator=g, device=dev) < 0.7
    cand[..., 0] = False
    return svals, sidx, leaf, w, y, cand


def level_totals(leaf, w, y, L1, S, task):
    import torch
    from repro_torch.core import splits
    T, n = leaf.shape
    stats = splits.row_stats(y, w, S, task)
    inb = (w > 0) & (leaf > 0)
    flat = leaf.long() + torch.arange(T, device=leaf.device)[:, None] * L1
    tot = torch.zeros((T * L1, S), device=leaf.device)
    tot.index_add_(0, flat.reshape(-1),
                   torch.where(inb[..., None], stats, 0.0).reshape(T * n, S))
    return tot.reshape(T, L1, S)


def check_split_scan(args, dev, g, n, T, m, L1, impurity, task, C, timed):
    import torch
    from repro_torch.kernels import split_scan as ss
    S = C if task == "classification" else 3
    svals, sidx, leaf, w, y, cand = split_scan_inputs(g, n, T, m, L1, C,
                                                      task, dev)
    totals = level_totals(leaf, w, y, L1, S, task)
    kw = dict(impurity=impurity, task=task, min_records=1.0)
    ins = (svals, sidx, leaf, w, y, cand, totals)
    gk, tk = ss.split_scan(*ins, **kw)
    gp, tp = ss.split_scan_plain(*ins, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(gp)
    if not torch.equal(torch.isfinite(gk), fin):
        fail(f"split_scan {impurity} L1={L1}: finite masks differ")
    err = (gk[fin] - gp[fin]).abs().max().item() if fin.any() else 0.0
    thr_same = (tk[fin] == tp[fin]).float().mean().item() if fin.any() else 1.0
    exact = impurity == "gini" and C == 2
    if exact:
        if not (torch.equal(gk[fin], gp[fin]) and torch.equal(tk, tp)):
            fail(f"split_scan gini L1={L1}: not bit-equal (max gain err "
                 f"{err}, same thresholds {thr_same})")
    else:
        # a gain is a difference of impurity terms as large as the leaf's
        # stat sums; float32 rounding of those terms bounds the agreement
        scale = totals.abs().max().item()
        if err > 1e-6 * max(scale, 1.0) or thr_same < 0.99:
            fail(f"split_scan {impurity} L1={L1}: max gain err {err} (scale "
                 f"{scale}), same thresholds {thr_same}")
    row = dict(n=n, T=T, m=m, L1=L1, impurity=impurity, max_abs_err=err,
               same_thr=thr_same, bit_equal=exact)
    if timed:
        row["ms"] = cuda_ms(lambda: ss.split_scan(*ins, **kw))
        row["plain_ms"] = cuda_ms(lambda: ss.split_scan_plain(*ins, **kw),
                                  runs=3)
        nbytes = ss.bound_bytes(T, m, n, L1, S)
        act = ((leaf > 0) & (w > 0)).sum().item() * m
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, act * 40)
    log(f"  split_scan {json.dumps(row)}")
    return row


def cat_inputs(g, n, T, m, L1, V, task, dev):
    import torch
    x = torch.randint(0, V, (m, n), generator=g, device=dev,
                      dtype=torch.int32)
    leaf = torch.randint(0, L1, (T, n), generator=g, device=dev,
                         dtype=torch.int32)
    w = torch.randint(0, 3, (T, n), generator=g, device=dev).float()
    if task == "classification":
        y = torch.randint(0, 2, (n,), generator=g, device=dev).float()
    else:
        y = torch.randn((n,), generator=g, device=dev) * 3 + 1
    return x, leaf, w, y


def library_index_add(x, leaf, w, y, L1, V, S, task):
    """One PyTorch call computing the same tables: `index_add_` on flat
    (tree, column, leaf, category) ids.  Ids and row stats are prepared
    outside the timed call."""
    import torch
    from repro_torch.core import splits
    T, n = leaf.shape
    m = x.shape[0]
    stats = splits.row_stats(y, w, S, task)
    inb = (w > 0) & (leaf > 0)
    contrib = torch.where(inb[..., None], stats, 0.0)           # (T, n, S)
    contrib = contrib[:, None].expand(T, m, n, S).reshape(-1, S)
    base = (torch.arange(T, device=x.device)[:, None] * m
            + torch.arange(m, device=x.device)[None, :])        # (T, m)
    flat = ((base[..., None] * L1 + leaf.long()[:, None]) * V
            + x.long()[None]).reshape(-1)

    def call():
        out = torch.zeros((T * m * L1 * V, S), device=x.device)
        out.index_add_(0, flat, contrib)
        return out
    return call


def check_cat_hist(args, dev, g, n, T, m, L1, V, task, timed, inputs=None):
    import torch
    from repro_torch.kernels import cat_hist as ch
    S = 2 if task == "classification" else 3
    x, leaf, w, y = inputs or cat_inputs(g, n, T, m, L1, V, task, dev)
    kw = dict(L1=L1, V=V, num_stats=S, task=task)
    tk = ch.cat_hist(x, leaf, w, y, **kw)
    tp = ch.cat_hist_plain(x, leaf, w, y, **kw)
    torch.cuda.synchronize()
    err = (tk - tp).abs().max().item()
    if task == "classification":
        if not torch.equal(tk, tp):
            fail(f"cat_hist V={V} L1={L1}: not bit-equal (max err {err})")
    else:
        again = ch.cat_hist(x, leaf, w, y, **kw)
        if not torch.equal(tk, again):
            fail(f"cat_hist regression V={V} L1={L1}: not deterministic")
        mag = ch.cat_hist_plain(x, leaf, w, y.abs(), **kw)   # Σ|stat| per cell
        if not bool(((tk - tp).abs() <= 1e-4 * mag + 1e-6).all()):
            fail(f"cat_hist regression V={V} L1={L1}: max err {err}")
    row = dict(n=n, T=T, m=m, L1=L1, V=V, task=task, max_abs_err=err,
               bit_equal=task == "classification")
    del tk, tp
    if timed:
        row["ms"] = cuda_ms(lambda: ch.cat_hist(x, leaf, w, y, **kw))
        row["plain_ms"] = cuda_ms(lambda: ch.cat_hist_plain(x, leaf, w, y,
                                                            **kw), runs=1)
        row["library_ms"] = cuda_ms(
            library_index_add(x, leaf, w, y, L1, V, S, task), runs=3)
        adds = ((leaf > 0) & (w > 0)).sum().item() * m
        row["bound_ms"], row["bound_by"] = bound_ms(
            ch.bound_bytes(T, m, n, L1, V, S), adds)
    torch.cuda.empty_cache()
    log(f"  cat_hist {json.dumps(row)}")
    return row


def phase2(args, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    n = (1 << args.check_log2n) - 37          # ragged: no multiple of a tile
    for L1 in (2, 65, 513):
        check_split_scan(args, dev, g, n, 2, 3, L1, "gini",
                         "classification", 2, L1 == 513)
    check_split_scan(args, dev, g, n, 2, 3, 65, "gini", "classification", 3,
                     False)
    check_split_scan(args, dev, g, n, 2, 3, 65, "entropy", "classification",
                     2, False)
    check_split_scan(args, dev, g, n, 2, 3, 65, "variance", "regression", 3,
                     False)
    for V in (2, 1000, 10000):
        for L1 in (2, 65):
            check_cat_hist(args, dev, g, 1 << args.check_log2n, 2, 8, L1, V,
                           "classification", (V, L1) == (10000, 65))
    for V in (2, 1000):
        check_cat_hist(args, dev, g, 1 << args.check_log2n, 2, 8, 65, V,
                       "regression", False)


# ---------------------------------------------------------------------------
# The Leo-shaped dataset
# ---------------------------------------------------------------------------

def leo_dataset(seed: int, n: int, m_num: int = 3, m_cat: int = 79):
    """3 float32 numeric + 79 int32 categorical columns (arities log-spaced
    from 2 to 10,000) and binary labels from a seeded rule over one
    numeric and four categorical columns, with 5% label noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    arities = [int(a) for a in np.geomspace(2, 10_000, m_cat).round()]
    num = rng.normal(size=(n, m_num)).astype(np.float32)
    cat = np.empty((n, m_cat), np.int32)
    for j, a in enumerate(arities):
        cat[:, j] = rng.integers(0, a, size=n, dtype=np.int32)
    logit = 1.5 * num[:, 0]
    for j in (20, 45, 60, m_cat - 1):
        effect = rng.normal(size=arities[j]).astype(np.float32)
        logit += effect[cat[:, j]]
    y = (logit > 0).astype(np.int32)
    y ^= (rng.random(n) < 0.05).astype(np.int32)
    return num, cat, y, tuple(arities)


def phase2_main_shapes(args, dev, ds):
    """Both kernels at the shapes the deepest level of the main path gives
    them: the training columns, L1 = 513 leaves, V = 10,000."""
    import torch
    from repro_torch.core import bagging, presort
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 1)
    T, L1 = TREE_BATCH, 2 ** (args.depth - 1) + 1
    n = ds.n
    num = torch.as_tensor(ds.num, device=dev)
    sidx = presort.presort_columns(num)
    svals = presort.gather_sorted(num, sidx).contiguous()
    leaf = torch.randint(0, L1, (T, n), generator=g, device=dev,
                         dtype=torch.int32)
    w = bagging.bag_counts_forest(args.seed, range(T), n, "poisson", dev)
    y = torch.as_tensor(ds.labels, device=dev).float()
    m = ds.m_num
    cand = torch.rand((T, m, L1), generator=g, device=dev) < 10 / 82
    cand[..., 0] = False
    totals = level_totals(leaf, w, y, L1, 2, "classification")
    from repro_torch.kernels import split_scan as ss
    kw = dict(impurity="gini", task="classification", min_records=1.0)
    ins = (svals, sidx, leaf, w, y, cand, totals)
    gk, tk = ss.split_scan(*ins, **kw)
    gp, tp = ss.split_scan_plain(*ins, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(gp)
    if not (torch.equal(gk, gp) and torch.equal(tk, tp)):
        fail("split_scan at the main path's shapes: not bit-equal")
    rows = {}
    nbytes = ss.bound_bytes(T, m, n, L1, 2)
    act = (((leaf > 0) & (w > 0))[:, None, :]
           & torch.gather(cand, 2, leaf.long()[:, None, :].expand(T, m, n))
           ).sum().item()
    b, by = bound_ms(nbytes, act * 40)
    rows["split_scan"] = dict(
        shape=dict(n=n, T=T, m=m, L1=L1, S=2),
        max_abs_err=(gk[fin] - gp[fin]).abs().max().item() if fin.any()
        else 0.0,
        ms=cuda_ms(lambda: ss.split_scan(*ins, **kw)),
        plain_ms=cuda_ms(lambda: ss.split_scan_plain(*ins, **kw), runs=1),
        bound_ms=b, bound_by=by, library_ms=None)
    log(f"  split_scan main-path shapes {json.dumps(rows['split_scan'])}")
    del gk, tk, gp, tp, ins, svals, sidx, num
    cat_cols = torch.as_tensor(ds.cat, device=dev).t().contiguous()
    V = max(ds.arities)
    r = check_cat_hist(args, dev, g, n, T, ds.m_cat, L1, V,
                       "classification", True,
                       inputs=(cat_cols, leaf, w, y))
    rows["cat_hist"] = dict(shape=dict(n=n, T=T, m=ds.m_cat, L1=L1, V=V,
                                       S=2),
                            **{k: r[k] for k in ("max_abs_err", "ms",
                                                 "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")})
    del cat_cols, leaf, w, y
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: training and prediction through the port's entry points
# ---------------------------------------------------------------------------

def same_trees(a, b) -> bool:
    import numpy as np
    keys = ("feature", "threshold", "is_cat", "cat_mask", "children",
            "value", "depth", "n_node")
    return len(a) == len(b) and all(
        np.array_equal(getattr(x, k), getattr(y, k))
        for x, y in zip(a, b) for k in keys)


def phase3(args, dev, ds):
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.forest import RandomForest
    from repro_torch.kernels import cat_hist, split_scan
    params = tree_lib.TreeParams(max_depth=args.depth, backend="kernel")

    def fit():
        return RandomForest(params, num_trees=TREES, seed=args.seed,
                            tree_batch=TREE_BATCH).fit(ds, collect_stats=True)

    torch.cuda.reset_peak_memory_stats()
    split_scan.launches = 0
    cat_hist.launches = 0
    t0 = time.perf_counter()
    rf = fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"split_scan": split_scan.launches,
                "cat_hist": cat_hist.launches}
    levels = [(s.depth, s.wall_seconds) for t in range(0, TREES, TREE_BATCH)
              for s in rf.level_stats[t]]
    peak = torch.cuda.max_memory_allocated()
    log(f"  fit: {fit_s:.3f} s for {TREES} trees of depth <= "
        f"{args.depth} on n={ds.n} rows x {ds.m} columns "
        f"(tree_batch={TREE_BATCH})")
    for depth, sec in levels:
        log(f"    level depth={depth}: {sec * 1e3:.3f} ms")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    log(f"  launches on the main path: {json.dumps(launches)}")
    log(f"  nodes per tree: {[t.num_nodes for t in rf.trees]}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path never launched: {launches}")
    if peak > 60 * 2**30:
        fail(f"peak device memory {peak / 2**30:.1f} GiB passes 60 GiB")
    t0 = time.perf_counter()
    if args.profile:
        again = profiled(fit, fit_s)
    else:
        again = fit()
    log(f"  repeat fit: {time.perf_counter() - t0:.3f} s")
    if not same_trees(rf.trees, again.trees):
        fail("a repeat fit grew different trees")
    log("  repeat fit grew identical trees")
    return rf, dict(fit_s=fit_s, levels=levels, peak_bytes=peak,
                    launches=launches)


def profiled(fn, unprofiled_s: float):
    """Run `fn` under torch.profiler and print where the device time went:
    the device-side span of every `level.*` / `fit.*` range, call by call
    (levels in order, tree batch after tree batch), the top kernels, and
    the device busy time (union of kernel and copy intervals).  The
    profiler slows the host, so the idle share is also given against
    `unprofiled_s`, the same fit's wall time without the profiler."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    ann = [e for e in dev if getattr(e, "is_user_annotation", False)]
    work = [e for e in dev if not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for e in sorted(work, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_ms = busy_us / 1e3
    log(f"  profile: window {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms; "
        f"idle share {1 - busy_ms / wall_ms:.4f} of the profiled window, "
        f"{1 - busy_ms / (unprofiled_s * 1e3):.4f} of the unprofiled fit")
    spans = collections.defaultdict(list)
    for e in sorted(ann, key=lambda e: e.time_range.start):
        spans[e.name].append((e.time_range.end - e.time_range.start) / 1e3)
    for name in sorted(spans):
        v = spans[name]
        log(f"    range {name}: {len(v)} calls, {sum(v):.3f} ms; per call "
            f"{[round(x, 1) for x in v]}")
    kern = collections.defaultdict(lambda: [0, 0.0])
    for e in work:
        k = kern[e.name]
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    for name, (count, ms) in sorted(kern.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"    kernel {name[:60]}: {count} calls, {ms:.3f} ms")
    return out


def phase4(args, dev, rf, test):
    import numpy as np
    import torch
    from repro_torch.core import tree as tree_lib
    from repro_torch.core.dataset import from_numpy
    from repro_torch.core.forest import PackedForest, RandomForest
    t0 = time.perf_counter()
    proba = rf.predict_proba(test.num, test.cat)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    if tuple(proba.shape) != (test.n, 2) or not bool(
            torch.isfinite(proba).all()):
        fail(f"predict_proba gave {tuple(proba.shape)} / non-finite values")
    if not bool(((proba.sum(1) - 1).abs() < 1e-5).all()):
        fail("class distributions do not sum to 1")
    auc = rf.auc(test)
    log(f"  predict_proba on {test.n} held-out rows: {pred_s * 1e3:.3f} ms, "
        f"AUC {auc:.6f}")
    if not auc > 0.6:
        fail(f"AUC {auc} is no better than chance")
    path = ROOT / "build" / "repro_torch" / "chip_smoke_forest.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    rf.packed.save(path)
    loaded = PackedForest.load(path, device=dev)
    path.unlink()
    if not torch.equal(loaded.predict_proba(test.num, test.cat), proba):
        fail("save/load round trip changed the predictions")
    log("  save/load round trip: identical predictions")

    # the card's fit equals the CPU's plain-version fit on a small input
    rng = np.random.default_rng(args.seed)
    n = 20_000
    num = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, a, n) for a in (5, 40, 300)], 1)
    y = ((num[:, 0] > 0) ^ (cat[:, 1] % 3 == 0)).astype(np.int32)
    small = from_numpy(num, cat, y)
    params = tree_lib.TreeParams(max_depth=6, backend="kernel")
    gpu = RandomForest(params, num_trees=3, seed=args.seed,
                       tree_batch=3).fit(small)
    cpu = RandomForest(params, num_trees=3, seed=args.seed, tree_batch=3,
                       device="cpu").fit(small)
    if not same_trees(gpu.trees, cpu.trees):
        fail("the card's small fit differs from the CPU's")
    log("  small fit: the card's trees equal the CPU plain version's")
    return dict(auc=auc, predict_ms=pred_s * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-log2n", type=int, default=23)
    ap.add_argument("--check-log2n", type=int, default=20)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--skip-train", action="store_true",
                    help="stop after the kernel checks (development)")
    ap.add_argument("--profile", action="store_true",
                    help="profile the repeat fit: device time per part")
    args = ap.parse_args()

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("phase 0: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build the kernels")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"  built {list(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per source: {json.dumps({k: round(v, 2) for k, v in secs.items()})})")
    for name in secs:
        for line in _build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    phase2(args, dev)
    n_all = (1 << args.train_log2n) + TEST_ROWS
    t0 = time.perf_counter()
    num, cat, y, arities = leo_dataset(args.seed, n_all)
    from repro_torch.core.dataset import from_numpy
    cut = 1 << args.train_log2n
    train = from_numpy(num[:cut], cat[:cut], y[:cut], arities)
    test = from_numpy(num[cut:], cat[cut:], y[cut:], arities)
    del num, cat, y
    log(f"  Leo-shaped data: {train.n} train + {test.n} test rows, "
        f"{train.m_num} numeric + {train.m_cat} categorical columns, "
        f"made in {time.perf_counter() - t0:.2f} s")
    main_rows = phase2_main_shapes(args, dev, train)
    if args.skip_train:
        return 0

    log("phase 3: train on the card")
    rf, fit_info = phase3(args, dev, train)

    log("phase 4: predict")
    phase4(args, dev, rf, test)

    kernels = []
    sources = {"split_scan": ("src/repro_torch/csrc/split_scan.cu",
                              "src/repro/kernels/split_scan.py:164"),
               "cat_hist": ("src/repro_torch/csrc/cat_hist.cu",
                            "src/repro/kernels/cat_hist.py:64")}
    for name, (source, replaces) in sources.items():
        r = main_rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=fit_info["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
